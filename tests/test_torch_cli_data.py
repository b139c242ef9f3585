"""The port's operator commands against the JAX CLI: ``export``,
``backup``, ``restore``, ``check``, ``inspect``, ``sort`` and ``bench``
of ``pilosa_tpu_torch.cli`` against a port node, and of
``pilosa_tpu.cli`` against a JAX node holding the same data, give the
same output files (archives compared by their members' payloads: tar
mtimes differ), the same stdout (the data file's path and the timings
aside) and the same exit codes, error cases included."""

import io
import os
import re
import tarfile

import numpy as np
import pytest

pytest.importorskip("torch")

from pilosa_tpu.cli import main as jmain  # noqa: E402
from pilosa_tpu_torch.cli.main import main as tmain  # noqa: E402
from test_torch_data_routes import (  # noqa: E402
    N_SLICES,
    SW,
    nested_members,
    open_pair,
    populate,
    request,
    schema,
)


@pytest.fixture
def nodes(tmp_path):
    j, t = open_pair(tmp_path)
    try:
        for s in (j, t):
            populate(s, seed=2)
        yield j, t
    finally:
        t.close()
        j.close()


def run(main, argv, capsysbinary):
    code = main(argv)
    out = capsysbinary.readouterr().out
    return code, out


def both(j, t, argv_of, capsysbinary):
    """``argv_of(node, side)`` for each; returns ((code, stdout) JAX, port)."""
    return (run(jmain, argv_of(j, "jax"), capsysbinary),
            run(tmain, argv_of(t, "torch"), capsysbinary))


@pytest.mark.parametrize("view", ["standard", "inverse"])
def test_export_to_file_and_stdout(nodes, tmp_path, capsysbinary, view):
    j, t = nodes
    outs = {}

    def argv(node, side):
        outs[side] = str(tmp_path / f"{side}-{view}.csv")
        return ["export", "--host", node.host, "-i", "i", "-f", "f", "-v", view, "-o", outs[side]]

    a, b = both(j, t, argv, capsysbinary)
    # The export walks the index's max slice in any view, so an inverse
    # view with fewer slices ends in a 404 and exit 1 in both packages.
    assert a == b == ((0 if view == "standard" else 1), b"")
    with open(outs["jax"], "rb") as fj, open(outs["torch"], "rb") as ft:
        data = ft.read()
        assert data == fj.read()
    assert data.count(b"\n") > 1000
    a, b = both(j, t, lambda n, s: ["export", "--host", n.host, "-i", "i", "-f", "f", "-v", view],
                capsysbinary)
    assert a == b == (a[0], data)


def test_backup_and_restore_files_across_packages(nodes, tmp_path, capsysbinary):
    j, t = nodes
    files = {}

    def backup(node, side):
        files[side] = str(tmp_path / f"{side}.tar")
        return ["backup", "--host", node.host, "-i", "i", "-f", "f", "-o", files[side]]

    a, b = both(j, t, backup, capsysbinary)
    assert a == b == (0, b"")
    with open(files["jax"], "rb") as fj, open(files["torch"], "rb") as ft:
        jtar, ttar = fj.read(), ft.read()
    assert nested_members(ttar) == nested_members(jtar)
    assert sorted(nested_members(ttar), key=int) == [str(s) for s in range(N_SLICES)]
    j2, t2 = open_pair(tmp_path, "dst")
    try:
        for s in (j2, t2):
            schema(s)
        # Each package's CLI restores the OTHER package's file.
        a, b = both(j2, t2, lambda n, s: ["restore", "--host", n.host, "-i", "i", "-f", "f", "-d",
                                          files["torch" if s == "jax" else "jax"]], capsysbinary)
        assert a == b == (0, b"")
        for q in ("Count(Bitmap(frame=f, rowID=5))", "TopN(frame=f, n=4)",
                  "Bitmap(frame=f, rowID=8)"):
            want = request(j.host, "POST", "/index/i/query", q.encode())
            assert request(j2.host, "POST", "/index/i/query", q.encode()) == want
            assert request(t2.host, "POST", "/index/i/query", q.encode()) == want
        for slc in range(N_SLICES):
            path = f"/fragment/blocks?index=i&frame=f&view=standard&slice={slc}"
            assert request(t2.host, "GET", path) == request(j.host, "GET", path)
    finally:
        t2.close()
        j2.close()


@pytest.mark.parametrize("argv", [
    ["backup", "-i", "i"],                       # no frame
    ["backup", "-i", "i", "-f", "f", "-v", "standard_2017", "-o", "{tmp}/x.tar"],
    ["restore", "-i", "i", "-f", "f"],           # no input file
    ["restore", "-i", "i", "-d", "{tmp}/none.tar"],
    ["restore", "-i", "i", "-f", "f", "-d", "{tmp}/none.tar"],
    ["export", "-i", "i", "-f", "nope", "-o", "{tmp}/x.csv"],
    ["bench", "-i", "i", "-f", "f"],             # set-bit needs --num
    ["check", "{tmp}/none"],
])
def test_errors_exit_as_jax(nodes, tmp_path, capsysbinary, argv):
    j, t = nodes

    def argv_of(node, side):
        out = [a.replace("{tmp}", str(tmp_path / side)) for a in argv]
        os.makedirs(tmp_path / side, exist_ok=True)
        return [out[0], *(["--host", node.host] if out[0] not in ("check",) else []), *out[1:]]

    a, b = both(j, t, argv_of, capsysbinary)
    assert b == a
    assert a[0] == 1


def _data_files(node) -> list[str]:
    base = os.path.join(node.holder.path, "i", "f", "views", "standard", "fragments")
    return [os.path.join(base, str(s)) for s in range(N_SLICES)]


def test_check_and_inspect_data_files(nodes, tmp_path, capsysbinary):
    j, t = nodes
    for s in (j, t):
        s.holder.fragment("i", "f", "standard", 0).snapshot()

    def files(node, side):
        return _data_files(node) + [_data_files(node)[0] + ".cache"]

    a, b = both(j, t, lambda n, s: ["check", *files(n, s)], capsysbinary)
    assert a == b == (0, b"")
    a, b = both(j, t, lambda n, s: ["inspect", *_data_files(n)], capsysbinary)
    assert a[0] == b[0] == 0
    strip = re.compile(rb"^/\S+:$", re.M)
    assert strip.sub(b"PATH:", b[1]) == strip.sub(b"PATH:", a[1])
    assert b[1].count(b"container key=") > 10
    # A damaged file: the same problems on stdout, exit 1.
    for node, side in ((j, "jax"), (t, "torch")):
        with open(_data_files(node)[1], "rb") as f:
            data = bytearray(f.read())
        data[8:12] = b"\xff\xff\xff\x7f"
        bad = tmp_path / f"{side}-bad"
        bad.write_bytes(bytes(data))
    a, b = both(j, t, lambda n, s: ["check", str(tmp_path / f"{s}-bad")], capsysbinary)
    assert a[0] == b[0] == 1
    assert b[1].replace(b"torch-bad", b"X") == a[1].replace(b"jax-bad", b"X") != b""


def test_sort(tmp_path, capsysbinary):
    rng = np.random.default_rng(4)
    lines = [f"{r},{c}" for r, c in zip(rng.integers(0, 9, 300), rng.integers(0, 4 * SW, 300))]
    path = tmp_path / "bits.csv"
    path.write_text("\n".join(lines + ["", "5,7,2017-01-01T00:00"]) + "\n")
    a = run(jmain, ["sort", str(path)], capsysbinary)
    b = run(tmain, ["sort", str(path)], capsysbinary)
    assert a == b and a[0] == 0 and a[1].count(b"\n") == 301
    bad = tmp_path / "bad.csv"
    bad.write_text("1,x\n")
    assert run(jmain, ["sort", str(bad)], capsysbinary)[0] == \
        run(tmain, ["sort", str(bad)], capsysbinary)[0] == 1


@pytest.mark.parametrize("op", ["set-bit", "intersect-count", "topn"])
def test_bench(nodes, capsysbinary, op):
    j, t = nodes
    argv = ["-i", "i", "-f", "f", "-o", op, "-n", "30"]
    a, b = both(j, t, lambda n, s: ["bench", "--host", n.host, *argv], capsysbinary)
    assert a[0] == b[0] == 0
    timing = re.compile(rb"[0-9.]+s \([0-9]+ op/sec\)|p50 [0-9.]+ ms, p95 [0-9.]+ ms")
    assert timing.sub(b"T", b[1]) == timing.sub(b"T", a[1])


def test_backup_archive_is_a_tar_of_fragment_tars(nodes, tmp_path, capsysbinary):
    """Each member of the backup is one slice's archive, which restores
    through ``POST /fragment/data`` on its own."""
    j, t = nodes
    out = tmp_path / "b.tar"
    assert run(tmain, ["backup", "--host", t.host, "-i", "i", "-f", "g", "-o", str(out)],
               capsysbinary)[0] == 0
    tr = tarfile.open(out)
    for m in tr:
        payload = tr.extractfile(m).read()
        names = [x.name for x in tarfile.open(fileobj=io.BytesIO(payload))]
        assert names == ["checksum", "data", "cache"]
        path = f"/fragment/data?index=i&frame=f&view=standard&slice={m.name}"
        assert request(j.host, "POST", path, payload)[0] == request(t.host, "POST", path, payload)[0]
    for q in ("Count(Bitmap(frame=f, rowID=5))", "TopN(frame=f, n=4)"):
        assert request(t.host, "POST", "/index/i/query", q.encode()) == \
            request(j.host, "POST", "/index/i/query", q.encode())
