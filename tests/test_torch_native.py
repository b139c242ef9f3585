"""The port's native roaring codec (``pilosa_tpu_torch/native``) against
three references: the port's own Python codec (the plain version), the
JAX package's ``pilosa_tpu.ops.roaring``, and the JAX package's native
``parse_csv`` / ``format_csv``.

Random containers of both tiers (hypothesis and numpy seeds), op logs and
torn tails, corrupt files (the same ``CorruptError``), CSV round trips,
and files written by either package decoding alike in the other.  The
port loads its own library, never the JAX package's, and falls back to
the Python path without it.  Where ``g++`` is missing the native cases
skip and the Python cases still run."""

import mmap
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from pilosa_tpu import native as jnative  # noqa: E402
from pilosa_tpu.ops import roaring as jroaring  # noqa: E402
from pilosa_tpu_torch import native as tnative  # noqa: E402
from pilosa_tpu_torch.core.fragment import Fragment  # noqa: E402
from pilosa_tpu_torch.ops import roaring as troaring  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
needs_native = pytest.mark.skipif(not tnative.available(),
                                  reason="no g++: the port's native codec cannot be built")
MODES = ["python", pytest.param("native", marks=needs_native)]


@pytest.fixture
def mode(request, monkeypatch):
    """``python``: the port's codec with its native library switched off;
    ``native``: with it."""
    if request.param == "python":
        monkeypatch.setattr(tnative, "_lib", None)
        monkeypatch.setattr(tnative, "_failed", True)
    return request.param


def containers_of(seed: int, n_keys: int = 10) -> tuple[dict, dict]:
    """``(words, arrays)``: bitmap containers (uint64[1024]) and array
    containers (sorted uint32 values) at every size around the 4,096-bit
    form boundary, and an empty one of each."""
    rng = np.random.default_rng(seed)
    keys = [int(k) for k in rng.choice(1 << 20, size=2 * n_keys, replace=False)]
    words, arrays = {}, {}
    for i, key in enumerate(keys):
        n = int(rng.choice([1, 2, 100, 4095, 4096, 4097, 20000, 65536]))
        pos = np.sort(rng.choice(1 << 16, size=n, replace=False)).astype(np.uint32)
        if i % 2:
            arrays[key] = pos
        else:
            w = np.zeros(1024, np.uint64)
            np.bitwise_or.at(w, pos // 64, np.uint64(1) << (pos % 64).astype(np.uint64))
            words[key] = w
    words[(1 << 21) + 1] = np.zeros(1024, np.uint64)
    arrays[(1 << 21) + 2] = np.zeros(0, np.uint32)
    return words, arrays


def as_words(words: dict, arrays: dict) -> dict:
    out = {k: w for k, w in words.items() if w.any()}
    for k, vals in arrays.items():
        if len(vals):
            out[k] = troaring.values_to_words(vals)
    return out


def same_words(a: dict, b: dict) -> bool:
    a = {k: w for k, w in a.items() if w.any()}
    b = {k: w for k, w in b.items() if w.any()}
    return sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)


def ops_for(rng, n: int) -> bytes:
    typ = rng.integers(0, 2, n)
    vals = rng.integers(0, 1 << 36, n)
    return b"".join(troaring.encode_op(int(t), int(v)) for t, v in zip(typ, vals))


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES, indirect=True)
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_encode_equals_both_references(mode, seed):
    words, arrays = containers_of(seed)
    dense = as_words(words, arrays)
    want = troaring.encode_tiered_py(words, arrays)
    assert troaring.encode_tiered(words, arrays) == want
    assert troaring.encode(dense) == want == jroaring.encode(dense)
    keys = np.array(sorted(dense), dtype=np.uint64)
    packed = np.stack([dense[int(k)] for k in keys])
    assert troaring.encode_packed(keys, packed) == want == jroaring.encode_packed(keys, packed)


@pytest.mark.parametrize("mode", MODES, indirect=True)
@pytest.mark.parametrize("seed", [4, 5, 6])
def test_decode_with_op_log_equals_both_references(mode, seed):
    rng = np.random.default_rng(seed)
    words, arrays = containers_of(seed)
    data = troaring.encode_tiered(words, arrays) + ops_for(rng, 300)
    got, ops = troaring.decode_with_ops(data)
    want, want_ops = troaring.decode_with_ops_py(data)
    jwant, jops = jroaring.decode_with_ops(data)
    assert ops == want_ops == jops == 300
    assert same_words(got, want) and same_words(got, jwant)
    tw, ta, tops = troaring.decode_tiered(data)
    pw, pa, pops = troaring.decode_tiered_py(data)
    jw, ja, jops2 = jroaring.decode_tiered(data)
    assert tops == pops == jops2 == 300
    assert same_words(as_words(tw, ta), as_words(pw, pa))
    assert same_words(as_words(tw, ta), as_words(jw, ja))
    assert same_words(as_words(tw, ta), got)


@pytest.mark.parametrize("mode", MODES, indirect=True)
def test_decode_tiered_reads_a_mapped_file(mode, tmp_path):
    words, arrays = containers_of(7)
    path = tmp_path / "f.roaring"
    path.write_bytes(troaring.encode_tiered(words, arrays) + ops_for(np.random.default_rng(7), 40))
    with open(path, "rb") as fh, mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        w, a, ops = troaring.decode_tiered(mm)
    pw, pa, pops = troaring.decode_tiered_py(path.read_bytes())
    assert ops == pops == 40
    assert same_words(as_words(w, a), as_words(pw, pa))


@st.composite
def tiers(draw):
    """Container dicts of both forms, drawn around the form boundary."""
    words, arrays = {}, {}
    keys = draw(st.lists(st.integers(0, (1 << 32) - 1), min_size=0, max_size=6, unique=True))
    for key in keys:
        n = draw(st.sampled_from([0, 1, 7, 4095, 4096, 4097, 9000]))
        seed = draw(st.integers(0, 2**32 - 1))
        pos = np.sort(np.random.default_rng(seed).choice(1 << 16, size=n, replace=False))
        if draw(st.booleans()):
            arrays[key] = pos.astype(np.uint32)
        else:
            w = np.zeros(1024, np.uint64)
            np.bitwise_or.at(w, pos // 64, np.uint64(1) << (pos % 64).astype(np.uint64))
            words[key] = w
    ops = draw(st.lists(st.tuples(st.integers(0, 1), st.integers(0, (1 << 48) - 1)),
                        max_size=20))
    return words, arrays, ops


@needs_native
@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(tiers())
def test_drawn_files_native_equals_python(t):
    words, arrays, ops = t
    body = troaring.encode_tiered_py(words, arrays)
    assert troaring.encode_tiered(words, arrays) == body
    dense = as_words(words, arrays)
    assert troaring.encode(dense) == body
    data = body + b"".join(troaring.encode_op(typ, v) for typ, v in ops)
    got, n = troaring.decode_with_ops(data)
    want, n_py = troaring.decode_with_ops_py(data)
    assert n == n_py == len(ops) and same_words(got, want)
    tw, ta, _ = troaring.decode_tiered(data)
    pw, pa, _ = troaring.decode_tiered_py(data)
    assert same_words(as_words(tw, ta), as_words(pw, pa))


def corrupt_files() -> dict[str, bytes]:
    words, arrays = containers_of(11, n_keys=3)
    body = troaring.encode_tiered(words, arrays)
    op = troaring.encode_op(0, 5)
    return {
        "empty": b"",
        "short": body[:5],
        "cookie": b"\x00" * 8 + body[8:],
        "truncated payload": body[:-100],
        "torn op": body + op[:7],
        "torn second op": body + op + op[:12],
        "bad checksum": body + op[:-1] + bytes([op[-1] ^ 0xFF]),
        "bad op type": body + b"\x07" + op[1:],
    }


@pytest.mark.parametrize("name", sorted(corrupt_files()))
def test_corrupt_files_raise_the_same_error(name):
    """Every decoder refuses a corrupt file with ``CorruptError``: the
    port's native message equals the JAX native one, its Python message the
    JAX Python one, and the Python message extends the native one."""
    data = corrupt_files()[name]
    msgs = {}
    for label, fn in (("py", troaring.decode_with_ops_py), ("tiered py", troaring.decode_tiered_py),
                      ("jax py", jroaring._decode_containers),
                      ("native", troaring.decode_with_ops), ("tiered", troaring.decode_tiered)):
        try:
            out = fn(data)
            if label == "jax py":  # containers only: the ops follow
                jroaring._apply_ops(out[0], data, out[1])
        except (troaring.CorruptError, jroaring.CorruptError) as e:
            assert isinstance(e, troaring.CorruptError if label != "jax py" else jroaring.CorruptError)
            msgs[label] = str(e)
    assert set(msgs) == {"py", "tiered py", "jax py", "native", "tiered"}, msgs
    assert msgs["py"] == msgs["tiered py"] == msgs["jax py"]
    assert msgs["native"] == msgs["tiered"]
    assert msgs["py"].startswith(msgs["native"])
    if tnative.available() and jnative.available():
        with pytest.raises(jnative.NativeCorruptError) as e:
            jnative.decode(data)
        assert str(e.value) == msgs["native"]


@needs_native
def test_torn_tail_scan_agrees_with_native_decode():
    """A torn op-log tail: the decoders refuse it and ``scan_torn_tail``
    finds the last whole record, in both packages."""
    words, arrays = containers_of(12, n_keys=2)
    good = troaring.encode_tiered(words, arrays) + ops_for(np.random.default_rng(12), 5)
    for cut in (1, 6, 12):
        data = good + troaring.encode_op(1, 99)[:cut]
        with pytest.raises(troaring.CorruptError):
            troaring.decode_with_ops(data)
        assert troaring.scan_torn_tail(data) == jroaring.scan_torn_tail(data)
        assert troaring.scan_torn_tail(data)[0] == len(good)
        _, ops = troaring.decode_with_ops(data[: troaring.scan_torn_tail(data)[0]])
        assert ops == 5


@pytest.mark.parametrize("mode", MODES, indirect=True)
@pytest.mark.parametrize("seed", [20, 21])
def test_files_cross_between_packages(mode, seed, tmp_path):
    """A file written by either package decodes alike in the other, and
    re-encodes to the same bytes."""
    rng = np.random.default_rng(seed)
    words, arrays = containers_of(seed)
    dense = as_words(words, arrays)
    tail = ops_for(rng, 25)
    port_file = troaring.encode(dense) + tail
    jax_file = jroaring.encode(dense) + tail
    assert port_file == jax_file
    for data in (port_file, jax_file):
        tw, tops = troaring.decode_with_ops(data)
        jw, jops = jroaring.decode_with_ops(data)
        assert tops == jops and same_words(tw, jw)
        assert troaring.encode(tw) == jroaring.encode(jw)


def test_encode_op_matches_native_record():
    for typ, v in ((0, 0), (1, 5), (0, (1 << 64) - 1), (1, 1 << 40)):
        rec = troaring.encode_op(typ, v)
        assert rec == jroaring.encode_op(typ, v)
        if tnative.available():
            assert tnative.encode_op(typ, v) == rec


# ---------------------------------------------------------------------------
# CSV
# ---------------------------------------------------------------------------


def pairs_of(seed: int, n: int):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 20, n).astype(np.uint64)
    cols = rng.integers(0, 1 << 40, n).astype(np.uint64)
    k = min(n, 3)
    rows[:k] = [0, (1 << 64) - 1, 9][:k]
    cols[:k] = [0, 7, (1 << 64) - 1][:k]
    return rows, cols


@pytest.mark.parametrize("mode", MODES, indirect=True)
@pytest.mark.parametrize("n", [1, 17, 5000])
def test_csv_format_equals_jax_native_and_numpy(mode, n):
    rows, cols = pairs_of(n, n)
    blob = Fragment._format_pairs(rows, cols)
    want = b"".join(f"{int(r)},{int(c)}\n".encode() for r, c in zip(rows, cols))
    assert blob == want
    if jnative.available():
        assert jnative.format_csv(rows, cols) == want
    if tnative.available():
        assert tnative.format_csv(rows, cols) == want


@needs_native
@pytest.mark.parametrize("n", [1, 300, 20000])
def test_csv_parse_round_trips_like_jax_native(n):
    rows, cols = pairs_of(n + 1, n)
    blob = tnative.format_csv(rows, cols)
    for data in (blob, blob + b"\n\n", blob.replace(b"\n", b"\r\n")):
        got = tnative.parse_csv(data)
        assert got is not None
        assert np.array_equal(got[0], rows) and np.array_equal(got[1], cols)
        if jnative.available():
            want = jnative.parse_csv(data)
            assert np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])


@needs_native
@pytest.mark.parametrize("text", [b"x,5\n", b"5\n", b"1,5,2019-06-01T00:00\n", b'"1",2\n',
                                  b"1,-2\n", b"1,99999999999999999999999\n"])
def test_csv_parse_refuses_what_python_reads(text):
    """What the native parser refuses goes to Python's csv: both packages'
    parsers refuse the same records."""
    assert tnative.parse_csv(text) is None
    if jnative.available():
        assert jnative.parse_csv(text) is None


# ---------------------------------------------------------------------------
# dispatch, isolation, fallback
# ---------------------------------------------------------------------------


@needs_native
def test_export_and_import_go_through_the_native_codec(monkeypatch, tmp_path):
    """The CSV export formats with the native formatter, and the CLI's
    import of a plain file parses with the native parser (a file with
    timestamps goes back to Python's csv)."""
    import importlib

    cli = importlib.import_module("pilosa_tpu_torch.cli.main")

    calls = {"format": 0, "parse": 0}
    fmt, parse = tnative.format_csv, tnative.parse_csv

    def count(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(tnative, "format_csv", count("format", fmt))
    monkeypatch.setattr(tnative, "parse_csv", count("parse", parse))
    rows, cols = pairs_of(3, 40)
    assert Fragment._format_pairs(rows, cols) == fmt(rows, cols)
    assert calls["format"] == 1

    sent = []

    class Client:
        def import_bits(self, index, frame, r, c, ts=None):
            sent.append((np.asarray(r, np.uint64), np.asarray(c, np.uint64), ts))
            return sorted({int(x) >> 20 for x in np.asarray(c, np.uint64)})

    class Args:
        index, frame, field, buffer_size = "i", "f", "", 7

    plain = tmp_path / "plain.csv"
    plain.write_bytes(b"1,5\n2,1048577\n\n3,9\n")
    assert cli._import_native(Client(), Args, str(plain))
    assert calls["parse"] == 1
    got = np.concatenate([s[0] for s in sent]), np.concatenate([s[1] for s in sent])
    assert got[0].tolist() == [1, 2, 3] and got[1].tolist() == [5, 1048577, 9]
    stamped = tmp_path / "stamped.csv"
    stamped.write_bytes(b"1,5,2019-06-01T00:00\n")
    assert not cli._import_native(Client(), Args, str(stamped))


@needs_native
def test_port_loads_its_own_library_only():
    """In a fresh interpreter the port's codec loads the library it built
    from its own source, under build/torch_native, and never the JAX
    package's."""
    code = (
        "import numpy as np\n"
        "from pilosa_tpu_torch import native\n"
        "from pilosa_tpu_torch.ops import roaring\n"
        "roaring.decode(roaring.encode({0: np.ones(1024, np.uint64)}))\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(native.loaded_path())\n"
        "print('pilosa_tpu/native' in maps, 'torch_native/libpilosa_native' in maps)\n"
        "import sys\n"
        "print(any(m == 'pilosa_tpu' or m.startswith('pilosa_tpu.') for m in sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    path, maps, mods = out.stdout.split("\n")[:3]
    assert path.startswith(os.path.join(REPO, "build", "torch_native", "libpilosa_native-"))
    assert maps == "False True" and mods == "False"


def test_disabled_native_falls_back_to_python():
    """``PILOSA_TPU_DISABLE_NATIVE`` turns the library off: the port's
    codec answers from its Python path with the same bytes."""
    code = (
        "import numpy as np\n"
        "from pilosa_tpu_torch import native\n"
        "from pilosa_tpu_torch.ops import roaring\n"
        "b = roaring.encode({3: np.arange(1024, dtype=np.uint64)})\n"
        "c, n = roaring.decode_with_ops(b)\n"
        "print(native.available(), native.loaded_path(), b.hex()[:40], n)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, PILOSA_TPU_DISABLE_NATIVE="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    want = troaring.encode_tiered_py({3: np.arange(1024, dtype=np.uint64)}, {}).hex()[:40]
    assert out.stdout.split() == ["False", "None", want, "0"]


def test_build_is_keyed_by_source_and_flags(monkeypatch):
    """The library's file name moves with the source and the flags, so a
    changed source or flag never loads a stale build."""
    a = tnative.library_path()
    monkeypatch.setattr(tnative, "CFLAGS", tnative.CFLAGS + ("-DX",))
    assert tnative.library_path() != a
    assert a.parent == tnative.BUILD_DIR and a.name.startswith("libpilosa_native-")
