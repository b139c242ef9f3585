"""``/import`` and the device delta-scatter (K7) of the port against the
JAX package: ``ingest.scatter.fold`` and the plain K7 equal their JAX
counterparts; after imports and SetBit/ClearBit storms a port fragment's
host plane, device mirror and rank cache equal a JAX fragment's, on the
queued path and on the counted fallback path; and ``POST /import``
answers its error cases as the JAX handler does."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.core.fragment import Fragment as JFragment  # noqa: E402
from pilosa_tpu.exec import plan as jplan  # noqa: E402
from pilosa_tpu.ingest import scatter as jscatter  # noqa: E402
from pilosa_tpu.net import wire_pb2 as pb  # noqa: E402
from pilosa_tpu.net.server import Server as JServer  # noqa: E402
from pilosa_tpu_torch.core.fragment import Fragment as TFragment  # noqa: E402
from pilosa_tpu_torch.exec import plan as tplan  # noqa: E402
from pilosa_tpu_torch.ingest import scatter as tscatter  # noqa: E402
from pilosa_tpu_torch.net.server import Server as TServer  # noqa: E402
from pilosa_tpu_torch.ops import bitplane as tbp  # noqa: E402
from pilosa_tpu_torch.ops import delta_scatter as ds  # noqa: E402

SW = tbp.SLICE_WIDTH
SLICE = 3


def random_queue(rng, n: int, rows: int = 4, words: int = 6):
    """(slot, word, single-bit mask, op) entries crowded onto few words,
    so that sets and clears of one bit interleave."""
    return [
        (int(rng.integers(rows)), int(rng.integers(words)),
         1 << int(rng.integers(32)), int(rng.integers(2)))
        for _ in range(n)
    ]


@pytest.mark.parametrize("seed", range(6))
def test_fold_matches_jax(seed):
    rng = np.random.default_rng(seed)
    q = random_queue(rng, [1, 2, 40, 500, 3000, 8192][seed])
    if seed == 3:  # multi-bit masks too
        q = [(s, w, m | (m >> 3), op) for s, w, m, op in q]
    got = tscatter.fold(q)
    want = jscatter.fold(q)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_fold_empty_queue():
    assert all(len(a) == 0 for a in tscatter.fold([]))


@pytest.mark.parametrize("rows,n", [(8, 1), (8, 31), (16, 1100), (16, 4096)])
def test_plain_k7_matches_jax_scatter_apply(rows, n):
    rng = np.random.default_rng(rows * 10_000 + n)
    plane = rng.integers(0, 2**32, size=(rows, tbp.WORDS_PER_SLICE), dtype=np.uint32)
    plane[rows - 1, -1] = 0x80000000
    keys = rng.choice(rows * tbp.WORDS_PER_SLICE, size=n, replace=False)
    if n > 1:
        keys[:2] = (rows - 1) * tbp.WORDS_PER_SLICE + np.array([0, tbp.WORDS_PER_SLICE - 1])
    slots = (keys // tbp.WORDS_PER_SLICE).astype(np.int32)
    words = (keys % tbp.WORDS_PER_SLICE).astype(np.int32)
    or_m = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    andnot_m = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    or_m[0], andnot_m[0] = 0x80000001, 0x80000001  # bit 0 and bit 31, set wins
    want = np.asarray(jplan.scatter_apply(plane, slots, words, or_m, andnot_m))
    got = tbp.to_device(plane, "cpu")
    out = tplan.scatter_apply(got, slots, words, or_m, andnot_m)
    assert out is got  # in place
    np.testing.assert_array_equal(tbp.to_host(got), want)


def test_k7_wrapper_refuses_bad_entries():
    plane = torch.zeros(8, tbp.WORDS_PER_SLICE, dtype=torch.int32)
    i32, u32 = np.int32, np.uint32
    ok = (np.array([1], i32), np.array([2], i32), np.array([1], u32), np.array([0], u32))
    for bad in (
        (np.array([8], i32),) + ok[1:],  # slot past the plane
        (ok[0], np.array([tbp.WORDS_PER_SLICE], i32)) + ok[2:],  # word past the row
        (np.array([-1], i32),) + ok[1:],
        (np.array([1, 1], i32), np.array([2, 2], i32), np.array([1, 2], u32),
         np.array([0, 0], u32)),  # one (slot, word) twice
        (ok[0].astype(np.int64),) + ok[1:],  # dtype
        ok[:3] + (np.array([0, 0], u32),),  # length
    ):
        with pytest.raises(ValueError):
            ds.delta_scatter(plane, *bad)
    with pytest.raises(ValueError):
        ds.delta_scatter(plane[:, ::2], *ok)  # not contiguous
    meta = torch.empty(8, tbp.WORDS_PER_SLICE, dtype=torch.int32, device="meta")
    before = ds.launches
    with pytest.raises(ValueError):
        ds.delta_scatter(meta, *ok)
    assert ds.launches == before


# --- fragments --------------------------------------------------------------


def fragments(tmp_path):
    j = JFragment(str(tmp_path / "jax" / str(SLICE)), "i", "f", "standard", SLICE)
    t = TFragment(str(tmp_path / "torch" / str(SLICE)), "i", "f", "standard", SLICE, device="cpu")
    j.open()
    t.open()
    return j, t


def cols(rng, n):
    return SLICE * SW + rng.integers(0, SW, n)


def both_import(j, t, rows, columns):
    j.import_bulk(rows, columns)
    t.import_bulk(rows, columns)
    j.device_plane()  # the JAX mirror is resident where the port's is


def storm(j, t, rng, n_set: int, n_clear: int, rows: int) -> None:
    for r, c in zip(rng.integers(0, rows, n_set), cols(rng, n_set)):
        assert j.set_bit(int(r), int(c)) == t.set_bit(int(r), int(c))
    for r in range(rows):  # clears of bits that exist, and of ones that do not
        words = j._row_words_host(r)
        if words is None:
            continue
        offs = tbp.np_row_to_columns(words)[: n_clear // rows]
        for c in list(offs) + list(rng.integers(0, SW, 3)):
            assert j.clear_bit(r, SLICE * SW + int(c)) == t.clear_bit(r, SLICE * SW + int(c))


def assert_same_fragment(j, t) -> None:
    assert t._slot_of == j._slot_of
    assert t._plane.shape == j._plane.shape
    np.testing.assert_array_equal(t._plane, j._plane)
    mirror = tbp.to_host(t.device_plane())
    np.testing.assert_array_equal(mirror, np.asarray(j.device_plane()))
    np.testing.assert_array_equal(mirror, t._plane)
    assert t._count_of == j._count_of
    assert sorted(t.cache.ids()) == sorted(j.cache.ids())
    assert {i: t.cache.get(i) for i in t.cache.ids()} == {i: j.cache.get(i) for i in j.cache.ids()}


def test_queued_path_matches_jax(tmp_path):
    j, t = fragments(tmp_path)
    rng = np.random.default_rng(1)
    both_import(j, t, rng.integers(0, 6, 3000), cols(rng, 3000))
    t.device_plane()  # a read uploads the mirror; later writes queue for it
    limit = tscatter.pending_limit(t._mirror.shape[0])
    t0, j0 = tscatter.counters(), jscatter.counters()
    for n in (1, 700, min(jscatter.IMPORT_SCATTER_MAX, limit // 4)):
        both_import(j, t, rng.integers(0, 6, n), cols(rng, n))
    storm(j, t, rng, 300, 120, rows=8)  # rows 6-7 are new slots inside the padded plane
    assert 0 < t._pending_n <= limit
    assert_same_fragment(j, t)
    assert t._pending_n == 0
    t1, j1 = tscatter.counters(), jscatter.counters()
    # The imports and the storm only queued: the read applies it all at once.
    assert t1["launches"] - t0["launches"] == 1
    assert t1["fallbackInvalidations"] == t0["fallbackInvalidations"]
    assert j1["fallbackInvalidations"] == j0["fallbackInvalidations"]
    assert t1["updatesApplied"] - t0["updatesApplied"] > 0
    j.close()
    t.close()


def test_fallback_path_matches_jax(tmp_path):
    j, t = fragments(tmp_path)
    rng = np.random.default_rng(2)
    both_import(j, t, rng.integers(0, 6, 3000), cols(rng, 3000))
    t.device_plane()
    t0, j0 = tscatter.counters(), jscatter.counters()
    # Too many bits for either package's queue.
    n = max(jscatter.IMPORT_SCATTER_MAX, tscatter.pending_limit(t._mirror.shape[0])) + 1
    both_import(j, t, rng.integers(0, 6, n), cols(rng, n))
    assert t._mirror is None and t._pending_n == 0  # dropped; the next read uploads
    t.device_plane()
    storm(j, t, rng, 40, 20, rows=12)  # rows 8-11 grow the plane past 8 rows
    t.device_plane()
    j.device_plane()
    t._MAX_DEVICE_PENDING = j._MAX_DEVICE_PENDING = 16  # then overflow the queue
    storm(j, t, rng, 40, 0, rows=12)
    assert_same_fragment(j, t)
    t1, j1 = tscatter.counters(), jscatter.counters()
    assert t1["fallbackInvalidations"] - t0["fallbackInvalidations"] == 3
    assert j1["fallbackInvalidations"] - j0["fallbackInvalidations"] == 3
    j.close()
    t.close()


def test_point_writes_queue_and_apply_once(tmp_path):
    _, t = fragments(tmp_path)
    rng = np.random.default_rng(3)
    t.import_bulk(rng.integers(0, 4, 100), cols(rng, 100))
    t.device_plane()
    c = SLICE * SW + 5
    before = tscatter.counters()["launches"]
    assert t.set_bit(1, c) and t.clear_bit(1, c) and t.set_bit(1, c)
    assert t._pending_n == 3
    assert t.apply_pending_scatter()
    assert not t.apply_pending_scatter()  # nothing left
    assert tscatter.counters()["launches"] == before + 1
    assert tbp.to_host(t.device_plane()[t._slot_of[1]])[0] >> 5 & 1


# --- POST /import, JAX handler vs the port's ---------------------------------


def post_import(host: str, body: bytes):
    req = urllib.request.Request(
        f"http://{host}/import",
        data=body,
        method="POST",
        headers={"Content-Type": "application/x-protobuf", "Accept": "application/x-protobuf"},
    )
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            status, ctype, data = resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        status, ctype, data = e.code, e.headers["Content-Type"], e.read()
    if ctype == "application/json":
        return status, json.loads(data)
    msg = pb.ImportResponse()
    msg.ParseFromString(data)
    return status, {"Err": msg.Err}


@pytest.fixture
def import_servers(tmp_path):
    j = JServer(
        data_dir=str(tmp_path / "jax"), host="127.0.0.1:0",
        anti_entropy_interval=3600, polling_interval=3600, cache_flush_interval=3600,
    )
    t = TServer(str(tmp_path / "torch"), device="cpu", polling_interval=3600)
    j.open()
    t.open()
    try:
        for s in (j, t):
            s.holder.create_index_if_not_exists("i")
            s.holder.index("i").create_frame_if_not_exists("f")
        yield j, t
    finally:
        t.close()
        j.close()


def import_body(index="i", frame="f", slice_i=0, rows=(1, 2), columns=(5, 7), ts=()):
    return pb.ImportRequest(
        Index=index, Frame=frame, Slice=slice_i, RowIDs=list(rows),
        ColumnIDs=list(columns), Timestamps=list(ts),
    ).SerializeToString()


@pytest.mark.parametrize(
    "body",
    [
        import_body(),
        import_body(frame="nope"),
        import_body(index="nope"),
        import_body(rows=(1,), columns=(5, 7)),  # fewer rows than columns
        import_body(rows=(1, 2, 3), columns=(5, 7)),  # more rows than columns
        import_body(ts=(1_500_000_000_000_000_000, 0)),  # no time quantum on f
        import_body(slice_i=1, columns=(SW + 5, SW + 9)),
        import_body(columns=(5, SW + 7)),  # a column outside the slice
    ],
    ids=["ok", "unknown-frame", "unknown-index", "rows-short", "rows-long",
         "timestamps-no-quantum", "slice-1", "column-outside-slice"],
)
def test_import_answers_as_jax(import_servers, body):
    j, t = import_servers
    assert post_import(t.host, body) == post_import(j.host, body)
    q = b"Count(Bitmap(frame=f, rowID=1)) Count(Bitmap(frame=f, rowID=2))"
    for s in (j, t):
        req = urllib.request.Request(f"http://{s.host}/index/i/query", data=q, method="POST")
        with urllib.request.urlopen(req, timeout=5) as resp:
            s.answer = json.loads(resp.read())
    assert t.answer == j.answer


def test_import_malformed_body_is_400(import_servers):
    j, t = import_servers
    assert post_import(t.host, b"\x0a\x05ab")[0] == post_import(j.host, b"\x0a\x05ab")[0] == 400


def post_raw(host: str, body: bytes) -> tuple:
    proto = "application/x-protobuf"
    req = urllib.request.Request(f"http://{host}/import", data=body, method="POST",
                                 headers={"Content-Type": proto, "Accept": proto})
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


@pytest.mark.parametrize(
    "body",
    [b"\x08", b"\x0a\x05ab", import_body(rows=(2**63,), columns=(5,)),
     import_body(rows=(1,), columns=(2**63,))],
    ids=["varint-for-a-string", "truncated", "row-id-2^63", "column-id-2^63"],
)
def test_import_errors_are_byte_equal_to_jax(import_servers, body):
    """ROADMAP faults 4 and 5: a body that does not parse answers 400
    with the generated parser's text; an id past int64 answers 500 with
    an ImportResponse carrying the conversion's error."""
    j, t = import_servers
    assert post_raw(t.host, body) == post_raw(j.host, body)


def test_import_to_a_node_that_does_not_own_the_slice_is_412(import_servers):
    j, t = import_servers
    other = "127.0.0.1:1"  # a peer that owns half the slices
    j.cluster.add_node(other)
    t.add_peer(other)
    for s in (j, t):
        host = s.host
        slice_i = next(
            i for i in range(64) if s.cluster.fragment_nodes("i", i)[0].host == other
        )
        status, body = post_import(host, import_body(slice_i=slice_i, columns=(slice_i * SW,) * 2))
        assert status == 412
        assert body == {"error": f"host does not own slice {host} slice={slice_i}"}


def test_cli_import_matches_jax(import_servers, tmp_path):
    """``pilosa_tpu_torch.cli import`` loads a CSV as the JAX CLI does,
    and fails where it fails."""
    from pilosa_tpu.cli.main import main as jax_main
    from pilosa_tpu_torch.cli.main import main as port_main

    j, t = import_servers
    rng = np.random.default_rng(5)
    rows, columns = rng.integers(0, 8, 2000), rng.integers(0, 3 * SW, 2000)
    good = tmp_path / "bits.csv"
    good.write_text("\n".join(f"{r},{c}" for r, c in zip(rows, columns)) + "\n\n")
    for main, host in ((jax_main, j.host), (port_main, t.host)):
        assert main(["import", "--host", host, "-i", "i", "-f", "f", "-s", "700", str(good)]) == 0
    q = " ".join(f"Count(Bitmap(frame=f, rowID={r}))" for r in range(8)) + " TopN(frame=f, n=3)"
    answers = []
    for s in (j, t):
        url = f"http://{s.host}/index/i/query"
        req = urllib.request.Request(url, data=q.encode(), method="POST")
        with urllib.request.urlopen(req, timeout=5) as resp:
            answers.append(json.loads(resp.read()))
    assert answers[1] == answers[0]
    assert answers[0]["results"][0] == len(np.unique(columns[rows == 0]))
    bad = (("bad-row", "x,5\n"), ("short", "5\n"), ("timestamp", "1,5,2019-06-01T00:00\n"))
    for name, text in bad:
        path = tmp_path / f"{name}.csv"
        path.write_text(text)
        for main, host in ((jax_main, j.host), (port_main, t.host)):
            assert main(["import", "--host", host, "-i", "i", "-f", "f", str(path)]) == 1, name


def test_cli_import_field_matches_jax(import_servers, tmp_path):
    """``import --field`` loads ``column,value`` records into a BSI field
    as the JAX CLI's ``--value`` does, and fails where it fails."""
    from pilosa_tpu.cli.main import main as jax_main
    from pilosa_tpu_torch.cli.main import main as port_main

    j, t = import_servers
    for s in (j, t):
        f = s.holder.frame("i", "f")
        f.set_options(range_enabled=True)
        f.create_field("v", -500, 500)
    rng = np.random.default_rng(6)
    cols = rng.choice(3 * SW, size=1500, replace=False)
    vals = rng.integers(-500, 501, size=1500)
    good = tmp_path / "values.csv"
    good.write_text("\n".join(f"{c},{v}" for c, v in zip(cols, vals)) + "\n\n")
    assert jax_main(["import", "--host", j.host, "-i", "i", "-f", "f", "--value", "v",
                     "-s", "400", str(good)]) == 0
    assert port_main(["import", "--host", t.host, "-i", "i", "-f", "f", "--field", "v",
                      "-s", "400", str(good)]) == 0
    q = (b"Sum(frame=f, field=v) Min(frame=f, field=v) Max(frame=f, field=v) "
         b"Count(Range(frame=f, v > 7))")
    answers = []
    for s in (j, t):
        req = urllib.request.Request(f"http://{s.host}/index/i/query", data=q, method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:  # JAX compiles
            answers.append(json.loads(resp.read()))
    assert answers[1] == answers[0]
    assert answers[0]["results"][0] == {"value": int(vals.sum()), "count": 1500}
    bad = (("bad-col", "x,5\n"), ("short", "5\n"), ("bad-value", "1,y\n"),
           ("out-of-range", "1,501\n"))
    for name, text in bad:
        path = tmp_path / f"{name}.csv"
        path.write_text(text)
        args = ["import", "-i", "i", "-f", "f", str(path)]
        assert jax_main(args[:1] + ["--host", j.host, "--value", "v"] + args[1:]) == 1
        assert port_main(args[:1] + ["--host", t.host, "--field", "v"] + args[1:]) == 1
