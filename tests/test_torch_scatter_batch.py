"""The batched delta-scatter K7 and the write path that feeds it, in the
port against the JAX package.

* ``scatter.apply_many``'s plain version over many mirrors equals the
  JAX package's per-fragment fold (``pilosa_tpu.ingest.scatter.fold``)
  and scatter rule applied mirror by mirror: mixed sets and clears of
  one bit within and across queues, mirrors of 8, 16 and 65,536 rows
  (the tall one allocated lazily, so only its touched pages are real),
  empty queues in a batch, one mirror twice (merged in order), and the
  batches the kernel wrapper refuses;
* served answers after interleaved imports, point writes and reads
  equal a JAX node's, each read applying the queues with one batched
  flush per read site;
* a threaded writer and readers hold read-your-writes;
* an ``/import`` or ``/import-value`` makes no K7 launch, no row
  popcount, no mirror upload and no device read."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.ingest import scatter as jscatter  # noqa: E402
from pilosa_tpu.net import wire_pb2 as pb  # noqa: E402
from pilosa_tpu.net.server import Server as JServer  # noqa: E402
from pilosa_tpu_torch.core import fragment as tfragment  # noqa: E402
from pilosa_tpu_torch.ingest import scatter  # noqa: E402
from pilosa_tpu_torch.net.server import Server as TServer  # noqa: E402
from pilosa_tpu_torch.ops import bitplane as tbp  # noqa: E402
from pilosa_tpu_torch.ops import delta_scatter as ds  # noqa: E402
from pilosa_tpu_torch.ops import fused_popcount  # noqa: E402
from pilosa_tpu_torch.pql import parse_string  # noqa: E402

SW = tbp.SLICE_WIDTH
W = tbp.WORDS_PER_SLICE


def random_codes(rng, rows: int, n: int) -> np.ndarray:
    """n codes over few words of ``rows`` rows (bits set and cleared in
    turn), with the first and last bit of the plane among them."""
    pos = rng.choice(np.arange(64), size=n) * 997 % SW
    slots = rng.integers(0, rows, n)
    k = min(n, 2)
    slots[:k], pos[:k] = (0, rows - 1)[:k], (0, SW - 1)[:k]
    return scatter.codes(slots, pos, 0) | rng.integers(0, 2, n)


def jax_apply(plane: np.ndarray, codes: np.ndarray) -> None:
    """One mirror's queue through the JAX package's fold and its
    scatter's rule ``w = (w & ~andnot) | or``, in place on the uint32
    host plane."""
    if not len(codes):
        return
    pos = (codes >> 1) & (SW - 1)
    q = np.stack([codes >> 21, pos >> 5, np.left_shift(1, pos & 31), codes & 1], axis=1)
    slots, words, or_m, andnot_m = jscatter.fold(q)
    plane[slots, words] = (plane[slots, words] & ~andnot_m) | or_m


@pytest.mark.parametrize("seed", range(4))
def test_apply_many_matches_jax_fragment_by_fragment(seed):
    rng = np.random.default_rng(seed)
    shapes = [8, 16, 8, 16, 8][: 2 + seed]
    planes = [rng.integers(0, 2**32, size=(r, W), dtype=np.uint32) for r in shapes]
    queues = [random_codes(rng, r, int(rng.integers(1, 3000))) for r in shapes]
    queues[-1] = np.empty(0, np.int64)  # an empty queue in the batch
    # One bit set in one queue and cleared in the next, both orders.
    both = scatter.codes([3], [12345], 0)
    queues[0] = np.concatenate([queues[0], both | 1, both])
    queues[1] = np.concatenate([queues[1], both, both | 1])
    mirrors = [tbp.to_device(p, "cpu") for p in planes]
    before = scatter.counters()["launches"]
    assert scatter.apply_many(list(zip(mirrors, queues))) == 1
    assert scatter.counters()["launches"] == before + 1
    for p, q, m in zip(planes, queues, mirrors):
        jax_apply(p, q)
        np.testing.assert_array_equal(tbp.to_host(m), p)


def test_apply_many_with_a_tall_mirror():
    """A 65,536-row mirror (8 GiB, allocated lazily: only the touched
    pages become real) beside an 8-row one: the last word of the last
    row is reached through the kernel's 32-bit word index."""
    rng = np.random.default_rng(11)
    tall = np.zeros((1 << 16, W), dtype=np.uint32)
    small = rng.integers(0, 2**32, size=(8, W), dtype=np.uint32)
    q_tall = random_codes(rng, 1 << 16, 4000)
    q_small = random_codes(rng, 8, 500)
    m_tall = torch.from_numpy(tall.view(np.int32))  # shares the lazy pages
    m_small = tbp.to_device(small, "cpu")
    scatter.apply_many([(m_tall, q_tall), (m_small, q_small)])
    touched = np.unique(q_tall >> 21)
    want = np.zeros((len(touched), W), dtype=np.uint32)
    slot_in = {int(s): k for k, s in enumerate(touched)}
    remap = q_tall.copy()
    for k, s in enumerate(touched):
        sel = (q_tall >> 21) == s
        remap[sel] = (q_tall[sel] & ((1 << 21) - 1)) | (k << 21)
    jax_apply(want, remap)
    got = tall[touched]
    np.testing.assert_array_equal(got, want)
    assert tall[(1 << 16) - 1, W - 1] >> 31 == want[slot_in[(1 << 16) - 1], W - 1] >> 31
    jax_apply(small, q_small)
    np.testing.assert_array_equal(tbp.to_host(m_small), small)


def test_one_mirror_twice_merges_in_order():
    rng = np.random.default_rng(5)
    base = rng.integers(0, 2**32, size=(8, W), dtype=np.uint32)
    q1, q2 = random_codes(rng, 8, 900), random_codes(rng, 8, 900)
    m = tbp.to_device(base, "cpu")
    scatter.apply_many([(m, q1), (m, [q2])])
    jax_apply(base, np.concatenate([q1, q2]))
    np.testing.assert_array_equal(tbp.to_host(m), base)


def test_batch_wrapper_refuses_bad_batches():
    planes = [torch.zeros(8, W, dtype=torch.int32) for _ in range(2)]
    i32, u32 = np.int32, np.uint32
    ok = (np.array([0, 1], i32), np.array([5, 5], u32), np.array([1, 2], u32),
          np.array([0, 0], u32))
    ds.delta_scatter_many(planes, *ok)
    shared = torch.zeros(16, W, dtype=torch.int32)
    for bad_planes, entries in (
        ([shared[:8], shared[4:12]], ok),  # two planes share memory
        ([shared, shared], ok),  # one plane twice
        (planes, (np.array([1, 0], i32),) + ok[1:]),  # not sorted by job
        (planes, (np.array([0, 0], i32),) + ok[1:]),  # (job, word) twice
        (planes, (np.array([0, 2], i32),) + ok[1:]),  # no such job
        (planes, (ok[0], np.array([5, 8 * W], u32)) + ok[2:]),  # word past the plane
        (planes, (ok[0].astype(np.int64),) + ok[1:]),  # dtype
        ([], ok),  # no plane
    ):
        with pytest.raises(ValueError):
            ds.delta_scatter_many(bad_planes, *entries)


def test_fold_many_matches_the_jax_fold_of_each_queue():
    rng = np.random.default_rng(9)
    queues = [random_codes(rng, 8, n) for n in (1, 0, 700, 3000)]
    job, word, or_m, andnot_m = scatter.fold_many(queues)
    assert (np.diff((job.astype(np.int64) << 32) | word) > 0).all()  # sorted, unique
    for k, q in enumerate(queues):
        pos = (q >> 1) & (SW - 1)
        jq = np.stack([q >> 21, pos >> 5, np.left_shift(1, pos & 31), q & 1], axis=1)
        js, jw, jo, ja = jscatter.fold(jq) if len(q) else [np.empty(0)] * 4
        order = np.argsort(np.asarray(js, np.int64) * W + jw)
        sel = job == k
        np.testing.assert_array_equal(word[sel], (np.asarray(js, np.int64) * W + jw)[order])
        np.testing.assert_array_equal(or_m[sel], np.asarray(jo)[order])
        np.testing.assert_array_equal(andnot_m[sel], np.asarray(ja)[order])


# --- served: interleaved imports and reads ----------------------------------


def http(host: str, method: str, path: str, body: bytes = b"", headers=None):
    req = urllib.request.Request(f"http://{host}{path}", data=body if method != "GET" else None,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def post_import(host: str, slice_i: int, rows, cols) -> tuple:
    body = pb.ImportRequest(Index="i", Frame="f", Slice=slice_i, RowIDs=[int(r) for r in rows],
                            ColumnIDs=[int(c) for c in cols]).SerializeToString()
    proto = "application/x-protobuf"
    return http(host, "POST", "/import", body, {"Content-Type": proto, "Accept": proto})


READS = [
    b"Count(Bitmap(frame=f, rowID=1))",
    b"Count(Intersect(Bitmap(frame=f, rowID=1), Bitmap(frame=f, rowID=2)))",
    b"Count(Union(Bitmap(frame=f, rowID=0), Bitmap(frame=f, rowID=9)))",
    b"TopN(frame=f, n=4)",
    b"TopN(Bitmap(frame=f, rowID=1), frame=f, n=4)",
    b"Bitmap(frame=f, rowID=9)",
]


@pytest.fixture
def pair(tmp_path):
    j = JServer(data_dir=str(tmp_path / "jax"), host="127.0.0.1:0", anti_entropy_interval=3600,
                polling_interval=3600, cache_flush_interval=3600)
    t = TServer(str(tmp_path / "torch"), device="cpu")
    j.open()
    t.open()
    try:
        for s in (j, t):
            for path in ("/index/i", "/index/i/frame/f"):
                assert http(s.host, "POST", path)[0] == 200
        yield j, t
    finally:
        t.close()
        j.close()


def test_interleaved_imports_and_reads_match_jax(pair, monkeypatch):
    j, t = pair
    rng = np.random.default_rng(21)
    flushes = []
    real = scatter.apply_many
    monkeypatch.setattr(scatter, "apply_many", lambda jobs: flushes.append(len(jobs)) or real(jobs))

    def both(kind, *args):
        if kind == "import":
            got = post_import(j.host, *args), post_import(t.host, *args)
        else:
            got = tuple(http(s.host, "POST", "/index/i/query", args[0]) for s in (j, t))
        assert got[1] == got[0], (kind, args[0] if kind != "import" else args[:1])

    for rnd in range(4):
        for s in range(3):
            n = int(rng.integers(50, 400))
            rows = rng.integers(0, 8 if rnd < 3 else 10, n)  # rows 8-9: a grown plane
            both("import", s, rows, s * SW + rng.integers(0, SW, n))
        for c in rng.integers(0, 3 * SW, 5):
            both("query", f"SetBit(frame=f, rowID=2, columnID={c})".encode())
            both("query", f"ClearBit(frame=f, rowID=1, columnID={c})".encode())
        flushes.clear()
        for q in READS:
            both("query", q)
        # Rounds after the first find the mirrors resident: the first read
        # applies every slice's queue in ONE batch (one launch).
        if 0 < rnd < 3:
            assert flushes[0] == 3 and len(flushes) == 1


def test_threaded_writes_are_read_after_their_ack(tmp_path):
    """Writers set bits across slices; every Count that starts after a
    write's acknowledgement sees it, and none sees more than was written."""
    t = TServer(str(tmp_path / "torch"), device="cpu")
    t.open()
    try:
        ex = t.executor
        for path in ("/index/i", "/index/i/frame/f"):
            assert http(t.host, "POST", path)[0] == 200
        for s in range(4):
            ex.execute("i", parse_string(f"SetBit(frame=f, rowID=1, columnID={s * SW})"))
        count = parse_string("Count(Bitmap(frame=f, rowID=1))")
        assert ex.execute("i", count) == [4]  # mirrors resident from here on
        acked = [4]
        mu = threading.Lock()
        errors = []
        stop = threading.Event()

        def writer(w):
            for k in range(60):
                c = (k % 4) * SW + 1 + w * 1000 + k
                assert ex.execute("i", parse_string(f"SetBit(frame=f, rowID=1, columnID={c})"))
                with mu:
                    acked[0] += 1

        def reader():
            while not stop.is_set():
                with mu:
                    lo = acked[0]
                (n,) = ex.execute("i", count)
                with mu:
                    hi = acked[0] + 2  # writes in flight may already be applied
                if not lo <= n <= hi:
                    errors.append((lo, n, hi))

        readers = [threading.Thread(target=reader) for _ in range(3)]
        writers = [threading.Thread(target=writer, args=(w,)) for w in range(2)]
        for th in readers + writers:
            th.start()
        for th in writers:
            th.join()
        stop.set()
        for th in readers:
            th.join()
        assert not errors, errors[:5]
        assert ex.execute("i", count) == [acked[0]] == [124]
    finally:
        t.close()


def test_imports_never_touch_the_device(tmp_path, monkeypatch):
    t = TServer(str(tmp_path / "torch"), device="cpu")
    t.open()
    try:
        for path, body in (("/index/i", b""), ("/index/i/frame/f", b""),
                           ("/index/i/frame/n", b'{"options": {"rangeEnabled": true}}'),
                           ("/index/i/frame/n/field/v", b'{"min": -100, "max": 100}')):
            assert http(t.host, "POST", path, body)[0] == 200
        rng = np.random.default_rng(3)

        def value_import(s):
            body = json.dumps({"index": "i", "frame": "n", "field": "v", "slice": s,
                               "columnIDs": [int(s * SW + c) for c in rng.integers(0, SW, 50)],
                               "values": [int(v) for v in rng.integers(-100, 101, 50)]})
            assert http(t.host, "POST", "/import-value", body.encode())[0] == 200

        for s in range(3):
            assert post_import(t.host, s, rng.integers(0, 4, 300),
                               s * SW + rng.integers(0, SW, 300))[0] == 200
            value_import(s)
        # Reads upload every mirror; from here on imports queue for them.
        assert http(t.host, "POST", "/index/i/query", b"Count(Bitmap(frame=f, rowID=1))")[0] == 200
        assert http(t.host, "POST", "/index/i/query", b"Sum(frame=n, field=v)")[0] == 200
        calls = []
        for mod, name in ((tbp, "row_counts"), (tbp, "to_device"), (tbp, "to_host"),
                          (fused_popcount, "row_popcounts"), (scatter, "apply_many"),
                          (tfragment.Fragment, "device_plane")):
            real = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real, **k: (
                calls.append(_n), _r(*a, **k))[1])
        launches = ds.launches
        for s in range(3):
            assert post_import(t.host, s, rng.integers(0, 4, 300),
                               s * SW + rng.integers(0, SW, 300))[0] == 200
            value_import(s)
        assert calls == [] and ds.launches == launches
        frags = [t.holder.fragment("i", "f", "standard", s) for s in range(3)]
        assert all(f._pending_n for f in frags)
        # The first read brings all three up to date in one batch.
        assert http(t.host, "POST", "/index/i/query", b"Count(Bitmap(frame=f, rowID=1))")[0] == 200
        assert calls.count("apply_many") == 1 and not any(f._pending_n for f in frags)
    finally:
        t.close()
