"""Device residency in the port against the JAX package: a JAX ``Server``
and a port ``Server(device="cpu")`` under the same small
``hbm_budget_bytes`` answer a seeded query storm (dense rows, sparse
rows, inverse views, BSI, TopN) byte for byte while both evict; queued
writes are dropped coherently with an evicted mirror; a
``.residency.json`` written by either package stages the same fragments
in the same order in the other; ``/debug/hbm`` and ``/debug/ingest``
carry the JAX package's keys."""

import json
import os
import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pilosa_tpu.core.fragment as jfr  # noqa: E402
from pilosa_tpu import device as jdevice  # noqa: E402
from pilosa_tpu.core.holder import Holder as JHolder  # noqa: E402
from pilosa_tpu.device.pool import PlanePool as JPool  # noqa: E402
from pilosa_tpu.net import wire_pb2 as pb  # noqa: E402
from pilosa_tpu.net.server import Server as JServer  # noqa: E402
from pilosa_tpu.ops import bitplane as jbp  # noqa: E402
from pilosa_tpu_torch import device as tdevice  # noqa: E402
from pilosa_tpu_torch.core import fragment as tfr  # noqa: E402
from pilosa_tpu_torch.core.holder import Holder as THolder  # noqa: E402
from pilosa_tpu_torch.device.pool import PlanePool as TPool  # noqa: E402
from pilosa_tpu_torch.ingest import scatter  # noqa: E402
from pilosa_tpu_torch.net.server import Server as TServer  # noqa: E402
from pilosa_tpu_torch.ops import bitplane as tbp  # noqa: E402

SW = tbp.SLICE_WIDTH
SLICES = 10
PROTOBUF = "application/x-protobuf"
MiB = 1 << 20


@pytest.fixture(autouse=True)
def fresh_pools():
    """Both packages' process-wide pools, fresh for the test."""
    jp, tp = JPool(), TPool()
    jprev, tprev = jdevice._set_pool(jp), tdevice._set_pool(tp)
    for bp in (jbp, tbp):
        bp.configure_plane_format(mode="auto", sparse_max_bytes=65536, rle_max_bytes=65536)
    yield jp, tp
    jdevice._set_pool(jprev)
    tdevice._set_pool(tprev)


def set_budget(monkeypatch, budget):
    """Both packages' fragments get ``budget`` dense rows."""
    orig = jfr.Fragment.__init__

    def small(self, *a, **kw):
        kw.setdefault("dense_row_budget", budget)
        orig(self, *a, **kw)

    monkeypatch.setattr(jfr.Fragment, "__init__", small)
    monkeypatch.setattr(tfr, "DENSE_ROW_BUDGET", budget)


def http(host, method, path, body=b"", headers=None):
    req = urllib.request.Request(f"http://{host}{path}", data=body if method != "GET" else None,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def ask(host, pql):
    """(JSON status and body bytes, protobuf status and bytes)."""
    body = pb.QueryRequest(Query=pql).SerializeToString()
    return (http(host, "POST", "/index/i/query", pql.encode()),
            http(host, "POST", "/index/i/query", body,
                 {"Content-Type": PROTOBUF, "Accept": PROTOBUF}))


def jax_server(path, **kw):
    return JServer(data_dir=path, host="127.0.0.1:0", anti_entropy_interval=3600,
                   polling_interval=3600, cache_flush_interval=3600, **kw)


def corpus(seed=5):
    """Frame f: rows 0-5 over SLICES slices, scattered and clustered,
    row 5 dense; frame h (inverse storage): rows 0-3; the BSI field v
    of f over row 0's first columns."""
    rng = np.random.default_rng(seed)
    f, h = {}, {}
    for row in range(6):
        cols = set()
        for s in range(SLICES):
            n = 9000 if row == 5 else 400
            if row % 2:
                part = rng.choice(SW, size=n, replace=False)
            else:
                st = int(rng.integers(0, SW - n))
                part = range(st, st + n)
            cols.update(int(p) + s * SW for p in part)
        f[row] = cols
    for row in range(4):
        h[row] = {int(c) for c in rng.choice(SLICES * SW, size=300, replace=False)}
    return f, h


def load(holder, f_bits, h_bits):
    idx = holder.create_index_if_not_exists("i")
    f = idx.create_frame_if_not_exists("f")
    f.set_options(range_enabled=True)
    if f.bsi_field("v") is None:
        f.create_field("v", 0, 500)
    h = idx.create_frame_if_not_exists("h", inverse_enabled=True)
    for frame, bits in ((f, f_bits), (h, h_bits)):
        rows = np.concatenate([np.full(len(c), r, np.int64) for r, c in bits.items()])
        cols = np.concatenate([np.array(sorted(c), np.int64) for c in bits.values()])
        frame.import_bulk(rows, cols)
    vcols = sorted(f_bits[0])[:300]
    f.import_value("v", vcols, [c % 500 for c in vcols])


def bm(r, frame="f"):
    return f"Bitmap(rowID={r}, frame={frame})"


def storm(host, f_bits, h_bits, rng):
    out = []
    for _ in range(2):  # twice: the second pass re-uploads what the first evicted
        for a in rng.permutation(6)[:4]:
            b = (int(a) + 1) % 6
            for q in (f"Count(Intersect({bm(a)}, {bm(b)}))", f"Count(Union({bm(a)}, {bm(b)}))",
                      f"Difference({bm(a)}, {bm(b)})"):
                out.append(ask(host, q))
        col = sorted(h_bits[1])[7]
        for q in (bm(0), bm(5), "TopN(frame=f, n=4)", f"TopN({bm(1)}, frame=f, n=4)",
                  f"Bitmap(frame=h, columnID={col})", f"Count({bm(2, 'h')})",
                  f"TopN({bm(0, 'h')}, frame=h, n=3)",
                  f"TopN(Bitmap(frame=h, columnID={col}), frame=h, inverse=true, n=3)",
                  "Range(frame=f, v > 250)", f"Count(Intersect({bm(0)}, Range(frame=f, v > 250)))",
                  "Sum(frame=f, field=v)", f"Max({bm(3)}, frame=f, field=v)"):
            out.append(ask(host, q))
    return out


def test_answers_match_jax_under_a_small_budget(tmp_path, monkeypatch, fresh_pools):
    """A budget of about two plane tiers of frame f on every device: both
    packages evict (the JAX package per each of its 8 virtual devices,
    the port on its one), and every answer is byte-equal."""
    set_budget(monkeypatch, 2)
    f_bits, h_bits = corpus()
    budget = 3 * tbp.pad_rows(2) * tbp.WORDS_PER_SLICE * 4
    j = jax_server(str(tmp_path / "jax"), hbm_budget_bytes=budget)
    t = TServer(str(tmp_path / "torch"), device="cpu", polling_interval=3600,
                hbm_budget_bytes=budget)
    j.open()
    t.open()
    try:
        for s in (j, t):
            load(s.holder, f_bits, h_bits)
        want = storm(j.host, f_bits, h_bits, np.random.default_rng(1))
        got = storm(t.host, f_bits, h_bits, np.random.default_rng(1))
        assert all(w[0][0] == 200 for w in want)
        assert got == want
        jp, tp = fresh_pools
        assert jp.evictions > 0 and tp.evictions > 0
    finally:
        j.close()
        t.close()
    assert fresh_pools[1].resident_bytes() == 0  # closing released every entry


def test_write_evict_read_drops_the_queue(tmp_path, fresh_pools):
    """A write queues against a resident mirror; the pool evicts the
    mirror before the next read; the read uploads the host plane (which
    holds the write) and applies nothing: the queue went with the mirror.
    The JAX node answers the same."""
    _, tp = fresh_pools
    j = jax_server(str(tmp_path / "jax"))
    t = TServer(str(tmp_path / "torch"), device="cpu", polling_interval=3600)
    j.open()
    t.open()
    try:
        for s in (j, t):
            idx = s.holder.create_index_if_not_exists("i")
            idx.create_frame_if_not_exists("f").import_bulk([1, 1, 2], [3, SW + 4, 5])
        q = b"Count(Union(Bitmap(frame=f, rowID=1), Bitmap(frame=f, rowID=2)))"
        assert http(t.host, "POST", "/index/i/query", q) == http(j.host, "POST", "/index/i/query", q)
        frag = t.holder.fragment("i", "f", "standard", 0)
        assert frag._mirror is not None
        for s in (j, t):
            assert http(s.host, "POST", "/index/i/query",
                        b"SetBit(frame=f, rowID=2, columnID=9)")[0] == 200
        assert frag._pending_n == 1
        launches = scatter.counters()["launches"]
        tp.configure(budget_bytes=frag.plane_nbytes)
        tp.admit(("hog",), {torch.device("cpu"): frag.plane_nbytes}, lambda: True)
        assert frag._mirror is None and frag._pending_n == 0 and not frag._pending
        tp.remove(("hog",))
        tp.configure(budget_bytes=0)
        for q in (q, b"Bitmap(frame=f, rowID=2)"):
            assert http(t.host, "POST", "/index/i/query", q) == http(j.host, "POST",
                                                                    "/index/i/query", q)
        assert scatter.counters()["launches"] == launches
        assert frag._mirror is not None  # uploaded again, with the write
    finally:
        j.close()
        t.close()


class _Recorder:
    """A prefetcher stand-in that records the staging order."""

    def __init__(self):
        self.keys = []

    def stage(self, frags, throttle_s=0.0):
        self.keys = [f"{f.index}/{f.frame}/{f.view}/{f.slice}" for f in frags]
        return None


def _stage_order(holder_cls, path, **kw) -> list:
    h = holder_cls(path, **kw)
    h.open()
    try:
        rec = _Recorder()
        h.stage_device_mirrors(rec)
        return rec.keys
    finally:
        h.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_residency_table_stages_alike_in_both(tmp_path, monkeypatch, writer):
    """One package's node reads fragments in a seeded order and closes,
    leaving ``.residency.json``; both packages' holders open copies and
    stage the same fragments in the same order: the table's MRU first,
    then the rest, largest planes first."""
    set_budget(monkeypatch, 2)
    f_bits, h_bits = corpus()
    live = str(tmp_path / "live")
    srv = (jax_server(live) if writer == "jax" else
           TServer(live, device="cpu", polling_interval=3600))
    srv.open()
    try:
        load(srv.holder, f_bits, h_bits)
        for q in (bm(3), bm(0, "h"), f"Count({bm(1)})", "Sum(frame=f, field=v)", bm(5)):
            assert http(srv.host, "POST", "/index/i/query", q.encode())[0] == 200
    finally:
        srv.close()
    with open(os.path.join(live, ".residency.json")) as fh:
        table = json.load(fh)["fragments"]
    assert table, "the closing node recorded its resident mirrors"
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(live, jdir)
    shutil.copytree(live, tdir)
    want = _stage_order(JHolder, jdir)
    got = _stage_order(THolder, tdir, device="cpu")
    assert got == want
    assert got[: len(table)] == list(reversed(table))


def _keys(doc):
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in doc.items()}
    if isinstance(doc, list) and doc and isinstance(doc[0], dict):
        return [_keys(doc[0])]
    return None


def test_debug_routes_carry_the_jax_keys(tmp_path):
    j = jax_server(str(tmp_path / "jax"))
    t = TServer(str(tmp_path / "torch"), device="cpu", polling_interval=3600)
    j.open()
    t.open()
    try:
        docs = []
        for s, dev in ((j, jdevice), (t, tdevice)):
            for path in ("/index/i", "/index/i/frame/f"):
                assert http(s.host, "POST", path)[0] == 200
            q = b"SetBit(frame=f, rowID=1, columnID=3)"
            assert http(s.host, "POST", "/index/i/query", q)[0] == 200
            # The Count's prefetch would upload the mirror on a worker
            # thread while the query admits its batch entry, so the pool's
            # LRU order (read by _keys through the first entry) would
            # depend on thread timing: the mirror is staged first.
            dev.prefetcher().prefetch([s.holder.fragment("i", "f", "standard", 0)], wait=True)
            q = b"Count(Bitmap(frame=f, rowID=1))"
            assert http(s.host, "POST", "/index/i/query", q)[0] == 200
            docs.append([json.loads(http(s.host, "GET", p)[1])
                         for p in ("/debug/hbm", "/debug/ingest")])
        (jh, ji), (th, ti) = docs
        assert _keys(th) == _keys(jh)
        assert _keys(ti) == _keys(ji)
        assert ti["wal"]["totalAppends"] == ji["wal"]["totalAppends"] == 1
        assert th["fragments"][0]["fragment"] == jh["fragments"][0]["fragment"] == "i/f/standard/0"
    finally:
        j.close()
        t.close()


def test_cli_flags_name_the_jax_keys(monkeypatch):
    """``server`` takes the [device]/[ingest] keys as flags, with the JAX
    package's defaults, and hands them to the Server."""
    import importlib

    from pilosa_tpu_torch.net import server as server_mod

    cli = importlib.import_module("pilosa_tpu_torch.cli.main")

    args = cli.build_parser().parse_args(["server"])
    assert (args.hbm_budget_bytes, args.prefetch, args.wal, args.group_commit_ms,
            args.group_commit_max, args.wal_segment_bytes, args.plane_format) == (
        0, True, True, 2.0, 128, 4 << 20, "auto")
    seen = {}

    class Stop(Exception):
        pass

    class FakeServer:
        def __init__(self, data_dir, **kw):
            seen.update(kw)

        def open(self):
            raise Stop

    monkeypatch.setattr(server_mod, "Server", FakeServer)
    with pytest.raises(Stop):
        cli.main(["server", "--device", "cpu", "--hbm-budget-bytes", "123", "--prefetch",
                  "false", "--wal", "off", "--group-commit-ms", "5", "--group-commit-max",
                  "7", "--wal-segment-bytes", "999", "--plane-format", "dense"])
    assert {k: seen[k] for k in ("hbm_budget_bytes", "device_prefetch", "ingest_wal",
                                 "ingest_group_commit_ms", "ingest_group_commit_max",
                                 "ingest_wal_segment_bytes", "plane_format")} == {
        "hbm_budget_bytes": 123, "device_prefetch": False, "ingest_wal": False,
        "ingest_group_commit_ms": 5.0, "ingest_group_commit_max": 7,
        "ingest_wal_segment_bytes": 999, "plane_format": "dense"}
