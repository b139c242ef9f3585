"""The port's multi-device data plane against the JAX package's.

Counterparts of ``tests/test_mesh.py``: the port runs on 8 CPU members
(``bitplane.set_local_members(["cpu"] * 8)``, the stand-in for the JAX
package's 8 forced CPU devices), inputs come from a numpy seed, and
answers are byte-identical.  Also the plain versions of the two kernels
this data plane adds — K9 (``ops/mesh_topn.py``) and ``top_k``
(``ops/top_k.py``) — against the JAX functions they replace.
"""

import os
import socket
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pilosa_tpu.exec import plan as jplan
from pilosa_tpu.ops import bitplane as jbp
from pilosa_tpu.parallel import mesh as jmesh
from pilosa_tpu.pql.parser import parse_string as jparse

from pilosa_tpu_torch.exec import plan as tplan
from pilosa_tpu_torch.ops import bitplane as tbp
from pilosa_tpu_torch.ops import mesh_topn, top_k
from pilosa_tpu_torch.parallel import mesh as tmesh
from pilosa_tpu_torch.parallel import multihost as tmh
from pilosa_tpu_torch.pql.parser import parse_string as tparse

W = 256  # tiny word axis: the reduces are shape-agnostic
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def rng():
    return np.random.default_rng(11)


@pytest.fixture(autouse=True)
def members():
    """8 CPU members for the port, the cap (and the JAX package's cached
    mesh) cleared before and after (placement is process-wide in both
    packages)."""
    tbp.set_local_members(["cpu"] * 8)
    tbp.configure_mesh_devices(0)
    jbp.configure_mesh_devices(0)
    jmesh._slices_mesh = None
    yield
    tbp.set_local_members(None)
    tbp.configure_mesh_devices(0)
    jbp.configure_mesh_devices(0)
    jmesh._slices_mesh = None


def _expr(pql: str):
    """The same decomposed tree in both packages."""
    je, _ = jplan.decompose(jparse(pql).calls[0])
    te, _ = tplan.decompose(tparse(pql).calls[0])
    assert je == te
    return je


# ---------------------------------------------------------------------------
# the mesh and its sharded arrays
# ---------------------------------------------------------------------------


def test_slice_mesh_shape():
    m = tmesh.slice_mesh(8)
    assert m.shape == {tmesh.AXIS_SLICES: 8, tmesh.AXIS_ROWS: 1}
    m = tmesh.slice_mesh(8, row_shards=2)
    assert m.shape == {tmesh.AXIS_SLICES: 4, tmesh.AXIS_ROWS: 2}
    jm = jmesh.slice_mesh(8, row_shards=2)
    assert m.shape == dict(jm.shape)
    with pytest.raises(ValueError):
        tmesh.slice_mesh(8, row_shards=3)


def test_shard_planes_pads(rng):
    planes = rng.integers(0, 2**32, size=(5, 4, W), dtype=np.uint32)
    arr = tmesh.shard_planes(planes, tmesh.slice_mesh(8))
    want = np.asarray(jmesh.shard_planes(planes, jmesh.slice_mesh(8)))
    assert arr.shape == want.shape == (8, 4, W)
    np.testing.assert_array_equal(arr.numpy(), want)
    assert not arr.numpy()[5:].any()
    # one block per member, slices in contiguous blocks as JAX's P(slices)
    assert [b.shape[0] for b in arr.blocks] == [1] * 8
    assert [off[0] for off in arr.offsets] == list(range(8))


def test_shard_is_the_jax_input(rng):
    """``shard`` takes the JAX ``device_put`` input (a numpy stack) and the
    spec, and rows split like JAX's P(slices, None, rows, None)."""
    planes = rng.integers(0, 2**32, size=(8, 3, 4, W), dtype=np.uint32)
    m = tmesh.slice_mesh(8, row_shards=2)
    sh = tmesh.shard(planes, m, (tmesh.AXIS_SLICES, None, tmesh.AXIS_ROWS, None))
    np.testing.assert_array_equal(sh.numpy(), planes)
    jm = jmesh.slice_mesh(8, row_shards=2)
    ja = jax.device_put(planes, NamedSharding(jm, P("slices", None, "rows", None)))
    for shard_, off in zip(sorted(ja.addressable_shards, key=lambda s: (s.index[0].start,
                                                                       s.index[2].start)),
                           sh.offsets):
        assert (shard_.index[0].start, shard_.index[2].start) == (off[0], off[2])


def test_distributed_count_matches_host(rng):
    expr = _expr("Union(Intersect(Bitmap(rowID=1), Bitmap(rowID=2)), Bitmap(rowID=3))")
    planes = rng.integers(0, 2**32, size=(8, 3, 4, W), dtype=np.uint32)
    spec = (tmesh.AXIS_SLICES, None, tmesh.AXIS_ROWS, None)
    got = tmesh.distributed_count(expr, tmesh.shard(planes, tmesh.slice_mesh(8, 2), spec))
    jm = jmesh.slice_mesh(8, row_shards=2)
    want = jmesh.distributed_count(
        expr, jax.device_put(planes, NamedSharding(jm, P("slices", None, "rows", None))))
    a, b, c = planes[:, 0], planes[:, 1], planes[:, 2]
    assert got == want == int(np.bitwise_count((a & b) | c).sum())


def test_distributed_count_partials_route(rng, monkeypatch):
    """Past the partial budget both packages take the per-partial host
    sum, and it equals the collective route."""
    expr = _expr("Intersect(Bitmap(rowID=1), Bitmap(rowID=2))")
    planes = rng.integers(0, 2**32, size=(8, 2, 2, W), dtype=np.uint32)
    sh = tmesh.shard(planes, tmesh.slice_mesh(8), (tmesh.AXIS_SLICES, None, None, None))
    collective = tmesh.distributed_count(expr, sh)
    monkeypatch.setattr(tplan, "MAX_ONDEVICE_COUNT_PARTIALS", 4)
    monkeypatch.setattr(jplan, "MAX_ONDEVICE_COUNT_PARTIALS", 4)
    jm = jmesh.slice_mesh(8)
    want = jmesh.distributed_count(
        expr, jax.device_put(planes, NamedSharding(jm, P("slices", None, None, None))))
    assert tmesh.distributed_count(expr, sh) == collective == want
    np.testing.assert_array_equal(
        tmesh.count_tree(expr, sh),
        np.asarray(jmesh._count_tree(expr, jnp.asarray(planes))))


def test_distributed_topn_matches_host(rng):
    planes = rng.integers(0, 2**32, size=(8, 16, W), dtype=np.uint32)
    src = rng.integers(0, 2**32, size=(8, W), dtype=np.uint32)
    m = tmesh.slice_mesh(8)
    counts, ids = tmesh.distributed_topn(
        tmesh.shard(planes, m, tmesh.plane_spec()),
        tmesh.shard(src, m, (tmesh.AXIS_SLICES, None)), 4)
    jm = jmesh.slice_mesh(8)
    jc, ji = jmesh.distributed_topn(
        jax.device_put(planes, NamedSharding(jm, P("slices", "rows", None))),
        jax.device_put(src, NamedSharding(jm, P("slices", None))), 4)
    want = np.bitwise_count(planes & src[:, None, :]).sum(axis=(0, 2))
    order = np.argsort(-want, kind="stable")[:4]
    np.testing.assert_array_equal(ids, order)
    np.testing.assert_array_equal(ids, ji)
    np.testing.assert_array_equal(counts, want[order])
    np.testing.assert_array_equal(counts, jc)


def test_distributed_topn_reduce_totals(rng):
    """The per-row totals of the collective route equal the JAX limb
    program's, row shards and all."""
    planes = rng.integers(0, 2**32, size=(8, 16, W), dtype=np.uint32)
    src = rng.integers(0, 2**32, size=(8, W), dtype=np.uint32)
    m = tmesh.slice_mesh(8, row_shards=2)
    per = tmesh.topn_totals(tmesh.shard(planes, m, tmesh.plane_spec()),
                            tmesh.shard(src, m, (tmesh.AXIS_SLICES, None)))
    jm = jmesh.slice_mesh(8)
    pl = jax.device_put(planes, NamedSharding(jm, P("slices", "rows", None)))
    sr = jax.device_put(src, NamedSharding(jm, P("slices", None)))
    want = jplan.recombine_count_limbs(jax.device_get(jmesh._topn_total_fn(jm)(pl, sr)))
    np.testing.assert_array_equal(per, want)
    np.testing.assert_array_equal(
        tmesh.topn_partials(tmesh.shard(planes, m, tmesh.plane_spec()),
                            tmesh.shard(src, m, (tmesh.AXIS_SLICES, None))),
        np.asarray(jmesh._topn_partials(jnp.asarray(planes), jnp.asarray(src))))


def test_query_step_end_to_end(rng):
    """The write+read step: scatter-OR writes (K7), Count(Intersect) (K2),
    TopN (K9 + top_k), against JAX's query_step and the numpy oracle."""
    n_slices, rows, n_upd = 8, 8, 16
    planes = rng.integers(0, 2**32, size=(n_slices, rows, W), dtype=np.uint32)
    flat = rng.choice(rows * W, size=n_upd, replace=False)
    rows_upd, words_upd = flat // W, flat % W
    masks = rng.integers(0, 2**32, size=(n_slices, n_upd), dtype=np.uint32)

    m = tmesh.slice_mesh(8, row_shards=2)
    planes2, count, top_counts, top_ids = tmesh.query_step(m)(
        tmesh.shard_planes(planes, m), rows_upd, words_upd, masks)

    jm = jmesh.slice_mesh(8, row_shards=2)
    jp, jc, jtc, jti = jmesh.query_step(jm)(
        jmesh.shard_planes(planes, jm), jnp.asarray(rows_upd), jnp.asarray(words_upd),
        jnp.asarray(masks))

    ref = planes.copy()
    for i in range(n_upd):
        ref[:, rows_upd[i], words_upd[i]] |= masks[:, i]
    np.testing.assert_array_equal(planes2.numpy(), ref)
    np.testing.assert_array_equal(planes2.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(count, np.asarray(jc))
    assert int(count.astype(np.int64).sum()) == int(
        np.bitwise_count(ref[:, 0, :] & ref[:, 1, :]).sum())
    per_row = np.bitwise_count(ref & ref[:, 0:1, :]).sum(axis=(0, 2))
    order = np.argsort(-per_row, kind="stable")[:4]
    np.testing.assert_array_equal(top_ids.numpy(), order)
    np.testing.assert_array_equal(top_ids.numpy(), np.asarray(jti))
    np.testing.assert_array_equal(top_counts.numpy(), per_row[order])
    np.testing.assert_array_equal(top_counts.numpy(), np.asarray(jtc))


def test_query_step_duplicate_targets_or_combine(rng):
    """Duplicate (row, word) targets OR-combine (the host write path's
    pre-combine), so every batch is one K7 launch a member."""
    planes = np.zeros((8, 4, W), dtype=np.uint32)
    rows_upd = np.asarray([1, 1, 2])
    words_upd = np.asarray([5, 5, 7])
    masks = rng.integers(0, 2**32, size=(8, 3), dtype=np.uint32)
    m = tmesh.slice_mesh(8)
    out, *_ = tmesh.query_step(m)(tmesh.shard_planes(planes, m), rows_upd, words_upd, masks)
    got = out.numpy()
    np.testing.assert_array_equal(got[:, 1, 5], masks[:, 0] | masks[:, 1])
    np.testing.assert_array_equal(got[:, 2, 7], masks[:, 2])


def test_count_reduce_at_4096_slices_past_int32():
    """4096 slices of all-ones rows: every partial is 2^16 and the total
    ~2^28, far past any single partial (JAX's limb-budget case)."""
    expr = _expr("Intersect(Bitmap(rowID=1), Bitmap(rowID=2))")
    n, w = 4096, 2048
    planes = np.full((n, 2, w), 0xFFFFFFFF, dtype=np.uint32)
    planes[:7, 0, 0] = 0x1
    m = tmesh.slice_mesh(8)
    sh = tmesh.shard(planes[:, :, None, :], m, (tmesh.AXIS_SLICES, None, None, None))
    got = tmesh.distributed_count(expr, sh)
    jm = jmesh.slice_mesh(8)
    batch = jax.device_put(planes, NamedSharding(jm, P("slices", None, None)))
    want = jplan.recombine_count_limbs(
        jax.device_get(jplan.compiled_total_count(expr, jm)(batch)))
    assert want > 2**27
    assert got == want == int(np.bitwise_count(planes[:, 0] & planes[:, 1]).sum())


def test_count_reduce_per_slice_total_past_int32():
    """2 slices x 2048 full-width rows of all ones: the per-slice total is
    exactly 2^31 and the count 2^32, exact in the port's int64 sums."""
    expr = _expr("Bitmap(rowID=1)")
    rows, w = 2048, 32768
    planes = np.full((2, 1, rows, w), 0xFFFFFFFF, dtype=np.uint32)
    m = tmesh.slice_mesh(2)
    sh = tmesh.shard(planes, m, (tmesh.AXIS_SLICES, None, tmesh.AXIS_ROWS, None))
    assert tmesh.distributed_count(expr, sh) == 1 << 32
    jm = jmesh.slice_mesh(2)
    assert jmesh.distributed_count(
        expr, jax.device_put(planes, NamedSharding(jm, P("slices", None, "rows", None)))
    ) == 1 << 32


# ---------------------------------------------------------------------------
# the collective route under the watchdog
# ---------------------------------------------------------------------------


def test_collective_hang_trips_and_answers_from_partials(rng):
    """A hung cross-member sum trips the watchdog, quarantines the
    collective path, and the answer comes from the per-member partials;
    the next call skips the quarantined path."""
    from pilosa_tpu_torch.device import health as health_mod

    expr = _expr("Intersect(Bitmap(rowID=1), Bitmap(rowID=2))")
    planes = rng.integers(0, 2**32, size=(8, 2, 1, W), dtype=np.uint32)
    sh = tmesh.shard(planes, tmesh.slice_mesh(8), (tmesh.AXIS_SLICES, None, None, None))
    want = int(np.bitwise_count(planes[:, 0] & planes[:, 1]).sum())
    h = health_mod.DeviceHealth(watchdog_ms=100, open_ms=60_000)
    release = threading.Event()
    real = tplan.total_count

    def hung(*a, **kw):
        release.wait(5)
        return real(*a, **kw)

    try:
        tplan.total_count = hung
        assert tmesh.distributed_count(expr, sh, health=h) == want
        assert h.watchdog_trips == 1
        assert not h.collective_allowed()
        assert tmesh.distributed_count(expr, sh, health=h) == want
        assert h.watchdog_trips == 1
        counts, ids = tmesh.distributed_topn(
            tmesh.shard(planes[:, :, 0], tmesh.slice_mesh(8), tmesh.plane_spec()),
            tmesh.shard(planes[:, 0, 0], tmesh.slice_mesh(8), (tmesh.AXIS_SLICES, None)),
            2, health=h)
        per = np.bitwise_count(planes[:, :, 0] & planes[:, 0:1, 0]).sum(axis=(0, 2))
        np.testing.assert_array_equal(counts, np.sort(per)[::-1][:2])
    finally:
        tplan.total_count = real
        release.set()
        h.close()


# ---------------------------------------------------------------------------
# K9 and top_k: the plain versions against the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1, 4), (3, 5, 64), (8, 16, W), (2, 70, 32)])
def test_k9_plain_matches_jax(rng, shape):
    s, r, w = shape
    plane = rng.integers(0, 2**32, size=(s, r, w), dtype=np.uint32)
    src = rng.integers(0, 2**32, size=(s, w), dtype=np.uint32)
    tp = torch.from_numpy(plane.view(np.int32))
    ts = torch.from_numpy(src.view(np.int32))
    part = mesh_topn.mesh_topn(tp, ts, "partials")
    assert part.dtype == torch.int32
    want = np.asarray(jmesh._topn_partials(jnp.asarray(plane), jnp.asarray(src)))
    np.testing.assert_array_equal(part.numpy(), want)
    tot = mesh_topn.mesh_topn(tp, ts, "total")
    assert tot.dtype == torch.int64
    np.testing.assert_array_equal(tot.numpy(), want.astype(np.int64).sum(axis=0))
    # src rows of the plane itself (strided), as query_step reads them
    np.testing.assert_array_equal(
        mesh_topn.mesh_topn(tp, tp[:, 0, :], "total").numpy(),
        np.bitwise_count(plane & plane[:, 0:1, :]).sum(axis=(0, 2)))


def test_k9_plain_rejects_bad_shapes():
    with pytest.raises(ValueError):
        mesh_topn.mesh_topn(torch.zeros(2, 3, 8, dtype=torch.int32),
                            torch.zeros(3, 8, dtype=torch.int32), "total")
    with pytest.raises(ValueError):
        mesh_topn.mesh_topn(torch.zeros(2, 3, 8, dtype=torch.int32),
                            torch.zeros(2, 8, dtype=torch.int32), "sum")


@pytest.mark.parametrize("counts,k", [
    ([3, 1, 3, 2, 3, 0], 3),           # ties toward the lower index
    ([0, 0, 0, 0], 2),                 # all zero
    ([5, 5, 5, 5, 5], 5),              # all equal
    ([4, 0, 0, 7], 4),                 # k past the non-zero counts
    ([2, 9, 1], 10),                   # k past n: clipped
    ([1], 1),
])
def test_top_k_plain_matches_jax(counts, k):
    c = np.asarray(counts, dtype=np.int32)
    tc, ti = top_k.top_k(torch.from_numpy(c), k)
    jc, ji = jbp.top_k(jnp.asarray(c), k)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tc.dtype == ti.dtype == torch.int64


@pytest.mark.parametrize("n,k", [(3000, 4), (5000, 100), (64, 64)])
def test_top_k_plain_many_ties(rng, n, k):
    c = rng.integers(0, 5, size=n).astype(np.int64)
    tc, ti = top_k.top_k(torch.from_numpy(c), k)
    jc, ji = jbp.top_k(jnp.asarray(c.astype(np.int32)), k)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ---------------------------------------------------------------------------
# placement and the caps
# ---------------------------------------------------------------------------


def test_mesh_devices_env_caps(monkeypatch):
    monkeypatch.setenv("PILOSA_DEVICE_MESH_DEVICES", "4")
    assert tbp.mesh_device_count() == jbp.mesh_device_count() == 4
    monkeypatch.setenv("PILOSA_DEVICE_MESH_DEVICES", "0")
    assert tbp.mesh_device_count() == jbp.mesh_device_count() == 8
    monkeypatch.setenv("PILOSA_DEVICE_MESH_DEVICES", "bogus")
    assert tbp.mesh_device_count() == jbp.mesh_device_count() == 8
    tbp.configure_mesh_devices(2)
    jbp.configure_mesh_devices(2)
    monkeypatch.setenv("PILOSA_DEVICE_MESH_DEVICES", "4")
    assert tbp.mesh_device_count() == jbp.mesh_device_count() == 2


def test_mesh_shape_config_caps_devices(monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_MESH_SHAPE", "2x2")
    assert tbp.mesh_device_count() == jbp.mesh_device_count() == 4
    for s in range(8):
        assert tbp.home_device(s, torch.device("cpu")) == torch.device("cpu")
        assert tbp.home_member(s, tbp.mesh_device_count()) == s % 4
    mesh = tmesh.default_slices_mesh()
    assert mesh is not None and mesh.size == 4
    monkeypatch.setenv("PILOSA_TPU_MESH_SHAPE", "1")
    assert tbp.mesh_device_count() == 1
    assert tmesh.default_slices_mesh() is None
    for bad in ("bogus", "x", "0", "0x4", "-2"):
        monkeypatch.setenv("PILOSA_TPU_MESH_SHAPE", bad)
        assert tbp.mesh_device_count() == jbp.mesh_device_count() == 8, bad


def test_placement_keys_on_member_not_device():
    """Repeated devices are distinct members; a holder whose device type
    differs from the members keeps every slice on its own device."""
    tbp.set_local_members(["cpu", "cpu", "meta"])
    assert tbp.placement(torch.device("cpu")) == (torch.device("cpu"),)
    tbp.set_local_members(["cpu"] * 3)
    assert len(tbp.placement(torch.device("cpu"))) == 3
    assert [tbp.home_member(s, 3) for s in range(6)] == [0, 1, 2, 0, 1, 2]
    tbp.set_local_members([])
    assert tbp.placement(torch.device("cpu")) == (torch.device("cpu"),)
    assert tbp.mesh_device_count() == 0


def test_explicit_card_pins_every_slice(tmp_path, monkeypatch):
    """On a host with two cards (faked), a bare ``cuda`` spreads the slices
    over both, while ``cuda:1`` keeps every slice on card 1 — through the
    holder's chain down to the view its fragments are made by — and asks
    for no mesh beside it."""
    from pilosa_tpu_torch import device as tdevice
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.net.server import Server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    tbp.set_local_members(["cuda:0", "cuda:1"])
    cuda1 = torch.device("cuda", 1)
    assert tdevice.placed(None) == tdevice.placed("cuda") == torch.device("cuda")
    assert tdevice.placed("cuda:1") == cuda1
    assert tdevice.placed("cpu") == torch.device("cpu")
    assert tbp.placement(cuda1) == (cuda1,)
    for s in range(6):
        assert tbp.home_device(s, cuda1) == cuda1
        assert tbp.home_device(s, torch.device("cuda")) == torch.device("cuda", s % 2)
    holder = Holder(str(tmp_path / "h"), device="cuda:1")
    assert holder.device == cuda1 and holder.placed == cuda1
    index = holder._new_index("i")
    frame = index._new_frame("f")
    view = frame._new_view("standard")
    assert view.placed == cuda1
    assert {tbp.home_device(s, view.placed) for s in range(6)} == {cuda1}
    bare = Holder(str(tmp_path / "b"))._new_index("i")._new_frame("f")._new_view("standard")
    assert [tbp.home_device(s, bare.placed).index for s in range(4)] == [0, 1, 0, 1]
    with pytest.raises(ValueError, match="pins the node"):
        Server(str(tmp_path / "s"), device="cuda:1", mesh_devices=2)


# ---------------------------------------------------------------------------
# multihost over torch.distributed
# ---------------------------------------------------------------------------


def test_multihost_initialize_unconfigured_noop(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    tmh.initialize()
    import torch.distributed as dist

    assert not dist.is_initialized()
    assert tmh.global_device_count() == 8
    assert not tmh.is_multihost()
    assert tmh.group() is None


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_pair(tmp_path, script_text: str, marker: str) -> list[str]:
    """Boot a real 2-process gloo group (4 CPU members each) running
    ``script_text``; both processes print ``marker <rank> <token>``."""
    port = _free_port()
    script = tmp_path / "mh_worker.py"
    script.write_text(script_text)

    def env_for(pid: int):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid))
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        return env

    procs = [subprocess.Popen([sys.executable, str(script)], env=env_for(pid), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in range(2)]
    tokens = []
    try:
        for pid, p in enumerate(procs):
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-1500:]
            assert f"{marker} {pid}" in out, out
            tokens.append(out.strip().split()[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return tokens


_WORKER_HEAD = """
import numpy as np
import torch.distributed as dist
from pilosa_tpu_torch.ops import bitplane as bp
from pilosa_tpu_torch.parallel import mesh as pmesh, multihost

bp.set_local_members(["cpu"] * 4)
multihost.initialize()
assert multihost.is_multihost() and dist.get_backend() == "gloo"
assert multihost.global_device_count() == 8
rank = dist.get_rank()
mesh = pmesh.slice_mesh()
assert mesh.group is not None and mesh.size == 4
"""

_COUNT_WORKER = _WORKER_HEAD + """
from pilosa_tpu_torch.exec import plan
from pilosa_tpu_torch.pql.parser import parse_string

rng = np.random.default_rng(5)
planes = rng.integers(0, 2**32, size=(8, 2, 1, 256), dtype=np.uint32)
mine = planes[rank * 4:(rank + 1) * 4]
batch = pmesh.shard(mine, mesh, ("slices", None, None, None))
expr, _ = plan.decompose(parse_string('Intersect(Bitmap(rowID=1), Bitmap(rowID=2))').calls[0])
total = pmesh.distributed_count(expr, batch)
want = int(np.bitwise_count(planes[:, 0] & planes[:, 1]).sum())
assert total == want, (total, want)
print('MH OK', rank, total, flush=True)
dist.destroy_process_group()
"""

_TOPN_WORKER = _WORKER_HEAD + """
rng = np.random.default_rng(9)
planes = rng.integers(0, 2**32, size=(8, 16, 256), dtype=np.uint32)
src = rng.integers(0, 2**32, size=(8, 256), dtype=np.uint32)
s = slice(rank * 4, (rank + 1) * 4)
plane = pmesh.shard(planes[s], mesh, ("slices", None, None))
srcb = pmesh.shard(src[s], mesh, ("slices", None))
counts, ids = pmesh.distributed_topn(plane, srcb, 5)
want_per = np.bitwise_count(planes & src[:, None, :]).sum(axis=(0, 2))
want_ids = np.argsort(-want_per, kind='stable')[:5]
assert list(ids) == list(want_ids), (ids, want_ids)
assert list(counts) == [int(want_per[i]) for i in want_ids], counts
print('MHT OK', rank, ','.join(f'{i}:{c}' for i, c in zip(ids, counts)), flush=True)
dist.destroy_process_group()
"""


def test_multihost_two_process_sharded_count(tmp_path):
    """A real 2-process gloo group: each process sums its 4 members'
    K2 totals and one all_reduce gives both the oracle total."""
    totals = _run_pair(tmp_path, _COUNT_WORKER, "MH OK")
    assert len(set(totals)) == 1


def test_multihost_two_process_sharded_topn(tmp_path):
    """The distributed TopN over a real 2-process gloo group: the per-row
    totals all_reduce across processes and both rank like the oracle."""
    tokens = _run_pair(tmp_path, _TOPN_WORKER, "MHT OK")
    assert len(set(tokens)) == 1


# ---------------------------------------------------------------------------
# the executor's mesh routes
# ---------------------------------------------------------------------------

SW = 1 << 20


def _holders(tmp_path, n_slices=8):
    """A JAX holder (8 forced devices) and a port holder (8 CPU members)
    with the same bits: row 1 at column s of every slice, row 2 at the
    even slices."""
    from pilosa_tpu.core.holder import Holder as JHolder
    from pilosa_tpu.exec.executor import Executor as JExecutor
    from pilosa_tpu_torch.core.holder import Holder as THolder
    from pilosa_tpu_torch.exec.executor import Executor as TExecutor

    out = []
    for Holder, Executor, kw in ((JHolder, JExecutor, {}), (THolder, TExecutor,
                                                            {"device": "cpu"})):
        h = Holder(str(tmp_path / ("jax" if not kw else "torch")), **kw)
        h.open()
        f = h.create_index("i").create_frame("f")
        for s in range(n_slices):
            f.set_bit("standard", 1, s * SW + s)
            if s % 2 == 0:
                f.set_bit("standard", 2, s * SW + s)
        out.append((h, Executor(holder=h, host="local")))
    return out


@pytest.fixture
def execs(tmp_path, request):
    pair = _holders(tmp_path, getattr(request, "param", 8))
    yield pair
    for h, ex in pair:
        ex.close()
        h.close()


def _call(pql):
    return tparse(pql).calls[0]


COUNT_AND = 'Count(Intersect(Bitmap(frame="f", rowID=1), Bitmap(frame="f", rowID=2)))'


def test_fragment_planes_pinned_round_robin(execs):
    """Each fragment's mirror lives on its slice's member, and a batch
    keeps one table a member over exactly the slices homed there."""
    from pilosa_tpu_torch.exec.executor import _MeshEntry

    (_, _), (h, ex) = execs
    members = tbp.placement(h.device)
    assert len(members) == 8
    for s in range(8):
        frag = h.fragment("i", "f", "standard", s)
        assert frag.device == members[s % 8]
        assert frag.device_plane().device == members[s % 8]
    call = _call(COUNT_AND).children[0]
    expr, leaves = tplan.decompose(call)
    ent, table = ex._cached_batch("i", call, expr, leaves, list(range(8)))
    assert isinstance(ent, _MeshEntry)
    assert [(m, pe.kept) for m, pe, _t in ent.parts] == [(s, [s]) for s in range(8)]
    assert table.members == tuple(range(8)) and table.shape[0] == 8
    assert ent.pos_of == {s: s for s in range(8)}


def test_sharded_count_and_rows_match_jax(execs):
    from pilosa_tpu.net import codec as jcodec
    from pilosa_tpu_torch.net import codec as tcodec

    (jh, jex), (th, tex) = execs
    for q in ('Count(Bitmap(frame="f", rowID=1))', COUNT_AND):
        assert tex.execute("i", tparse(q)) == jex.execute("i", jparse(q))
    assert tex.execute("i", tparse('Count(Bitmap(frame="f", rowID=1))')) == [8]
    q = 'Bitmap(frame="f", rowID=1)'
    (tbm,) = tex.execute("i", tparse(q))
    (jbm,) = jex.execute("i", jparse(q))
    assert tcodec.result_to_json(tbm)["bits"] == jcodec.bitmap_to_json(jbm)["bits"] \
        == [s * SW + s for s in range(8)]


@pytest.mark.parametrize("execs", [11], indirect=True)
def test_uneven_groups_pad_cleanly(execs):
    """11 slices over 8 members: some members keep two slices, some one;
    no pad slice counts or shows in a row result."""
    from pilosa_tpu_torch.net import codec as tcodec

    (jh, jex), (th, tex) = execs
    q = 'Count(Bitmap(frame="f", rowID=1))'
    assert tex.execute("i", tparse(q)) == jex.execute("i", jparse(q)) == [11]
    (tbm,) = tex.execute("i", tparse('Union(Bitmap(frame="f", rowID=1), '
                                     'Bitmap(frame="f", rowID=2))'))
    assert tcodec.result_to_json(tbm)["bits"] == [s * SW + s for s in range(11)]


def test_count_uses_one_k2_total_a_member_under_the_collective(execs, monkeypatch):
    """A direct mesh Count: one K2 "total" launch a member inside one
    watched collective body, and only the int64 sum comes home."""
    from pilosa_tpu_torch.ops import tree_eval as te

    (_, _), (h, ex) = execs
    calls, bodies = [], []
    real_te, real_rc = te.tree_eval, ex.device_health.run_collective
    monkeypatch.setattr(te, "tree_eval", lambda t, p, r: calls.append((r, t.shape[0]))
                        or real_te(t, p, r))
    monkeypatch.setattr(ex.device_health, "run_collective",
                        lambda fn: bodies.append(1) or real_rc(fn))
    assert ex.execute("i", tparse(COUNT_AND)) == [4]
    assert bodies == [1]
    # Only the members whose slice keeps a leaf row launch: the even ones
    # hold row 2, every one row 1.
    assert calls == [("total", 1)] * 8


def test_collective_quarantine_takes_per_member_partials(execs, monkeypatch):
    from pilosa_tpu_torch.device import health as health_mod

    (_, _), (h, ex) = execs

    def denied(fn):
        raise health_mod.CollectiveUnavailable("quarantined")

    monkeypatch.setattr(ex.device_health, "run_collective", denied)
    from pilosa_tpu_torch.ops import tree_eval as te

    calls = []
    real_te = te.tree_eval
    monkeypatch.setattr(te, "tree_eval", lambda t, p, r: calls.append(r) or real_te(t, p, r))
    assert ex.execute("i", tparse(COUNT_AND)) == [4]
    assert calls == ["count"] * 8


def test_count_past_partial_budget_takes_partials(execs, monkeypatch):
    (_, _), (h, ex) = execs
    monkeypatch.setattr(tplan, "MAX_ONDEVICE_COUNT_PARTIALS", 2)
    bodies = []
    real_rc = ex.device_health.run_collective
    monkeypatch.setattr(ex.device_health, "run_collective",
                        lambda fn: bodies.append(1) or real_rc(fn))
    assert ex.execute("i", tparse(COUNT_AND)) == [4]
    assert bodies == []


@pytest.mark.parametrize("execs", [11], indirect=True)
def test_cold_and_warm_assembly_identical(execs):
    """A batch built over cold fragments (no mirror resident) and one
    built over warm mirrors give the same layout and the same rows."""
    from pilosa_tpu_torch import device as device_mod

    (_, _), (h, ex) = execs
    call = _call('Intersect(Bitmap(frame="f", rowID=1), Bitmap(frame="f", rowID=2))')
    expr, leaves = tplan.decompose(call)
    for s in range(11):
        h.fragment("i", "f", "standard", s)._evict_mirror()
    assert not any(device_mod.pool().contains(h.fragment("i", "f", "standard", s)._pool_key)
                   for s in range(11))
    cold, cold_t = ex._cached_batch("i", call, expr, leaves, list(range(11)))
    cold_rows = [ex._direct_eval(pe, t, "row").clone() for _m, pe, t in cold.live()]
    ex._batch_cache.clear()
    warm, warm_t = ex._cached_batch("i", call, expr, leaves, list(range(11)))
    warm_rows = [ex._direct_eval(pe, t, "row") for _m, pe, t in warm.live()]
    assert (cold.kept, cold.empties, cold.pos_of) == (warm.kept, warm.empties, warm.pos_of)
    assert cold_t.layout == warm_t.layout
    for a, b in zip(cold_rows, warm_rows):
        assert torch.equal(a, b)


def test_mesh_devices_1_forces_single_device(execs):
    from pilosa_tpu_torch.exec.executor import _BatchEntry

    tbp.configure_mesh_devices(1)
    (_, _), (h, ex) = execs
    assert tbp.mesh_device_count() == 1
    assert tmesh.default_slices_mesh() is None
    call = _call('Count(Bitmap(frame="f", rowID=1))').children[0]
    expr, leaves = tplan.decompose(call)
    ent, table = ex._cached_batch("i", call, expr, leaves, list(range(8)))
    assert isinstance(ent, _BatchEntry) and table.device == torch.device("cpu")
    assert ex.execute("i", tparse('Count(Bitmap(frame="f", rowID=1))')) == [8]


def test_batch_cache_keys_include_the_member_layout(execs, monkeypatch):
    """A changed member layout never reuses a table built for the old
    one."""
    (_, _), (h, ex) = execs
    builds = []
    real = ex._cached_batch_build
    monkeypatch.setattr(ex, "_cached_batch_build",
                        lambda *a: builds.append(len(a[4])) or real(*a))
    q = tparse(COUNT_AND)
    assert ex.execute("i", q) == [4]
    assert ex.execute("i", q) == [4]
    assert builds == [1] * 8  # one entry a member, then hits
    tbp.configure_mesh_devices(4)
    assert ex.execute("i", q) == [4]
    assert builds == [1] * 8 + [2] * 4


def test_topn_scores_one_k4_launch_a_member(execs, monkeypatch):
    from pilosa_tpu_torch.ops import score_planes as sp

    (jh, jex), (th, tex) = execs
    seen = []
    real = sp.score_planes
    monkeypatch.setattr(sp, "score_planes",
                        lambda planes, slots, srcs: seen.append(len(planes))
                        or real(planes, slots, srcs))
    q = 'TopN(Bitmap(frame="f", rowID=2), frame="f", n=2)'
    assert [[(p.id, p.count) for p in r] for r in tex.execute("i", tparse(q))] == \
        [[(p.id, p.count) for p in r] for r in jex.execute("i", jparse(q))]
    assert seen and all(n == 1 for n in seen) and len(seen) <= 8


# ---------------------------------------------------------------------------
# the server on a mesh, against a JAX server over HTTP
# ---------------------------------------------------------------------------


def _writes(n_slices: int, seed: int = 3) -> list[str]:
    rng = np.random.default_rng(seed)
    calls = []
    for _ in range(600):
        r = int(rng.integers(0, 8))
        if rng.random() < (r + 1) / 8:
            calls.append(f"SetBit(frame=f, rowID={r}, columnID={int(rng.integers(0, n_slices * SW))})")
    for _ in range(40):
        calls.append(f"SetBit(frame=g, rowID={int(rng.integers(0, 4))}, "
                     f"columnID={int(rng.integers(0, n_slices * SW))})")
    return [" ".join(calls[i:i + 40]) for i in range(0, len(calls), 40)]


@pytest.fixture
def mesh_servers(tmp_path):
    from test_torch_server import jax_server

    from pilosa_tpu_torch.net.server import Server as TServer

    j = jax_server(str(tmp_path / "jax"))
    t = TServer(str(tmp_path / "torch"), device="cpu", floor_probe=False)
    j.open()
    t.open()
    try:
        yield j, t
    finally:
        t.close()
        j.close()


def _setup(j, t, n_slices=11):
    from test_torch_server import both

    for path, body in (("/index/i", b""), ("/index/i/frame/f", b""), ("/index/i/frame/g", b"")):
        jr, tr = both(j, t, "POST", path, body)
        assert tr == jr
    for q in _writes(n_slices):
        jr, tr = both(j, t, "POST", "/index/i/query", q.encode())
        assert tr == jr and jr[0] == 200


def test_server_mesh_answers_equal_jax_over_http(mesh_servers):
    from test_torch_server import READS, both

    j, t = mesh_servers
    assert len(tbp.placement(t.device)) == 8
    _setup(j, t)
    for q in READS:
        jr, tr = both(j, t, "POST", "/index/i/query", q.encode())
        assert tr == jr, q
    # A write between two reads.
    for q in ("SetBit(frame=f, rowID=2, columnID=31)", f"Count(Bitmap(frame=f, rowID=2))",
              "ClearBit(frame=f, rowID=2, columnID=31)", f"Count(Bitmap(frame=f, rowID=2))"):
        jr, tr = both(j, t, "POST", "/index/i/query", q.encode())
        assert tr == jr, q


def test_server_mesh_coalesced_storm_and_collective_site(mesh_servers):
    """8 threads of mixed Counts and Bitmaps over the mesh through the
    coalescer: every answer equals the serial one (the JAX node's), and
    /debug/perf shows the collective launch site."""
    from concurrent.futures import ThreadPoolExecutor

    from test_torch_server import http

    from pilosa_tpu_torch.obs import perf as perf_mod

    j, t = mesh_servers
    _setup(j, t)
    perf_mod.registry().configure(enabled=True)
    qs = [f"Count(Intersect(Bitmap(frame=f, rowID={a}), Bitmap(frame=f, rowID={b})))"
          for a in range(4) for b in range(4, 8)] + \
         [f"Union(Bitmap(frame=f, rowID={a}), Bitmap(frame=g, rowID={a % 4}))" for a in range(4)]
    want = {q: http(j.host, "POST", "/index/i/query", q.encode()) for q in qs}
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda q: (q, http(t.host, "POST", "/index/i/query", q.encode())),
                            qs * 3))
    for q, r in got:
        assert r == want[q], q
    status, perf = http(t.host, "GET", "/debug/perf")
    assert status == 200 and "collective" in perf["sites"], perf["sites"].keys()
    assert t.coalescer.snapshot()["launches"] > 0


def test_server_applies_mesh_devices(tmp_path):
    from pilosa_tpu_torch.net.server import Server as TServer

    s = TServer(str(tmp_path / "d"), device="cpu", floor_probe=False, mesh_devices=1)
    s.open()
    try:
        assert tbp.mesh_device_count() == 1
        assert tbp.placement(s.device) == (torch.device("cpu"),)
        assert s.device_health.device_paths() == ["device:0"]
    finally:
        s.close()


def test_server_collective_hang_trips_and_answers(tmp_path):
    """An injected ``collective`` hang on a mesh node trips the watchdog;
    the Count still answers right (per-member partials), /debug/health
    shows the collective path quarantined, and the next Count skips it."""
    from test_torch_server import http

    from pilosa_tpu_torch.net.server import Server as TServer
    from pilosa_tpu_torch.testing import faults

    t = TServer(str(tmp_path / "d"), device="cpu", floor_probe=False,
                launch_watchdog_ms=200, quarantine_open_ms=60_000)
    t.open()
    try:
        for path in ("/index/i", "/index/i/frame/f"):
            assert http(t.host, "POST", path)[0] == 200
        bits = " ".join(f"SetBit(frame=f, rowID=1, columnID={s * SW + s})" for s in range(8))
        assert http(t.host, "POST", "/index/i/query", bits.encode())[0] == 200
        assert t.device_health.device_paths() == [f"device:{i}" for i in range(8)]
        faults.install("device.launch:path=collective,kind=hang,delay-ms=1500,times=1")
        try:
            q = b"Count(Bitmap(frame=f, rowID=1))"
            assert http(t.host, "POST", "/index/i/query", q) == (200, {"results": [8]})
            _, health = http(t.host, "GET", "/debug/health")
            assert health["device"]["watchdogTrips"] == 1
            assert health["device"]["paths"]["collective"]["state"] == "quarantined"
            assert http(t.host, "POST", "/index/i/query", q) == (200, {"results": [8]})
        finally:
            faults.clear()
    finally:
        t.close()


def test_jax_written_directory_serves_on_the_mesh(tmp_path):
    """A data directory a JAX node wrote and closed opens in a port node
    on 8 members, and every answer equals the JAX node's."""
    from test_torch_server import READS, http, jax_server

    from pilosa_tpu_torch.net.server import Server as TServer

    jdir = str(tmp_path / "jax")
    j = jax_server(jdir)
    j.open()
    try:
        for path in ("/index/i", "/index/i/frame/f", "/index/i/frame/g"):
            assert http(j.host, "POST", path)[0] == 200
        for q in _writes(11):
            assert http(j.host, "POST", "/index/i/query", q.encode())[0] == 200
        want = [http(j.host, "POST", "/index/i/query", q.encode()) for q in READS]
    finally:
        j.close()
    t = TServer(jdir, device="cpu", floor_probe=False)
    t.open()
    try:
        assert len(tbp.placement(t.device)) == 8
        assert [http(t.host, "POST", "/index/i/query", q.encode()) for q in READS] == want
    finally:
        t.close()


def test_total_reduce_fused_over_mesh(rng):
    """Distinct Count trees over sharded batches in one coalescer drain:
    one fused K3 "total" launch a member, summed across members, equal
    to the JAX fused interpreter's totals."""
    from pilosa_tpu_torch.exec import coalesce as tco
    from pilosa_tpu_torch.ops import interp as tit

    planes = rng.integers(0, 2**32, size=(8, 3, W), dtype=np.uint32)
    t = torch.from_numpy(planes.view(np.int32))

    def sharded():
        tables = []
        for m in range(4):
            base = t[m * 2:(m + 1) * 2].reshape(6, W).contiguous()
            idx = np.stack([np.zeros((2, 3), np.int64),
                            np.arange(6, dtype=np.int64).reshape(2, 3)], axis=-1)
            tables.append(tplan.RowTable([base], idx, words=W))
        return tmesh.ShardedTable(range(4), tables,
                                  [tuple(("col", m, j) for j in range(3)) for m in range(4)])

    e_and = ("Intersect", ("leaf", 0), ("leaf", 1))
    e_or = ("Union", ("leaf", 0), ("leaf", 1), ("leaf", 2))
    calls = []
    real = tit.interp
    tit.interp = lambda *a, **k: calls.append(a[0]) or real(*a, **k)
    # The first drain lingers for company, so both trees land in it.
    sch = tco.CoalesceScheduler(max_wait_us=300_000)
    try:
        f1 = sch.submit(e_and, "total", sharded())
        f2 = sch.submit(e_or, "total", sharded())
        (r1, i1), (r2, _) = f1.result(timeout=30), f2.result(timeout=30)
    finally:
        tit.interp = real
        sch.close()
    a, b, c = planes[:, 0], planes[:, 1], planes[:, 2]
    assert r1 == int(np.bitwise_count(a & b).sum())
    assert r2 == int(np.bitwise_count(a | b | c).sum())
    # JAX: the same two trees as one fused "total" program over the mesh.
    em = jplan.FuseEmitter(4)
    regs = [jplan.lower_expr(e_and, 0, em), jplan.lower_expr(e_or, 0, em)]
    prog = np.zeros((8, 4), dtype=np.int32)
    prog[: len(em.rows)] = np.asarray(em.rows, dtype=np.int32)
    jm = jmesh.slice_mesh(8)
    padded = jax.device_put(np.pad(planes, ((0, 0), (0, 1), (0, 0))),
                            NamedSharding(jm, P("slices", None, None)))
    res = jplan.recombine_count_limbs(np.asarray(jax.device_get(jplan.interp_exec(
        "total", padded, prog, np.asarray(regs, dtype=np.int32)))))
    assert [r1, r2] == [int(x) for x in res]
    assert calls == ["total"] * 4 and i1["members"] == 4


def test_prewarm_warms_each_member(monkeypatch):
    from pilosa_tpu_torch.exec import warmup
    from pilosa_tpu_torch.ops import tree_eval as te

    devs = []
    real = te.tree_eval
    monkeypatch.setattr(te, "tree_eval", lambda t, p, r: devs.append(t.device) or real(t, p, r))
    tbp.set_local_members(["cpu"] * 3)
    assert warmup.prewarm("cpu") == 3 * 7
    assert len(devs) == 3 * 3


def test_bsi_trees_and_aggregates_on_the_mesh_match_jax(tmp_path):
    """BSI comparisons inside trees and Sum/Min/Max on 8 members: one
    ripple launch a member, the per-slice vectors in the batch's order,
    every answer equal to a JAX node's."""
    from test_torch_bsi_route import QUERIES, data, load
    from test_torch_server import http, jax_server

    from pilosa_tpu_torch.net.server import Server as TServer

    j = jax_server(str(tmp_path / "jax"))
    t = TServer(str(tmp_path / "torch"), device="cpu", floor_probe=False)
    j.open()
    t.open()
    try:
        d = data()
        for s in (j, t):
            load(s.holder, d)
        assert len(tbp.placement(t.device)) == 8
        for q in QUERIES:
            assert http(t.host, "POST", "/index/i/query", q.encode()) == \
                http(j.host, "POST", "/index/i/query", q.encode()), q
    finally:
        t.close()
        j.close()
