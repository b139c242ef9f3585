"""The port's residency pool (``pilosa_tpu_torch/device/pool.py``) against
the JAX package's (``pilosa_tpu/device/pool.py``): the same seeded
sequence of admit, touch, resize, pin, unpin and remove on stand-in
device keys must give the same victims in the same order, the same
resident, pinned and high-water bytes and the same counters after every
operation; the budget's resolution order; evict callbacks that lose
their lock race; the port's pin leases; and the prefetcher's lanes."""

import importlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.device.pool import PlanePool as JPool  # noqa: E402
from pilosa_tpu_torch import device as device_mod  # noqa: E402
from pilosa_tpu_torch.core.holder import Holder  # noqa: E402
from pilosa_tpu_torch.device.pool import PlanePool as TPool  # noqa: E402
from pilosa_tpu_torch.device.prefetch import Prefetcher  # noqa: E402
from pilosa_tpu_torch.ops import bitplane as bp  # noqa: E402

# ``device.pool`` names the accessor function, so the module by its path.
pool_mod = importlib.import_module("pilosa_tpu_torch.device.pool")
MiB = 1 << 20
DEVS = ("dev0", "dev1", "dev2")


@pytest.fixture
def fresh_pool():
    p = TPool()
    prev = device_mod._set_pool(p)
    yield p
    device_mod._set_pool(prev)


def _state(pool, victims) -> dict:
    snap = pool.snapshot()
    c = snap["counters"]
    return {
        "victims": list(victims),
        "order": [tuple(e["fragment"] for e in d["entries"]) for d in snap["devices"]],
        "devices": [(d["device"], d["resident_bytes"], d["pinned_bytes"],
                     d["max_resident_bytes"]) for d in snap["devices"]],
        "resident": [pool.resident_bytes(d) for d in DEVS],
        "high": [pool.max_resident_bytes(d) for d in DEVS],
        "counters": (c["evictions"], c["evictSkipped"], c["overBudget"]),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_victims_and_counters_match_jax(seed):
    """2,000 seeded operations over 24 keys on three devices under a
    10 MiB budget; some owners refuse eviction (a lost lock race)."""
    rng = np.random.default_rng(seed)
    budget = 10 * MiB
    pools = (JPool(budget_bytes=budget), TPool(budget_bytes=budget))
    victims = ([], [])
    refuse = set()

    def evict_of(k, i):
        def evict():
            if k in refuse:
                return False
            victims[i].append(k)
            return True
        return evict

    keys = [f"k{i}" for i in range(24)]
    for step in range(2000):
        k = keys[int(rng.integers(len(keys)))]
        op = rng.choice(["admit", "admit", "touch", "resize", "pin", "unpin", "remove",
                         "refuse"])
        dev = DEVS[int(rng.integers(len(DEVS)))]
        nbytes = int(rng.integers(1, 4 * MiB))
        for i, p in enumerate(pools):
            if op == "admit":
                p.admit((k,), {dev: nbytes}, evict_of(k, i), category="mirror",
                        info={"fragment": k})
            elif op == "touch":
                p.touch((k,))
            elif op == "resize":
                p.resize((k,), {dev: nbytes})
            elif op == "pin":
                p.pin((k,))
            elif op == "unpin":
                p.unpin((k,))
            elif op == "remove":
                p.remove((k,))
        if op == "refuse":
            refuse.symmetric_difference_update({k})
        want, got = _state(pools[0], victims[0]), _state(pools[1], victims[1])
        assert got == want, f"step {step}: {op} {k}"
    assert pools[1].evictions > 0 and pools[1].counters()["evictSkipped"] > 0


def test_budget_resolution(monkeypatch):
    """Explicit > PILOSA_DEVICE_HBM_BUDGET_BYTES > 0.8 of the card's
    memory > unbounded, which is what the CPU gets."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    monkeypatch.delenv(pool_mod.ENV_BUDGET, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = TPool()
    assert p.budget_bytes() == 0 and p.budget_bytes(cpu) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (1 << 30, 80 << 30))
    assert TPool().budget_bytes(cuda) == int(0.8 * (80 << 30))
    assert TPool().budget_bytes() == int(0.8 * (80 << 30))
    assert TPool().budget_bytes(cpu) == 0
    for bad in ("", "abc", "-5", "0"):
        monkeypatch.setenv(pool_mod.ENV_BUDGET, bad)
        assert TPool().budget_bytes(cuda) == int(0.8 * (80 << 30))
    monkeypatch.setenv(pool_mod.ENV_BUDGET, str(3 * MiB))
    assert TPool().budget_bytes(cuda) == 3 * MiB == TPool().budget_bytes(cpu)
    explicit = TPool(budget_bytes=5 * MiB)
    assert explicit.budget_bytes(cuda) == 5 * MiB
    explicit.configure(budget_bytes=0)  # back to auto
    assert explicit.budget_bytes(cpu) == 3 * MiB
    explicit.configure(budget_bytes=7 * MiB)
    assert explicit.budget_bytes(cpu) == 7 * MiB


def _holder_with(tmp_path, n: int) -> tuple[Holder, list]:
    h = Holder(str(tmp_path / "data"), device="cpu")
    h.open()
    view = h.create_index("i").create_frame("f").create_view_if_not_exists("standard")
    frags = []
    for s in range(n):
        frag = view.create_fragment_if_not_exists(s)
        frag.set_bit(0, s * bp.SLICE_WIDTH + 1)
        frags.append(frag)
    return h, frags


def test_evict_callback_that_loses_its_lock_race(tmp_path, fresh_pool):
    """A fragment whose lock another thread holds is skipped, counted,
    and left resident — at the admission and again at the reclaim after
    the upload; the breach is counted too; once the lock is free the
    next admission evicts it."""
    h, (a, b) = _holder_with(tmp_path, 2)
    try:
        a.device_plane()
        plane = a.plane_nbytes
        fresh_pool.configure(budget_bytes=plane)
        held, release = threading.Event(), threading.Event()

        def hold():
            with a._mu:
                held.set()
                release.wait(10)

        t = threading.Thread(target=hold)
        t.start()
        assert held.wait(10)
        b.device_plane()
        c = fresh_pool.counters()
        assert (c["evictions"], c["evictSkipped"], c["overBudget"]) == (0, 2, 1)
        assert a._mirror is not None and fresh_pool.resident_bytes() == 2 * plane
        release.set()
        t.join(10)
        assert not t.is_alive()
        b.close()  # frees b's entry; a is the LRU victim of the next one
        h.index("i").frame("f").view("standard").create_fragment_if_not_exists(2).device_plane()
        assert fresh_pool.counters()["evictions"] == 1 and a._mirror is None
    finally:
        h.close()


def test_lease_pins_what_its_thread_admits_and_touches(tmp_path, fresh_pool):
    h, (a, b, c) = _holder_with(tmp_path, 3)
    try:
        a.device_plane()
        fresh_pool.configure(budget_bytes=2 * a.plane_nbytes)
        with fresh_pool.pinned():
            a.device_plane()  # a hit: touched, so pinned
            b.device_plane()  # admitted: pinned
            c.device_plane()  # both others pinned: over budget, nothing evicted
            snap = fresh_pool.snapshot()
            assert all(e["pinned"] for e in snap["fragments"])
            assert snap["devices"][0]["pinned_bytes"] == 3 * a.plane_nbytes
            assert fresh_pool.counters()["overBudget"] == 1
        # Closing the lease ends the saturation: back to the budget, the
        # LRU mirror out.
        snap = fresh_pool.snapshot()
        assert not any(e["pinned"] for e in snap["fragments"])
        assert snap["devices"][0]["pinned_bytes"] == 0
        assert fresh_pool.resident_bytes() == 2 * a.plane_nbytes
        assert a._mirror is None and fresh_pool.evictions == 1
        # Removed under a lease (a structural write), re-admitted: the
        # lease's pin does not outlive it and the books stay whole.
        with fresh_pool.pinned():
            a.device_plane()
            a._reserve(a._plane.shape[0] + 1)  # drops the mirror
            a.device_plane()
        assert fresh_pool.snapshot()["devices"][0]["pinned_bytes"] == 0
        assert fresh_pool.resident_bytes() <= 2 * a.plane_nbytes
    finally:
        h.close()
    assert fresh_pool.resident_bytes() == 0


def test_prefetcher_lanes(tmp_path, fresh_pool):
    h, frags = _holder_with(tmp_path, 4)
    try:
        pf = Prefetcher(pool=fresh_pool, max_workers=2)
        frags[0].device_plane()
        assert pf.prefetch(frags, wait=True) == 3
        assert all(f._mirror is not None for f in frags)
        c = fresh_pool.counters()
        assert (c["prefetchHit"], c["prefetchMiss"]) == (1, 3)
        for f in frags:
            f._invalidate_device()
        job = pf.stage(frags[:2])
        assert job.wait(10) and job.snapshot() == {
            "total": 2, "staged": 2, "skipped": 0, "errors": 0, "remaining": 0}
        assert pf.wait_idle(10)
        staging = fresh_pool.snapshot()["staging"]
        assert (staging["scheduled"], staging["done"], staging["pending"]) == (2, 2, 0)
        assert staging["bytes"] == 2 * frags[0].plane_nbytes
        assert [f._mirror is not None for f in frags] == [True, True, False, False]
    finally:
        h.close()


def test_warm_device_mirrors_fills_the_budget_largest_first(tmp_path, fresh_pool):
    """The synchronous warm uploads the largest planes that fit, skipping
    one that would pass the budget."""
    h, frags = _holder_with(tmp_path, 3)
    try:
        frags[1].import_bulk(list(range(1, 10)), [bp.SLICE_WIDTH + 2] * 9)  # a taller plane
        big, small = frags[1].plane_nbytes, frags[0].plane_nbytes
        assert big > small
        assert h.warm_device_mirrors(budget_bytes=big + small) == 2
        assert frags[1]._mirror is not None and frags[0]._mirror is not None
        assert frags[2]._mirror is None
        assert fresh_pool.resident_bytes() == big + small
    finally:
        h.close()
