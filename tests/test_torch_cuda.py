"""The CUDA kernels on the card, each against its plain PyTorch version
on the same inputs (exact: integer counts).  Marked ``cuda``: they skip
where ``torch.cuda.is_available()`` is false and run on a machine with
a card (``python -m pytest --noconftest tests/test_torch_cuda.py -m
cuda``: ``tests/conftest.py`` imports jax, which that machine lacks)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu_torch.ops import bitplane as tbp  # noqa: E402
from pilosa_tpu_torch.ops import fused_popcount as fp  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("rows", [1, 7, 8, 13, 954])
def test_fused_popcount_matches_plain(cuda, rows):
    rng = np.random.default_rng(rows)
    a_np = rng.integers(0, 2**32, size=(rows, tbp.WORDS_PER_SLICE), dtype=np.uint32)
    b_np = rng.integers(0, 2**32, size=(rows, tbp.WORDS_PER_SLICE), dtype=np.uint32)
    a_np[0, 0], a_np[-1, -1] = 0x80000000, 0xFFFFFFFF
    a, b = tbp.to_device(a_np, cuda), tbp.to_device(b_np, cuda)
    for op in fp.OPS:
        for bb in ([None] if op == "none" else [b, b[-1:]]):
            before = fp.launches
            got = fp.row_popcounts(a, bb, op)
            torch.cuda.synchronize()
            assert fp.launches == before + 1
            want = fp.plain_row_popcounts(a, bb, op)
            assert torch.equal(got, want), (op, bb is not None and bb.shape[0])


def test_fused_popcount_rejects_misaligned(cuda):
    a = torch.zeros(2 * tbp.WORDS_PER_SLICE + 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        fp.row_popcounts(a[1:].reshape(2, tbp.WORDS_PER_SLICE))


# --- K7: delta-scatter -------------------------------------------------------


def k7_cases(rows: int, rng):
    """Phase 3 of chip_smoke.py: edge queues folded as the fragment folds
    them, then n unique random entries for each n."""
    from pilosa_tpu_torch.ingest import scatter

    last = rows - 1
    queues = {
        "bit0_bit31": [(0, 5, 1, 1), (0, 6, 1 << 31, 1), (1, 5, 1, 0), (1, 6, 1 << 31, 0)],
        "word32767": [(2, 32767, 1 << 31, 1), (3, 32767, 1, 0)],
        "set_clear_same_bit": [(0, 7, 1 << 9, 1), (0, 7, 1 << 9, 0),
                               (1, 7, 1 << 9, 0), (1, 7, 1 << 9, 1)],
        "last_slot": [(last, 0, 1, 1), (last, 32767, 1 << 31, 0)],
        "empty": [],
    }
    cases = {name: scatter.fold(q) for name, q in queues.items()}
    for n in (1, 31, 1100, 4096, 8192):
        keys = rng.choice(rows * tbp.WORDS_PER_SLICE, size=n, replace=False)
        cases[f"n={n}"] = (
            (keys // tbp.WORDS_PER_SLICE).astype(np.int32),
            (keys % tbp.WORDS_PER_SLICE).astype(np.int32),
            rng.integers(0, 2**32, size=n, dtype=np.uint32),
            rng.integers(0, 2**32, size=n, dtype=np.uint32),
        )
    return cases


@pytest.mark.parametrize("rows", [8, 16])
def test_delta_scatter_matches_plain(cuda, rows):
    from pilosa_tpu_torch.ops import delta_scatter as ds

    rng = np.random.default_rng(100 + rows)
    base = rng.integers(0, 2**32, size=(rows, tbp.WORDS_PER_SLICE), dtype=np.uint32)
    base[0, :8] = (0, 0xFFFFFFFF, 0x80000000, 1, 0, 0xFFFFFFFF, 0, 0x7FFFFFFF)
    for name, entries in k7_cases(rows, rng).items():
        got = tbp.to_device(base, cuda)
        want = got.clone()
        before = ds.launches
        ds.delta_scatter(got, *entries)
        torch.cuda.synchronize()
        assert ds.launches == before + (1 if len(entries[0]) else 0), name
        ds.plain_delta_scatter(want, *entries)
        assert torch.equal(got, want), name


def k7_batch(name: str, rng):
    """Phase 3's K7 batches of chip_smoke.py: (mirror rows per job, or
    "same" for the previous job's mirror, and a code queue per job)."""
    from pilosa_tpu_torch.ingest import scatter

    def codes(rows, n, words=0):
        offs = (rng.integers(0, words, n) * 32 + rng.integers(0, 32, n) if words
                else rng.integers(0, 1 << 20, n))
        return scatter.codes(rng.integers(0, rows, n), offs, 0) | rng.integers(0, 2, n)

    one_bit = scatter.codes([1], [(1 << 20) - 1], 0)
    tall_last = scatter.codes([(1 << 16) - 1], [(1 << 20) - 1], 0)
    return {
        "one_bit_across_queues": (
            [8, 8, 16],
            [np.concatenate([codes(8, 300, 4), one_bit | 1, one_bit]),
             np.concatenate([one_bit, codes(8, 300, 4), one_bit | 1]),
             np.concatenate([one_bit | 1, one_bit, one_bit | 1])]),
        "rows_8_16_65536": (
            [8, 1 << 16, 16],
            [codes(8, 1100), np.concatenate([codes(1 << 16, 20000), tall_last | 1]),
             codes(16, 4096, 64)]),
        "empty_queues": ([8, 8, 8], [np.empty(0, np.int64), codes(8, 31),
                                     np.empty(0, np.int64)]),
        "same_mirror_twice": ([8, "same"], [codes(8, 900, 16), codes(8, 900, 16)]),
        "954_jobs": ([8] * 954, [codes(8, 1100) for _ in range(954)]),
    }[name]


@pytest.mark.parametrize("name", ["one_bit_across_queues", "rows_8_16_65536", "empty_queues",
                                  "same_mirror_twice", "954_jobs"])
def test_batched_delta_scatter_matches_plain(cuda, name):
    """One launch applies every queue of a batch, equal to the plain
    version on the same folded entries."""
    from pilosa_tpu_torch.ingest import scatter
    from pilosa_tpu_torch.ops import delta_scatter as ds

    shapes, queues = k7_batch(name, np.random.default_rng(7))
    mirrors = []
    for r in shapes:
        mirrors.append(mirrors[-1] if r == "same" else torch.randint(
            -2**31, 2**31 - 1, (r, tbp.WORDS_PER_SLICE), dtype=torch.int32, device=cuda))
    plain = {id(m): m.clone() for m in mirrors}
    before = ds.launches
    assert scatter.apply_many(list(zip(mirrors, queues))) == 1
    torch.cuda.synchronize()
    assert ds.launches == before + 1
    merged = {}
    for m, q in zip(mirrors, queues):
        merged.setdefault(id(m), []).append(q)
    ds.plain_delta_scatter_many(list(plain.values()),
                                *scatter.fold_many([np.concatenate(merged[k]) for k in plain]))
    for m in mirrors:
        assert torch.equal(m, plain[id(m)]), name


def test_read_applies_every_fragment_with_one_launch(cuda, tmp_path):
    from pilosa_tpu_torch.core.fragment import Fragment, apply_pending_many
    from pilosa_tpu_torch.ops import delta_scatter as ds

    frags = []
    for s in range(5):
        f = Fragment(str(tmp_path / str(s)), "i", "f", "standard", s, device=cuda)
        f.open()
        f.import_bulk([0, 1, 2], [s << 20 | 5, s << 20 | 6, s << 20 | 7])
        f.device_plane()
        frags.append(f)
    before = ds.launches
    for s, f in enumerate(frags):
        f.import_bulk([1] * 40, [(s << 20) + 64 * c for c in range(40)])
        f.clear_bit(0, s << 20 | 5)
    assert ds.launches == before  # writes only queue
    assert apply_pending_many(frags + [None, frags[0]]) == 5
    assert ds.launches == before + 1
    for f in frags:
        np.testing.assert_array_equal(tbp.to_host(f.device_plane()), f._plane)
        f.close()
    assert ds.launches == before + 1


def test_fragment_applies_queued_writes_with_one_launch(cuda, tmp_path):
    from pilosa_tpu_torch.core.fragment import Fragment
    from pilosa_tpu_torch.ops import delta_scatter as ds

    frag = Fragment(str(tmp_path / "0"), "i", "f", "standard", 0, device=cuda)
    frag.open()
    frag.import_bulk([0, 1, 2], [5, 6, 7])
    frag.device_plane()  # a read uploads the mirror; the writes below queue for it
    before = ds.launches
    for c in (0, 31, 32767 * 32 + 31):
        frag.set_bit(1, c)
    frag.clear_bit(0, 5)
    mirror = tbp.to_host(frag.device_plane())
    assert ds.launches == before + 1
    np.testing.assert_array_equal(mirror, frag._plane)
    frag.close()


# --- K8: the BSI ripple --------------------------------------------------------


def k8_field(depth: int, kinds, seed: int, device):
    """A seeded field over len(kinds) slices, each slice's planes in its
    own mirror in shuffled rows: random values, no valued column,
    non-negative only, negative only, every value equal, or absent
    planes (slot -1)."""
    from pilosa_tpu_torch import bsi
    from pilosa_tpu_torch.ops import bsi_ripple as br

    rng = np.random.default_rng(seed)
    W = tbp.WORDS_PER_SLICE
    mirrors, slots = [], np.empty((len(kinds), 2 + depth), dtype=np.int64)
    for s, kind in enumerate(kinds):
        p = rng.integers(0, 2**32, size=(2 + depth, W), dtype=np.uint32)
        if kind == "no_exists":
            p[0] = 0
        elif kind == "positive":
            p[1] = 0
        elif kind == "negative":
            p[1] = 0xFFFFFFFF
        elif kind == "all_equal":
            v = int(rng.integers(1, 1 << depth))
            p[2:] = [[0xFFFFFFFF if (v >> k) & 1 else 0] for k in range(depth)]
        p[2:] &= p[0]
        p[1] &= p[0] & np.bitwise_or.reduce(p[2:], axis=0)
        order = rng.permutation(3 + depth)
        mirror = np.zeros((3 + depth, W), dtype=np.uint32)
        mirror[order[: 2 + depth]] = p
        slots[s] = order[: 2 + depth]
        if kind == "absent_planes":
            slots[s, [1] + list(range(2, 2 + depth, 3))] = -1
        mirrors.append(tbp.to_device(mirror, device))
    filt = tbp.to_device(rng.integers(0, 2**32, size=(len(kinds), W), dtype=np.uint32), device)
    return br.FieldPlanes(mirrors, slots, bsi.pad_depth(depth), device), filt


@pytest.mark.parametrize("depth", [1, 7, 8, 9, 31, 62])
def test_bsi_ripple_matches_plain(cuda, depth):
    from pilosa_tpu_torch import bsi
    from pilosa_tpu_torch.ops import bsi_ripple as br

    kinds = ("random", "no_exists", "positive", "negative", "all_equal", "absent_planes")
    fp_, filt = k8_field(depth, kinds, depth, cuda)
    hi = (1 << depth) - 1
    for count in (False, True):
        for op0 in ("lt", "le", "eq", "ne", "ge", "gt"):
            for v in (hi, -hi, 0, 1, -1, hi + 1, -hi - 1):
                op, pv = bsi.clamp_predicate(op0, v, depth)
                before = br.launches["bsi_cmp"]
                got = br.bsi_cmp(fp_, op, pv, None, count)
                torch.cuda.synchronize()
                assert br.launches["bsi_cmp"] == before + 1
                assert torch.equal(got, br.plain_bsi_cmp(fp_, op, pv, None, count)), (op, pv)
        for a, b in ((-hi, hi), (-1, 1), (5, 2), (hi, -hi)):
            lo, up = bsi.clamp_between(a, b, depth)
            assert torch.equal(br.bsi_cmp(fp_, "between", lo, up, count),
                               br.plain_bsi_cmp(fp_, "between", lo, up, count)), (a, b)
    for f in (None, filt):
        assert torch.equal(br.bsi_sum(fp_, f), br.plain_bsi_sum(fp_, f))
        for which in ("min", "max"):
            assert torch.equal(br.bsi_minmax(fp_, which, f), br.plain_bsi_minmax(fp_, which, f))


# --- K4: the cross-fragment TopN scorer ------------------------------------------


@pytest.mark.parametrize("rows_per_frag", [(1,), (8, 64, 65), (1, 8, 9) * 318])
def test_score_planes_matches_plain(cuda, rows_per_frag):
    """Ragged mirrors and candidate lists (1 to every row, pads of -1),
    self-src and row-src, an all-zero and an all-ones src."""
    from pilosa_tpu_torch.ops import score_planes as sp

    rng = np.random.default_rng(len(rows_per_frag))
    n = len(rows_per_frag)
    planes = [tbp.to_device(rng.integers(0, 2**32, size=(r, tbp.WORDS_PER_SLICE),
                                         dtype=np.uint32), cuda) for r in rows_per_frag]
    width = max(rows_per_frag) + 3
    slots = np.full((n, width), -1, np.int64)
    for f, r in enumerate(rows_per_frag):
        k = 1 + f % (r + 1) if f else r  # fragment 0 scores every row
        slots[f, :k] = rng.choice(r, size=k, replace=k > r)
    srcs_np = rng.integers(0, 2**32, size=(n, tbp.WORDS_PER_SLICE), dtype=np.uint32)
    srcs_np[0] = 0xFFFFFFFF
    if n > 1:
        srcs_np[1] = 0
    src_rows = tbp.to_device(srcs_np, cuda)
    for srcs in ([src_rows[f] for f in range(n)],
                 [p[int(rng.integers(0, p.shape[0]))] for p in planes]):
        before = sp.launches
        got = sp.score_planes(planes, slots, srcs)
        torch.cuda.synchronize()
        assert sp.launches == before + 1
        assert torch.equal(got, sp.plain_score_planes(planes, slots, srcs))


def test_score_planes_rejects_misaligned(cuda):
    from pilosa_tpu_torch.ops import score_planes as sp

    flat = torch.zeros(2 * tbp.WORDS_PER_SLICE + 4, dtype=torch.int32, device=cuda)
    plane = flat[1 : 1 + 2 * tbp.WORDS_PER_SLICE].view(2, tbp.WORDS_PER_SLICE)
    with pytest.raises(ValueError):
        sp.score_planes([plane], np.array([[0]], np.int64), [plane[1]])


# --- K5 and K6: the anchored count and the payload expansion -------------------


def _mixed_rows(rng, n, cuda):
    """n rows' device forms, every format and the edges: (fmt, payload,
    sorted positions), with absent rows (None)."""
    sw = tbp.SLICE_WIDTH
    out = []
    for k in range(n):
        kind = k % 6
        if kind == 0:
            offs = np.sort(rng.choice(sw, size=int(rng.integers(1, 3000)), replace=False))
        elif kind == 1:
            start = int(rng.integers(0, sw - 5000))
            offs = np.arange(start, start + int(rng.integers(1, 5000)))
        elif kind == 2:
            offs = np.sort(rng.choice(sw, size=40_000, replace=False))  # dense format
        elif kind == 3:
            offs = np.array([0, 31, 32, sw - 1])
        elif kind == 4:
            offs = np.arange(sw - 100, sw)  # a run ending at 2^20
        else:
            out.append(None)
            continue
        offs = offs.astype(np.uint32)
        fmt, payload, _ = tbp.encode_row(offs)
        out.append((fmt, tbp.to_device(tbp.payload_entries(fmt, payload), cuda), offs))
    return out


@pytest.mark.parametrize("n", [1, 6, 954])
def test_expand_payload_matches_plain(cuda, n):
    from pilosa_tpu_torch.ops import expand_payload as ep

    rows = [r for r in _mixed_rows(np.random.default_rng(n), n + 1, cuda) if r is not None][:n]
    got = torch.full((len(rows), tbp.WORDS_PER_SLICE), -1, dtype=torch.int32, device=cuda)
    want = torch.full_like(got, 7)
    before = ep.launches
    ep.expand_payloads([(f, p, got[i]) for i, (f, p, _) in enumerate(rows)])
    torch.cuda.synchronize()
    assert ep.launches == before + 1
    ep.plain_expand([(f, p, want[i]) for i, (f, p, _) in enumerate(rows)])
    assert torch.equal(got, want)
    for i, (_, _, offs) in enumerate(rows):
        np.testing.assert_array_equal(tbp.to_host(got[i]), tbp.np_columns_to_row(offs))


@pytest.mark.parametrize("n", [1, 7, 954])
def test_anchored_count_matches_plain(cuda, n):
    """Every format mix in one launch, absent rows, anchors of every format
    as a fourth leaf (32,768 positions, 1, none, a run up to 2^20) or as
    the tree's own leaf, the window edges, a program 64 deep."""
    from pilosa_tpu_torch.exec import plan as tplan
    from pilosa_tpu_torch.ops import anchored_count as ac

    rng = np.random.default_rng(n)
    sw = tbp.SLICE_WIDTH
    leaves, anchor_leaf = [], []
    for s in range(n):
        row = [(r[0], r[1]) if r is not None else None
               for r in _mixed_rows(rng, 3, cuda)[::-1] + _mixed_rows(rng, 1, cuda)][:3]
        k = s % 5
        offs = (np.sort(rng.choice(sw, size=32768, replace=False)) if k == 0 else
                np.array([sw - 1]) if k == 1 else np.array([], np.int64) if k == 2 else
                np.arange(sw - 300, sw) if k == 3 else
                np.array([0, 16383, 16384, 32767, 32768, sw - 32768, sw - 1]))
        fmt, payload, _ = tbp.encode_row(offs.astype(np.uint32))
        row.append((fmt, tbp.to_device(tbp.payload_entries(fmt, payload), cuda)))
        leaves.append(row)
        anchor_leaf.append(-1 if k == 2 else 0 if (s % 3 == 2 and row[0] is not None) else 3)
    anchor_leaf = np.array(anchor_leaf, np.int32)
    deep = ("leaf", 2)
    for k in range(62):  # 64 sets deep inside the Intersect
        deep = (("Union", "Intersect", "Xor", "Difference")[k % 4], ("leaf", k % 3), deep)
    for expr in (("Intersect", ("leaf", 0), ("leaf", 1), ("leaf", 2)),
                 ("Difference", ("leaf", 0), ("Union", ("leaf", 1), ("leaf", 2))),
                 ("Xor", ("leaf", 2), ("Intersect", ("leaf", 0)), ("Union",)),
                 ("Intersect", ("leaf", 1), deep)):
        before = ac.launches
        got = tplan.anchored_count(expr, anchor_leaf, leaves, cuda)
        torch.cuda.synchronize()
        assert ac.launches == before + 1
        want = ac.plain_anchored_count(tplan.compile_program(expr), anchor_leaf, leaves, cuda)
        assert torch.equal(got, want), expr


# --- the residency pool on the card ------------------------------------------


def test_pool_budget_is_a_share_of_the_card(cuda, monkeypatch):
    from pilosa_tpu_torch.device.pool import DEFAULT_BUDGET_FRACTION, ENV_BUDGET, PlanePool

    monkeypatch.delenv(ENV_BUDGET, raising=False)
    dev = torch.device("cuda", torch.cuda.current_device())
    want = int(torch.cuda.mem_get_info(dev)[1] * DEFAULT_BUDGET_FRACTION)
    assert PlanePool().budget_bytes(dev) == want == PlanePool().budget_bytes()


def test_eviction_returns_the_mirror_memory(cuda, tmp_path):
    """Mirrors admitted under a budget of one plane: the second upload
    evicts the first, and memory_allocated() follows the pool's
    accounting (no reference outlives the eviction); a pin lease holds
    both through saturation, counted."""
    import gc

    from pilosa_tpu_torch import device as device_mod
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.device.pool import PlanePool

    pool = PlanePool()
    prev = device_mod._set_pool(pool)
    h = Holder(str(tmp_path / "d"), device="cuda")
    h.open()
    try:
        view = h.create_index("i").create_frame("f").create_view_if_not_exists("standard")
        frags = [view.create_fragment_if_not_exists(s) for s in range(2)]
        for s, f in enumerate(frags):
            f.import_bulk(list(range(64)), [s * tbp.SLICE_WIDTH + 5] * 64)
        plane = frags[0].plane_nbytes
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        pool.configure(budget_bytes=plane)
        frags[0].device_plane()
        frags[1].device_plane()
        torch.cuda.synchronize()
        assert frags[0]._mirror is None and pool.evictions == 1
        assert torch.cuda.memory_allocated() - base == pool.resident_bytes() == plane
        with pool.pinned():
            a = frags[0].device_plane()
            b = frags[1].device_plane()
            assert pool.counters()["overBudget"] == 1
            assert torch.cuda.memory_allocated() - base == pool.resident_bytes() == 2 * plane
            assert int(a[3].sum()) != 0 and int(b[3].sum()) != 0
        del a, b
    finally:
        h.close()
        device_mod._set_pool(prev)
    gc.collect()
    assert pool.resident_bytes() == 0


# --- K2 and K3: the fused tree eval and the interpreter ---------------------


def k23_table(te, cuda, n, n_cols, rng):
    """A row table of ``n`` slices x ``n_cols`` leaves drawn from a zero
    row, scratch rows and mirrors of 8 and 64 rows."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(int(rng.integers(0, 2**31)))
    bases = [torch.zeros(1, tbp.WORDS_PER_SLICE, dtype=torch.int32, device=cuda)]
    bases += [torch.randint(-2**31, 2**31, (r, tbp.WORDS_PER_SLICE), dtype=torch.int32,
                            device=cuda, generator=gen) for r in (16, 8, 64)]
    rows = np.asarray([b.shape[0] for b in bases])
    idx = np.zeros((n, n_cols, 2), dtype=np.int64)
    idx[..., 0] = rng.integers(0, len(bases), size=(n, n_cols))
    idx[..., 1] = rng.integers(0, 2**31, size=(n, n_cols)) % rows[idx[..., 0]]
    return te.RowTable(bases, idx)


def chain(depth: int, leaves: int = 6) -> tuple:
    """A right-nested tree that keeps ``depth`` + 1 rows on K2's stack."""
    expr = ("leaf", depth % leaves)
    for k in reversed(range(depth)):
        expr = (("Intersect", "Union", "Xor", "Difference")[k % 4], ("leaf", k % leaves), expr)
    return expr


def k2_trees():
    """Every fold, nested trees, a single leaf, Union() and a tree past
    K2's stack (it runs on K3); 9 and 16 leaves and a depth-8 tree of 11
    pushes (the kernel's general variant), a depth-8 chain of 8 pushes
    (its fast variant's widest)."""
    leaf = [("leaf", i) for i in range(16)]
    deep = leaf[5]
    for k in range(12):  # past K2's stack: runs on K3
        deep = (("Intersect", "Union", "Xor", "Difference")[k % 4], leaf[k % 6], deep)
    return [leaf[0], ("Intersect", leaf[0], leaf[1]), ("Union", *leaf[:4]),
            ("Difference", leaf[4], leaf[1], leaf[2]), ("Xor", leaf[3], leaf[0], leaf[5]),
            ("Union",), ("Intersect", leaf[2], ("Union",)),
            ("Difference", ("Union", leaf[0], leaf[1]),
             ("Xor", leaf[2], ("Intersect", *leaf[3:6]))),
            deep,
            ("Union", *leaf[:9]),
            ("Xor", ("Intersect", *leaf[:4]), ("Union", *leaf[4:8]), ("Difference", *leaf[8:12]),
             ("Xor", *leaf[12:16])),
            chain(7),
            ("Difference", ("Intersect", *leaf[8:12]), chain(6))]


@pytest.mark.parametrize("n", [1, 3, 16, 954, 3816])
def test_tree_eval_matches_plain(cuda, n):
    """Every reduce of every tree of :func:`k2_trees` over 16 leaf
    columns; 3,816 slices are four checked 954-slice tables concatenated,
    as the coalescer concatenates."""
    from pilosa_tpu_torch.exec import plan
    from pilosa_tpu_torch.ops import interp as it
    from pilosa_tpu_torch.ops import tree_eval as te

    rng = np.random.default_rng(n)
    if n > 954:
        parts = [k23_table(te, cuda, 954, 16, rng) for _ in range(n // 954)]
        for t in parts:
            t.check()
        table = te.RowTable.concat_slices(parts)
        assert table.checked
    else:
        table = k23_table(te, cuda, n, 16, rng)
    for expr in k2_trees():
        program = plan.compile_program(expr)
        deep = te.program_depth(program, 16) > te.MAX_DEPTH
        for reduce in ("count", "row", "total"):
            k2, k3 = te.launches, it.launches
            got = plan.tree_eval(expr, reduce, table)
            torch.cuda.synchronize()
            assert (te.launches - k2, it.launches - k3) == ((0, 1) if deep else (1, 0))
            want = te.plain_tree_eval(table, program, reduce)
            assert torch.equal(got, want), (expr, reduce)


def test_interp_matches_plain(cuda):
    from pilosa_tpu_torch import bsi
    from pilosa_tpu_torch.bsi import ripple
    from pilosa_tpu_torch.exec import plan
    from pilosa_tpu_torch.ops import interp as it
    from pilosa_tpu_torch.ops import tree_eval as te

    rng = np.random.default_rng(3)
    cases = []
    em = plan.FuseEmitter(6)
    regs = [plan.lower_expr(e, 0, em) for e in k2_trees()[:8]]
    for n in (1, 3, 954):
        cases.append((k23_table(te, cuda, n, 6, rng), em.table(),
                       np.asarray(list(dict.fromkeys(regs + [2])), np.int32)))
    for depth in (1, 31, 62):
        n_leaves = depth + 4
        words = rng.integers(0, 2**32, size=(n_leaves, tbp.WORDS_PER_SLICE), dtype=np.uint32)
        words[depth + 2] = bsi.pred_row(-5, depth)
        words[depth + 3] = bsi.pred_row(2**depth - 3, depth)
        em = plan.FuseEmitter(n_leaves, max_ops=4096)
        planes = list(range(2, 2 + depth))
        regs = [ripple.lower_signed_cmp(em, op, 0, 1, planes, depth + 2)
                for op in ("lt", "le", "eq", "ne", "ge", "gt")]
        regs.append(ripple.lower_between(em, 0, 1, planes, depth + 2, depth + 3))
        idx = np.zeros((3, n_leaves, 2), dtype=np.int64)
        idx[..., 1] = np.arange(n_leaves)
        cases.append((te.RowTable([tbp.to_device(words, cuda)], idx), em.table(),
                      np.asarray(regs + regs[:2], np.int32)))
    for table, prog, out_idx in cases:
        for reduce in ("count", "row", "total"):
            before = it.launches
            got = it.interp(reduce, table, prog, out_idx)
            torch.cuda.synchronize()
            assert it.launches == before + 1
            want = it.plain_interp(reduce, table, prog, out_idx)
            assert torch.equal(got, want), (table.shape, len(prog), reduce)


def test_interp_rejects_maskw_of_a_non_leaf(cuda):
    from pilosa_tpu_torch.ops import interp as it
    from pilosa_tpu_torch.ops import tree_eval as te

    table = k23_table(te, cuda, 1, 2, np.random.default_rng(0))
    prog = np.asarray([[0, 0, 1, 0], [4, 2, 2, 0]], np.int32)
    with pytest.raises(ValueError):
        it.interp("count", table, prog, np.asarray([3], np.int32))


def k3_edge_tables(n_leaves: int = 6):
    """K3 tables at the edges of its design, over ``n_leaves`` leaves, as
    (name, table, out_idx): a chain that forwards every operand after the
    first, a table that forwards none, ``x ^ x`` and an and-not of the
    previous result (forwarded as its first operand after a swap), and
    maskw of two leaves' first and last words beside an odd number of leaf
    outputs."""
    last = tbp.WORDS_PER_SLICE - 1
    chain = [(0, 0, 1, 0)] + [(i % 4, n_leaves + i - 1, i % n_leaves, 0) for i in range(1, 40)]
    none = [(i % 4, i % n_leaves, (i + 1) % n_leaves, 0) for i in range(n_leaves)]
    swaps = [(0, 0, 1, 0), (3, n_leaves, n_leaves, 0), (2, 2, n_leaves + 1, 0),
             (2, 3, n_leaves + 2, 0), (1, n_leaves + 3, n_leaves, 0)]
    masks = [(4, 2, 2, 0), (4, 2, 2, last), (4, 3, 3, 0), (4, 3, 3, last),
             (0, n_leaves, 0, 0), (1, n_leaves + 1, n_leaves + 2, 0),
             (3, n_leaves + 3, n_leaves + 5, 0), (2, 1, n_leaves + 4, 0)]
    return [
        ("forward-all", np.asarray(chain, np.int32),
         np.asarray([n_leaves + 39, n_leaves + 20], np.int32)),
        ("forward-none", np.asarray(none, np.int32),
         np.arange(n_leaves, 2 * n_leaves, dtype=np.int32)),
        ("swaps", np.asarray(swaps, np.int32),
         np.asarray([n_leaves + 1, n_leaves + 2, n_leaves + 3, n_leaves + 4], np.int32)),
        ("maskw-first-last", np.asarray(masks, np.int32),
         np.asarray([n_leaves + j for j in range(8)] + [5], np.int32)),
    ]


def k3_mask_leaves(table, cuda):
    """Leaves 2 and 3 of every slice's rows of ``table``: bit 0 of word 0
    set and of the last word clear in leaf 2, the other way in leaf 3."""
    for s in range(table.shape[0]):
        for leaf, (w0, w1) in ((2, (1, 0)), (3, (0, 1))):
            b, r = table.index[s, leaf]
            row = table.bases[int(b)][int(r)]
            row[0] = (row[0] & ~1) | w0
            row[-1] = (row[-1] & ~1) | w1


@pytest.mark.parametrize("n", [1, 3, 16, 954])
def test_interp_edges_match_plain(cuda, n):
    """Every edge table at 1, 3, 16 and 954 slices (count, row, total), and
    the 16 phase-14 storm programs beside a leaf output: equal to the plain
    version, one launch each."""
    from pilosa_tpu_torch.exec import plan
    from pilosa_tpu_torch.ops import interp as it
    from pilosa_tpu_torch.ops import tree_eval as te

    rng = np.random.default_rng(50 + n)
    table = k23_table(te, cuda, n, 6, rng)
    k3_mask_leaves(table, cuda)
    cases = k3_edge_tables()
    em = plan.FuseEmitter(6)
    regs = [plan.lower_expr(e, 0, em) for e in k2_trees()]
    cases.append(("trees", em.table(), np.asarray(list(dict.fromkeys(regs + [4])), np.int32)))
    for name, prog, out_idx in cases:
        for reduce in ("count", "row", "total"):
            before = it.launches
            got = it.interp(reduce, table, prog, out_idx)
            torch.cuda.synchronize()
            assert it.launches == before + 1
            want = it.plain_interp(reduce, table, prog, out_idx)
            assert torch.equal(got, want), (name, n, reduce)


def test_interp_every_block_shape_matches_plain(cuda):
    """Every block shape and both variants (one to eight warps, one to
    eight words a lane) on the edge tables over 3 slices equal the plain
    version, and the kernel's shared-memory figure is smem_bytes'; the full
    256-op / 64-leaf table too (the largest leaf buffer), whose planned
    shape fits a block."""
    from pilosa_tpu_torch.ops import interp as it
    from pilosa_tpu_torch.ops import tree_eval as te

    rng = np.random.default_rng(8)
    table = k23_table(te, cuda, 3, 6, rng)
    k3_mask_leaves(table, cuda)
    cases = [(name, prog, out_idx, table) for name, prog, out_idx in k3_edge_tables()]
    full = np.zeros((256, 4), np.int32)
    for i in range(256):
        a = int(rng.integers(0, 64))
        full[i] = ((4, a, a, int(rng.integers(0, tbp.WORDS_PER_SLICE))) if i % 16 == 15 else
                   (int(rng.integers(0, 4)), int(rng.integers(0, 64 + i)),
                    int(rng.integers(0, 64 + i)), 0))
    leaves = torch.randint(-2**31, 2**31, (64, tbp.WORDS_PER_SLICE), dtype=torch.int32,
                           device=cuda)
    idx = np.zeros((3, 64, 2), dtype=np.int64)
    idx[..., 1] = rng.permutation(64)
    cases.append(("full", full, np.arange(64, 320, dtype=np.int32), te.RowTable([leaves], idx)))
    for name, prog, out_idx, tab in cases:
        n_leaves = tab.shape[1]
        alloc = it.check_program(prog, out_idx, n_leaves)
        k = len(set(out_idx.tolist()))
        sizes = (n_leaves, len(alloc.ins), alloc.n_phys, len(alloc.masks), len(alloc.lout), k)
        for reduce in ("count", "row", "total"):
            want = it.plain_interp(reduce, tab, prog, out_idx)
            for warps in it.WARPS:
                for vec in it.VECS:
                    smem = it.smem_bytes(*sizes, reduce, warps, vec)
                    assert it.kernel_smem_bytes(*sizes, reduce, warps, vec) == smem
                    if smem > it.SMEM_BYTES:
                        continue
                    for variant in (0, it.BRANCH_FREE):
                        shape = it.Shape(warps, vec, variant, smem)
                        got = it.interp(reduce, tab, prog, out_idx, shape=shape)
                        assert torch.equal(got, want), (name, reduce, shape)
        if name == "full":
            assert it.launch_plan(alloc, n_leaves, k, "count").smem <= it.SMEM_BYTES


# --- K11: the stream-floor read-sum -----------------------------------------


@pytest.mark.parametrize("pattern", ["zeros", "ones", "max", "random"])
@pytest.mark.parametrize("n", [1, 7, 1023, (1 << 20) + 7, (1 << 27) + 3])
def test_stream_sum_matches_plain(cuda, n, pattern):
    from pilosa_tpu_torch.ops import stream_sum as ss

    if pattern == "random":
        x = torch.randint(-(2**31), 2**31 - 1, (n,), dtype=torch.int32, device=cuda,
                          generator=torch.Generator(cuda).manual_seed(n))
    else:
        fill = {"zeros": 0, "ones": 1, "max": -1}[pattern]
        x = torch.full((n,), fill, dtype=torch.int32, device=cuda)
    before = ss.launches
    got = ss.stream_sum(x)
    assert ss.launches == before + 1
    assert got.device == x.device and got.dtype == torch.int32
    assert int(got) == int(ss.plain_stream_sum(x))
    assert int(ss.stream_sum(x.view(torch.uint32))) == int(got)


def test_stream_sum_rejects_misaligned(cuda):
    from pilosa_tpu_torch.ops import stream_sum as ss

    x = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ss.stream_sum(x[1:])


def test_floor_probe_reads_device_memory(cuda, tmp_path):
    """The probe's buffer is at least 8x the L2 and its floor lies under
    the card's data-sheet memory rate (3.35 TB/s on an H100 SXM)."""
    from pilosa_tpu_torch.device import floorprobe

    floorprobe.reset_cache()
    fp_ = floorprobe.probe(artifact_dir=str(tmp_path), device=cuda)
    l2 = torch.cuda.get_device_properties(cuda).L2_cache_size
    assert fp_["probe_bytes"] >= 8 * l2
    assert 0 < fp_["mean_gbps"] <= 1.05 * 3350


# --- K9: the mesh TopN scorer, and top_k --------------------------------------


@pytest.mark.parametrize("slices,rows", [(1, 1), (3, 70), (16, 8)])
def test_mesh_topn_matches_plain(cuda, slices, rows):
    from pilosa_tpu_torch.ops import mesh_topn as mt

    rng = np.random.default_rng(slices * 100 + rows)
    plane = tbp.to_device(rng.integers(0, 2**32, size=(slices, rows, tbp.WORDS_PER_SLICE),
                                       dtype=np.uint32), cuda)
    src = tbp.to_device(rng.integers(0, 2**32, size=(slices, tbp.WORDS_PER_SLICE),
                                     dtype=np.uint32), cuda)
    for s in (src, plane[:, 0, :]):
        for reduce in mt.REDUCES:
            before = mt.launches
            got = mt.mesh_topn(plane, s, reduce)
            torch.cuda.synchronize()
            assert mt.launches == before + 1
            assert torch.equal(got, mt.plain_mesh_topn(plane, s, reduce)), reduce


@pytest.mark.parametrize("n,k", [(1, 1), (8, 4), (2049, 1024), (100_000, 5), (5, 9),
                                 (2048, 2048), (1500, 1200)])
def test_top_k_matches_plain(cuda, n, k):
    from pilosa_tpu_torch.ops import top_k as tk

    rng = np.random.default_rng(n)
    for counts in (rng.integers(0, 4, size=n), np.zeros(n, dtype=np.int64)):
        for dtype in (torch.int32, torch.int64):
            c = torch.from_numpy(counts).to(dtype).to(cuda)
            gv, gi = tk.top_k(c, k)
            wv, wi = tk.plain_top_k(c, k)
            assert torch.equal(gv, wv) and torch.equal(gi, wi), (n, k, dtype)


# --- a node over several cards, and a node pinned to one -----------------------

_MULTI_READS = [
    "Count(Bitmap(frame=f, rowID=0))",
    "Count(Intersect(Bitmap(frame=f, rowID=0), Bitmap(frame=f, rowID=1)))",
    "Count(Union(Bitmap(frame=f, rowID=0), Bitmap(frame=f, rowID=1), Bitmap(frame=f, rowID=2)))",
    "Bitmap(frame=f, rowID=1)",
    "Difference(Bitmap(frame=f, rowID=2), Bitmap(frame=f, rowID=0))",
    "TopN(frame=f, n=3)",
    "TopN(Bitmap(frame=f, rowID=0), frame=f, n=3)",
]


def _post(host: str, path: str, body: str = "") -> tuple[int, object]:
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://{host}{path}", data=body.encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_node_over_cards_and_pinned_node(cuda, tmp_path):
    """On a host with two or more cards: a node on ``cuda:1`` keeps every
    fragment on card 1; a node on the bare ``cuda`` spreads its slices over
    every card (slice s on card s mod n) and answers as the pinned node
    does, writes between reads included."""
    from pilosa_tpu_torch.net.server import Server

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip(f"needs two or more cards, the machine has {n_cards}")
    tbp.set_local_members(None)
    tbp.configure_mesh_devices(0)
    rng = np.random.default_rng(29)
    n_slices = 2 * n_cards + 1
    writes = " ".join(f"SetBit(frame=f, rowID={int(r)}, columnID={int(c)})" for r, c in zip(
        rng.integers(0, 4, size=400), rng.integers(0, n_slices << 20, size=400)))
    answers = {}
    for name, device in (("pinned", "cuda:1"), ("cards", "cuda")):
        srv = Server(str(tmp_path / name), host="127.0.0.1:0", device=device, floor_probe=False)
        srv.open()
        try:
            for path in ("/index/i", "/index/i/frame/f"):
                assert _post(srv.host, path)[0] == 200
            assert _post(srv.host, "/index/i/query", writes)[0] == 200
            devices = {f.slice: f.device for f in srv.holder._all_fragments()}
            if name == "pinned":
                assert set(devices.values()) == {torch.device("cuda", 1)}
                assert srv.device_health.device_paths() == ["device:1"]
            else:
                assert devices == {s: torch.device("cuda", s % n_cards) for s in devices}
                assert len(srv.device_health.device_paths()) == n_cards
            got = [_post(srv.host, "/index/i/query", q) for q in _MULTI_READS]
            got.append(_post(srv.host, "/index/i/query", "SetBit(frame=f, rowID=0, columnID=7)"))
            got += [_post(srv.host, "/index/i/query", q) for q in _MULTI_READS[:2]]
            got.append(_post(srv.host, "/index/i/query", "ClearBit(frame=f, rowID=0, columnID=7)"))
            got += [_post(srv.host, "/index/i/query", q) for q in _MULTI_READS[:2]]
            assert all(status == 200 for status, _ in got), got
            answers[name] = got
        finally:
            srv.close()
    assert answers["cards"] == answers["pinned"]
