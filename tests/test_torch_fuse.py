"""The interpreter's program model and the two kernels' plain versions,
against the JAX package on the same inputs (made with numpy from a seed),
exactly: ``FuseEmitter`` / ``lower_expr`` emit the same ``int32[n_ops,
4]`` tables as the JAX emitter over random trees and every BSI
comparison; K3's plain version equals ``plan.interp_exec`` and K2's
(through ``plan.tree_eval``) equals ``compiled_batched`` /
``compiled_total_count``, both run on JAX's CPU backend."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu import bsi as jbsi  # noqa: E402
from pilosa_tpu.exec import plan as jplan  # noqa: E402
from pilosa_tpu_torch.exec import plan as tplan  # noqa: E402
from pilosa_tpu_torch.ops import interp as tinterp  # noqa: E402
from pilosa_tpu_torch.ops import tree_eval as te  # noqa: E402

W = 32768
FOLDS = ("Intersect", "Union", "Difference", "Xor")


def random_tree(rng, n_leaves: int, depth: int) -> tuple:
    """A random fold tree over ``n_leaves`` leaves: 1-3 children a node,
    now and then an empty Union."""
    if depth == 0 or rng.random() < 0.25:
        return ("leaf", int(rng.integers(n_leaves)))
    op = FOLDS[int(rng.integers(4))]
    if op == "Union" and rng.random() < 0.1:
        return ("Union",)
    kids = tuple(random_tree(rng, n_leaves, depth - 1) for _ in range(int(rng.integers(1, 4))))
    return (op,) + kids


def lower_both(exprs, n_leaves, leaf_maps, max_ops=256):
    """Lower every tree into one JAX and one port emitter: (jax regs,
    port regs, jax emitter, port emitter)."""
    je, pe = jplan.FuseEmitter(n_leaves, max_ops), tplan.FuseEmitter(n_leaves, max_ops)
    jr = [jplan.lower_expr(e, m, je) for e, m in zip(exprs, leaf_maps)]
    pr = [tplan.lower_expr(e, m, pe) for e, m in zip(exprs, leaf_maps)]
    return jr, pr, je, pe


def assert_same_tables(je, pe, jr, pr):
    assert pr == jr
    assert pe.rows == je.rows
    assert pe.dedup_hits == je.dedup_hits
    np.testing.assert_array_equal(pe.table(), np.asarray(je.rows, np.int32).reshape(-1, 4))


def table_of(words: np.ndarray) -> te.RowTable:
    """A CPU row table over uint32 ``[S, L, W]`` leaf rows."""
    s, n, _ = words.shape
    base = torch.from_numpy(np.ascontiguousarray(words).view(np.int32).reshape(s * n, W))
    idx = np.zeros((s, n, 2), dtype=np.int64)
    idx[..., 1] = np.arange(s * n).reshape(s, n)
    return te.RowTable([base], idx)


def u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


# --- the emitter --------------------------------------------------------------


def test_emitter_value_numbering_commutes_like_jax():
    for em in (jplan.FuseEmitter(4), tplan.FuseEmitter(4)):
        a, b = em.and_(0, 1), em.and_(1, 0)
        assert a == b and em.dedup_hits == 1
        assert em.andnot(0, 1) != em.andnot(1, 0)
        assert em.maskw(2, 3) == em.maskw(2, 3)
        assert em.dedup_hits == 2
    je, pe = jplan.FuseEmitter(4), tplan.FuseEmitter(4)
    for em in (je, pe):
        em.and_(0, 1), em.and_(1, 0), em.andnot(0, 1), em.andnot(1, 0), em.maskw(2, 3)
    assert pe.rows == je.rows


def test_emitter_rollback_and_budget_like_jax():
    for mod in (jplan, tplan):
        em = mod.FuseEmitter(2, max_ops=4)
        em.and_(0, 1)
        cp = em.checkpoint()
        em.or_(0, 1)
        em.xor(0, 1)
        em.rollback(cp)
        assert len(em.rows) == 1
        assert em.or_(0, 1) == em.n_leaves + 1
        em = mod.FuseEmitter(2, max_ops=2)
        em.and_(0, 1)
        em.or_(0, 1)
        with pytest.raises(mod.FuseUnsupported):
            em.xor(0, 1)
    assert issubclass(tplan.FuseUnsupported, tplan.PlanError)
    assert (tplan.FUSE_MAX_OPS, tplan.FUSE_OPS_FLOOR) == (jplan.FUSE_MAX_OPS, jplan.FUSE_OPS_FLOOR)
    assert (tplan.OP_AND, tplan.OP_OR, tplan.OP_ANDNOT, tplan.OP_XOR, tplan.OP_MASKW) == (
        jplan.OP_AND, jplan.OP_OR, jplan.OP_ANDNOT, jplan.OP_XOR, jplan.OP_MASKW)


@pytest.mark.parametrize("seed", range(6))
def test_lower_expr_random_trees_equal_jax_tables(seed):
    """Random trees lowered one by one into one table, with contiguous
    leaves and with a shared union-leaf layout: the same registers, rows
    and dedup hits as the JAX emitter."""
    rng = np.random.default_rng(seed)
    n_leaves = int(rng.integers(1, 9))
    exprs = [random_tree(rng, n_leaves, 4) for _ in range(8)]
    jr, pr, je, pe = lower_both(exprs, n_leaves, [0] * len(exprs))
    assert_same_tables(je, pe, jr, pr)
    # The fused layout: each tree's leaves mapped into a union of 12.
    maps = [list(rng.integers(0, 12, size=n_leaves)) for _ in exprs]
    jr, pr, je, pe = lower_both(exprs, 12, maps)
    assert_same_tables(je, pe, jr, pr)


@pytest.mark.parametrize("depth", [1, 8, 31, 62])
def test_lower_bsi_every_comparison_equal_jax_tables(depth):
    """Every BSI comparison and a between, lowered into one table (the
    emitter shares the sign groups and ripple state; the budget raised to
    hold them all): JAX's table."""
    leaves = tuple(("leaf", i) for i in range(depth + 3))
    exprs = [("bsiCmp", op) + leaves for op in ("lt", "le", "eq", "ne", "ge", "gt")]
    exprs.append(("bsiCmp", "between") + leaves + (("leaf", depth + 3),))
    exprs.append(("Intersect", ("leaf", depth + 4), ("bsiCmp", "gt") + leaves))
    jr, pr, je, pe = lower_both(exprs, depth + 5, [0] * len(exprs), max_ops=4096)
    assert_same_tables(je, pe, jr, pr)
    assert pe.dedup_hits > 0


def test_lower_bsi_aggregate_and_budget_unsupported():
    agg = ("bsiSum", False) + tuple(("leaf", i) for i in range(10))
    for mod in (jplan, tplan):
        with pytest.raises(mod.FuseUnsupported):
            mod.lower_expr(agg, 0, mod.FuseEmitter(10))
    deep = ("Union",) + tuple(("leaf", i % 4) for i in range(300))
    em = tplan.FuseEmitter(4)
    with pytest.raises(tplan.FuseUnsupported):
        tplan.lower_expr(("Xor",) + deep[1:], 0, em)


# --- K3's plain version against the JAX interpreter ---------------------------


@pytest.mark.parametrize("reduce", ["count", "row", "total"])
def test_plain_interp_equals_jax_interp_exec(reduce):
    """Eight random trees over 6 leaves and a BSI comparison with its
    predicate (the MASKW path), lowered into one table, over 3 slices:
    K3's plain version equals JAX's ``interp_exec`` (its "total" limbs
    recombined)."""
    rng = np.random.default_rng(31)
    depth = 8
    n = 3 + depth + 6  # exists, sign, planes, predicate, then 6 row leaves
    words = rng.integers(0, 2**32, size=(3, n, W), dtype=np.uint32)
    words[:, 2 + depth] = jbsi.pred_row(-77, depth)
    bsi_expr = ("bsiCmp", "le") + tuple(("leaf", i) for i in range(depth + 3))
    exprs = [bsi_expr] + [random_tree(rng, 6, 3) for _ in range(8)]
    maps = [0] + [list(range(depth + 3, depth + 9))] * 8
    jr, pr, je, pe = lower_both(exprs, n, maps)
    assert_same_tables(je, pe, jr, pr)
    out_idx = np.asarray(list(dict.fromkeys(pr)), dtype=np.int32)
    want = np.asarray(jplan.interp_exec(reduce, words, np.asarray(je.rows, np.int32), out_idx))
    got = tplan.interp_exec(reduce, table_of(words), pe.table(), out_idx)
    if reduce == "row":
        np.testing.assert_array_equal(u32(got), want)
    elif reduce == "count":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_array_equal(got.numpy(), jplan.recombine_count_limbs(want))
        assert list(tplan.recombine_count_limbs(want)) == list(got.numpy())


def test_plain_interp_rejects_what_the_kernel_would():
    table = table_of(np.zeros((1, 2, W), dtype=np.uint32))
    bad = [
        np.asarray([[0, 0, 2, 0]], np.int32),  # reads its own result
        np.asarray([[9, 0, 1, 0]], np.int32),  # no such op
        np.asarray([[0, 0, 1, 0], [4, 2, 2, 0]], np.int32),  # MASKW of a non-leaf
        np.asarray([[4, 0, 0, W]], np.int32),  # MASKW word past the row
    ]
    for prog in bad:
        with pytest.raises(ValueError):
            tinterp.plain_interp("count", table, prog, np.asarray([2], np.int32))
    with pytest.raises(ValueError):
        tinterp.plain_interp("count", table, np.zeros((0, 4), np.int32), np.asarray([2], np.int32))


# --- K2's plain version against the compiled tree ------------------------------


TREES = [
    ("leaf", 0),
    ("Intersect", ("leaf", 0), ("leaf", 1)),
    ("Union", ("leaf", 0), ("leaf", 1), ("leaf", 2)),
    ("Difference", ("leaf", 2), ("leaf", 0), ("leaf", 1)),
    ("Xor", ("leaf", 1), ("leaf", 3), ("leaf", 0)),
    ("Union",),
    ("Intersect", ("leaf", 3), ("Union",)),
    ("Difference", ("Union", ("leaf", 0), ("leaf", 1)), ("Intersect", ("leaf", 2), ("leaf", 3))),
]


def chain(depth: int) -> tuple:
    """A right-nested tree needing ``depth`` + 1 stack rows (past K2's cap:
    it runs as one K3 program)."""
    expr = ("leaf", depth % 4)
    for k in reversed(range(depth)):
        expr = (FOLDS[k % 4], ("leaf", k % 4), expr)
    return expr


@pytest.mark.parametrize("expr", TREES + [chain(te.MAX_DEPTH + 2)], ids=str)
def test_plain_tree_eval_equals_jax_compiled(expr):
    """count, row and total of every fold, nested trees, a single leaf,
    Union() and a tree past K2's stack, over 3 slices of 4 random leaves:
    equal to ``compiled_batched`` / ``compiled_total_count``."""
    rng = np.random.default_rng(len(str(expr)))
    words = rng.integers(0, 2**32, size=(3, 4, W), dtype=np.uint32)
    words[1, 2] = 0
    table = table_of(words)
    np.testing.assert_array_equal(
        tplan.tree_eval(expr, "count", table).numpy(),
        np.asarray(jplan.compiled_batched(expr, "count")(words)))
    np.testing.assert_array_equal(
        u32(tplan.tree_eval(expr, "row", table)),
        np.asarray(jplan.compiled_batched(expr, "row")(words)))
    assert int(tplan.tree_eval(expr, "total", table)[0]) == jplan.recombine_count_limbs(
        jplan.compiled_total_count(expr)(words))


def test_tree_eval_reads_rows_in_place_through_the_table():
    """One base holds every row; leaves name its rows in any order and
    repeat them, an absent row is the zero base — the plain version
    reads what the table names."""
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 2**32, size=(5, W), dtype=np.uint32)
    base = torch.from_numpy(rows.view(np.int32))
    zero = torch.zeros(1, W, dtype=torch.int32)
    idx = np.asarray([[[1, 4], [1, 0]], [[0, 0], [1, 4]]], dtype=np.int64)
    table = te.RowTable([zero, base], idx)
    got = u32(tplan.tree_eval(("Union", ("leaf", 0), ("leaf", 1)), "row", table))
    np.testing.assert_array_equal(got[0], rows[4] | rows[0])
    np.testing.assert_array_equal(got[1], rows[4])
    with pytest.raises(ValueError):
        te.RowTable([base], np.asarray([[[0, 5]]], dtype=np.int64)).check()
    with pytest.raises(ValueError):
        te.program_depth([0, 1], 2)  # leaves two rows


def run_allocated(ins, dest, lout, leaves: list, k: int) -> list:
    """The kernel's walk of an allocated table (``interp.allocate``), in
    numpy: physical registers reused, outputs taken where computed."""
    n_leaves = len(leaves)
    regs: dict[int, np.ndarray] = {}
    outs = [None] * k

    def read(r):
        return leaves[r] if r < n_leaves else regs[r]

    for (op, a, b, aux), (d, e) in zip(ins.tolist(), dest.tolist()):
        assert d >= n_leaves
        if op == tinterp.OP_MASKW:
            v = np.full_like(leaves[0], 0xFFFFFFFF if leaves[a][aux] & 1 else 0)
        else:
            x, y = read(a), read(b)
            v = {0: x & y, 1: x | y, 2: x & ~y, 3: x ^ y}[op]
        regs[d] = v
        if e >= 0:
            outs[e] = v
    for r, j in lout.tolist():
        outs[j] = leaves[r]
    return outs


@pytest.mark.parametrize("case", ["trees", "bsi", "full"])
def test_register_allocation_walks_like_the_table(case):
    """K3 runs an allocated table (op results in reused registers, each
    output reduced where it is computed); walking it gives the plain
    version's rows for every output, with fewer registers."""
    rng = np.random.default_rng(40)
    if case == "trees":
        n = 8
        em = tplan.FuseEmitter(n)
        regs = [tplan.lower_expr(random_tree(rng, n, 4), 0, em) for _ in range(16)]
        regs.append(3)  # a leaf output
        prog = em.table()
    elif case == "bsi":
        depth = 31
        n = depth + 4
        em = tplan.FuseEmitter(n, max_ops=4096)
        planes = list(range(2, 2 + depth))
        regs = [tplan.ripple.lower_signed_cmp(em, op, 0, 1, planes, n - 2)
                for op in ("lt", "eq", "ge")]
        regs.append(tplan.ripple.lower_between(em, 0, 1, planes, n - 2, n - 1))
        prog = em.table()
    else:
        n = 64
        prog = np.zeros((256, 4), dtype=np.int32)
        for i in range(256):
            if i % 16 == 15:
                a = int(rng.integers(0, n))
                prog[i] = (4, a, a, int(rng.integers(0, 64)))
            else:
                prog[i] = (int(rng.integers(0, 4)), int(rng.integers(0, n + i)),
                           int(rng.integers(0, n + i)), 0)
        regs = list(range(n + 200, n + 256))
    out_idx = np.asarray(list(dict.fromkeys(regs)), dtype=np.int32)
    words = rng.integers(0, 2**32, size=(1, n, W), dtype=np.uint32)
    if case == "bsi":
        words[0, n - 2] = jbsi.pred_row(-1234, 31)
        words[0, n - 1] = jbsi.pred_row(99999, 31)
    want = u32(tinterp.plain_interp("row", table_of(words), prog, out_idx))[0]
    ins, dest, lout, n_phys = tinterp.allocate(prog, out_idx, n)
    assert n_phys < len(prog)
    got = run_allocated(ins, dest, lout, list(words[0]), len(out_idx))
    for j in range(len(out_idx)):
        np.testing.assert_array_equal(got[j], want[j], err_msg=str(j))
