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
from pilosa_tpu_torch.ops import anchored_count as ac  # noqa: E402
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


def leaves_of(expr) -> int:
    if expr[0] == "leaf":
        return expr[1] + 1
    return max([leaves_of(e) for e in expr[1:]], default=1)


LEAF = [("leaf", i) for i in range(16)]
# A table of one leaf column (the others have at least 4).
ONE_LEAF = ("Intersect", LEAF[0])
# Past the kernel's fast variant (more than MAX_PUSH leaf pushes), its
# widest (depth 8 over 8 pushes), depth 8 in the general variant, an
# empty Union deep inside a tree, one leaf.
WIDE_TREES = [
    ("Union", *LEAF[:9]),
    ("Xor", ("Intersect", *LEAF[:4]), ("Union", *LEAF[4:8]), ("Difference", *LEAF[8:12]),
     ("Xor", *LEAF[12:16])),
    chain(te.MAX_DEPTH - 1),
    ("Difference", ("Intersect", *LEAF[8:12]), chain(te.MAX_DEPTH - 2)),
    ("Union", LEAF[5], ("Intersect", LEAF[1], ("Xor", LEAF[2], ("Difference", LEAF[3],
                                                                 ("Union",), LEAF[0])))),
    ONE_LEAF,
]


@pytest.mark.parametrize("expr", TREES + [chain(te.MAX_DEPTH + 2)] + WIDE_TREES, ids=str)
def test_plain_tree_eval_equals_jax_compiled(expr):
    """count, row and total of every fold, nested trees, a single leaf,
    Union(), a tree past K2's stack, 9 and 16 leaves, depth 8 and an
    empty Union inside a deep tree, over 3 slices of 4 random leaves (as
    many as the tree reads, and 1 for ``ONE_LEAF``): equal to
    ``compiled_batched`` / ``compiled_total_count``."""
    rng = np.random.default_rng(len(str(expr)))
    cols = 1 if expr == ONE_LEAF else max(4, leaves_of(expr))
    words = rng.integers(0, 2**32, size=(3, cols, W), dtype=np.uint32)
    words[1, cols // 2] = 0
    table = table_of(words)
    np.testing.assert_array_equal(
        tplan.tree_eval(expr, "count", table).numpy(),
        np.asarray(jplan.compiled_batched(expr, "count")(words)))
    np.testing.assert_array_equal(
        u32(tplan.tree_eval(expr, "row", table)),
        np.asarray(jplan.compiled_batched(expr, "row")(words)))
    assert int(tplan.tree_eval(expr, "total", table)[0]) == jplan.recombine_count_limbs(
        jplan.compiled_total_count(expr)(words))


def run_resolved(slots: np.ndarray, rows: list) -> np.ndarray:
    """The kernel's fast variant over a resolved program, in numpy: push
    k fills slot k (a leaf's row, or zero), step j sets slot a = slot a
    op slot b with a < b, the result is slot 0."""
    n = int(slots[0])
    pushes = slots[1 : 1 + n].tolist()
    ops, a, b = (slots[o : o + n - 1].tolist() for o in (te._OPS, te._AS, te._BS))
    st = [np.zeros_like(rows[0]) if lf < 0 else rows[lf].copy() for lf in pushes]
    for op, x, y in zip(ops, a, b):
        assert 0 <= x < y < n
        st[x] = {ac.OP_AND: st[x] & st[y], ac.OP_OR: st[x] | st[y],
                 ac.OP_ANDNOT: st[x] & ~st[y], ac.OP_XOR: st[x] ^ st[y]}[op]
    return st[0]


@pytest.mark.parametrize("seed", range(6))
def test_resolved_slots_compute_the_program(seed):
    """The host's resolution of a postfix program into register slots
    (``tree_eval.resolve``, what the kernel's fast variant runs) gives the
    plain fold's row for random trees up to ``MAX_PUSH`` pushes, and
    declines past it (the general variant)."""
    rng = np.random.default_rng(100 + seed)
    words = rng.integers(0, 2**32, size=(8, 64), dtype=np.uint32)
    table = te.RowTable([torch.from_numpy(np.pad(words, ((0, 0), (0, W - 64))).view(np.int32))],
                        np.stack([np.zeros(8, np.int64), np.arange(8)], -1)[None])
    seen = 0
    for _ in range(40):
        expr = random_tree(rng, 8, 4)
        program = tplan.compile_program(expr)
        slots = te.resolve(program)
        pushes = sum(1 for op in program if op >= 0 or op == ac.OP_ZERO)
        if pushes > te.MAX_PUSH:
            assert slots is None
            continue
        seen += 1
        want = u32(te.plain_tree_eval(table, program, "row"))[0, :64]
        np.testing.assert_array_equal(run_resolved(slots, list(words)), want)
    assert seen >= 10


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


def run_allocated(alloc: tinterp.Allocation, leaves: list, k: int) -> list:
    """The kernel's walk of an allocated table (``interp.allocate``), in
    numpy: a forwarded first operand is the previous instruction's result
    (its field -1), the second operand is always a leaf or a stored
    register; a result reaches a register only when STORE is set (into a
    register no later reader still needs); a maskw reads its (leaf, word)
    pair from ``masks``; ``OP_NOTAND`` is ``~a & b``; outputs are taken
    where computed, leaf outputs after."""
    n_leaves = len(leaves)
    regs: dict[int, np.ndarray] = {}
    outs = [None] * k
    prev = None

    def read(r):
        assert 0 <= r < n_leaves or r in regs
        return leaves[r] if r < n_leaves else regs[r]

    for code, a, b, d in alloc.ins.tolist():
        op = code & 7
        if op == tinterp.OP_MASKW:
            leaf, word = alloc.masks[b]
            assert code & tinterp.FWD == 0 and a == leaf
            v = np.full_like(leaves[0], 0xFFFFFFFF if leaves[leaf][word] & 1 else 0)
        else:
            if code & tinterp.FWD:
                assert a == -1 and prev is not None
                x = prev
            else:
                x = read(a)
            y = read(b)
            v = {0: x & y, 1: x | y, 2: x & ~y, 3: x ^ y, tinterp.OP_NOTAND: ~x & y}[op]
        if code & tinterp.STORE:
            assert n_leaves <= d < n_leaves + alloc.n_phys
            regs[d] = v
        else:
            assert d == -1
        if code >> tinterp.EMIT_SHIFT:
            outs[(code >> tinterp.EMIT_SHIFT) - 1] = v
        prev = v
    for r, j in alloc.lout.tolist():
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
    alloc = tinterp.allocate(prog, out_idx, n)
    assert alloc.n_phys < len(prog)
    got = run_allocated(alloc, list(words[0]), len(out_idx))
    for j in range(len(out_idx)):
        np.testing.assert_array_equal(got[j], want[j], err_msg=str(j))


# --- K3's host side: the allocated table, the planner, the domain -----------


def random_full_table(rng, n_leaves: int = 64, n_ops: int = 256) -> np.ndarray:
    """Random folds of earlier registers, every 16th op a MASKW of a leaf."""
    prog = np.zeros((n_ops, 4), dtype=np.int32)
    for i in range(n_ops):
        if i % 16 == 15:
            a = int(rng.integers(0, n_leaves))
            prog[i] = (tinterp.OP_MASKW, a, a, int(rng.integers(0, W)))
        else:
            prog[i] = (int(rng.integers(0, 4)), int(rng.integers(0, n_leaves + i)),
                       int(rng.integers(0, n_leaves + i)), 0)
    return prog


def bsi_table(depth: int):
    """Every BSI comparison and a between at ``depth``, lowered into one
    table over exists, sign, the planes and two predicate rows: (table,
    out_idx, n_leaves)."""
    n = depth + 4
    em = tplan.FuseEmitter(n, max_ops=4096)
    planes = list(range(2, 2 + depth))
    regs = [tplan.ripple.lower_signed_cmp(em, op, 0, 1, planes, n - 2)
            for op in ("lt", "le", "eq", "ne", "ge", "gt")]
    regs.append(tplan.ripple.lower_between(em, 0, 1, planes, n - 2, n - 1))
    return em.table(), np.asarray(list(dict.fromkeys(regs)), np.int32), n


def k3_case(case: str):
    """(table, out_idx, uint32 leaf words [1, L, W]) of one host-side case."""
    rng = np.random.default_rng(int(case[5:]) if case.startswith("trees") else 0)
    if case.startswith("trees"):
        n = int(rng.integers(2, 13))
        em = tplan.FuseEmitter(n)
        regs = [tplan.lower_expr(random_tree(rng, n, 4), 0, em) for _ in range(12)]
        regs.append(int(rng.integers(n)))  # a leaf output
        prog, out_idx = em.table(), np.asarray(list(dict.fromkeys(regs)), np.int32)
    elif case.startswith("bsi"):
        prog, out_idx, n = bsi_table(int(case[3:]))
    else:
        n = 64
        prog = random_full_table(np.random.default_rng(77))
        out_idx = np.arange(n, n + 256, dtype=np.int32)
    words = np.random.default_rng(9).integers(0, 2**32, size=(1, n, W), dtype=np.uint32)
    if case.startswith("bsi"):
        depth = n - 4
        words[0, n - 2] = jbsi.pred_row(-(2**depth) // 3, depth)
        words[0, n - 1] = jbsi.pred_row((2**depth) // 5, depth)
    elif case == "full":
        words[0, :, 0] |= 1  # MASKW reads bit 0 of the words it names: both values
        words[0, ::2, 0] ^= 1
    return prog, out_idx, words


K3_HOST_CASES = [f"trees{s}" for s in range(4)] + ["bsi1", "bsi31", "bsi62", "full"]


@pytest.mark.parametrize("case", K3_HOST_CASES)
def test_allocated_table_equals_jax_interp_exec(case):
    """The table as the kernel runs it (dead ops dropped, the first operand
    forwarded, stores elided, registers reused, maskw values listed),
    walked in numpy, equals JAX's ``interp_exec`` and the plain version on
    random FuseEmitter trees, every BSI comparison at depth 1, 31 and 62,
    and a random 256-op / 64-leaf table."""
    prog, out_idx, words = k3_case(case)
    n = words.shape[1]
    want = np.asarray(jplan.interp_exec("row", words, prog, out_idx))[0]
    plain = u32(tinterp.plain_interp("row", table_of(words), prog, out_idx))[0]
    np.testing.assert_array_equal(plain, want)
    alloc = tinterp.check_program(prog, out_idx, n)
    got = run_allocated(alloc, list(words[0]), len(out_idx))
    for j in range(len(out_idx)):
        np.testing.assert_array_equal(got[j], want[j], err_msg=f"{case} output {j}")
    code = alloc.ins[:, 0] if len(alloc.ins) else np.zeros(0, np.int32)
    if case.startswith("bsi"):
        assert (code & tinterp.FWD).any() and len(alloc.masks) > 0
    assert ((code & tinterp.STORE) != 0).sum() < len(alloc.ins)  # some stores elided


def test_allocation_forwards_the_first_operand_only():
    """A chain forwards every operand after the first op and stores
    nothing; a second operand that is the previous result is read from its
    register; an and-not whose right operand is forwarded swaps into
    not-and; an op no output needs is dropped."""
    chain = np.asarray([(0, 0, 1, 0), (1, 2, 4, 0), (2, 3, 5, 0), (3, 6, 0, 0)], np.int32)
    alloc = tinterp.allocate(chain, np.asarray([7], np.int32), 4)
    assert [c & (tinterp.FWD | tinterp.STORE) for c in alloc.ins[:, 0]] == [
        0, tinterp.FWD, tinterp.FWD, tinterp.FWD]
    assert alloc.n_phys == 0
    right = np.asarray([(0, 0, 1, 0), (2, 2, 4, 0)], np.int32)  # 2 & ~r4: r4 forwarded
    alloc = tinterp.allocate(right, np.asarray([5], np.int32), 4)
    assert alloc.ins[1, 0] & 7 == tinterp.OP_NOTAND and alloc.ins[1, 1:3].tolist() == [-1, 2]
    same = np.asarray([(0, 0, 1, 0), (3, 4, 4, 0)], np.int32)  # r4 ^ r4
    alloc = tinterp.allocate(same, np.asarray([5], np.int32), 4)
    assert alloc.ins[0, 0] & tinterp.STORE and alloc.ins[1, 0] & tinterp.FWD
    assert alloc.ins[1, 2] == alloc.ins[0, 3] == 4
    dead = np.asarray([(0, 0, 1, 0), (1, 0, 1, 0)], np.int32)
    assert len(tinterp.allocate(dead, np.asarray([5], np.int32), 4).ins) == 1


def chain_of_live(m: int) -> tuple:
    """m ops over 2 leaves that all stay live until a fold reads them back
    (m registers stored at once), and its out_idx."""
    rows = [(i % 4, i % 2, 1 - i % 2, 0) for i in range(m)]
    acc = 2
    for i in range(1, m):
        rows.append((3, acc if i > 1 else 2, 2 + i, 0))
        acc = 2 + len(rows) - 1
    return np.asarray(rows, np.int32), np.asarray([2 + len(rows) - 1], np.int32)


def narrowest(prog, out_idx, n_leaves):
    alloc = tinterp.allocate(prog, np.asarray(list(dict.fromkeys(out_idx.tolist())), np.int32),
                             n_leaves)
    k = len(set(out_idx.tolist()))
    sizes = (n_leaves, len(alloc.ins), alloc.n_phys, len(alloc.masks), len(alloc.lout), k)
    return tinterp.smem_bytes(*sizes, "count", *tinterp.NARROWEST)


@pytest.mark.parametrize("kind", ["leaves", "registers"])
def test_check_program_accepts_and_rejects_at_the_planner_boundary(kind):
    """check_program accepts a table just inside a block's shared memory in
    the narrowest shape and rejects one just past it; the boundary is
    smem_bytes' own."""
    if kind == "leaves":
        def table(x):
            return np.zeros((0, 4), np.int32), np.asarray([0], np.int32), x
    else:
        def table(x):
            return (*chain_of_live(x), 2)
    x = 1
    while narrowest(*table(x * 2)) <= tinterp.SMEM_BYTES:
        x *= 2
    lo, hi = x, x * 2  # lo fits, hi does not
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if narrowest(*table(mid)) <= tinterp.SMEM_BYTES else (lo, mid)
    inside, past = table(lo), table(hi)
    assert narrowest(*inside) <= tinterp.SMEM_BYTES < narrowest(*past)
    alloc = tinterp.check_program(*inside)
    if kind == "registers":
        assert alloc.n_phys > 100
    with pytest.raises(ValueError, match="shared memory"):
        tinterp.check_program(*past)


def old_smem_rule(n_leaves: int, n_ops: int, k: int) -> bool:
    """The shared-memory test check_program made before the kernel's
    redesign (one warp, one word a lane, every op its own register)."""
    regs = (n_ops * 24 + k * 8 + n_leaves * 8 + k * 32 * 4 + 15) // 16 * 16
    return regs + (2 * n_leaves + n_ops) * 32 * 4 <= tinterp.SMEM_BYTES


@pytest.mark.parametrize("seed", range(3))
def test_check_program_accepts_every_table_the_old_rule_did(seed):
    """Tables at the edge of the old rule (many leaves, many ops, many
    outputs, MASKW, leaf outputs) all still pass check_program."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(12):
        n_leaves = int(rng.integers(1, 800))
        n_ops = int(rng.integers(0, 1400))
        while n_ops and not old_smem_rule(n_leaves, n_ops, min(n_ops + n_leaves, 64)):
            n_ops //= 2
        prog = random_full_table(rng, n_leaves, n_ops) if n_ops else np.zeros((0, 4), np.int32)
        k = min(n_ops + n_leaves, 64)
        out_idx = rng.choice(n_leaves + n_ops, size=k, replace=False).astype(np.int32)
        if not old_smem_rule(n_leaves, n_ops, k):
            continue
        tinterp.check_program(prog, out_idx, n_leaves)


@pytest.mark.parametrize("case", K3_HOST_CASES)
@pytest.mark.parametrize("reduce", ["count", "row", "total"])
def test_launch_plan_figure_is_smem_bytes(case, reduce):
    """The planner's shape fits a block, its shared-memory figure is
    smem_bytes of that shape, and its tile divides the row."""
    prog, out_idx, words = k3_case(case)
    n = words.shape[1]
    alloc = tinterp.check_program(prog, out_idx, n)
    k = len(set(out_idx.tolist()))
    shape = tinterp.launch_plan(alloc, n, k, reduce)
    sizes = (n, len(alloc.ins), alloc.n_phys, len(alloc.masks), len(alloc.lout), k)
    assert shape.smem == tinterp.smem_bytes(*sizes, reduce, shape.warps, shape.vec)
    assert shape.smem <= tinterp.SMEM_BYTES
    assert shape.variant in (0, tinterp.BRANCH_FREE)
    assert tinterp.WORDS_PER_SLICE % (shape.warps * 32 * shape.vec) == 0
