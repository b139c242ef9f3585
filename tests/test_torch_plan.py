"""The port's planner against ``pilosa_tpu.exec.plan``: the same
decomposition, and counts and result rows equal to
``plan.compiled_batched(expr, "count"|"row")`` on the same seeded leaf
stacks (exact: integers and bitmaps)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pilosa_tpu.exec import plan as jplan  # noqa: E402
from pilosa_tpu.pql.parser import parse_string as jparse  # noqa: E402
from pilosa_tpu_torch.exec import plan as tplan  # noqa: E402
from pilosa_tpu_torch.ops import bitplane as tbp  # noqa: E402
from pilosa_tpu_torch.ops import fused_popcount as fp  # noqa: E402
from pilosa_tpu_torch.pql.parser import parse_string as tparse  # noqa: E402

W = tbp.WORDS_PER_SLICE
B = "Bitmap(frame=f, rowID={})"

TREES = [
    B.format(0),
    f"Intersect({B.format(0)}, {B.format(1)})",
    f"Union({B.format(0)}, {B.format(1)}, {B.format(2)})",
    f"Difference({B.format(2)}, {B.format(0)})",
    f"Xor({B.format(1)}, {B.format(3)})",
    f"Intersect({B.format(0)})",
    f"Union(Intersect({B.format(0)}, {B.format(1)}), Difference({B.format(2)}, {B.format(3)}))",
    f"Xor(Union({B.format(0)}, {B.format(1)}), {B.format(2)}, Intersect({B.format(3)}, {B.format(0)}))",
]


def leaf_batch(n_slices: int, n_leaves: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    batch = rng.integers(0, 2**32, size=(n_slices, n_leaves, W), dtype=np.uint32)
    batch[0, 0, 0] = 0x80000000
    batch[-1, -1, W - 1] = 0xFFFFFFFF
    return batch


@pytest.mark.parametrize("pql", TREES)
def test_decompose_matches_jax(pql):
    texpr, tleaves = tplan.decompose(tparse(pql).calls[0])
    jexpr, jleaves = jplan.decompose(jparse(pql).calls[0])
    assert texpr == jexpr
    assert [str(c) for c in tleaves] == [str(c) for c in jleaves]
    assert str(tplan.canonicalize_call(tparse(pql).calls[0])) == str(
        jplan.canonicalize_call(jparse(pql).calls[0])
    )


@pytest.mark.parametrize("pql", TREES)
def test_count_and_rows_match_compiled_batched(pql):
    expr, leaves = tplan.decompose(tparse(pql).calls[0])
    batch = leaf_batch(3, len(leaves), seed=len(pql))
    stacks = [tbp.to_device(batch[:, j], "cpu") for j in range(len(leaves))]
    got_counts = tplan.count_rows(expr, stacks).numpy()
    want_counts = np.asarray(jplan.compiled_batched(expr, "count")(jnp.asarray(batch)))
    np.testing.assert_array_equal(got_counts, want_counts)
    got_rows = tbp.to_host(tplan.eval_expr(expr, stacks))
    want_rows = np.asarray(jplan.compiled_batched(expr, "row")(jnp.asarray(batch)))
    np.testing.assert_array_equal(got_rows, want_rows)


def test_count_is_one_fused_launch_per_tree(monkeypatch):
    """The outer op + popcount + reduce of a count is ONE call of the
    fused kernel's wrapper, whatever the tree's depth."""
    calls = []
    real = fp.row_popcounts
    monkeypatch.setattr(
        fp, "row_popcounts", lambda *a, **k: calls.append(1) or real(*a, **k)
    )
    for pql in TREES:
        expr, leaves = tplan.decompose(tparse(pql).calls[0])
        stacks = [tbp.to_device(leaf_batch(2, len(leaves), 1)[:, j], "cpu") for j in range(len(leaves))]
        calls.clear()
        tplan.count_rows(expr, stacks)
        assert len(calls) == 1, pql


@pytest.mark.parametrize("pql", TREES)
def test_eval_with_absent_leaves_matches_eval_expr_np(pql):
    expr, leaves = tplan.decompose(tparse(pql).calls[0])
    batch = leaf_batch(1, len(leaves), seed=3)[0]
    for absent in range(len(leaves) + 1):
        rows = [None if j == absent else batch[j] for j in range(len(leaves))]
        want = jplan.eval_expr_np(expr, rows, W)
        got = tplan.eval_expr_np(expr, rows, W)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pql", ["Sum(frame=f, field=v)", "Foo()", "Intersect()"])
def test_unsupported_trees_raise(pql):
    with pytest.raises(tplan.PlanError):
        tplan.decompose(tparse(pql).calls[0])


def _bsi_node_inputs(case: str):
    """A depth-1 field's ``bsiCmp eq 1`` node over one CPU slice (exists,
    sign, bit 0, seven pads to the bucket of 8, the predicate), bent per
    ``case``."""
    from pilosa_tpu_torch.ops import bsi_ripple as br

    mirror = tbp.to_device(leaf_batch(1, 3, seed=5)[0], "cpu")

    def field():
        return br.FieldPlanes([mirror], np.array([[0, 1, 2]], dtype=np.int64), 8, "cpu")

    fp_ = field()
    inputs = [fp_, fp_, fp_] + [None] * 7 + [tplan.PredLeaf(1)]
    if case == "two_fields":
        inputs[1] = field()
    elif case == "missing_pad":
        inputs = inputs[:9] + inputs[10:]
    elif case == "missing_plane":
        inputs = inputs[:2] + inputs[3:]
    expr = ("bsiCmp", "eq") + tuple(("leaf", j) for j in range(len(inputs)))
    return expr, inputs, mirror


def test_bsi_node_reads_one_whole_field():
    expr, inputs, mirror = _bsi_node_inputs("whole")
    rows = tbp.to_host(mirror)
    want = rows[0] & ~rows[1] & rows[2]  # valued, not negative, bit 0: v == 1
    np.testing.assert_array_equal(tbp.to_host(tplan.eval_expr(expr, inputs))[0], want)
    assert int(tplan.count_rows(expr, inputs)[0]) == int(np.unpackbits(want.view(np.uint8)).sum())


@pytest.mark.parametrize("case", ["two_fields", "missing_pad", "missing_plane"])
def test_bsi_node_over_part_of_a_field_raises(case):
    expr, inputs, _ = _bsi_node_inputs(case)
    with pytest.raises(tplan.PlanError):
        tplan.eval_expr(expr, inputs)
