"""The port's BSI helpers and the plain versions of the ripple kernel K8
against ``pilosa_tpu``: ``bsi/__init__.py`` helper for helper, and every
comparison row, count, Sum and Min/Max partial vector byte-identical to
the JAX package's ``plan.compiled_batched(expr, "row"|"count"|"agg")``
(on the JAX CPU backend) and ``plan.eval_expr_np`` on the same seeded
planes — whole vectors, empty slices and pad entries included."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from pilosa_tpu import bsi as jbsi  # noqa: E402
from pilosa_tpu.bsi import ripple as jripple  # noqa: E402
from pilosa_tpu.exec import plan as jplan  # noqa: E402
from pilosa_tpu.pql.parser import Call as JCall  # noqa: E402
from pilosa_tpu_torch import bsi as tbsi  # noqa: E402
from pilosa_tpu_torch.bsi import ripple as tripple  # noqa: E402
from pilosa_tpu_torch.exec import plan as tplan  # noqa: E402
from pilosa_tpu_torch.ops import bsi_ripple as br  # noqa: E402
from pilosa_tpu_torch.pql.parser import Call as TCall  # noqa: E402

W = 32768
DEPTHS = (1, 7, 8, 9, 31, 62)
CMP_OPS = ("lt", "le", "eq", "ne", "ge", "gt")
# Slice kinds of phase 3 of chip_smoke.py.
KINDS = ("random", "no_exists", "positive", "negative", "all_equal", "absent_planes")


# --- helpers -----------------------------------------------------------------



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU tensor ops: one thread each, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_constants_match_jax():
    for name in ("VIEW_FIELD_PREFIX", "ROW_EXISTS", "ROW_SIGN", "ROW_BIT_BASE",
                 "DEPTH_BLOCK", "MAX_DEPTH", "OPS"):
        assert getattr(tbsi, name) == getattr(jbsi, name), name


@pytest.mark.parametrize("lo,hi", [(0, 0), (0, 1), (0, 255), (0, 256), (-1000, 10),
                                   (-3, 1000), (-(1 << 61), 1 << 61), (5, 5)])
def test_field_helpers_match_jax(lo, hi):
    assert tbsi.bit_depth_for(lo, hi) == jbsi.bit_depth_for(lo, hi)
    t, j = tbsi.BSIField("qty", lo, hi), jbsi.BSIField("qty", lo, hi)
    assert (t.bit_depth, t.view, t.to_dict()) == (j.bit_depth, j.view, j.to_dict())
    for d in range(0, 70):
        assert tbsi.pad_depth(d) == jbsi.pad_depth(d)
    assert tbsi.is_field_view("field_qty") and not tbsi.is_field_view("standard")
    assert tbsi.field_view_name("qty") == jbsi.field_view_name("qty")
    assert tbsi.ValCount(-3, 2) == tbsi.ValCount(-3, 2)


@pytest.mark.parametrize("args", [("v", 10, -10), ("v", 0, 1 << 63), ("9v", 0, 1), ("v", -5, 5)])
def test_validate_field_matches_jax(args):
    def outcome(mod):
        try:
            mod.validate_field(*args)
        except ValueError as e:
            return type(e).__name__, str(e)
        return None

    assert outcome(tbsi) == outcome(jbsi)


@given(value=st.integers(-(1 << 62) + 1, (1 << 62) - 1), depth=st.sampled_from(DEPTHS))
@settings(max_examples=60, deadline=None)
def test_pred_row_and_clamps_match_jax(value, depth):
    bucket = tbsi.pad_depth(depth)
    if abs(value) < (1 << bucket):
        np.testing.assert_array_equal(tbsi.pred_row(value, bucket), jbsi.pred_row(value, bucket))
    for op in CMP_OPS:
        assert tbsi.clamp_predicate(op, value, depth) == jbsi.clamp_predicate(op, value, depth)
    for other in (value - 3, value + 1, -value, 0):
        assert tbsi.clamp_between(value, other, depth) == jbsi.clamp_between(value, other, depth)
        assert tbsi.clamp_between(other, value, depth) == jbsi.clamp_between(other, value, depth)


@pytest.mark.parametrize("lo,hi", [(-1000, 1000), (0, 255), (-4, 3), (-(1 << 33), 1 << 33)])
def test_value_bit_rows_match_jax(lo, hi):
    rng = np.random.default_rng(hi)
    cols = rng.choice(3 << 20, size=300, replace=False)
    vals = rng.integers(lo, hi + 1, size=300)
    vals[:3] = lo, hi, max(lo, 0)
    got = tbsi.value_bit_rows(tbsi.BSIField("v", lo, hi), cols, vals)
    want = jbsi.value_bit_rows(jbsi.BSIField("v", lo, hi), cols, vals)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for bad in ([hi + 1], [lo - 1]):
        with pytest.raises(tbsi.BSIError):
            tbsi.value_bit_rows(tbsi.BSIField("v", lo, hi), [1], bad)
    with pytest.raises(tbsi.BSIError):
        tbsi.value_bit_rows(tbsi.BSIField("v", lo, hi), [1, 2], [0])


def test_decoders_match_jax():
    rng = np.random.default_rng(4)
    for depth in (8, 16, 64):
        for _ in range(20):
            vec = rng.integers(0, 2, size=2 * depth + 1)
            assert tripple.decode_sum(vec, depth) == jripple.decode_sum(vec, depth)
            vec = rng.integers(0, 3, size=depth + 2)
            assert tripple.decode_minmax(vec, depth) == jripple.decode_minmax(vec, depth)


# --- planes ------------------------------------------------------------------


def slice_planes(rng, kind: str, depth: int) -> np.ndarray:
    """uint32 [2 + depth, W] planes of one slice: exists, sign, magnitude
    bits, with values masked to exists and zero stored with sign 0."""
    ex = rng.integers(0, 2**32, size=W, dtype=np.uint32)
    mags = rng.integers(0, 2**32, size=(depth, W), dtype=np.uint32)
    sign = rng.integers(0, 2**32, size=W, dtype=np.uint32)
    if kind == "no_exists":
        ex[:] = 0
    elif kind == "positive":
        sign[:] = 0
    elif kind == "negative":
        sign[:] = 0xFFFFFFFF
    elif kind == "all_equal":
        v = int(rng.integers(1, 1 << depth)) * (-1 if depth % 2 else 1)
        mags[:] = 0
        for k in range(depth):
            if (abs(v) >> k) & 1:
                mags[k] = 0xFFFFFFFF
        sign[:] = 0xFFFFFFFF if v < 0 else 0
    mags &= ex
    nonzero = np.bitwise_or.reduce(mags, axis=0)
    sign &= ex & nonzero
    return np.concatenate([ex[None], sign[None], mags])


def make_planes(depth: int, kinds, seed: int):
    """``(planes uint32 [S, 2 + depth, W], FieldPlanes on the CPU)``: each
    slice's rows live in a mirror in shuffled order with a spare row; an
    ``absent_planes`` slice lacks its sign row and every third bit row,
    which the planes hold as zeros."""
    rng = np.random.default_rng(seed)
    planes = np.stack([slice_planes(rng, k, depth) for k in kinds])
    mirrors, slots = [], np.empty((len(kinds), 2 + depth), dtype=np.int64)
    for s, kind in enumerate(kinds):
        order = rng.permutation(3 + depth)
        mirror = np.zeros((3 + depth, W), dtype=np.uint32)
        for j in range(2 + depth):
            mirror[order[j]] = planes[s, j]
            slots[s, j] = order[j]
        if kind == "absent_planes":
            gone = [1] + list(range(2, 2 + depth, 3))
            slots[s, gone] = -1
            planes[s, gone] = 0
        mirrors.append(torch.from_numpy(mirror.view(np.int32)))
    fp = br.FieldPlanes(mirrors, slots, tbsi.pad_depth(depth), torch.device("cpu"))
    return planes, fp


def jax_inputs(planes: np.ndarray, depth: int, tail: list[np.ndarray]):
    """The JAX leaf batch [S, leaves, W]: planes, zero pads, tail rows."""
    s = planes.shape[0]
    pads = np.zeros((s, jbsi.pad_depth(depth) - depth, W), dtype=np.uint32)
    tails = [np.broadcast_to(t, (s, W)) for t in tail]
    return np.concatenate([planes, pads] + [t[:, None] for t in tails], axis=1)


def bsi_call(name: str, depth: int, args: dict, tail_calls: list):
    """A synthetic BSI node as the JAX executor's rewrite builds it."""
    bucket = jbsi.pad_depth(depth)
    kids = [JCall("BsiPlane", {"frame": "f", "field": "v", "row": r}) for r in range(2 + depth)]
    kids += [JCall("BsiZero") for _ in range(bucket - depth)]
    return JCall(name, args, children=kids + tail_calls)


def predicates(depth: int):
    hi = (1 << depth) - 1
    raw = [hi, -hi, 0, 1, -1, hi + 1, -hi - 1]
    pairs = [(-hi, hi), (-1, 1), (0, 0), (5, 2), (-hi - 9, hi + 9), (hi, -hi)]
    return raw, pairs


def as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 and t.dim() == 2 else t.numpy()


# --- K8 plain versions vs JAX -----------------------------------------------


@pytest.mark.parametrize("depth", DEPTHS)
def test_cmp_plain_matches_jax(depth):
    """Every op and predicate (clamped as the executor clamps them), row
    and count, against compiled_batched (depth 8) and against
    eval_expr_np per slice (every depth)."""
    planes, fp = make_planes(depth, KINDS, seed=depth)
    compiled = depth == 8
    raw, pairs = predicates(depth)
    bucket = jbsi.pad_depth(depth)
    cases = []
    for op0 in CMP_OPS:
        for v in raw:
            cases.append((*tbsi.clamp_predicate(op0, v, depth), None))
    cases += [("between", *tbsi.clamp_between(a, b, depth)) for a, b in pairs]
    for op, lo, hi in cases:
        preds = [lo] if op != "between" else [lo, hi]
        call = bsi_call("BsiCmp", depth, {"op": op},
                        [JCall("BsiPred", {"v": p, "d": bucket}) for p in preds])
        expr, _ = jplan.decompose(call)
        assert tplan.decompose(_to_port(call))[0] == expr
        batch = jax_inputs(planes, depth, [jbsi.pred_row(p, bucket) for p in preds])
        got_row = as_u32(br.bsi_cmp(fp, op, lo, hi))
        got_count = br.bsi_cmp(fp, op, lo, hi, count=True).numpy()
        for s in range(len(KINDS)):
            want = jplan.eval_expr_np(expr, list(batch[s]), W)
            np.testing.assert_array_equal(got_row[s], want, err_msg=f"{op} {lo} {hi} s={s}")
            np.testing.assert_array_equal(
                tplan.eval_expr_np(expr, list(batch[s]), W), want)
        np.testing.assert_array_equal(got_count, np.bitwise_count(got_row).sum(-1))
        if compiled:
            jb = jnp.asarray(batch)
            np.testing.assert_array_equal(
                got_row, np.asarray(jplan.compiled_batched(expr, "row")(jb)))
            if op in ("lt", "between"):
                np.testing.assert_array_equal(
                    got_count, np.asarray(jplan.compiled_batched(expr, "count")(jb)))


def _to_port(c: JCall) -> TCall:
    return TCall(name=c.name, args=dict(c.args), children=[_to_port(k) for k in c.children])


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("with_filter", [False, True])
def test_agg_plain_matches_jax(depth, with_filter):
    """Whole Sum and Min/Max partial vectors — empty slices and pad
    entries included — against compiled_batched(..., "agg") (depth 9)
    and eval_expr_np (every depth)."""
    planes, fp = make_planes(depth, KINDS, seed=100 + depth)
    rng = np.random.default_rng(depth)
    filt_np = rng.integers(0, 2**32, size=(len(KINDS), W), dtype=np.uint32)
    filt_np[1] = 0  # a slice where the filter leaves nothing
    filt = torch.from_numpy(filt_np.view(np.int32)) if with_filter else None
    compiled = depth == 9
    got = {
        "BsiSum": br.bsi_sum(fp, filt).numpy(),
        "BsiMin": br.bsi_minmax(fp, "min", filt).numpy(),
        "BsiMax": br.bsi_minmax(fp, "max", filt).numpy(),
    }
    bucket = jbsi.pad_depth(depth)
    for name, vecs in got.items():
        tail = [JCall("Bitmap", {"frame": "g", "rowID": 0})] if with_filter else []
        call = bsi_call(name, depth, {"filter": with_filter, "nplanes": bucket}, tail)
        expr, _ = jplan.decompose(call)
        assert tplan.decompose(_to_port(call))[0] == expr
        batch = jax_inputs(planes, depth, [])
        if with_filter:
            batch = np.concatenate([batch, filt_np[:, None]], axis=1)
        width = 2 * bucket + 1 if name == "BsiSum" else bucket + 2
        assert vecs.shape == (len(KINDS), width) and vecs.dtype == np.int32
        for s in range(len(KINDS)):
            np.testing.assert_array_equal(
                vecs[s], jplan.eval_expr_np(expr, list(batch[s]), W), err_msg=f"{name} s={s}")
            np.testing.assert_array_equal(
                tplan.eval_expr_np(expr, list(batch[s]), W), vecs[s])
        if compiled:
            np.testing.assert_array_equal(
                vecs, np.asarray(jplan.compiled_batched(expr, "agg")(jnp.asarray(batch))))


def test_empty_slice_vectors():
    """A slice with no valued column: Min/Max bits all 1, negative 0 for
    Min and 1 for Max, count 0; Sum all zero."""
    _, fp = make_planes(9, ["no_exists"], seed=1)
    bucket = 16
    mn = br.bsi_minmax(fp, "min").numpy()[0]
    mx = br.bsi_minmax(fp, "max").numpy()[0]
    assert list(mn) == [1] * bucket + [0, 0]
    assert list(mx) == [1] * bucket + [1, 0]
    assert not br.bsi_sum(fp).numpy().any()


@pytest.mark.parametrize("depth", [1, 7, 31])
def test_ripple_matches_jax_numpy_backend(depth):
    """The torch ripple functions against the JAX module's with the
    numpy backend, on single rows."""
    rng = np.random.default_rng(depth)
    planes = slice_planes(rng, "random", depth)
    pad = jbsi.pad_depth(depth)
    rows = list(planes[2:]) + [np.zeros(W, np.uint32)] * (pad - depth)
    t = [torch.from_numpy(r.view(np.int32)) for r in planes[:2]]
    trows = [torch.from_numpy(r.view(np.int32)) for r in rows]
    v = int(rng.integers(-(1 << depth) + 1, 1 << depth))
    for op in CMP_OPS:
        want = jripple.signed_cmp(op, planes[0], planes[1], rows, jbsi.pred_row(v, pad), np)
        got = tripple.signed_cmp(op, *t, trows, torch.from_numpy(
            tbsi.pred_row(v, pad).view(np.int32)))
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    pops = lambda r: int(np.bitwise_count(r).sum())  # noqa: E731
    np.testing.assert_array_equal(
        tripple.sum_vec(*t, trows, None).numpy(),
        jripple.sum_vec(planes[0], planes[1], rows, None, np, pops))
    for which in ("min", "max"):
        np.testing.assert_array_equal(
            tripple.minmax_vec(which, *t, trows, None).numpy(),
            jripple.minmax_vec(which, planes[0], planes[1], rows, None, np, pops, np.where))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    _, fp = make_planes(8, ["random", "positive"], seed=2)
    with pytest.raises(ValueError):
        br.bsi_cmp(fp, "gt", 256)  # outside the depth-8 window: clamp first
    with pytest.raises(ValueError):
        br.bsi_cmp(fp, "between", 1)
    with pytest.raises(ValueError):
        br.bsi_cmp(fp, "like", 1)
    with pytest.raises(ValueError):
        br.bsi_minmax(fp, "mean")
    with pytest.raises(ValueError):
        br.bsi_sum(fp, torch.zeros(3, W, dtype=torch.int32))
    for slots, bucket in ((fp.slots + 50, 8), (fp.slots, 7), (fp.slots[:1], 8)):
        with pytest.raises(ValueError):
            br.FieldPlanes(fp.mirrors, slots, bucket, fp.device)
    meta = br.FieldPlanes(
        [torch.empty(11, W, dtype=torch.int32, device="meta")] * 2, fp.slots, 8,
        torch.device("meta"))
    before = dict(br.launches)
    for call in (lambda: br.bsi_cmp(meta, "gt", 1), lambda: br.bsi_sum(meta),
                 lambda: br.bsi_minmax(meta, "max")):
        with pytest.raises(ValueError):
            call()
    assert br.launches == before
