"""The port's bit-plane ops and the fused popcount kernel's plain version,
held against ``pilosa_tpu.ops.bitplane`` on the same seeded and
adversarial planes.  Outputs are integers and bitmaps: every comparison
is exact (tolerance 0)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pilosa_tpu.ops import bitplane as jbp  # noqa: E402
from pilosa_tpu_torch.ops import bitplane as tbp  # noqa: E402
from pilosa_tpu_torch.ops import fused_popcount as fp  # noqa: E402
from pilosa_tpu_torch.ops import score_planes  # noqa: E402

W = tbp.WORDS_PER_SLICE
ROWS = [1, 3, 8, 13]
OPS = ["and", "or", "xor", "andnot"]


def adversarial(rows: int, shift: int = 0) -> np.ndarray:
    """Rows cycling through all-zero, all-ones, sign-bit words, and a
    single bit at word 32767."""
    pats = [np.zeros(W, np.uint32) for _ in range(4)]
    pats[1][:] = 0xFFFFFFFF
    pats[2][:] = 0x80000000
    pats[3][W - 1] = 0x80000000
    return np.stack([pats[(r + shift) % 4] for r in range(rows)])


def planes(rows: int, kind: str, seed: int = 0):
    if kind == "adversarial":
        return adversarial(rows), adversarial(rows, 1)
    rng = np.random.default_rng(seed + rows)
    return (
        rng.integers(0, 2**32, size=(rows, W), dtype=np.uint32),
        rng.integers(0, 2**32, size=(rows, W), dtype=np.uint32),
    )


def t(words: np.ndarray) -> "torch.Tensor":
    return tbp.to_device(words, "cpu")


def test_constants_match():
    for name in (
        "SLICE_WIDTH", "WORD_BITS", "WORDS_PER_SLICE", "CONTAINER_BITS",
        "WORDS_PER_CONTAINER", "CONTAINERS_PER_SLICE", "ROW_BLOCK",
    ):
        assert getattr(tbp, name) == getattr(jbp, name), name
    for n in (0, 1, 7, 8, 9, 100, 1 << 16):
        assert tbp.pad_rows(n) == jbp.pad_rows(n)
        assert tbp.pow2_bucket(n, 4) == jbp.pow2_bucket(n, 4)


@pytest.mark.parametrize("kind", ["random", "adversarial"])
@pytest.mark.parametrize("rows", ROWS)
def test_fused_counts_match_jax(rows, kind):
    a, b = planes(rows, kind)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = t(a), t(b)
    assert tbp.count(ta) == int(jbp.count(ja))
    for op in OPS:
        want = int(getattr(jbp, f"count_{op}")(ja, jb))
        assert getattr(tbp, f"count_{op}")(ta, tb) == want, op


@pytest.mark.parametrize("kind", ["random", "adversarial"])
@pytest.mark.parametrize("rows", ROWS)
def test_row_and_top_counts_match_jax(rows, kind):
    a, b = planes(rows, kind)
    got = tbp.row_counts(t(a)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbp.row_counts(jnp.asarray(a))))
    # The TopN scores of every row against a src: the port's scorer
    # (ops/score_planes.py) over the one plane.
    src = b[rows // 2]
    got = score_planes.score_planes([t(a)], np.arange(rows, dtype=np.int64)[None], [t(src)])
    want = np.asarray(jbp.top_counts(jnp.asarray(a), jnp.asarray(src)))
    np.testing.assert_array_equal(got.numpy()[0], want)


@pytest.mark.parametrize("rows", ROWS)
def test_kernel_plain_version_matches_numpy(rows):
    """The plain version (the CPU path of every wrapper) over every op,
    b full and broadcast — the numpy popcount is the oracle."""
    a, b = planes(rows, "random", seed=5)
    a[0, 0], a[0, -1] = 0x80000000, 0xFFFFFFFF
    ta, tb = t(a), t(b)
    np_ops = {
        "none": lambda x, y: x,
        "and": np.bitwise_and,
        "or": np.bitwise_or,
        "xor": np.bitwise_xor,
        "andnot": lambda x, y: x & ~y,
    }
    for op, f in np_ops.items():
        for b_np, b_t in ((b, tb), (b[-1:], tb[-1:])):
            got = fp.row_popcounts(ta, None if op == "none" else b_t, op)
            assert got.dtype == torch.int32
            want = np.bitwise_count(f(a, b_np)).sum(axis=-1)
            np.testing.assert_array_equal(got.numpy(), want)
            if op == "none":
                break


@pytest.mark.parametrize(
    "start,end",
    [(0, 0), (0, 1), (5, 37), (31, 33), (0, 1 << 20), (100, 1 << 20),
     ((1 << 20) - 1, 1 << 20), (70000, 70000 + 65536), (40, 10)],
)
def test_range_ops_match_jax(start, end):
    a, _ = planes(2, "random", seed=11)
    words = a[1].copy()
    words[0] = 0x80000000
    words[-1] = 0xFFFFFFFF
    got = tbp.to_host(tbp.flip_range(t(words), start, end))
    want = np.asarray(jbp.flip_range(jnp.asarray(words), start, end))
    np.testing.assert_array_equal(got, want)
    assert tbp.count_range(t(words), start, end) == int(
        jbp.count_range(jnp.asarray(words), start, end)
    )


def test_materializing_ops_match_jax():
    a, b = planes(3, "random", seed=2)
    for name in ("and_", "or_", "xor", "andnot"):
        got = tbp.to_host(getattr(tbp, name)(t(a), t(b)))
        want = np.asarray(getattr(jbp, name)(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("k", [1, 3, 5, 12])
def test_top_k_tie_order_matches_jax(k):
    rng = np.random.default_rng(k)
    counts = rng.integers(0, 4, size=10).astype(np.int32)  # many ties
    tc, ti = tbp.top_k(torch.from_numpy(counts), k)
    jc, ji = jbp.top_k(jnp.asarray(counts), k)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_host_helpers_match_jax():
    p1 = tbp.empty_plane(2)
    p2 = jbp.empty_plane(2)
    for bit in (0, 31, 32, (1 << 20) - 1, (1 << 20) + 5):
        assert tbp.np_set_bit(p1, bit) == jbp.np_set_bit(p2, bit)
    assert tbp.np_clear_bit(p1, 31) == jbp.np_clear_bit(p2, 31)
    np.testing.assert_array_equal(p1, p2)
    offs = np.array([0, 5, 31, 32, (1 << 20) - 1], dtype=np.uint64)
    np.testing.assert_array_equal(tbp.np_columns_to_row(offs), jbp.np_columns_to_row(offs))
    np.testing.assert_array_equal(
        tbp.np_row_to_columns(p1[1]), jbp.np_row_to_columns(p2[1])
    )


def test_device_round_trip_keeps_sign_bits():
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF] * 4, dtype=np.uint32)
    np.testing.assert_array_equal(tbp.to_host(tbp.to_device(words, "cpu")), words)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.zeros(2, W, dtype=torch.int32)
    with pytest.raises(ValueError):
        fp.row_popcounts(a.to(torch.int64))
    with pytest.raises(ValueError):
        fp.row_popcounts(a, a[:, :8], "and")
    with pytest.raises(ValueError):
        fp.row_popcounts(a, None, "and")
    with pytest.raises(ValueError):
        fp.row_popcounts(a, a, "nand")
    with pytest.raises(ValueError):
        fp.row_popcounts(a[:, ::2])
