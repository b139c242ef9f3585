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
