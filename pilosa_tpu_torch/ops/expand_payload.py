"""K6: payload expansion, every row of a call in one launch.

The port's counterpart of ``_expand_sparse_xla`` / ``_expand_rle_xla`` /
``expand_payload`` (``pilosa_tpu/ops/bitplane.py:458, 480, 508``): a
sparse-tier row's compressed payload — sorted positions or sorted
half-open runs, real entries only, as int32 bit-views — becomes a dense
int32 ``[32768]`` row.  :func:`expand_payloads` takes a list of jobs
``(fmt, payload, dest)`` and writes each expansion straight into its
destination row (a row of a leaf stack, a ``Bitmap()`` result, a TopN
src), so the rows a ``leaf_stacks`` call needs cost one launch, not one
per row.

On CPU tensors the wrapper runs :func:`plain_expand` (the plain PyTorch
version, ``bitplane.expand_payload``) per job.  On CUDA tensors it
launches the kernel (``csrc/expand_payload.cu``, built at first use by
``_build``) or raises — on a build failure, on a launch whose
``cudaGetLastError`` is not 0, on a bad shape or an unaligned row: there
is no fallback to the plain version.  ``launches`` counts kernel
launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import threading
from collections.abc import Sequence

import numpy as np
import torch

from pilosa_tpu_torch.ops import _build
from pilosa_tpu_torch.ops import bitplane as bp

NAME = "expand_payload"
SOURCE = "pilosa_tpu_torch/ops/csrc/expand_payload.cu"
REPLACES = "pilosa_tpu/ops/bitplane.py:458"
# Rows are the grid's y dimension.
MAX_ROWS = 65535

launches = 0
_launch_mu = threading.Lock()

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library(NAME).pilosa_expand_payload
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def entries(fmt: int, payload: torch.Tensor) -> int:
    """The payload's length in entries (words, positions or runs) after
    checking its shape against its format."""
    if payload.dtype != torch.int32 or not payload.is_contiguous():
        raise ValueError("a payload must be a contiguous int32 tensor")
    if fmt == bp.FMT_DENSE:
        if tuple(payload.shape) != (bp.WORDS_PER_SLICE,):
            raise ValueError(f"a dense payload must be [{bp.WORDS_PER_SLICE}]")
        return bp.WORDS_PER_SLICE
    if fmt == bp.FMT_SPARSE:
        if payload.dim() != 1:
            raise ValueError("a sparse payload must be 1-D positions")
        return payload.shape[0]
    if fmt == bp.FMT_RLE:
        if payload.dim() != 2 or payload.shape[1] != 2:
            raise ValueError("an RLE payload must be [runs, 2]")
        return payload.shape[0]
    raise ValueError(f"unknown container format {fmt!r}")


def _check(jobs) -> torch.device:
    if not jobs:
        raise ValueError("no rows to expand")
    device = jobs[0][2].device
    for fmt, payload, dest in jobs:
        entries(fmt, payload)
        if (dest.dtype != torch.int32 or tuple(dest.shape) != (bp.WORDS_PER_SLICE,)
                or not dest.is_contiguous()):
            raise ValueError(f"a destination must be a contiguous int32 [{bp.WORDS_PER_SLICE}] row")
        if payload.device != device or dest.device != device:
            raise ValueError(f"payloads and destinations must share one device ({device})")
    return device


def plain_expand(jobs: Sequence[tuple[int, torch.Tensor, torch.Tensor]]) -> None:
    """The plain PyTorch version of :func:`expand_payloads`."""
    _check(jobs)
    for fmt, payload, dest in jobs:
        dest.copy_(bp.expand_payload(fmt, payload))


def expand_payloads(jobs: Sequence[tuple[int, torch.Tensor, torch.Tensor]]) -> None:
    """Write the dense row of every ``(fmt, payload, dest)`` job into
    ``dest`` — the kernel on CUDA (one launch per 65,535 rows), the
    plain version on the CPU; raises for any other device."""
    global launches
    # The wrapper's own references to the payloads and destinations whose
    # addresses it tabulates, held until the launches are enqueued.
    jobs = tuple(jobs)
    device = _check(jobs)
    if device.type == "cpu":
        plain_expand(jobs)
        return
    if device.type != "cuda":
        raise ValueError(f"{NAME} runs on cuda or cpu tensors, not {device}")
    table = np.empty((len(jobs), 4), dtype=np.int64)
    for i, (fmt, payload, dest) in enumerate(jobs):
        table[i] = (payload.data_ptr(), fmt, entries(fmt, payload), dest.data_ptr())
    aligned = table[:, 3] if not (table[:, 1] == bp.FMT_DENSE).any() else np.concatenate(
        [table[:, 3], table[table[:, 1] == bp.FMT_DENSE, 0]])
    if (aligned % 16).any():
        raise ValueError(f"{NAME} needs 16-byte aligned destinations and dense payloads")
    fn = _kernel()
    # ``jobs`` holds the payloads and destinations until the launches are
    # enqueued; later frees are ordered after them on the stream.
    with torch.cuda.device(device):
        dev_table = torch.from_numpy(table).to(device)
        stream = torch.cuda.current_stream(device).cuda_stream
        for lo in range(0, len(jobs), MAX_ROWS):
            n = min(MAX_ROWS, len(jobs) - lo)
            rc = fn(dev_table[lo:].data_ptr(), n, stream)
            if rc != 0:
                raise RuntimeError(f"{NAME} launch failed: cudaError {rc}")
            with _launch_mu:
                launches += 1
