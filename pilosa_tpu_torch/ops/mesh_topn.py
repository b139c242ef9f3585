"""K9: the mesh TopN scorer over one member's contiguous block.

The port's counterpart of ``_topn_partials`` and ``_topn_total_fn``
(``pilosa_tpu/parallel/mesh.py:187,206``) and of the TopN half of
``query_step`` (``:264``): for a plane block int32 ``[S, R, words]`` and
one src row a slice, int32 ``[S, words]`` whose rows may lie apart (a row
of each slice of the plane itself, as in ``query_step``) — int32
bit-views of the uint32 words —

* ``"partials"``: int32 ``[S, R]``, ``popcount(plane[s, r] & src[s])``
  (a slice-row holds at most 2^20 bits, so int32 is exact);
* ``"total"``: int64 ``[R]``, the same summed over the slices — the
  kernel adds into it and never writes the partials.

On the CPU the wrapper runs :func:`plain_mesh_topn`, the plain PyTorch
version (``bitwise_and`` and the SWAR popcount of
``fused_popcount.popcount_words`` on the int32 views).  On CUDA it
launches the kernel (``csrc/mesh_topn.cu``, built at first use by
``_build``) or raises — on a build failure, a launch whose
``cudaGetLastError`` is not 0, a tensor that is not contiguous, int32,
16-byte aligned or on one device: there is no fallback to the plain
version.  ``launches`` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from pilosa_tpu_torch.ops import _build
from pilosa_tpu_torch.ops.fused_popcount import popcount_words

NAME = "mesh_topn"
SOURCE = "pilosa_tpu_torch/ops/csrc/mesh_topn.cu"
REPLACES = "pilosa_tpu/parallel/mesh.py:187"
REDUCES = {"partials": 0, "total": 1}

launches = 0
_launch_mu = threading.Lock()

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library(NAME).pilosa_mesh_topn
        fn.argtypes = [
            ctypes.c_void_p,  # plane (int32 [S, R, words])
            ctypes.c_void_p,  # src (int32 [S, words], rows src_stride words apart)
            ctypes.c_longlong,  # src_stride
            ctypes.c_int,  # slices
            ctypes.c_int,  # rows
            ctypes.c_int,  # words
            ctypes.c_int,  # total
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(plane: torch.Tensor, src: torch.Tensor, reduce: str) -> None:
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce {reduce!r}")
    if plane.dtype != torch.int32 or src.dtype != torch.int32:
        raise ValueError("plane and src must be int32 bit-views")
    if plane.dim() != 3 or src.dim() != 2 or plane.shape[0] != src.shape[0] \
            or plane.shape[2] != src.shape[1]:
        raise ValueError("plane must be [S, R, words] and src [S, words]")
    if min(plane.shape) < 1:
        raise ValueError("plane must hold at least one slice, row and word")
    if plane.device != src.device:
        raise ValueError("plane and src must lie on one device")


def plain_mesh_topn(plane: torch.Tensor, src: torch.Tensor, reduce: str) -> torch.Tensor:
    """The plain PyTorch version of :func:`mesh_topn` (same domain, same
    result)."""
    _check(plane, src, reduce)
    partials = popcount_words(torch.bitwise_and(plane, src[:, None, :]))
    if reduce == "partials":
        return partials
    return partials.sum(dim=0, dtype=torch.int64)


def mesh_topn(plane: torch.Tensor, src: torch.Tensor, reduce: str) -> torch.Tensor:
    """Per (slice, row) ``|plane row AND src|`` partials, or their per-row
    totals over the slices — the kernel on CUDA (one launch), the plain
    version on the CPU; raises for any other device."""
    global launches
    device = plane.device
    if device.type == "cpu":
        return plain_mesh_topn(plane, src, reduce)
    if device.type != "cuda":
        raise ValueError(f"{NAME} runs on cuda or cpu tensors, not {device}")
    _check(plane, src, reduce)
    if not plane.is_contiguous() or src.stride(1) != 1:
        raise ValueError(f"{NAME} takes a contiguous plane and src rows of adjacent words")
    n, rows, words = plane.shape
    stride = src.stride(0) if n > 1 else words
    if words % 4 or stride % 4 or stride < words or plane.data_ptr() % 16 \
            or src.data_ptr() % 16:
        raise ValueError(f"{NAME} takes 16-byte aligned rows of a multiple of 4 words")
    fn = _kernel()
    with torch.cuda.device(device):
        if reduce == "total":
            out = torch.empty(rows, dtype=torch.int64, device=device)
        else:  # the launcher zeroes it on the stream
            out = torch.empty(n, rows, dtype=torch.int32, device=device)
        rc = fn(plane.data_ptr(), src.data_ptr(), stride, n, rows, words, REDUCES[reduce],
                out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {rc}")
    with _launch_mu:
        launches += 1
    return out
