"""top_k: the k largest counts with their indices, selected on the card.

The port's counterpart of ``top_k`` (``pilosa_tpu/ops/bitplane.py:850``,
``jax.lax.top_k``): for int32 or int64 counts ``[n]``, the
``min(k, n)`` largest as ``(counts int64 [kk], indices int64 [kk])``,
count descending, ties toward the lower index — the reference's Pair
order (``cache.go:316-330``); ``torch.topk`` promises no order among
equal values.

On the CPU the wrapper runs :func:`plain_top_k`, the plain PyTorch
version: a stable descending sort.  On CUDA it launches the kernel
(``csrc/top_k.cu``, built at first use by ``_build``) — one launch per
round of 2,048-element tiles, one round for ``n <= 2048`` — or raises: on
a build failure, a launch whose ``cudaGetLastError`` is not 0, or ``kk``
past ``MAX_K`` with more than one tile of counts (any ``kk`` up to ``n``
when ``n <= TILE``); there is no fallback to the plain version.  ``launches``
counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from pilosa_tpu_torch.ops import _build

NAME = "top_k"
SOURCE = "pilosa_tpu_torch/ops/csrc/top_k.cu"
REPLACES = "pilosa_tpu/ops/bitplane.py:850"
# A kernel tile's elements, and the most a round may keep of one when
# there are several tiles (each round must at least halve the candidates;
# a single tile keeps up to all of its elements).
TILE = 2048
MAX_K = TILE // 2

launches = 0
_launch_mu = threading.Lock()

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library(NAME).pilosa_top_k
        fn.argtypes = [
            ctypes.c_void_p,  # counts (int32 or int64 [n])
            ctypes.c_int,  # is64
            ctypes.c_void_p,  # indices of a later round (int32 [n]) or None
            ctypes.c_int,  # n
            ctypes.c_int,  # k
            ctypes.c_void_p,  # out counts (int64)
            ctypes.c_void_p,  # out indices (int32)
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(counts: torch.Tensor, k: int) -> int:
    if counts.dim() != 1 or counts.dtype not in (torch.int32, torch.int64):
        raise ValueError("counts must be an int32 or int64 vector")
    if k < 0:
        raise ValueError("k must be >= 0")
    return min(int(k), int(counts.shape[0]))


def plain_top_k(counts: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`top_k` (same domain, same
    result): a stable sort on (-count, index)."""
    kk = _check(counts, k)
    vals, idx = torch.sort(counts.to(torch.int64), descending=True, stable=True)
    return vals[:kk], idx[:kk]


def top_k(counts: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``min(k, n)`` largest counts and their indices, count
    descending and ties toward the lower index — the kernel on CUDA, the
    plain version on the CPU; raises for any other device."""
    global launches
    device = counts.device
    if device.type == "cpu":
        return plain_top_k(counts, k)
    if device.type != "cuda":
        raise ValueError(f"{NAME} runs on cuda or cpu tensors, not {device}")
    kk = _check(counts, k)
    if kk == 0:
        empty = torch.empty(0, dtype=torch.int64, device=device)
        return empty, empty.clone()
    if kk > MAX_K and counts.shape[0] > TILE:
        raise ValueError(f"{NAME} selects at most {MAX_K} of more than {TILE} counts")
    counts = counts.contiguous()
    fn = _kernel()
    n_launch = 0
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        cnt, idx, is64, n = counts, None, int(counts.dtype == torch.int64), counts.shape[0]
        while True:
            blocks = (n + TILE - 1) // TILE
            out_c = torch.empty(blocks * kk, dtype=torch.int64, device=device)
            out_i = torch.empty(blocks * kk, dtype=torch.int32, device=device)
            rc = fn(cnt.data_ptr(), is64, None if idx is None else idx.data_ptr(), n, kk,
                    out_c.data_ptr(), out_i.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"{NAME} launch failed: cudaError {rc}")
            n_launch += 1
            if blocks == 1:
                break
            cnt, idx, is64, n = out_c, out_i, 1, blocks * kk
    with _launch_mu:
        launches += n_launch
    return out_c, out_i.to(torch.int64)
