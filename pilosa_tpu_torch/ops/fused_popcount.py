"""K1: fused bitwise op + popcount + reduce, per row.

The port's counterpart of the TPU kernel ``_fused_count_pallas``
(``pilosa_tpu/ops/bitplane.py:615``).  PyTorch has no popcount op, and
the last step of every Count tree, every tanimoto src count and every
rank-cache recount is "apply the outer bitwise op, popcount, reduce" —
this kernel.  (TopN scores come from the cross-fragment scorer,
``ops/score_planes.py``.)

``row_popcounts(a, b, op)`` returns int32[R] with
``out[r] = popcount(a[r] OP b[r])`` over int32 bit-views of the plane
words; ``b`` is ``None`` (op ``"none"``), a tensor of ``a``'s shape, or
one row ``[1, W]`` that every row of ``a`` reads (a broadcast src).  ``fused_count`` sums it in int64.

On a CPU tensor the wrapper runs :func:`plain_row_popcounts`, the plain
PyTorch version.  On a CUDA tensor it launches the CUDA kernel
(``csrc/fused_popcount.cu``, built at first use by ``_build``) or
raises: there is no fallback to the plain version.  ``launches`` counts
kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from pilosa_tpu_torch.ops import _build

OPS = {"none": 0, "and": 1, "or": 2, "xor": 3, "andnot": 4}

NAME = "fused_popcount"
SOURCE = "pilosa_tpu_torch/ops/csrc/fused_popcount.cu"
REPLACES = "pilosa_tpu/ops/bitplane.py:615"

# Kernel launches since the last reset (a plain integer: chip_smoke.py
# sets it to 0 before it drives the server and reads it after).
launches = 0
_launch_mu = threading.Lock()

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library(NAME).pilosa_fused_popcount
        fn.argtypes = [
            ctypes.c_void_p,  # a
            ctypes.c_void_p,  # b (NULL for op none)
            ctypes.c_longlong,  # b row stride, words
            ctypes.c_void_p,  # out
            ctypes.c_longlong,  # rows
            ctypes.c_longlong,  # words per row
            ctypes.c_int,  # op
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(a: torch.Tensor, b: torch.Tensor | None, op: str) -> None:
    """The domain both versions accept: ``a`` int32 [R, W] contiguous with
    R >= 1 and W a positive multiple of 4; ``b`` absent exactly for op
    none, else int32 on a's device, contiguous, [R, W] or [1, W]."""
    if op not in OPS:
        raise ValueError(f"unknown fused-count op {op!r}")
    if a.dtype != torch.int32 or a.dim() != 2:
        raise ValueError(f"a must be a 2-D int32 tensor, got {a.dtype} {tuple(a.shape)}")
    rows, words = a.shape
    if rows < 1 or words < 4 or words % 4:
        raise ValueError(f"a must be [R>=1, W] with W a multiple of 4, got {tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    if op == "none":
        if b is not None:
            raise ValueError("op 'none' takes no b")
        return
    if b is None:
        raise ValueError(f"op {op!r} needs b")
    if b.dtype != torch.int32 or b.dim() != 2 or b.shape[1] != words:
        raise ValueError(f"b must be int32 [R or 1, {words}], got {b.dtype} {tuple(b.shape)}")
    if b.shape[0] not in (rows, 1):
        raise ValueError(f"b must have {rows} rows or 1, got {b.shape[0]}")
    if b.device != a.device:
        raise ValueError(f"a on {a.device} but b on {b.device}")
    if not b.is_contiguous():
        raise ValueError("b must be contiguous")


def popcount_words(x: torch.Tensor) -> torch.Tensor:
    """Per-row popcount of an int32 [R, W] tensor: SWAR on its uint8
    view, where shifts are logical, so sign bits need no masking."""
    v = x.view(torch.uint8)
    v = v - ((v >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    v = (v + (v >> 4)) & 0x0F
    return v.sum(dim=-1, dtype=torch.int32)


def plain_row_popcounts(
    a: torch.Tensor, b: torch.Tensor | None = None, op: str = "none"
) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same domain, same
    result): apply the op, popcount each byte, sum per row."""
    _check(a, b, op)
    if op == "none":
        x = a
    elif op == "and":
        x = a & b
    elif op == "or":
        x = a | b
    elif op == "xor":
        x = a ^ b
    else:
        x = a & ~b
    return popcount_words(x.contiguous())


def row_popcounts(
    a: torch.Tensor, b: torch.Tensor | None = None, op: str = "none"
) -> torch.Tensor:
    """int32[R] per-row popcounts of ``a OP b`` — the kernel on CUDA,
    the plain version on the CPU; raises for any other device."""
    global launches
    _check(a, b, op)
    if a.device.type == "cpu":
        return plain_row_popcounts(a, b, op)
    if a.device.type != "cuda":
        raise ValueError(f"fused_popcount runs on cuda or cpu tensors, not {a.device}")
    if a.data_ptr() % 16 or (b is not None and b.data_ptr() % 16):
        raise ValueError("fused_popcount needs 16-byte aligned a and b")
    rows, words = a.shape
    stride = 0 if b is None or b.shape[0] == 1 else words
    fn = _kernel()
    with torch.cuda.device(a.device):
        out = torch.zeros(rows, dtype=torch.int32, device=a.device)
        rc = fn(
            a.data_ptr(),
            None if b is None else b.data_ptr(),
            stride,
            out.data_ptr(),
            rows,
            words,
            OPS[op],
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_popcount launch failed: cudaError {rc}")
    with _launch_mu:
        launches += 1
    return out


def fused_count(
    a: torch.Tensor, b: torch.Tensor | None = None, op: str = "none"
) -> int:
    """sum(popcount(a OP b)) as a Python int (exact: the per-row int32
    counts are summed in int64)."""
    return int(row_popcounts(a, b, op).sum(dtype=torch.int64))
