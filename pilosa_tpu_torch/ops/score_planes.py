"""K4: the cross-fragment TopN scorer, read in place from the mirrors.

The port's counterpart of ``bp.score_planes``
(``pilosa_tpu/ops/bitplane.py:815``, the jitted programs
``_score_planes_self_src`` ``:785`` and ``_score_planes_host_src``
``:800``): every candidate row of every fragment of a node against that
fragment's src row, in one launch —

    out[f, j] = popcount(planes[f][slots[f, j]] & srcs[f])   int32 [F, R]

``planes[f]`` is fragment f's mirror (int32 ``[rows_f, 32768]``; the
fragments' row counts may differ), ``slots`` int64 ``[F, R]`` the
candidate slots, -1 for a pad (scored 0: the candidate lists are ragged
and the port pads nothing else), and ``srcs[f]`` an int32 ``[32768]``
row on the same device: a row of the fragment's own mirror
(``planes[f][src_slot]``, the ``TopN(Bitmap(frame=f), frame=f)`` shape)
or a row the src tree was evaluated into.  Nothing is stacked or
uploaded but a table of addresses and slots: the kernel
(``csrc/score_planes.cu``, built at first use by ``_build``) reads the
rows where they live.

On CPU planes the wrapper runs :func:`plain_score_planes`, the plain
PyTorch version (gather, AND, the SWAR popcount of
``fused_popcount.popcount_words``).  On CUDA planes it launches the
kernel or raises — on a build failure, on a launch whose
``cudaGetLastError`` is not 0, on a slot outside its mirror, on an
unaligned row: there is no fallback to the plain version.  ``launches``
counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import threading
from collections.abc import Sequence

import numpy as np
import torch

from pilosa_tpu_torch.ops import _build
from pilosa_tpu_torch.ops.bitplane import WORDS_PER_SLICE
from pilosa_tpu_torch.ops.fused_popcount import popcount_words

NAME = "score_planes"
SOURCE = "pilosa_tpu_torch/ops/csrc/score_planes.cu"
REPLACES = "pilosa_tpu/ops/bitplane.py:815"
# Fragments are the grid's y dimension.
MAX_FRAGMENTS = 65535
ROW_BYTES = WORDS_PER_SLICE * 4

# Kernel launches since the last reset (a plain integer: chip_smoke.py
# sets it to 0 before it drives the server and reads it after).
launches = 0
_launch_mu = threading.Lock()

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library(NAME).pilosa_score_planes
        fn.argtypes = [
            ctypes.c_void_p,  # table
            ctypes.c_int,  # fragments
            ctypes.c_int,  # candidate rows per fragment
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(planes: Sequence[torch.Tensor], slots: np.ndarray,
           srcs: Sequence[torch.Tensor]) -> torch.device:
    """The domain both versions accept; returns the planes' device."""
    if not isinstance(slots, np.ndarray) or slots.ndim != 2 or slots.dtype != np.int64:
        raise ValueError("slots must be an int64 [fragments, rows] array")
    n, rows = slots.shape
    if n < 1 or rows < 1:
        raise ValueError(f"need at least one fragment and one row, got {tuple(slots.shape)}")
    if len(planes) != n or len(srcs) != n:
        raise ValueError(f"{len(planes)} planes and {len(srcs)} srcs for {n} fragments")
    device = planes[0].device
    plane_rows = np.empty(n, dtype=np.int64)
    for f, (p, s) in enumerate(zip(planes, srcs)):
        if p.dtype != torch.int32 or p.dim() != 2 or p.shape[1] != WORDS_PER_SLICE:
            raise ValueError(f"plane must be int32 [rows, {WORDS_PER_SLICE}], got "
                             f"{p.dtype} {tuple(p.shape)}")
        if s.dtype != torch.int32 or tuple(s.shape) != (WORDS_PER_SLICE,):
            raise ValueError(f"src must be an int32 [{WORDS_PER_SLICE}] row, got "
                             f"{s.dtype} {tuple(s.shape)}")
        if p.device != device or s.device != device:
            raise ValueError(f"planes and srcs must share one device ({device})")
        if not p.is_contiguous() or not s.is_contiguous():
            raise ValueError("planes and srcs must be contiguous")
        plane_rows[f] = p.shape[0]
    if (slots < -1).any() or (slots >= plane_rows[:, None]).any():
        raise ValueError("slot out of range of its fragment's mirror")
    return device


def plain_score_planes(planes: Sequence[torch.Tensor], slots: np.ndarray,
                       srcs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The plain PyTorch version of :func:`score_planes`: gather each
    fragment's candidate rows, AND its src row, popcount per row, 0 for
    a pad slot."""
    device = _check(planes, slots, srcs)
    out = []
    for p, sl, src in zip(planes, slots, srcs):
        idx = torch.from_numpy(np.maximum(sl, 0)).to(device)
        cnt = popcount_words((p.index_select(0, idx) & src).contiguous())
        out.append(torch.where(torch.from_numpy(sl < 0).to(device), 0, cnt))
    return torch.stack(out)


def score_planes(planes: Sequence[torch.Tensor], slots: np.ndarray,
                 srcs: Sequence[torch.Tensor]) -> torch.Tensor:
    """int32 [F, R] scores ``popcount(planes[f][slots[f, j]] & srcs[f])``
    (0 for a pad slot) — the kernel on CUDA, the plain version on the
    CPU; raises for any other device."""
    global launches
    # The wrapper's own references to the tensors whose addresses it
    # tabulates, held until the launch is enqueued: a caller's list may
    # change, and an evicted mirror's memory is freed with its last
    # reference.
    planes, srcs = tuple(planes), tuple(srcs)
    device = _check(planes, slots, srcs)
    if device.type == "cpu":
        return plain_score_planes(planes, slots, srcs)
    if device.type != "cuda":
        raise ValueError(f"{NAME} runs on cuda or cpu tensors, not {device}")
    n, rows = slots.shape
    if n > MAX_FRAGMENTS:
        raise ValueError(f"{NAME} takes at most {MAX_FRAGMENTS} fragments per launch")
    table = np.empty((n, 2 + rows), dtype=np.int64)
    table[:, 0] = [p.data_ptr() for p in planes]
    table[:, 1] = [s.data_ptr() for s in srcs]
    table[:, 2:] = slots
    if (table[:, :2] % 16).any():
        raise ValueError(f"{NAME} needs 16-byte aligned planes and src rows")
    fn = _kernel()
    # ``planes`` and ``srcs`` hold the tensors until the launch is
    # enqueued; later frees are ordered after it on the stream.
    with torch.cuda.device(device):
        dev_table = torch.from_numpy(table).to(device)
        out = torch.empty(n, rows, dtype=torch.int32, device=device)
        rc = fn(dev_table.data_ptr(), n, rows, out.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {rc}")
    with _launch_mu:
        launches += 1
    return out
