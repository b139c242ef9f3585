"""K7: delta-scatter of folded point-write deltas into a resident plane.

The port's counterpart of the jitted XLA program ``plan._build_scatter``
(``pilosa_tpu/exec/plan.py:814``), which ``ingest.scatter.apply`` drives:
for each entry ``i``,
``plane[slots[i], words[i]] = (plane[slots[i], words[i]] & ~andnot[i]) | or[i]``,
on the int32 bit-view of the uint32 plane words, IN PLACE (the JAX
program returned a new array; ``core/fragment.py`` says why readers
still see old-or-new).

``delta_scatter(plane, slots, words, or_m, andnot_m)`` takes the plane
as a tensor and the entries as host arrays (``ingest.scatter.fold``'s
output): slots and words int32, the masks uint32.  The entries are
checked on the host — lengths, bounds, one entry per (slot, word) —
and copied to the plane's device as one int32 ``[4, n]`` tensor.

On a CPU plane the wrapper runs :func:`plain_delta_scatter`, the plain
PyTorch version (a gather, the bitwise op and an ``index_put_``).  On a
CUDA plane it launches the CUDA kernel (``csrc/delta_scatter.cu``,
built at first use by ``_build``) or raises: there is no fallback to the
plain version.  ``launches`` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from pilosa_tpu_torch.ops import _build

NAME = "delta_scatter"
SOURCE = "pilosa_tpu_torch/ops/csrc/delta_scatter.cu"
REPLACES = "pilosa_tpu/exec/plan.py:814"

# Kernel launches since the last reset (a plain integer, as in
# fused_popcount: chip_smoke.py sets it to 0 and reads it).
launches = 0
_launch_mu = threading.Lock()

_fn = None
_noop = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library(NAME).pilosa_delta_scatter
        fn.argtypes = [
            ctypes.c_void_p,  # plane
            ctypes.c_longlong,  # rows
            ctypes.c_longlong,  # words per row
            ctypes.c_void_p,  # slots
            ctypes.c_void_p,  # words
            ctypes.c_void_p,  # or masks
            ctypes.c_void_p,  # andnot masks
            ctypes.c_longlong,  # n
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(plane: torch.Tensor, slots, words, or_m, andnot_m) -> np.ndarray:
    """The domain both versions accept; returns the entries packed as an
    int32 [4, n] host array (slots, words, or bit-view, andnot
    bit-view)."""
    if plane.dtype != torch.int32 or plane.dim() != 2:
        raise ValueError(
            f"plane must be a 2-D int32 tensor, got {plane.dtype} {tuple(plane.shape)}"
        )
    if not plane.is_contiguous():
        raise ValueError("plane must be contiguous")
    rows, width = plane.shape
    arrays = [np.asarray(a) for a in (slots, words, or_m, andnot_m)]
    n = len(arrays[0])
    for name, a, kinds in zip(
        ("slots", "words", "or_m", "andnot_m"), arrays, ("i", "i", "u", "u")
    ):
        if a.ndim != 1 or len(a) != n:
            raise ValueError(f"{name} must be 1-D of length {n}, got shape {a.shape}")
        if a.dtype.kind != kinds or a.dtype.itemsize != 4:
            want = "int32" if kinds == "i" else "uint32"
            raise ValueError(f"{name} must be {want}, got {a.dtype}")
    s, w = arrays[0], arrays[1]
    if n:
        if s.min() < 0 or s.max() >= rows:
            raise ValueError(f"slot out of range [0, {rows})")
        if w.min() < 0 or w.max() >= width:
            raise ValueError(f"word out of range [0, {width})")
        key = s.astype(np.int64) * width + w
        if len(np.unique(key)) != n:
            raise ValueError("entries must be unique per (slot, word): fold them first")
    packed = np.empty((4, n), dtype=np.int32)
    packed[0], packed[1] = s, w
    packed[2], packed[3] = arrays[2].view(np.int32), arrays[3].view(np.int32)
    return packed


def plain_delta_scatter(plane: torch.Tensor, slots, words, or_m, andnot_m) -> None:
    """The plain PyTorch version of the kernel (same domain, same result,
    in place): gather the words, apply the masks, ``index_put_``."""
    packed = _check(plane, slots, words, or_m, andnot_m)
    if not packed.shape[1]:
        return
    e = torch.from_numpy(packed).to(plane.device)
    idx = e[0].long() * plane.shape[1] + e[1].long()
    flat = plane.view(-1)
    cur = flat[idx]
    flat.index_put_((idx,), (cur & ~e[3]) | e[2])


def delta_scatter(plane: torch.Tensor, slots, words, or_m, andnot_m) -> None:
    """Apply the entries to ``plane`` in place — the kernel on CUDA, the
    plain version on the CPU; raises for any other device."""
    if plane.device.type == "cpu":
        plain_delta_scatter(plane, slots, words, or_m, andnot_m)
        return
    if plane.device.type != "cuda":
        raise ValueError(f"delta_scatter runs on cuda or cpu tensors, not {plane.device}")
    packed = _check(plane, slots, words, or_m, andnot_m)
    if packed.shape[1]:
        launch(plane, torch.from_numpy(packed).to(plane.device))


def launch(plane: torch.Tensor, entries: torch.Tensor) -> None:
    """One kernel launch over checked entries already on the card: an
    int32 [4, n] tensor on the plane's device (``delta_scatter`` makes
    it; ``chip_smoke.py`` times this call alone)."""
    global launches
    if entries.device != plane.device or entries.dtype != torch.int32:
        raise ValueError("entries must be int32 on the plane's device")
    if entries.dim() != 2 or entries.shape[0] != 4 or not entries.is_contiguous():
        raise ValueError("entries must be a contiguous [4, n] tensor")
    if not entries.shape[1]:
        return  # nothing to launch
    fn = _kernel()
    with torch.cuda.device(plane.device):
        rc = fn(
            plane.data_ptr(),
            plane.shape[0],
            plane.shape[1],
            entries[0].data_ptr(),
            entries[1].data_ptr(),
            entries[2].data_ptr(),
            entries[3].data_ptr(),
            entries.shape[1],
            torch.cuda.current_stream(plane.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"delta_scatter launch failed: cudaError {rc}")
    with _launch_mu:
        launches += 1


def noop_launch(device: torch.device) -> None:
    """Launch one empty kernel on ``device``'s current stream: the
    launch-latency floor that bounds this kernel (measured beside it)."""
    global _noop
    if _noop is None:
        fn = _build.library(NAME).pilosa_noop_launch
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _noop = fn
    with torch.cuda.device(device):
        rc = _noop(torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"noop launch failed: cudaError {rc}")
