"""K11: the stream-floor read-sum — the int32 sum of a flat uint32 buffer.

The port's counterpart of the XLA program of the stream-floor probe
(``pilosa_tpu/device/floorprobe.py:96``, ``jnp.sum(a.astype(jnp.int32))``
jitted at ``:108``): it reads every word of a buffer once and returns
their sum as int32, wrapping mod 2^32.  ``device/floorprobe.py`` times it
to measure how fast the card streams device memory — the denominator of
every launch site's ``floorPct`` on ``/debug/perf``.

``stream_sum(x)`` takes a 1-D int32 or uint32 tensor (uint32 words are
read through their int32 bit-view) and returns a 0-d int32 tensor on
``x``'s device; nothing waits for the card.  On a CPU tensor the wrapper
runs :func:`plain_stream_sum`, the plain PyTorch version (an int64 sum
whose low 32 bits are read as int32).  On a CUDA tensor it launches the
kernel (``csrc/stream_sum.cu``, built at first use by ``_build``) or
raises: there is no fallback to the plain version.  ``launches`` counts
kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from pilosa_tpu_torch.ops import _build

NAME = "stream_sum"
SOURCE = "pilosa_tpu_torch/ops/csrc/stream_sum.cu"
REPLACES = "pilosa_tpu/device/floorprobe.py:96"

launches = 0
_launch_mu = threading.Lock()

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library(NAME).pilosa_stream_sum
        fn.argtypes = [
            ctypes.c_void_p,  # words
            ctypes.c_longlong,  # n_words
            ctypes.c_void_p,  # out (one uint32, zeroed)
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _words(x: torch.Tensor) -> torch.Tensor:
    """The domain both versions accept: a non-empty contiguous 1-D int32
    or uint32 tensor, returned as its int32 view."""
    if x.dim() != 1 or x.numel() < 1:
        raise ValueError(f"stream_sum takes a non-empty 1-D tensor, got {tuple(x.shape)}")
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    if x.dtype != torch.int32:
        raise ValueError(f"stream_sum takes int32 or uint32 words, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("stream_sum needs a contiguous tensor")
    return x


def plain_stream_sum(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the int64 sum, its low 32 bits as a
    0-d int32 tensor (two's complement, so the sum wraps as the
    kernel's)."""
    low = _words(x).sum(dtype=torch.int64) & 0xFFFFFFFF
    return torch.where(low >= 1 << 31, low - (1 << 32), low).to(torch.int32)


def library_stream_sum(x: torch.Tensor) -> torch.Tensor:
    """PyTorch's own reduction of the same function (timed beside the
    kernel on the card; not used by the port)."""
    return torch.sum(_words(x), dtype=torch.int32)


def stream_sum(x: torch.Tensor) -> torch.Tensor:
    """0-d int32 sum of ``x``'s words mod 2^32 — the kernel on CUDA, the
    plain version on the CPU; raises for any other device."""
    global launches
    w = _words(x)
    if w.device.type == "cpu":
        return plain_stream_sum(w)
    if w.device.type != "cuda":
        raise ValueError(f"stream_sum runs on cuda or cpu tensors, not {w.device}")
    if w.data_ptr() % 16:
        raise ValueError("stream_sum needs a 16-byte aligned tensor")
    fn = _kernel()
    with torch.cuda.device(w.device):
        out = torch.zeros((), dtype=torch.int32, device=w.device)
        rc = fn(w.data_ptr(), w.numel(), out.data_ptr(),
                torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stream_sum launch failed: cudaError {rc}")
    with _launch_mu:
        launches += 1
    return out
