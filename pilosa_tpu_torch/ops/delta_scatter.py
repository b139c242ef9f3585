"""K7: delta-scatter of folded write deltas into resident planes.

The port's counterpart of the jitted XLA program ``plan._build_scatter``
(``pilosa_tpu/exec/plan.py:814``), which ``ingest.scatter.apply`` drives:
for each entry ``i``,
``plane[i][word[i]] = (plane[i][word[i]] & ~andnot[i]) | or[i]``
on the int32 bit-view of the uint32 plane words, IN PLACE (the JAX
program returned a new array; ``core/fragment.py`` says why readers
still see old-or-new).

One launch serves any number of planes (a *batch*).
``delta_scatter_many(planes, job, word, or_m, andnot_m)`` takes the
planes — 2-D contiguous int32 tensors on one device, no two sharing
memory — and per entry its plane's index ``job`` (int32), the word's
index in that plane's flat words ``word`` (uint32: slot x width + word)
and the two masks (uint32), sorted by ``(job, word)`` with no pair
twice, as ``ingest.scatter.fold_many`` gives them.  They are checked on
the host once and go to the card in ONE copy of one int64 buffer
(:func:`pack`): the planes' addresses, then the entries as 16-byte
``(job, word, or, andnot)`` records.

``delta_scatter(plane, slots, words, or_m, andnot_m)`` — the interface
of one plane, entries in any order with one per (slot, word) — is the
one-job case of the same kernel.

On CPU planes the wrappers run the plain PyTorch version (a gather, the
bitwise op and an ``index_put_`` per plane).  On CUDA planes they
launch the CUDA kernel (``csrc/delta_scatter.cu``, built at first use by
``_build``) or raise: there is no fallback to the plain version.
``launches`` counts kernel launches, and nothing else.
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

# The kernel indexes a plane's words with 32 bits.
MAX_PLANE_WORDS = 1 << 32


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library(NAME).pilosa_delta_scatter_many
        fn.argtypes = [
            ctypes.c_void_p,  # int64 buffer: addresses, then entries
            ctypes.c_longlong,  # planes (jobs)
            ctypes.c_longlong,  # entries
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_planes(planes) -> torch.device:
    """The batch's one device; raises unless every plane is a 2-D
    contiguous int32 tensor on it and no two planes share memory."""
    if not planes:
        raise ValueError("a batch needs at least one plane")
    device = planes[0].device
    spans = []
    for p in planes:
        if p.dtype != torch.int32 or p.dim() != 2:
            raise ValueError(f"plane must be a 2-D int32 tensor, got {p.dtype} {tuple(p.shape)}")
        if not p.is_contiguous():
            raise ValueError("plane must be contiguous")
        if p.device != device:
            raise ValueError(f"planes on {device} and {p.device} in one batch")
        if p.numel() > MAX_PLANE_WORDS:
            raise ValueError(f"plane of {p.numel()} words: past the kernel's 32-bit index")
        if device.type != "meta":
            spans.append((p.data_ptr(), p.data_ptr() + 4 * p.numel()))
    spans.sort()
    for (_, end), (start, _) in zip(spans, spans[1:]):
        if start < end:
            raise ValueError("two planes of a batch share memory: merge their queues")
    return device


def pack(planes, job, word, or_m, andnot_m) -> np.ndarray:
    """Check a batch — the domain both versions accept — and lay out its
    launch buffer (int64): the planes' addresses, their count padded to
    even so the records start on 16 bytes, then one ``(job, word, or
    bit-view, andnot bit-view)`` record of four 32-bit fields per entry
    (:func:`records` views them).  Sortedness is checked first: it makes
    the job and word bounds a check of each job's last entry."""
    arrays = [np.asarray(a) for a in (job, word, or_m, andnot_m)]
    n = len(arrays[0])
    for name, a, kind in zip(("job", "word", "or_m", "andnot_m"), arrays, "iuuu"):
        if a.ndim != 1 or len(a) != n:
            raise ValueError(f"{name} must be 1-D of length {n}, got shape {a.shape}")
        if a.dtype.kind != kind or a.dtype.itemsize != 4:
            raise ValueError(f"{name} must be {'int32' if kind == 'i' else 'uint32'}, got {a.dtype}")
    j, w = arrays[0], arrays[1]
    if n:
        key = (j.astype(np.int64) << 32) | w
        if n > 1 and not (key[1:] > key[:-1]).all():
            raise ValueError("entries must be sorted by (job, word), each once: fold them first")
        if j[0] < 0 or j[-1] >= len(planes):
            raise ValueError(f"job out of range [0, {len(planes)})")
        ends = np.searchsorted(j, np.arange(1, len(planes) + 1))
        full = np.flatnonzero(ends > np.concatenate(([0], ends[:-1])))
        sizes = np.asarray([planes[k].numel() for k in full.tolist()], dtype=np.int64)
        if (w[ends[full] - 1].astype(np.int64) >= sizes).any():
            raise ValueError("word out of range of its plane")
    n_addr = (len(planes) + 1) & ~1
    buf = np.zeros(n_addr + 2 * n, dtype=np.int64)
    buf[: len(planes)] = [p.data_ptr() for p in planes]
    rec = buf[n_addr:].view(np.int32).reshape(n, 4)
    for k, a in enumerate(arrays):
        rec[:, k] = a.view(np.int32)
    return buf


def records(buf: np.ndarray, n_jobs: int) -> np.ndarray:
    """The int32 ``[n, 4]`` records of a launch buffer of ``n_jobs``."""
    return buf[(n_jobs + 1) & ~1 :].view(np.int32).reshape(-1, 4)


def plain_delta_scatter_many(planes, job, word, or_m, andnot_m) -> None:
    """The plain PyTorch version of the kernel (same domain, same result,
    in place): per plane, gather the words, apply the masks,
    ``index_put_``."""
    _check_planes(planes)
    e = records(pack(planes, job, word, or_m, andnot_m), len(planes))
    bounds = np.searchsorted(e[:, 0], np.arange(len(planes) + 1))
    for k, plane in enumerate(planes):
        lo, hi = int(bounds[k]), int(bounds[k + 1])
        if lo == hi:
            continue
        t = torch.from_numpy(e[lo:hi]).to(plane.device)
        idx = t[:, 1].long() & 0xFFFFFFFF
        flat = plane.view(-1)
        flat.index_put_((idx,), (flat[idx] & ~t[:, 3]) | t[:, 2])


def delta_scatter_many(planes, job, word, or_m, andnot_m) -> None:
    """Apply a batch's entries to its planes in place: ONE kernel launch
    on CUDA planes, the plain version on CPU planes; raises for any
    other device."""
    # The wrapper's own references to the planes whose addresses it packs,
    # held until the launch is enqueued: a caller's list may change, and an
    # evicted mirror's memory is freed with its last reference.
    planes = tuple(planes)
    device = _check_planes(planes)
    if device.type == "cpu":
        plain_delta_scatter_many(planes, job, word, or_m, andnot_m)
        return
    if device.type != "cuda":
        raise ValueError(f"delta_scatter runs on cuda or cpu tensors, not {device}")
    buf = pack(planes, job, word, or_m, andnot_m)
    n = len(records(buf, len(planes)))
    if n:
        launch_many(upload(buf, device), len(planes), n)


def upload(buf: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host-to-device copy of a launch buffer.  It is made from
    pageable memory without a stream sync: CUDA stages the buffer before
    the call returns, so the host array may go."""
    return torch.from_numpy(buf).to(device, non_blocking=True)


def launch_many(buf: torch.Tensor, n_jobs: int, n: int) -> None:
    """One kernel launch over a launch buffer already on the card
    (``chip_smoke.py`` times this call alone)."""
    global launches
    if buf.device.type != "cuda" or buf.dtype != torch.int64 or not buf.is_contiguous():
        raise ValueError("the buffer must be a contiguous int64 cuda tensor")
    if n_jobs <= 0 or buf.numel() < ((n_jobs + 1) & ~1) + 2 * n:
        raise ValueError(f"buffer of {buf.numel()} words too small for {n_jobs} jobs, {n} entries")
    if not n:
        return  # nothing to launch
    fn = _kernel()
    with torch.cuda.device(buf.device):
        rc = fn(buf.data_ptr(), n_jobs, n, torch.cuda.current_stream(buf.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"delta_scatter launch failed: cudaError {rc}")
    with _launch_mu:
        launches += 1


def _one_job(plane: torch.Tensor, slots, words, or_m, andnot_m):
    """One plane's entries — int32 slots and words, uint32 masks, any
    order, one per (slot, word) — as a sorted one-job batch."""
    _check_planes([plane])
    arrays = [np.asarray(a) for a in (slots, words, or_m, andnot_m)]
    n = len(arrays[0])
    for name, a, kind in zip(("slots", "words", "or_m", "andnot_m"), arrays, "iiuu"):
        if a.ndim != 1 or len(a) != n:
            raise ValueError(f"{name} must be 1-D of length {n}, got shape {a.shape}")
        if a.dtype.kind != kind or a.dtype.itemsize != 4:
            raise ValueError(f"{name} must be {'int32' if kind == 'i' else 'uint32'}, got {a.dtype}")
    rows, width = plane.shape
    s, w = arrays[0].astype(np.int64), arrays[1].astype(np.int64)
    if n and (s.min() < 0 or s.max() >= rows):
        raise ValueError(f"slot out of range [0, {rows})")
    if n and (w.min() < 0 or w.max() >= width):
        raise ValueError(f"word out of range [0, {width})")
    key = s * width + w
    order = np.argsort(key, kind="stable")
    return ([plane], np.zeros(n, np.int32), key[order].astype(np.uint32),
            arrays[2][order], arrays[3][order])


def plain_delta_scatter(plane: torch.Tensor, slots, words, or_m, andnot_m) -> None:
    """The plain version of :func:`delta_scatter`."""
    plain_delta_scatter_many(*_one_job(plane, slots, words, or_m, andnot_m))


def delta_scatter(plane: torch.Tensor, slots, words, or_m, andnot_m) -> None:
    """Apply one plane's entries in place: the one-job case of
    :func:`delta_scatter_many`."""
    delta_scatter_many(*_one_job(plane, slots, words, or_m, andnot_m))


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
