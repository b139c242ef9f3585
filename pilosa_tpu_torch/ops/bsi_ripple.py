"""K8: the BSI ripple — comparison, Sum and Min/Max over an integer
field's bit-planes, read in place from the field fragments' mirrors.

The port's counterpart of the jitted XLA programs that
``pilosa_tpu/exec/plan.py:183-210`` builds from
``pilosa_tpu/bsi/ripple.py``: three CUDA kernels in
``csrc/bsi_ripple.cu`` (built at first use by ``_build``), one per
function —

* :func:`bsi_cmp` — ``signed_cmp`` / ``between_row``: the result row of
  every slice (int32 ``[S, 32768]``, row mode) or its popcount (int32
  ``[S]``, count mode);
* :func:`bsi_sum` — ``sum_vec``: int32 ``[S, 2 * bucket + 1]``;
* :func:`bsi_minmax` — ``minmax_vec``: int32 ``[S, bucket + 2]``;

each in the JAX package's bucket layout.  Their input is a
:class:`FieldPlanes`: for each of S slices the field fragment's mirror
and the mirror rows of exists, sign and every magnitude bit — the
kernels read the planes where they live, instead of a stacked copy as
large as what they read.  A comparison predicate is a Python int whose
magnitude fits the field's depth (``bsi.clamp_predicate`` /
``clamp_between`` make it so).

On CPU mirrors each wrapper runs its plain PyTorch version
(``plain_*``: the planes gathered into stacks, zero pad planes to the
bucket, and ``bsi/ripple.py`` run as written).  On CUDA mirrors it
launches its kernel or raises — on a build failure, on a launch whose
``cudaGetLastError`` is not 0, on any input the kernel does not take:
there is no fallback to the plain version.  ``launches[name]`` counts
the launches of each kernel, and nothing else.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import numpy as np
import torch

from pilosa_tpu_torch import bsi
from pilosa_tpu_torch.bsi import ripple
from pilosa_tpu_torch.ops import _build
from pilosa_tpu_torch.ops.bitplane import WORDS_PER_SLICE

NAME = "bsi_ripple"
SOURCE = "pilosa_tpu_torch/ops/csrc/bsi_ripple.cu"
KERNELS = ("bsi_cmp", "bsi_sum", "bsi_minmax")
# The JAX function each kernel computes, inside the XLA program that
# pilosa_tpu/exec/plan.py:183-210 builds per op kind.
REPLACES = {
    "bsi_cmp": "pilosa_tpu/bsi/ripple.py:44",
    "bsi_sum": "pilosa_tpu/bsi/ripple.py:85",
    "bsi_minmax": "pilosa_tpu/bsi/ripple.py:102",
}
CMP_OPS = {"lt": 0, "le": 1, "eq": 2, "ne": 3, "ge": 4, "gt": 5, "between": 6}
# Grid rows of the comparison and Sum kernels are slices (gridDim.y).
MAX_SLICES = 65535

# Kernel launches since the last reset, per kernel (plain integers:
# chip_smoke.py sets them to 0 before it drives the server and reads them
# after).
launches = dict.fromkeys(KERNELS, 0)
_launch_mu = threading.Lock()

_fns: dict = {}


@dataclass
class FieldPlanes:
    """One integer field's planes over S slices, read in place.

    ``mirrors[s]`` is slice s's field fragment mirror (int32
    ``[rows, 32768]``) or None where the slice has no such fragment;
    ``slots`` is int64 ``[S, 2 + depth]``: the mirror row of exists,
    sign and magnitude bit k, -1 for a row the fragment does not hold
    (read as zero).  ``bucket`` (>= depth) sets the layout of the
    aggregate vectors; ``device`` is where the planes live.  Checked
    once, when made; the kernels' table of mirror addresses is built
    on the card at the first launch and kept (:meth:`table`).

    A cached batch makes its FieldPlanes anew for every query from the
    mirrors it still holds: ``addrs`` passes the table it built (and
    checked) once, so that such a FieldPlanes is neither walked nor
    uploaded again."""

    mirrors: list
    slots: np.ndarray
    bucket: int
    device: torch.device
    addrs: torch.Tensor | None = None

    def __post_init__(self) -> None:
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._table = self.addrs
        if self._table is not None:
            self._held = tuple(self.mirrors)
            return
        slots = self.slots
        if not isinstance(slots, np.ndarray) or slots.ndim != 2 or slots.dtype != np.int64:
            raise ValueError("slots must be an int64 [S, 2 + depth] array")
        n, depth = self.n, self.depth
        if n < 1 or not 1 <= depth <= bsi.MAX_DEPTH:
            raise ValueError(
                f"need S >= 1 slices and depth in [1, {bsi.MAX_DEPTH}], got {n}, {depth}")
        if self.bucket < depth:
            raise ValueError(f"bucket {self.bucket} < depth {depth}")
        if len(self.mirrors) != n:
            raise ValueError(f"{len(self.mirrors)} mirrors for {n} slices")
        rows = np.zeros(n, dtype=np.int64)  # mirror rows per slice (0: no mirror)
        for s, m in enumerate(self.mirrors):
            if m is None:
                continue
            if m.dtype != torch.int32 or m.dim() != 2 or m.shape[1] != WORDS_PER_SLICE:
                raise ValueError(f"mirror must be int32 [rows, {WORDS_PER_SLICE}], got "
                                 f"{m.dtype} {tuple(m.shape)}")
            if m.device != self.device:
                raise ValueError(f"mirror on {m.device}, planes declared on {self.device}")
            if not m.is_contiguous():
                raise ValueError("mirrors must be contiguous")
            rows[s] = m.shape[0]
        if (slots < -1).any() or (slots >= rows[:, None]).any():
            raise ValueError("slot out of range of its slice's mirror (or no mirror)")

    @property
    def depth(self) -> int:
        return self.slots.shape[1] - 2

    @property
    def n(self) -> int:
        return self.slots.shape[0]

    def table(self) -> torch.Tensor:
        """int64 [S, 3 + depth] on the card: each slice's mirror address,
        then its slots.  The FieldPlanes keeps its own references to the
        tabulated mirrors (and so their memory) for as long as it holds
        the table, whatever becomes of the caller's list."""
        if self._table is None:
            held = tuple(self.mirrors)
            t = np.empty((self.n, 3 + self.depth), dtype=np.int64)
            t[:, 0] = [0 if m is None else m.data_ptr() for m in held]
            t[:, 1:] = self.slots
            self._table = torch.from_numpy(t).to(self.device)
            self._held = held
        return self._table


def _check_filter(fp: FieldPlanes, filt: torch.Tensor | None) -> None:
    if filt is None:
        return
    if filt.dtype != torch.int32 or tuple(filt.shape) != (fp.n, WORDS_PER_SLICE):
        raise ValueError(f"filter must be int32 [{fp.n}, {WORDS_PER_SLICE}], got "
                         f"{filt.dtype} {tuple(filt.shape)}")
    if filt.device != torch.device(fp.device) or not filt.is_contiguous():
        raise ValueError("filter must be contiguous on the planes' device")


def _check_pred(fp: FieldPlanes, op: str, lo: int, hi: int | None) -> None:
    if op not in CMP_OPS:
        raise ValueError(f"unknown BSI comparison op {op!r}")
    window = (1 << fp.depth) - 1
    values = (lo, hi) if op == "between" else (lo,)
    if op == "between" and hi is None:
        raise ValueError("between needs lo and hi")
    for v in values:
        if isinstance(v, bool) or not isinstance(v, int) or abs(v) > window:
            raise ValueError(f"predicate {v!r} outside the depth-{fp.depth} window; clamp it")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _gather(fp: FieldPlanes):
    """(exists, sign, planes) as int32 [S, 32768] stacks, the magnitude
    planes padded with zero planes to the bucket."""
    rows = []
    zero = torch.zeros(fp.depth + 2, WORDS_PER_SLICE, dtype=torch.int32, device=fp.device)
    for m, slots in zip(fp.mirrors, fp.slots):
        if m is None:
            rows.append(zero)
            continue
        idx = torch.from_numpy(np.maximum(slots, 0)).to(fp.device)
        got = m.index_select(0, idx)
        absent = torch.from_numpy(slots < 0).to(fp.device)
        rows.append(torch.where(absent[:, None], zero, got))
    stack = torch.stack(rows, dim=1)  # [2 + depth, S, W]
    pad = torch.zeros(fp.bucket - fp.depth, fp.n, WORDS_PER_SLICE, dtype=torch.int32,
                      device=fp.device)
    planes = list(stack[2:]) + list(pad)
    return stack[0], stack[1], planes


def _pred(value: int, bucket: int, device) -> torch.Tensor:
    return torch.from_numpy(bsi.pred_row(value, bucket).view(np.int32)).to(device)


def plain_bsi_cmp(fp: FieldPlanes, op: str, lo: int, hi: int | None = None,
                  count: bool = False) -> torch.Tensor:
    """The plain version of :func:`bsi_cmp`: ``ripple.signed_cmp`` /
    ``between_row`` over the gathered planes and packed predicate rows."""
    _check_pred(fp, op, lo, hi)
    exists, sign, planes = _gather(fp)
    pred = _pred(lo, fp.bucket, fp.device)
    if op == "between":
        row = ripple.between_row(exists, sign, planes, pred, _pred(hi, fp.bucket, fp.device))
    else:
        row = ripple.signed_cmp(op, exists, sign, planes, pred)
    return ripple.popcount(row) if count else row


def plain_bsi_sum(fp: FieldPlanes, filt: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of :func:`bsi_sum` (``ripple.sum_vec``)."""
    _check_filter(fp, filt)
    exists, sign, planes = _gather(fp)
    return ripple.sum_vec(exists, sign, planes, filt)


def plain_bsi_minmax(fp: FieldPlanes, which: str, filt: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of :func:`bsi_minmax` (``ripple.minmax_vec``)."""
    _check_filter(fp, filt)
    if which not in ("min", "max"):
        raise ValueError(f"which must be 'min' or 'max', got {which!r}")
    exists, sign, planes = _gather(fp)
    return ripple.minmax_vec(which, exists, sign, planes, filt)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = _build.library(NAME)
        fn = getattr(lib, f"pilosa_{name}")
        common = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]  # table, stride, depth
        if name == "bsi_cmp":
            fn.argtypes = common + [
                ctypes.c_int,  # slices
                ctypes.c_int,  # op
                ctypes.c_uint64, ctypes.c_int,  # lo magnitude, negative
                ctypes.c_uint64, ctypes.c_int,  # hi magnitude, negative
                ctypes.c_int,  # count mode
                ctypes.c_void_p,  # out
                ctypes.c_void_p,  # cudaStream_t
            ]
        elif name == "bsi_sum":
            fn.argtypes = common + [
                ctypes.c_int, ctypes.c_int,  # bucket, slices
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # filter, out, stream
            ]
        else:
            fn.argtypes = common + [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bucket, slices, which_max
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # filter, out, stream
            ]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _on_cuda(fp: FieldPlanes, filt: torch.Tensor | None = None) -> bool:
    """True to launch, False for the plain version (CPU planes); raises
    for any other device or a shape the kernels do not take."""
    dev = torch.device(fp.device)
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{NAME} runs on cuda or cpu tensors, not {dev}")
    if fp.n > MAX_SLICES:
        raise ValueError(f"{NAME} takes at most {MAX_SLICES} slices per launch")
    for m in fp.mirrors:
        if m is not None and m.data_ptr() % 16:
            raise ValueError(f"{NAME} needs 16-byte aligned mirrors")
    if filt is not None and filt.data_ptr() % 16:
        raise ValueError(f"{NAME} needs a 16-byte aligned filter")
    return True


def _count(name: str) -> None:
    with _launch_mu:
        launches[name] += 1


def bsi_cmp(fp: FieldPlanes, op: str, lo: int, hi: int | None = None,
            count: bool = False) -> torch.Tensor:
    """Signed comparison ``v <op> lo`` (or ``lo <= v <= hi`` for op
    ``between``) of every slice's valued columns: int32 [S, 32768] result
    rows, or with ``count`` their int32 [S] popcounts."""
    _check_pred(fp, op, lo, hi)
    if not _on_cuda(fp):
        return plain_bsi_cmp(fp, op, lo, hi, count)
    fn = _kernel("bsi_cmp")
    hi = 0 if hi is None else hi
    with torch.cuda.device(fp.device):
        table = fp.table()
        if count:
            out = torch.zeros(fp.n, dtype=torch.int32, device=fp.device)
        else:
            out = torch.empty(fp.n, WORDS_PER_SLICE, dtype=torch.int32, device=fp.device)
        rc = fn(table.data_ptr(), 3 + fp.depth, fp.depth, fp.n, CMP_OPS[op],
                abs(lo), int(lo < 0), abs(hi), int(hi < 0), int(count), out.data_ptr(),
                torch.cuda.current_stream(fp.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bsi_cmp launch failed: cudaError {rc}")
    _count("bsi_cmp")
    return out


def bsi_sum(fp: FieldPlanes, filt: torch.Tensor | None = None) -> torch.Tensor:
    """Sum partials per slice, int32 [S, 2 * bucket + 1]; ``filt`` an
    optional int32 [S, 32768] row per slice."""
    _check_filter(fp, filt)
    if not _on_cuda(fp, filt):
        return plain_bsi_sum(fp, filt)
    fn = _kernel("bsi_sum")
    with torch.cuda.device(fp.device):
        table = fp.table()
        out = torch.zeros(fp.n, 2 * fp.bucket + 1, dtype=torch.int32, device=fp.device)
        rc = fn(table.data_ptr(), 3 + fp.depth, fp.depth, fp.bucket, fp.n,
                None if filt is None else filt.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(fp.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bsi_sum launch failed: cudaError {rc}")
    _count("bsi_sum")
    return out


def bsi_minmax(fp: FieldPlanes, which: str, filt: torch.Tensor | None = None) -> torch.Tensor:
    """Min (``which="min"``) or Max partials per slice, int32
    [S, bucket + 2]; ``filt`` an optional int32 [S, 32768] row per
    slice."""
    _check_filter(fp, filt)
    if which not in ("min", "max"):
        raise ValueError(f"which must be 'min' or 'max', got {which!r}")
    if not _on_cuda(fp, filt):
        return plain_bsi_minmax(fp, which, filt)
    fn = _kernel("bsi_minmax")
    with torch.cuda.device(fp.device):
        table = fp.table()
        out = torch.empty(fp.n, fp.bucket + 2, dtype=torch.int32, device=fp.device)
        rc = fn(table.data_ptr(), 3 + fp.depth, fp.depth, fp.bucket, fp.n,
                int(which == "max"), None if filt is None else filt.data_ptr(),
                out.data_ptr(), torch.cuda.current_stream(fp.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bsi_minmax launch failed: cudaError {rc}")
    _count("bsi_minmax")
    return out
