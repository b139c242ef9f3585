"""K3: the multi-query interpreter — many trees over a union leaf set in one pass.

The port's counterpart of ``_build_interp`` / ``interp_exec``
(``pilosa_tpu/exec/plan.py:571,667``): a register machine whose
instruction table is data.  Registers ``0 .. L-1`` are the leaves of a
:class:`~pilosa_tpu_torch.ops.tree_eval.RowTable` (read in place through
its row addresses), register ``L + i`` is instruction ``i``'s result; an
instruction row ``(op, a, b, aux)`` is ``OP_AND`` / ``OP_OR`` /
``OP_ANDNOT`` (``a & ~b``) / ``OP_XOR`` of registers ``a`` and ``b``, or
``OP_MASKW``: all ones where bit 0 of word ``aux`` of register ``a`` is
set (the BSI ripple's predicate mask; ``a`` must be a leaf).  The tables
come from ``exec/plan.py``'s ``FuseEmitter`` / ``lower_expr``, equal to
the JAX package's.  ``out_idx`` selects the ``k`` registers reduced:

* ``"count"``: int32 ``[S, k]`` popcounts;
* ``"row"``: int32 ``[S, k, 32768]`` rows;
* ``"total"``: int64 ``[k]``, each register's popcount over every slice
  (the JAX package returned (hi, lo) int32 limbs).

On the CPU the wrapper runs :func:`plain_interp`, the plain PyTorch
version over int32 bit-views.  On CUDA the host first allocates the table
as the kernel runs it (:func:`allocate`: dead instructions dropped, the
previous result forwarded in registers, a result stored only when a later
instruction reads it from shared memory, registers reused) and picks the
block shape (:func:`launch_plan`), then launches the kernel
(``csrc/interp.cu``, built at first use by ``_build``) or raises — on a
build failure, a launch whose ``cudaGetLastError`` is not 0, a malformed
table (an operand that is not an earlier register, a MASKW whose ``a`` is
not a leaf, a register file past a block's shared memory): there is no
fallback to the plain version.  ``launches`` counts kernel launches, and
nothing else.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from pilosa_tpu_torch.ops import _build
from pilosa_tpu_torch.ops.bitplane import WORDS_PER_SLICE
from pilosa_tpu_torch.ops.fused_popcount import popcount_words
from pilosa_tpu_torch.ops.tree_eval import MAX_SLICES, REDUCES, RowTable

NAME = "interp"
SOURCE = "pilosa_tpu_torch/ops/csrc/interp.cu"
REPLACES = "pilosa_tpu/exec/plan.py:571"
OP_AND, OP_OR, OP_ANDNOT, OP_XOR, OP_MASKW = 0, 1, 2, 3, 4
# The allocated table's own op: an and-not whose operands the allocation
# swapped (``~a & b``), so that its forwarded operand comes first.
OP_NOTAND = 5
# Flags of an allocated instruction's code word (``csrc/interp.cu``): the
# first operand is the previous instruction's result; the result is
# stored to its register; ``code >> EMIT_SHIFT`` is the output index + 1
# (0: none).
FWD, STORE = 1 << 3, 1 << 5
EMIT_SHIFT = 8
# Shared memory a block may take (227 KiB) and an SM holds (228 KiB, less
# 1 KiB the runtime keeps a block), and registers an SM holds, on Hopper;
# the kernel takes at most 56 registers a thread (ptxas, sm_90a).
SMEM_BYTES = 232448
SM_SMEM_BYTES = 233472
BLOCK_RESERVED = 1024
SM_REGS = 65536
KERNEL_REGS = 56
LANES = 32
# The kernel's block shapes: consumer warps, words a lane; and its variant
# that runs the op without a branch (else a switch).
WARPS = (8, 4, 2, 1)
VECS = (8, 4, 2, 1)
BRANCH_FREE = 1
# The shape that takes the least shared memory: check_program accepts a
# table iff it fits there.
NARROWEST = (1, 1)


class Allocation(NamedTuple):
    """A table as the kernel runs it (:func:`allocate`)."""

    ins: np.ndarray  # int32 [n, 4]: (code, a, b, dest)
    masks: np.ndarray  # int32 [n_mask, 2]: maskw (leaf, word)
    lout: np.ndarray  # int32 [n_lout, 2]: leaf outputs (leaf, output)
    n_phys: int  # physical op registers


class Shape(NamedTuple):
    """A launch's block shape, kernel variant and shared memory."""

    warps: int
    vec: int
    variant: int
    smem: int


def smem_bytes(n_leaves: int, n_ops: int, n_phys: int, n_mask: int, n_lout: int, k: int,
               reduce: str, warps: int, vec: int) -> int:
    """A block's shared memory, in bytes (``csrc/interp.cu`` ``layout``,
    which ``pilosa_interp_smem`` returns): the instructions (16 bytes each)
    and the leaf outputs (8); then, 16-byte aligned, two barriers (16), the
    maskw values (16 each: four copies) and a count per (warp, output)
    unless the reduce is row; then, 128-byte aligned, the leaf buffer
    (``n_leaves`` tiles) and the op registers (``n_phys`` tiles), a tile
    being ``warps`` x 32 x ``vec`` words."""
    def up(x: int, a: int) -> int:
        return (x + a - 1) // a * a

    tile = warps * LANES * vec * 4
    bars = up(n_ops * 16 + n_lout * 8, 16)
    cnt = bars + 16 + n_mask * 16
    buf = up(cnt + (warps * k * 4 if reduce != "row" else 0), 128)
    return buf + (n_leaves + n_phys) * tile


def allocate(prog: np.ndarray, out_idx: np.ndarray, n_leaves: int) -> Allocation:
    """The table as the kernel runs it.  Instructions whose result no
    output needs are dropped.  Where an operand is the previous (kept)
    instruction's result, it becomes the first operand (commutative ops
    swap, an and-not becomes ``OP_NOTAND``) and is forwarded (``FWD``, its
    field -1): the kernel holds that result in registers; the second
    operand is always read.  A result is stored (``STORE``, to physical
    register ``dest`` = ``n_leaves + p``) only when a later instruction
    reads it other than forwarded; a register is reused once its last such
    reader ran.  Each output is reduced where it is computed (``code >>
    EMIT_SHIFT`` = output + 1), a leaf output after the program.  A
    maskw's ``b`` is the index of its (leaf, word) pair in ``masks``.
    ``out_idx`` must name distinct registers."""
    rows = prog.tolist()
    emit = {int(r): j for j, r in enumerate(out_idx.tolist())}
    live = [False] * len(rows)
    for r in emit:
        if r >= n_leaves:
            live[r - n_leaves] = True
    for i in reversed(range(len(rows))):
        op, a, b, _aux = rows[i]
        if live[i] and op != OP_MASKW:
            for r in (a, b):
                if r >= n_leaves:
                    live[r - n_leaves] = True
    # The kept instructions, first operand forwarded where it can be.
    kept = []
    prev = -1
    for i in range(len(rows)):
        if not live[i]:
            continue
        op, a, b, aux = rows[i]
        fwd = False
        if op != OP_MASKW and prev in (a, b):
            if a != prev:
                a, b = b, a
                op = OP_NOTAND if op == OP_ANDNOT else op
            fwd = True
        kept.append((i, op, a, b, aux, fwd))
        prev = n_leaves + i
    # Each register's last reader that does not take it forwarded.
    last: dict[int, int] = {}
    for q, (_i, op, a, b, _aux, fwd) in enumerate(kept):
        if op != OP_MASKW:
            for r in (b,) if fwd else (a, b):
                if r >= n_leaves:
                    last[r] = q
    phys: dict[int, int] = {}
    free: list[int] = []
    n_phys = 0
    ins = np.zeros((len(kept), 4), dtype=np.int32)
    masks: list[tuple[int, int]] = []
    for q, (i, op, a, b, aux, fwd) in enumerate(kept):
        code = op
        if op == OP_MASKW:
            fa, fb = a, len(masks)
            masks.append((a, aux))
        else:
            fa = -1 if fwd else (a if a < n_leaves else phys[a])
            fb = b if b < n_leaves else phys[b]
            code |= FWD if fwd else 0
            for r in {a, b}:
                if last.get(r) == q:
                    free.append(phys[r])
        reg = n_leaves + i
        dest = -1
        if reg in last:
            if free:
                dest = free.pop()
            else:
                dest = n_leaves + n_phys
                n_phys += 1
            phys[reg] = dest
            code |= STORE
        if reg in emit:
            code |= (emit[reg] + 1) << EMIT_SHIFT
        ins[q] = (code, fa, fb, dest)
    lout = np.asarray([(r, j) for r, j in emit.items() if r < n_leaves],
                      dtype=np.int32).reshape(-1, 2)
    return Allocation(ins, np.asarray(masks, dtype=np.int32).reshape(-1, 2), lout, n_phys)


def _sizes(alloc: Allocation, n_leaves: int, k: int) -> tuple:
    return n_leaves, len(alloc.ins), alloc.n_phys, len(alloc.masks), len(alloc.lout), k


def launch_plan(alloc: Allocation, n_leaves: int, k: int, reduce: str) -> Shape | None:
    """The block shape and variant a launch of ``alloc`` takes (cached by
    the table's sizes), or None when none fits a block's shared memory.
    The kernel is bound by its SMs (the storm table runs as fast from L2
    as from device memory), so the shape is the one that keeps the most
    words in flight on an SM (resident consumer warps x words a lane, at
    most 8 counted); then at least 4 words a lane, the most resident warps
    up to 8, the most words a lane and the fewest warps a block (more
    blocks, more leaf buffers).  Under 2,048 words in flight the kernel
    waits on latency more than on issue and takes the branch-free op.
    Measured by ``tools/torch_interp_shapes.py``."""
    return _plan(_sizes(alloc, n_leaves, k), reduce)


@functools.lru_cache(maxsize=512)
def _plan(sizes: tuple, reduce: str) -> Shape | None:
    best, best_key = None, None
    for warps in WARPS:
        for vec in VECS:
            smem = smem_bytes(*sizes, reduce, warps, vec)
            if smem > SMEM_BYTES:
                continue
            threads = (warps + 1) * LANES
            per_sm = min(SM_SMEM_BYTES // (smem + BLOCK_RESERVED), 2048 // threads,
                         SM_REGS // (KERNEL_REGS * threads))
            resident = per_sm * warps
            key = (resident * min(vec, 8), min(vec, 4), min(resident, 8), vec, -warps)
            if best_key is None or key > best_key:
                variant = BRANCH_FREE if resident * vec * LANES < 2048 else 0
                best, best_key = Shape(warps, vec, variant, smem), key
    return best


launches = 0
_launch_mu = threading.Lock()

_fn = None


def _lib():
    global _fn
    if _fn is None:
        lib = _build.library(NAME)
        fn = lib.pilosa_interp
        fn.argtypes = [
            ctypes.c_void_p,  # table (int64 [S, L] row addresses)
            ctypes.c_int,  # slices
            ctypes.c_int,  # leaves
            ctypes.c_void_p,  # meta (int32, device: instructions, maskw pairs, leaf outputs)
            ctypes.c_int,  # n_ops
            ctypes.c_int,  # physical op registers
            ctypes.c_int,  # maskw pairs
            ctypes.c_int,  # leaf outputs
            ctypes.c_int,  # k
            ctypes.c_int,  # words per row
            ctypes.c_int,  # reduce
            ctypes.c_int,  # consumer warps a block
            ctypes.c_int,  # words a lane
            ctypes.c_int,  # variant
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        smem = lib.pilosa_interp_smem
        smem.argtypes = [ctypes.c_int] * 9
        smem.restype = ctypes.c_longlong
        _fn = fn, smem
    return _fn


def kernel_smem_bytes(n_leaves: int, n_ops: int, n_phys: int, n_mask: int, n_lout: int, k: int,
                      reduce: str, warps: int, vec: int) -> int:
    """The kernel's own figure for :func:`smem_bytes` (``pilosa_interp_smem``;
    builds the library: on the card only)."""
    return int(_lib()[1](n_leaves, n_ops, n_phys, n_mask, n_lout, k, REDUCES[reduce], warps,
                         vec))


def check_program(prog: np.ndarray, out_idx: np.ndarray, n_leaves: int) -> Allocation:
    """Raise unless ``prog`` (int32 ``[n_ops, 4]``) is a table the kernel
    runs over ``n_leaves`` leaves and ``out_idx`` (int32 ``[k >= 1]``)
    names its registers: its allocation over the distinct registers of
    ``out_idx`` (first seen first) must fit a block's shared memory in the
    narrowest shape.  Returns that allocation (read-only arrays, cached by
    the table's content: a repeated table costs one lookup)."""
    if not isinstance(prog, np.ndarray) or prog.dtype != np.int32 or prog.ndim != 2 \
            or prog.shape[1] != 4:
        raise ValueError("prog must be an int32 [n_ops, 4] array")
    if not isinstance(out_idx, np.ndarray) or out_idx.dtype != np.int32 or out_idx.ndim != 1 \
            or len(out_idx) < 1:
        raise ValueError("out_idx must be an int32 [k >= 1] array")
    return _checked(np.ascontiguousarray(prog).tobytes(), np.ascontiguousarray(out_idx).tobytes(),
                    int(n_leaves))


@functools.lru_cache(maxsize=512)
def _checked(prog_bytes: bytes, out_bytes: bytes, n_leaves: int) -> Allocation:
    prog = np.frombuffer(prog_bytes, dtype=np.int32).reshape(-1, 4)
    out_idx = np.frombuffer(out_bytes, dtype=np.int32)
    n_ops = len(prog)
    if n_ops:
        op, a, b, aux = prog.T
        limit = n_leaves + np.arange(n_ops)
        if ((op < OP_AND) | (op > OP_MASKW)).any():
            raise ValueError("unknown interpreter op")
        if (a < 0).any() or (a >= limit).any() or (b < 0).any() or (b >= limit).any():
            raise ValueError("an operand is not an earlier register")
        mask = op == OP_MASKW
        if (a[mask] >= n_leaves).any():
            raise ValueError("MASKW reads a word of a leaf register only")
        if ((aux[mask] < 0) | (aux[mask] >= WORDS_PER_SLICE)).any():
            raise ValueError("MASKW word outside the row")
    if (out_idx < 0).any() or (out_idx >= n_leaves + n_ops).any():
        raise ValueError("out_idx names no register")
    regs = np.asarray(list(dict.fromkeys(out_idx.tolist())), dtype=np.int32)
    alloc = allocate(prog, regs, n_leaves)
    if smem_bytes(*_sizes(alloc, n_leaves, len(regs)), "count", *NARROWEST) > SMEM_BYTES:
        raise ValueError(f"{n_leaves} leaves and {alloc.n_phys} op registers pass a block's "
                         "shared memory")
    for arr in (alloc.ins, alloc.masks, alloc.lout):
        arr.setflags(write=False)
    return alloc


def plain_interp(reduce: str, table: RowTable, prog: np.ndarray,
                 out_idx: np.ndarray) -> torch.Tensor:
    """The plain PyTorch version of :func:`interp` (same domain, same
    result): the register file as a list of int32 ``[S, 32768]`` rows."""
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce {reduce!r}")
    table.check()
    n, n_leaves, _ = table.shape
    check_program(prog, out_idx, n_leaves)
    regs = [table.leaf_rows(leaf) for leaf in range(n_leaves)]
    for op, a, b, aux in prog.tolist():
        ra, rb = regs[a], regs[b]
        if op == OP_AND:
            v = ra & rb
        elif op == OP_OR:
            v = ra | rb
        elif op == OP_ANDNOT:
            v = ra & ~rb
        elif op == OP_XOR:
            v = ra ^ rb
        else:
            v = (-(ra[:, aux : aux + 1] & 1)).expand(n, WORDS_PER_SLICE).contiguous()
        regs.append(v)
    outs = torch.stack([regs[i] for i in out_idx.tolist()], dim=1)  # [S, k, W]
    if reduce == "row":
        return outs
    counts = popcount_words(outs)  # [S, k]
    if reduce == "count":
        return counts
    return counts.sum(dim=0, dtype=torch.int64)


_metas: OrderedDict = OrderedDict()
_metas_mu = threading.Lock()


def _device_meta(alloc: Allocation, device: torch.device) -> torch.Tensor:
    """The allocation's instructions, maskw pairs and leaf outputs as one
    int32 tensor on ``device``, uploaded once per (allocation, device) and
    kept in a small LRU: a pageable upload at every launch would wait for
    the stream, so no launch could queue behind another."""
    key = (id(alloc), device)
    with _metas_mu:
        hit = _metas.get(key)
        if hit is not None:
            _metas.move_to_end(key)
            return hit[1]
    meta = torch.from_numpy(np.concatenate(
        [alloc.ins.reshape(-1), alloc.masks.reshape(-1), alloc.lout.reshape(-1)])).to(device)
    with _metas_mu:
        # The entry holds the allocation, so its id names it while cached.
        _metas[key] = (alloc, meta)
        while len(_metas) > 512:
            _metas.popitem(last=False)
    return meta


def interp(reduce: str, table: RowTable, prog: np.ndarray, out_idx: np.ndarray,
           shape: Shape | None = None) -> torch.Tensor:
    """The selected registers' reduce over every slice of ``table`` — the
    kernel on CUDA (one launch, in the block shape of :func:`launch_plan`
    unless ``shape`` names one), the plain version on the CPU; raises for
    any other device."""
    global launches
    device = table.device
    if device.type == "cpu":
        return plain_interp(reduce, table, prog, out_idx)
    if device.type != "cuda":
        raise ValueError(f"{NAME} runs on cuda or cpu tensors, not {device}")
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce {reduce!r}")
    table.check()
    n, n_leaves, words = table.shape
    alloc = check_program(prog, out_idx, n_leaves)
    if n > MAX_SLICES:
        raise ValueError(f"{NAME} takes at most {MAX_SLICES} slices per launch")
    # The kernel reduces each register once: repeated selections copy.
    regs = list(dict.fromkeys(out_idx.tolist()))
    k = len(regs)
    if shape is None:
        shape = launch_plan(alloc, n_leaves, k, reduce)
    fn, _ = _lib()
    # ``table`` holds every base whose rows it names until the launch is
    # enqueued; later frees are ordered after it on the stream.
    with torch.cuda.device(device):
        addrs = table.addresses()
        meta = _device_meta(alloc, device)
        if reduce == "row":
            out = torch.empty(n, k, words, dtype=torch.int32, device=device)
        elif reduce == "count":
            out = torch.zeros(n, k, dtype=torch.int32, device=device)
        else:
            out = torch.zeros(k, dtype=torch.int64, device=device)
        rc = fn(addrs.data_ptr(), n, n_leaves, meta.data_ptr(), len(alloc.ins), alloc.n_phys,
                len(alloc.masks), len(alloc.lout), k, words, REDUCES[reduce], shape.warps,
                shape.vec, shape.variant, out.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
        if rc == 0 and k < len(out_idx):
            pick = torch.as_tensor([regs.index(r) for r in out_idx.tolist()], device=device)
            out = out[pick] if reduce == "total" else out[:, pick]
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {rc}")
    with _launch_mu:
        launches += 1
    return out
