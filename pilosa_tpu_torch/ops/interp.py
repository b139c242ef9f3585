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
version over int32 bit-views.  On CUDA it launches the kernel
(``csrc/interp.cu``, built at first use by ``_build``) or raises — on a
build failure, a launch whose ``cudaGetLastError`` is not 0, a malformed
table (an operand that is not an earlier register, a MASKW whose ``a`` is
not a leaf, a register file past a block's shared memory): there is no
fallback to the plain version.  ``launches`` counts kernel launches, and
nothing else.
"""

from __future__ import annotations

import ctypes
import threading

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
# What a block keeps in shared memory at its narrowest (one word a lane)
# must fit in 227 KiB (``csrc/interp.cu`` ``layout``).
SMEM_BYTES = 232448


def smem_bytes(n_leaves: int, n_ops: int, n_phys: int, n_lout: int, k: int) -> int:
    """The kernel's shared memory at one word a lane, count reduce: the
    instructions with their (dest, emit), the leaf outputs, the row
    addresses, a count per (output, lane), the leaf registers twice and the
    physical op registers."""
    regs = (n_ops * 24 + n_lout * 8 + n_leaves * 8 + k * 32 * 4 + 15) // 16 * 16
    return regs + (2 * n_leaves + n_phys) * 32 * 4


def allocate(prog: np.ndarray, out_idx: np.ndarray, n_leaves: int):
    """The table as the kernel runs it: each op's result in a physical
    register (``n_leaves + p``) reused once its last reader ran, and each
    output reduced where it is computed.  Returns ``(instructions int32
    [n_ops, 4] over physical registers, (dest, emit) int32 [n_ops, 2],
    leaf outputs (leaf, output) int32 [m, 2], physical op registers)``;
    ``out_idx`` must name distinct registers."""
    rows = prog.tolist()
    last: dict[int, int] = {}
    for i, (_op, a, b, _aux) in enumerate(rows):
        last[a] = i
        last[b] = i
    emit = {int(r): j for j, r in enumerate(out_idx.tolist())}
    phys: dict[int, int] = {}
    free: list[int] = []
    n_phys = 0
    ins = np.zeros((len(rows), 4), dtype=np.int32)
    meta = np.zeros((len(rows), 2), dtype=np.int32)
    for i, (op, a, b, aux) in enumerate(rows):
        pa = a if a < n_leaves else phys[a]
        pb = b if b < n_leaves else phys[b]
        for r in {a, b}:
            if r >= n_leaves and last[r] == i:
                free.append(phys[r])
        if free:
            d = free.pop()
        else:
            d = n_leaves + n_phys
            n_phys += 1
        reg = n_leaves + i
        phys[reg] = d
        ins[i] = (op, pa, pb, aux)
        meta[i] = (d, emit.get(reg, -1))
        if reg not in last:
            free.append(d)
    lout = np.asarray([(r, j) for r, j in emit.items() if r < n_leaves],
                      dtype=np.int32).reshape(-1, 2)
    return ins, meta, lout, n_phys


launches = 0
_launch_mu = threading.Lock()

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library(NAME)
        fn = lib.pilosa_interp
        fn.argtypes = [
            ctypes.c_void_p,  # table (int64 [S, L] row addresses)
            ctypes.c_int,  # slices
            ctypes.c_int,  # leaves
            ctypes.c_void_p,  # meta (int32, device: instructions, dest/emit, leaf outputs)
            ctypes.c_int,  # n_ops
            ctypes.c_int,  # physical op registers
            ctypes.c_int,  # leaf outputs
            ctypes.c_int,  # k
            ctypes.c_int,  # words per row
            ctypes.c_int,  # reduce
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_program(prog: np.ndarray, out_idx: np.ndarray, n_leaves: int) -> None:
    """Raise unless ``prog`` (int32 ``[n_ops, 4]``) is a table the kernel
    runs over ``n_leaves`` leaves and ``out_idx`` (int32 ``[k >= 1]``)
    names its registers."""
    if not isinstance(prog, np.ndarray) or prog.dtype != np.int32 or prog.ndim != 2 \
            or prog.shape[1] != 4:
        raise ValueError("prog must be an int32 [n_ops, 4] array")
    if not isinstance(out_idx, np.ndarray) or out_idx.dtype != np.int32 or out_idx.ndim != 1 \
            or len(out_idx) < 1:
        raise ValueError("out_idx must be an int32 [k >= 1] array")
    n_ops = len(prog)
    if smem_bytes(n_leaves, n_ops, n_ops, len(out_idx), len(out_idx)) > SMEM_BYTES:
        raise ValueError(f"{n_leaves + n_ops} registers pass a block's shared memory")
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


def interp(reduce: str, table: RowTable, prog: np.ndarray, out_idx: np.ndarray) -> torch.Tensor:
    """The selected registers' reduce over every slice of ``table`` — the
    kernel on CUDA (one launch), the plain version on the CPU; raises for
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
    check_program(prog, out_idx, n_leaves)
    if n > MAX_SLICES:
        raise ValueError(f"{NAME} takes at most {MAX_SLICES} slices per launch")
    # The kernel reduces each register once: repeated selections copy.
    regs = list(dict.fromkeys(out_idx.tolist()))
    ins, dest, lout, n_phys = allocate(prog, np.asarray(regs, dtype=np.int32), n_leaves)
    k = len(regs)
    fn = _kernel()
    # ``table`` holds every base whose rows it names until the launch is
    # enqueued; later frees are ordered after it on the stream.
    with torch.cuda.device(device):
        addrs = table.addresses()
        meta = torch.from_numpy(np.concatenate(
            [ins.reshape(-1), dest.reshape(-1), lout.reshape(-1)])).to(device)
        if reduce == "row":
            out = torch.empty(n, k, words, dtype=torch.int32, device=device)
        elif reduce == "count":
            out = torch.zeros(n, k, dtype=torch.int32, device=device)
        else:
            out = torch.zeros(k, dtype=torch.int64, device=device)
        rc = fn(addrs.data_ptr(), n, n_leaves, meta.data_ptr(), len(ins), n_phys, len(lout), k,
                words, REDUCES[reduce], out.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
        if rc == 0 and k < len(out_idx):
            pick = torch.as_tensor([regs.index(r) for r in out_idx.tolist()], device=device)
            out = out[pick] if reduce == "total" else out[:, pick]
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {rc}")
    with _launch_mu:
        launches += 1
    return out
