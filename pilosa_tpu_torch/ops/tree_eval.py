"""K2: the fused tree eval — one bitmap tree over every slice of a node.

The port's counterpart of the XLA programs ``_eval_expr`` with
``_make_fn`` / ``_build_batched`` / ``_build_total_count``
(``pilosa_tpu/exec/plan.py:179,298,810,779``), which fold an
Intersect/Union/Difference/Xor tree over ``uint32[S, L, 32768]`` leaf
stacks.  The port stacks nothing: the leaves are read in place through a
:class:`RowTable` — for each (slice, leaf) the address of one row, a row
of a fragment's mirror, a scratch row its owner filled, or a shared zero
row — and the tree travels as a postfix program (``exec/plan.py``
``compile_program``, the format K5 takes): an index ``>= 0`` pushes that
leaf's row, ``OP_AND`` / ``OP_OR`` / ``OP_ANDNOT`` / ``OP_XOR`` pop two
and push one (a left fold, in the JAX package's order), ``OP_ZERO``
pushes the empty row.  Reduces:

* ``"count"``: int32 ``[S]`` popcounts of the result rows (a slice-row
  holds at most 2^20 bits, so int32 is exact);
* ``"row"``: the result rows, int32 ``[S, 32768]``;
* ``"total"``: the sum over every slice, int64 ``[1]`` (the card has
  64-bit atomics; the JAX package's (hi, lo) limbs are not needed).

No inner result row is written to memory.  On the CPU the wrapper runs
:func:`plain_tree_eval`, the plain PyTorch version over int32 bit-views.
On CUDA it launches the kernel (``csrc/tree_eval.cu``, built at first use
by ``_build``) or raises — on a build failure, a launch whose
``cudaGetLastError`` is not 0, a program deeper than the kernel's stack
(``MAX_DEPTH``; ``exec/plan.py`` sends such trees to K3): there is no
fallback to the plain version.  ``launches`` counts kernel launches, and
nothing else.
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from collections.abc import Sequence

import numpy as np
import torch

from pilosa_tpu_torch.ops import _build
from pilosa_tpu_torch.ops.anchored_count import OP_AND, OP_ANDNOT, OP_OR, OP_XOR, OP_ZERO
from pilosa_tpu_torch.ops.bitplane import WORDS_PER_SLICE
from pilosa_tpu_torch.ops.fused_popcount import popcount_words

NAME = "tree_eval"
SOURCE = "pilosa_tpu_torch/ops/csrc/tree_eval.cu"
REPLACES = "pilosa_tpu/exec/plan.py:179"
REDUCES = {"count": 0, "row": 1, "total": 2}
# The kernel's operand stack (in shared memory) holds this many rows.
MAX_DEPTH = 8
# Slices are the grid's y dimension.
MAX_SLICES = 65535
ROW_BYTES = WORDS_PER_SLICE * 4

launches = 0
_launch_mu = threading.Lock()

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library(NAME).pilosa_tree_eval
        fn.argtypes = [
            ctypes.c_void_p,  # table (int64 [S, L] row addresses)
            ctypes.c_int,  # slices
            ctypes.c_int,  # leaves
            ctypes.c_void_p,  # program (int32, device)
            ctypes.c_int,  # program length
            ctypes.c_int,  # words per row
            ctypes.c_int,  # reduce
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


class RowTable:
    """The rows a K2 or K3 launch reads in place: slice ``s``, leaf ``l``
    is row ``index[s, l, 1]`` of ``bases[index[s, l, 0]]``.  ``bases`` are
    int32 ``[rows, 32768]`` contiguous tensors on one device (mirrors, an
    owner's scratch rows, a zero row), held by the table so that no row it
    names is freed while it lives.  ``index`` is int64 ``[S, L, 2]`` on the
    host.  ``addrs`` is the table the kernels read — int64 ``[S, L]`` row
    addresses on the card — computed at first use and kept; ``ident``
    names the row set for identity dedup (tables made from one cached
    entry share it).  ``checked`` vouches that the bases already passed
    :meth:`check` (a cached entry's, whose tensors cannot change shape)."""

    __slots__ = ("bases", "index", "addrs", "ident", "checked")

    def __init__(self, bases: Sequence[torch.Tensor], index: np.ndarray,
                 addrs: torch.Tensor | None = None, checked: bool = False):
        self.bases = list(bases)
        self.index = index
        self.addrs = addrs
        self.ident = id(index)  # unique while the table holds ``index``
        self.checked = checked

    @property
    def shape(self) -> tuple[int, int, int]:
        return int(self.index.shape[0]), int(self.index.shape[1]), WORDS_PER_SLICE

    @property
    def device(self) -> torch.device:
        return self.bases[0].device

    def check(self) -> None:
        """Raise unless the table names real rows of its bases."""
        if not self.bases:
            raise ValueError("a row table needs at least one base")
        idx = self.index
        if not isinstance(idx, np.ndarray) or idx.dtype != np.int64 or idx.ndim != 3 \
                or idx.shape[2] != 2 or idx.shape[0] < 1 or idx.shape[1] < 1:
            raise ValueError("index must be an int64 [S >= 1, L >= 1, 2] array")
        dev = self.device
        for b in ([] if self.checked else self.bases):
            if b.dtype != torch.int32 or b.dim() != 2 or b.shape[1] != WORDS_PER_SLICE \
                    or not b.is_contiguous():
                raise ValueError(f"bases must be contiguous int32 [rows, {WORDS_PER_SLICE}]")
            if b.device != dev:
                raise ValueError(f"every base must lie on {dev}")
        rows = np.asarray([b.shape[0] for b in self.bases], dtype=np.int64)
        bi, ri = idx[..., 0], idx[..., 1]
        if bi.min() < 0 or bi.max() >= len(self.bases):
            raise ValueError("index names a base the table does not hold")
        if ri.min() < 0 or (ri >= rows[bi]).any():
            raise ValueError("index names a row past its base")
        self.checked = True

    def addresses(self) -> torch.Tensor:
        """The int64 ``[S, L]`` row addresses on the table's device."""
        if self.addrs is None:
            ptrs = np.asarray([b.data_ptr() for b in self.bases], dtype=np.int64)
            flat = ptrs[self.index[..., 0]] + self.index[..., 1] * ROW_BYTES
            self.addrs = torch.from_numpy(np.ascontiguousarray(flat)).to(self.device)
        return self.addrs

    def leaf_rows(self, leaf: int) -> torch.Tensor:
        """Leaf ``leaf``'s rows over every slice, int32 ``[S, 32768]`` (a
        copy: the plain versions' input)."""
        col = self.index[:, leaf]
        return torch.stack([self.bases[int(b)][int(r)] for b, r in col])

    @staticmethod
    def _merged(tables: Sequence["RowTable"]) -> tuple[list, list[np.ndarray]]:
        bases, parts = [], []
        for t in tables:
            idx = t.index.copy()
            idx[..., 0] += len(bases)
            bases += t.bases
            parts.append(idx)
        return bases, parts

    @staticmethod
    def concat_slices(tables: Sequence["RowTable"]) -> "RowTable":
        """One table over every slice of ``tables`` in turn (same leaves)."""
        bases, parts = RowTable._merged(tables)
        addrs = None
        if all(t.addrs is not None for t in tables):
            addrs = torch.cat([t.addrs for t in tables])
        return RowTable(bases, np.concatenate(parts), addrs)

    @staticmethod
    def concat_leaves(tables: Sequence["RowTable"], cols: Sequence[Sequence[int]]) -> "RowTable":
        """One table over the same slices whose leaves are columns
        ``cols[i]`` of ``tables[i]``, in turn."""
        bases, parts = RowTable._merged(tables)
        index = np.concatenate([p[:, list(c)] for p, c in zip(parts, cols)], axis=1)
        addrs = None
        if all(t.addrs is not None for t in tables):
            addrs = torch.cat([t.addrs[:, list(c)] for t, c in zip(tables, cols)], dim=1)
            addrs = addrs.contiguous()
        return RowTable(bases, index, addrs)


def program_depth(program: Sequence[int], n_leaves: int) -> int:
    """The deepest stack a well-formed postfix ``program`` over
    ``n_leaves`` leaves needs; raises for a malformed one."""
    depth = deepest = 0
    for op in program:
        if op >= 0:
            if op >= n_leaves:
                raise ValueError(f"program reads leaf {op} of {n_leaves}")
            depth += 1
        elif op == OP_ZERO:
            depth += 1
        elif op in (OP_AND, OP_OR, OP_ANDNOT, OP_XOR):
            if depth < 2:
                raise ValueError("program pops an empty stack")
            depth -= 1
        else:
            raise ValueError(f"unknown program op {op}")
        deepest = max(deepest, depth)
    if depth != 1:
        raise ValueError("program must leave exactly one row")
    return deepest


def _check(table: RowTable, program: Sequence[int], reduce: str) -> int:
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce {reduce!r}")
    table.check()
    return program_depth(program, table.shape[1])


def _fold(op: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op == OP_AND:
        return a & b
    if op == OP_OR:
        return a | b
    if op == OP_ANDNOT:
        return a & ~b
    return a ^ b


def plain_tree_eval(table: RowTable, program: Sequence[int], reduce: str) -> torch.Tensor:
    """The plain PyTorch version of :func:`tree_eval` (same domain, same
    result): the leaf rows stacked, folded by torch bitwise ops."""
    _check(table, program, reduce)
    n = table.shape[0]
    rows: dict[int, torch.Tensor] = {}
    stack: list[torch.Tensor] = []
    for op in program:
        if op >= 0:
            if op not in rows:
                rows[op] = table.leaf_rows(op)
            stack.append(rows[op])
        elif op == OP_ZERO:
            stack.append(torch.zeros(n, WORDS_PER_SLICE, dtype=torch.int32, device=table.device))
        else:
            b, a = stack.pop(), stack.pop()
            stack.append(_fold(op, a, b))
    out = stack[0]  # a new tensor: leaf_rows copies
    if reduce == "row":
        return out
    counts = popcount_words(out)
    if reduce == "count":
        return counts
    return counts.sum(dtype=torch.int64).reshape(1)


_programs: OrderedDict = OrderedDict()
_programs_mu = threading.Lock()


def _device_program(program: Sequence[int], device: torch.device) -> torch.Tensor:
    """The program as an int32 tensor on ``device``, uploaded once per
    (program, device) and kept in a small LRU."""
    key = (tuple(int(op) for op in program), device)
    with _programs_mu:
        t = _programs.get(key)
        if t is not None:
            _programs.move_to_end(key)
            return t
    t = torch.tensor(key[0], dtype=torch.int32).to(device)
    with _programs_mu:
        _programs[key] = t
        while len(_programs) > 1024:
            _programs.popitem(last=False)
    return t


def tree_eval(table: RowTable, program: Sequence[int], reduce: str) -> torch.Tensor:
    """The tree's reduce over every slice of ``table`` — the kernel on
    CUDA (one launch), the plain version on the CPU; raises for any other
    device."""
    global launches
    device = table.device
    if device.type == "cpu":
        return plain_tree_eval(table, program, reduce)
    if device.type != "cuda":
        raise ValueError(f"{NAME} runs on cuda or cpu tensors, not {device}")
    depth = _check(table, program, reduce)
    if depth > MAX_DEPTH:
        raise ValueError(f"{NAME}: program needs a stack of {depth} > {MAX_DEPTH}")
    n, n_leaves, words = table.shape
    if n > MAX_SLICES:
        raise ValueError(f"{NAME} takes at most {MAX_SLICES} slices per launch")
    fn = _kernel()
    # ``table`` holds every base whose rows it names until the launch is
    # enqueued; later frees are ordered after it on the stream.
    with torch.cuda.device(device):
        addrs = table.addresses()
        prog = _device_program(program, device)
        if reduce == "row":
            out = torch.empty(n, words, dtype=torch.int32, device=device)
        elif reduce == "count":
            out = torch.zeros(n, dtype=torch.int32, device=device)
        else:
            out = torch.zeros(1, dtype=torch.int64, device=device)
        rc = fn(addrs.data_ptr(), n, n_leaves, prog.data_ptr(), len(program), words,
                REDUCES[reduce], out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {rc}")
    with _launch_mu:
        launches += 1
    return out
