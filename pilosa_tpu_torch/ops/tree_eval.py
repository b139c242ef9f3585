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
fallback to the plain version.  A program of at most ``MAX_PUSH`` leaf
pushes runs in the kernel's fast variant, resolved once on the host into
fixed register slots (:func:`resolve`); a longer one in its general
variant, from device memory.  ``launches`` counts kernel launches, and
nothing else.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from collections import OrderedDict
from collections.abc import Sequence
from typing import NamedTuple

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
# The kernel's operand stack holds this many rows.
MAX_DEPTH = 8
# Leaf pushes of the kernel's fast variant (one register slot each).
MAX_PUSH = 8
# Slices per launch (K3 shares the limit).
MAX_SLICES = 65535
# The resolved program (``resolve``): P, leaf[8], then op, a and b [7] each
# from these offsets (the layout ``pilosa_tree_eval`` reads).
_OPS, _AS, _BS = 1 + MAX_PUSH, MAX_PUSH * 2, MAX_PUSH * 3 - 1
_SLOTS_LEN = 1 + MAX_PUSH + 3 * (MAX_PUSH - 1)
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
            ctypes.c_void_p,  # slots (int32, host: the fast variant) or None
            ctypes.c_void_p,  # program (int32, device: the general variant) or None
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
    int32 ``[rows, words]`` contiguous tensors on one device (mirrors, an
    owner's scratch rows, a zero row: ``words`` is 32,768; the mesh
    functions' plane stacks may be narrower), held by the table so that no row it
    names is freed while it lives.  ``index`` is int64 ``[S, L, 2]`` on the
    host.  ``addrs`` is the table the kernels read — int64 ``[S, L]`` row
    addresses on the card — computed at first use and kept; ``ident``
    names the row set for identity dedup (tables made from one cached
    entry share it).

    ``checked`` is True once the table passed the full :meth:`check` —
    its bases and its index — or when its maker vouches for both: a
    batch entry's table (checked when the entry was built; its tensors
    cannot change shape) and a concatenation of checked tables (their
    own indices, shifted by construction).  :meth:`check` returns at once
    on a checked table, so K2's and K3's wrappers walk no base of one.  A
    table made unchecked is checked in full when a wrapper first takes
    it: an index past its base would be a wild read on the card."""

    __slots__ = ("bases", "index", "addrs", "ident", "checked", "words")

    def __init__(self, bases: Sequence[torch.Tensor], index: np.ndarray,
                 addrs: torch.Tensor | None = None, checked: bool = False,
                 words: int = WORDS_PER_SLICE):
        self.bases = list(bases)
        self.index = index
        self.addrs = addrs
        self.ident = id(index)  # unique while the table holds ``index``
        self.checked = checked
        self.words = int(words)

    @property
    def shape(self) -> tuple[int, int, int]:
        return int(self.index.shape[0]), int(self.index.shape[1]), self.words

    @property
    def device(self) -> torch.device:
        return self.bases[0].device

    def check(self) -> None:
        """Raise unless the table names real rows of its bases (nothing to
        do on a checked table)."""
        if self.checked:
            return
        if not self.bases:
            raise ValueError("a row table needs at least one base")
        idx = self.index
        if not isinstance(idx, np.ndarray) or idx.dtype != np.int64 or idx.ndim != 3 \
                or idx.shape[2] != 2 or idx.shape[0] < 1 or idx.shape[1] < 1:
            raise ValueError("index must be an int64 [S >= 1, L >= 1, 2] array")
        dev = self.device
        for b in self.bases:
            if b.dtype != torch.int32 or b.dim() != 2 or b.shape[1] != self.words \
                    or not b.is_contiguous():
                raise ValueError(f"bases must be contiguous int32 [rows, {self.words}]")
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
            flat = ptrs[self.index[..., 0]] + self.index[..., 1] * (self.shape[2] * 4)
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
        """One table over every slice of ``tables`` in turn (same leaves);
        checked when every part is."""
        bases, parts = RowTable._merged(tables)
        addrs = None
        if all(t.addrs is not None for t in tables):
            addrs = torch.cat([t.addrs for t in tables])
        return RowTable(bases, np.concatenate(parts), addrs,
                        checked=all(t.checked for t in tables), words=tables[0].words)

    @staticmethod
    def concat_leaves(tables: Sequence["RowTable"], cols: Sequence[Sequence[int]]) -> "RowTable":
        """One table over the same slices whose leaves are columns
        ``cols[i]`` of ``tables[i]``, in turn; checked when every part is."""
        bases, parts = RowTable._merged(tables)
        index = np.concatenate([p[:, list(c)] for p, c in zip(parts, cols)], axis=1)
        addrs = None
        if all(t.addrs is not None for t in tables):
            addrs = torch.cat([t.addrs[:, list(c)] for t, c in zip(tables, cols)], dim=1)
            addrs = addrs.contiguous()
        return RowTable(bases, index, addrs, checked=all(t.checked for t in tables),
                        words=tables[0].words)


class ShardedTable:
    """A batch over a mesh: ``tables[i]`` is the K2/K3 row table of
    member ``members[i]`` (one device a table, its mirrors homed there),
    and the batch's slice order is the concatenation of the tables;
    ``leaf_keys[i]`` are table i's per-column row identities.  ``layout``
    names the members and their devices: batches group in one launch
    only under the same layout."""

    __slots__ = ("members", "tables", "leaf_keys", "layout")

    def __init__(self, members, tables, leaf_keys=None):
        self.members = tuple(int(m) for m in members)
        self.tables = list(tables)
        self.leaf_keys = list(leaf_keys) if leaf_keys is not None else [None] * len(tables)
        self.layout = tuple((m, str(t.device)) for m, t in zip(self.members, self.tables))

    @property
    def shape(self) -> tuple:
        _, leaves, words = self.tables[0].shape
        return sum(t.shape[0] for t in self.tables), leaves, words


class Program(NamedTuple):
    """A checked postfix program as the kernel takes it (:func:`resolve`)."""

    depth: int  # the deepest stack it needs
    slots: object  # the fast variant's ctypes int array, or None (general)


def program_depth(program: Sequence[int], n_leaves: int) -> int:
    """The deepest stack a well-formed postfix ``program`` over
    ``n_leaves`` leaves needs; raises for a malformed one."""
    return _program(tuple(int(op) for op in program), int(n_leaves)).depth


@functools.lru_cache(maxsize=1024)
def _program(program: tuple, n_leaves: int) -> Program:
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
    resolved = resolve(program)
    slots = None
    if resolved is not None:
        slots = (ctypes.c_int * len(resolved))(*resolved.tolist())
    return Program(deepest, slots)


def resolve(program: Sequence[int]) -> np.ndarray | None:
    """The fast variant's form of a well-formed postfix program, or None
    past ``MAX_PUSH`` pushes: push ``k`` (a leaf, or -1 for the empty row)
    fills register slot ``k``, and step ``j`` sets slot ``a[j]`` to
    ``slot a[j] op[j] slot b[j]`` — the value under the top of the stack
    lives in the slot of its first push, so ``a < b`` and the result is
    slot 0.  int32 ``[P, leaf[8], op[7], a[7], b[7]]``, unused entries 0."""
    pushes: list[int] = []
    steps: list[tuple[int, int, int]] = []
    stack: list[int] = []
    for op in program:
        if op >= 0 or op == OP_ZERO:
            stack.append(len(pushes))
            pushes.append(op if op >= 0 else -1)
        else:
            b = stack.pop()
            steps.append((op, stack[-1], b))
    if len(pushes) > MAX_PUSH:
        return None
    out = np.zeros(_SLOTS_LEN, dtype=np.int32)
    out[0] = len(pushes)
    out[1 : 1 + len(pushes)] = pushes
    for j, (op, a, b) in enumerate(steps):
        out[_OPS + j], out[_AS + j], out[_BS + j] = op, a, b
    return out


def _check(table: RowTable, program: tuple, reduce: str) -> Program:
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce {reduce!r}")
    table.check()
    return _program(program, table.shape[1])


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
    _check(table, tuple(int(op) for op in program), reduce)
    n = table.shape[0]
    rows: dict[int, torch.Tensor] = {}
    stack: list[torch.Tensor] = []
    for op in program:
        if op >= 0:
            if op not in rows:
                rows[op] = table.leaf_rows(op)
            stack.append(rows[op])
        elif op == OP_ZERO:
            stack.append(torch.zeros(n, table.shape[2], dtype=torch.int32, device=table.device))
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


def _device_program(program: tuple, device: torch.device) -> torch.Tensor:
    """The program as an int32 tensor on ``device`` (the general variant
    reads it there), uploaded once per (program, device) and kept in a
    small LRU."""
    key = (program, device)
    with _programs_mu:
        t = _programs.get(key)
        if t is not None:
            _programs.move_to_end(key)
            return t
    t = torch.tensor(program, dtype=torch.int32).to(device)
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
    if not isinstance(program, tuple):
        program = tuple(int(op) for op in program)
    prog = _check(table, program, reduce)
    if prog.depth > MAX_DEPTH:
        raise ValueError(f"{NAME}: program needs a stack of {prog.depth} > {MAX_DEPTH}")
    n, n_leaves, words = table.shape
    if n > MAX_SLICES:
        raise ValueError(f"{NAME} takes at most {MAX_SLICES} slices per launch")
    fn = _kernel()
    # ``table`` holds every base whose rows it names until the launch is
    # enqueued; later frees are ordered after it on the stream.
    with torch.cuda.device(device):
        addrs = table.addresses()
        dev_prog = None if prog.slots is not None else _device_program(program, device)
        if reduce == "row":
            out = torch.empty(n, words, dtype=torch.int32, device=device)
        else:  # the launcher zeroes it on the stream
            out = torch.empty(n if reduce == "count" else 1,
                              dtype=torch.int32 if reduce == "count" else torch.int64,
                              device=device)
        rc = fn(addrs.data_ptr(), n, n_leaves,
                None if prog.slots is None else ctypes.addressof(prog.slots),
                None if dev_prog is None else dev_prog.data_ptr(), len(program), words,
                REDUCES[reduce], out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {rc}")
    with _launch_mu:
        launches += 1
    return out
