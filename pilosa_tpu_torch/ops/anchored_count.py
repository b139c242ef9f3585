"""K5: the anchored position-domain Count, every slice of a node in one launch.

The port's counterpart of ``_build_anchored`` / ``anchored_count_exec``
(``pilosa_tpu/exec/plan.py:855-934``) over ``membership_dense`` /
``membership_sparse`` / ``membership_rle``
(``pilosa_tpu/ops/bitplane.py:429-453``)::

    out[s] = #{p in anchor_s : tree(member(leaf_0, p), ..., member(leaf_L-1, p))}

The anchors are host arrays — ``positions`` (uint32, each slice's
anchor ascending) and CSR ``offsets`` (int64 ``[S + 1]``).  ``leaves[s]
[i]`` is leaf i's row in slice s: ``(fmt, tensor)`` with an int32 bit-view
tensor of the real entries (a dense row — typically a view of a
fragment's mirror, read in place —, sorted positions, or ``[R, 2]`` runs),
or None for an absent row, which is never a member.  ``program`` is the
tree in postfix (:func:`compile_program` in ``exec/plan.py`` builds it):
an index ``>= 0`` pushes that leaf's membership, ``OP_AND`` / ``OP_OR`` /
``OP_ANDNOT`` / ``OP_XOR`` pop two and push one, ``OP_ZERO`` pushes an
empty set.  Formats are values, not compile keys: any mix of formats and
lengths goes in one launch.

On the CPU the wrapper runs :func:`plain_anchored_count` (the plain
PyTorch version over ``bitplane.membership``).  On CUDA it launches the
kernel (``csrc/anchored_count.cu``, built at first use by ``_build``)
or raises — on a build failure, on a launch whose ``cudaGetLastError``
is not 0, on a malformed program or leaf: there is no fallback to the
plain version.  ``launches`` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import threading
from collections.abc import Sequence

import numpy as np
import torch

from pilosa_tpu_torch.ops import _build
from pilosa_tpu_torch.ops import bitplane as bp
from pilosa_tpu_torch.ops.expand_payload import entries

NAME = "anchored_count"
SOURCE = "pilosa_tpu_torch/ops/csrc/anchored_count.cu"
REPLACES = "pilosa_tpu/exec/plan.py:855"
OP_AND, OP_OR, OP_ANDNOT, OP_XOR, OP_ZERO = -1, -2, -3, -4, -5
# The kernel's stack of membership masks holds 64.
MAX_DEPTH = 64
# Slices are the grid's y dimension.
MAX_SLICES = 65535

launches = 0
_launch_mu = threading.Lock()

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library(NAME).pilosa_anchored_count
        fn.argtypes = [
            ctypes.c_void_p,  # meta
            ctypes.c_int,  # slices
            ctypes.c_int,  # leaves
            ctypes.c_int,  # program length
            ctypes.c_int,  # largest anchor
            ctypes.c_void_p,  # positions
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_program(program: Sequence[int], n_leaves: int) -> None:
    """Raise unless ``program`` is a well-formed postfix tree over
    ``n_leaves`` leaves that fits the kernel's stack."""
    depth = 0
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
        if depth > MAX_DEPTH:
            raise ValueError(f"program deeper than {MAX_DEPTH}")
    if depth != 1:
        raise ValueError("program must leave exactly one set")


def _check(program, positions, offsets, leaves, device) -> None:
    if not isinstance(offsets, np.ndarray) or offsets.dtype != np.int64 or offsets.ndim != 1:
        raise ValueError("offsets must be an int64 [slices + 1] array")
    n = len(offsets) - 1
    if n < 1 or len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaf lists for {n} slices")
    if not isinstance(positions, np.ndarray) or positions.dtype != np.uint32:
        raise ValueError("positions must be a uint32 array")
    if offsets[0] != 0 or offsets[-1] != len(positions) or (np.diff(offsets) < 0).any():
        raise ValueError("offsets must run from 0 to len(positions), ascending")
    if len(positions) and int(positions.max()) >= bp.SLICE_WIDTH:
        raise ValueError("anchor position outside the slice")
    n_leaves = len(leaves[0])
    if n_leaves < 1 or any(len(row) != n_leaves for row in leaves):
        raise ValueError("every slice must list the same leaves")
    check_program(program, n_leaves)
    for row in leaves:
        for leaf in row:
            if leaf is None:
                continue
            fmt, t = leaf
            if entries(fmt, t) > bp.SLICE_WIDTH:
                raise ValueError("a leaf holds more entries than a slice has positions")
            if t.device != device:
                raise ValueError(f"leaves must lie on {device}")


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def plain_anchored_count(program: Sequence[int], positions: np.ndarray, offsets: np.ndarray,
                         leaves, device: torch.device | str) -> torch.Tensor:
    """The plain PyTorch version of :func:`anchored_count`."""
    device = _device(device)
    _check(program, positions, offsets, leaves, device)
    out = torch.zeros(len(leaves), dtype=torch.int32, device=device)
    for s, row in enumerate(leaves):
        lo, hi = int(offsets[s]), int(offsets[s + 1])
        if lo == hi:
            continue
        pos = torch.from_numpy(positions[lo:hi].astype(np.int64)).to(device)
        stack: list[torch.Tensor] = []
        for op in program:
            if op >= 0:
                leaf = row[op]
                stack.append(torch.zeros(pos.shape, dtype=torch.bool, device=device)
                             if leaf is None else bp.membership(leaf[0], leaf[1], pos))
            elif op == OP_ZERO:
                stack.append(torch.zeros(pos.shape, dtype=torch.bool, device=device))
            else:
                b, a = stack.pop(), stack.pop()
                stack.append(a & b if op == OP_AND else a | b if op == OP_OR
                             else a & ~b if op == OP_ANDNOT else a ^ b)
        out[s] = int(stack[0].sum())
    return out


def anchored_count(program: Sequence[int], positions: np.ndarray, offsets: np.ndarray,
                   leaves, device: torch.device | str) -> torch.Tensor:
    """int32 [S] anchored counts — the kernel on CUDA (one launch), the
    plain version on the CPU; raises for any other device."""
    global launches
    device = torch.device(device)
    if device.type == "cpu":
        return plain_anchored_count(program, positions, offsets, leaves, device)
    if device.type != "cuda":
        raise ValueError(f"{NAME} runs on cuda or cpu tensors, not {device}")
    device = _device(device)
    # The wrapper's own references to every leaf tensor whose address it
    # tabulates, held until the launch is enqueued: a caller's list may
    # change, and an evicted mirror's memory is freed with its last
    # reference.
    leaves = tuple(tuple(row) for row in leaves)
    _check(program, positions, offsets, leaves, device)
    n, n_leaves = len(leaves), len(leaves[0])
    if n > MAX_SLICES:
        raise ValueError(f"{NAME} takes at most {MAX_SLICES} slices per launch")
    widest = int(np.diff(offsets).max())
    if widest < 1:
        raise ValueError(f"{NAME} needs at least one anchor position")
    meta = np.zeros(n + 1 + 3 * n * n_leaves + len(program), dtype=np.int64)
    meta[: n + 1] = offsets
    table = meta[n + 1 : n + 1 + 3 * n * n_leaves].reshape(n, n_leaves, 3)
    for s, row in enumerate(leaves):
        for i, leaf in enumerate(row):
            if leaf is not None:
                fmt, t = leaf
                table[s, i] = (fmt, t.data_ptr(), entries(fmt, t))
    meta[n + 1 + 3 * n * n_leaves :] = program
    fn = _kernel()
    # ``leaves`` holds the leaf tensors until the launch is enqueued;
    # later frees (and K7's later patches of a mirror) are ordered after it
    # on the stream.
    with torch.cuda.device(device):
        dev_meta = torch.from_numpy(meta).to(device)
        dev_pos = torch.from_numpy(np.ascontiguousarray(positions).view(np.int32)).to(device)
        out = torch.zeros(n, dtype=torch.int32, device=device)
        rc = fn(dev_meta.data_ptr(), n, n_leaves, len(program), widest, dev_pos.data_ptr(),
                out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {rc}")
    with _launch_mu:
        launches += 1
    return out
