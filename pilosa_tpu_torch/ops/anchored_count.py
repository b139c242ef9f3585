"""K5: the anchored position-domain Count, every slice of a node in one launch.

The port's counterpart of ``_build_anchored`` / ``anchored_count_exec``
(``pilosa_tpu/exec/plan.py:855-934``) over ``membership_dense`` /
``membership_sparse`` / ``membership_rle``
(``pilosa_tpu/ops/bitplane.py:429-453``)::

    out[s] = #{p in A_s : tree(member(leaf_0, p), ..., member(leaf_L-1, p))}

``leaves[s][i]`` is leaf i's row in slice s: ``(fmt, tensor)`` with an
int32 bit-view tensor of the real entries (a dense row — typically a view
of a fragment's mirror, read in place —, sorted positions, or ``[R, 2]``
runs), or None for an absent row, which is never a member.  The anchor
``A_s`` is one of them: ``anchor_leaf`` (int32 ``[S]``) names, for each
slice, the leaf whose set it is, or -1 for a slice that counts 0; it may
be a leaf the program does not read.  ``program`` is the tree in postfix
(:func:`compile_program` in ``exec/plan.py`` builds it): an index ``>= 0``
pushes that leaf's membership, ``OP_AND`` / ``OP_OR`` / ``OP_ANDNOT`` /
``OP_XOR`` pop two and push one, ``OP_ZERO`` pushes an empty set.
Formats are values, not compile keys: any mix of formats and lengths goes
in one launch.  Nothing but the table goes up per call: ``S x L x 3``
int64 leaf entries, the anchor indices and the program.

On the CPU the wrapper runs :func:`plain_anchored_count` (the plain
PyTorch version over ``bitplane.membership``).  On CUDA it launches the
kernel (``csrc/anchored_count.cu``, built at first use by ``_build``)
or raises — on a build failure, on a launch whose ``cudaGetLastError``
is not 0, on a malformed program, anchor or leaf: there is no fallback to
the plain version.  ``launches`` counts kernel launches, and nothing else.
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
# The kernel's stack of window bitmaps holds 64.
MAX_DEPTH = 64
# Slices are the grid's y dimension.
MAX_SLICES = 65535
# A block's window of words, the largest whose stack fits in shared memory.
WINDOW_WORDS = (1024, 512)
MAX_SMEM = 232448

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
            ctypes.c_int,  # stack depth
            ctypes.c_int,  # window words
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # cudaStream_t
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_program(program: Sequence[int], n_leaves: int) -> int:
    """Raise unless ``program`` is a well-formed postfix tree over
    ``n_leaves`` leaves that fits the kernel's stack; returns its depth."""
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
        if depth > MAX_DEPTH:
            raise ValueError(f"program deeper than {MAX_DEPTH}")
        deepest = max(deepest, depth)
    if depth != 1:
        raise ValueError("program must leave exactly one set")
    return deepest


def smem_bytes(window_words: int, n_leaves: int, n_prog: int, depth: int) -> int:
    """A block's shared memory (``csrc/anchored_count.cu``: smem_bytes):
    barriers and long runs, the slice's leaf table and ranges, the program, the
    anchor's window, a ring of three staging buffers of half a window and
    16 bytes, and ``depth`` window bitmaps."""
    def align16(x):
        return (x + 15) // 16 * 16

    return (320 + align16(24 * n_leaves) + align16(8 * n_leaves) + align16(4 * n_prog)
            + 4 * window_words + 3 * (2 * window_words + 16) + 4 * window_words * depth)


def window_words(n_leaves: int, n_prog: int, depth: int) -> int:
    """The largest window whose block fits in shared memory."""
    for w in WINDOW_WORDS:
        if smem_bytes(w, n_leaves, n_prog, depth) <= MAX_SMEM:
            return w
    raise ValueError(f"{n_leaves} leaves and {n_prog} ops at depth {depth} do not fit a "
                     "block's shared memory")


def _table(program, anchor_leaf, leaves, device) -> tuple[np.ndarray, list[int], int]:
    """Check every argument in one pass over the leaves; returns the
    anchors (int64 [S]), the flat leaf table ``[(fmt, address, entries)
    per slice and leaf]`` and the program's depth."""
    anchor = np.asarray(anchor_leaf)
    n = len(leaves)
    if anchor.ndim != 1 or len(anchor) != n or (n and anchor.dtype.kind not in "iu"):
        raise ValueError(f"anchor_leaf must be an int array of one index per slice ({n})")
    if n < 1:
        raise ValueError("no slices")
    n_leaves = len(leaves[0])
    if n_leaves < 1:
        raise ValueError("every slice must list the same leaves")
    anchor = anchor.astype(np.int64)
    if int(anchor.min()) < -1 or int(anchor.max()) >= n_leaves:
        raise ValueError(f"an anchor names no leaf of {n_leaves}")
    depth = check_program(program, n_leaves)
    flat: list[int] = []
    for row in leaves:
        if len(row) != n_leaves:
            raise ValueError("every slice must list the same leaves")
        for leaf in row:
            if leaf is None:
                flat.extend((0, 0, 0))
                continue
            fmt, t = leaf
            k = entries(fmt, t)
            if k > bp.SLICE_WIDTH:
                raise ValueError("a leaf holds more entries than a slice has positions")
            if t.device != device:
                raise ValueError(f"leaves must lie on {device}")
            flat.extend((fmt, t.data_ptr(), k))
    return anchor, flat, depth


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def plain_anchored_count(program: Sequence[int], anchor_leaf, leaves,
                         device: torch.device | str) -> torch.Tensor:
    """The plain PyTorch version of :func:`anchored_count`: each slice's
    anchor expanded to positions on the host, each leaf's membership by
    ``bitplane.membership``."""
    device = _device(device)
    anchor, _, _ = _table(program, anchor_leaf, leaves, device)
    out = torch.zeros(len(leaves), dtype=torch.int32, device=device)
    for s, row in enumerate(leaves):
        a = int(anchor[s])
        if a < 0 or row[a] is None:
            continue
        fmt, t = row[a]
        pos = bp.np_row_to_columns(bp.decode_payload(fmt, bp.to_host(t)))
        if not len(pos):
            continue
        pos = torch.from_numpy(pos.astype(np.int64)).to(device)
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


def anchored_count(program: Sequence[int], anchor_leaf, leaves,
                   device: torch.device | str) -> torch.Tensor:
    """int32 [S] anchored counts — the kernel on CUDA (one launch), the
    plain version on the CPU; raises for any other device."""
    global launches
    device = torch.device(device)
    if device.type == "cpu":
        return plain_anchored_count(program, anchor_leaf, leaves, device)
    if device.type != "cuda":
        raise ValueError(f"{NAME} runs on cuda or cpu tensors, not {device}")
    device = _device(device)
    # The wrapper's own references to every leaf tensor whose address it
    # tabulates, held until the launch is enqueued: a caller's list may
    # change, and an evicted mirror's memory is freed with its last
    # reference.
    leaves = tuple(tuple(row) for row in leaves)
    anchor, flat, depth = _table(program, anchor_leaf, leaves, device)
    n, n_leaves = len(leaves), len(leaves[0])
    if n > MAX_SLICES:
        raise ValueError(f"{NAME} takes at most {MAX_SLICES} slices per launch")
    words = window_words(n_leaves, len(program), depth)
    fn = _kernel()
    # ``leaves`` holds the leaf tensors until the launch is enqueued;
    # later frees (and K7's later patches of a mirror) are ordered after it
    # on the stream.
    with torch.cuda.device(device):
        # Pinned, so the upload is queued on the stream and the host goes
        # on; the caching host allocator keeps the buffer until it is read.
        meta = torch.empty(n + len(flat) + len(program), dtype=torch.int64, pin_memory=True)
        m = meta.numpy()
        m[:n] = anchor
        m[n : n + len(flat)] = flat
        m[n + len(flat) :] = program
        dev_meta = meta.to(device, non_blocking=True)
        out = torch.zeros(n, dtype=torch.int32, device=device)
        rc = fn(dev_meta.data_ptr(), n, n_leaves, len(program), depth, words, out.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {rc}")
    with _launch_mu:
        launches += 1
    return out
