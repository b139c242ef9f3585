"""The BSI ripple — comparison, Sum, and Min/Max over bit-planes: the
plain PyTorch version of the CUDA kernel K8 (``ops/bsi_ripple.py``).

The counterpart of ``pilosa_tpu/bsi/ripple.py:21-155,226-246`` with
``xp=torch`` on int32 bit-views of the plane words: the same and/andnot/
or cascade, operation for operation, so a result row or partial vector
here is byte-identical to the JAX package's (``tests/test_torch_bsi.py``
holds them against ``plan.compiled_batched`` and ``plan.eval_expr_np``).
Rows may carry leading batch dimensions (``[S, W]`` for S slices): every
popcount reduces the last axis only, and per-slice decisions broadcast
over it.  Predicates arrive as packed rows (:func:`pilosa_tpu_torch.bsi.pred_row`
as int32).  The coalescer's interpreter emitters
(``pilosa_tpu/bsi/ripple.py:158-224``) are not part of the port.
"""

from __future__ import annotations

import torch

from pilosa_tpu_torch.ops.fused_popcount import popcount_words


def popcount(x: torch.Tensor) -> torch.Tensor:
    """int32 popcount of an int32 bit-view over its last axis."""
    return popcount_words(x.contiguous())


def _bit_mask(word: torch.Tensor) -> torch.Tensor:
    """int32 word (0/1 in bit 0) -> all-ones/all-zeros int32 mask."""
    return -(word & 1)


def _where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``where`` with a per-slice condition broadcast over the words."""
    while cond.dim() < a.dim():
        cond = cond.unsqueeze(-1)
    return torch.where(cond, a, b)


def magnitude_cmp(exists, planes, pred_bits):
    """Range-encoded ripple: partition the ``exists`` columns into
    (lt, eq, gt) against the unsigned magnitude whose bit ``k`` is
    ``pred_bits[k] & 1``.  High plane to low: columns still equal on
    every higher bit split on the current one."""
    eq = exists
    lt = torch.zeros_like(exists)
    gt = torch.zeros_like(exists)
    for k in reversed(range(len(planes))):
        b = planes[k]
        m = _bit_mask(pred_bits[k])
        lt = lt | (eq & ~b & m)
        gt = gt | (eq & b & ~m)
        eq = eq & (b ^ ~m)
    return lt, eq, gt


def signed_cmp(op, exists, sign, planes, pred):
    """One signed comparison row.  ``pred`` is a packed predicate row
    (bit ``k`` of the magnitude at word ``k``, sign flag at word
    ``len(planes)``); ``op`` is lt/le/eq/ne/ge/gt.  Sign-magnitude
    composition: the magnitude partition applies to the matching sign
    group, with ordering inverted among negatives; the predicate's sign
    selects between the two cases as a mask."""
    depth = len(planes)
    lt, eq, gt = magnitude_cmp(exists, planes, pred[:depth])
    nm = _bit_mask(pred[depth])  # all-ones iff the predicate is negative
    pos = exists & ~sign
    neg = exists & sign

    eq_row = (~nm & pos & eq) | (nm & neg & eq)
    if op == "eq":
        return eq_row
    if op == "ne":
        return exists & ~eq_row
    lt_row = (~nm & (neg | (pos & lt))) | (nm & neg & gt)
    if op == "lt":
        return lt_row
    if op == "le":
        return lt_row | eq_row
    gt_row = (~nm & pos & gt) | (nm & (pos | (neg & lt)))
    if op == "gt":
        return gt_row
    if op == "ge":
        return gt_row | eq_row
    raise ValueError(f"unknown BSI comparison op {op!r}")


def between_row(exists, sign, planes, pred_lo, pred_hi):
    """``lo <= v <= hi`` as two ripples over the same planes."""
    return signed_cmp("ge", exists, sign, planes, pred_lo) & signed_cmp(
        "le", exists, sign, planes, pred_hi
    )


def sum_vec(exists, sign, planes, filt):
    """Per-slice Sum partials: int32 ``[..., 2D + 1]`` =
    ``[pos_0..pos_{D-1}, neg_0..neg_{D-1}, n]``, where ``pos_k`` /
    ``neg_k`` count set bits of plane ``k`` among non-negative /
    negative valued columns and ``n`` counts valued columns; the
    weighted sum ``Σ 2^k (pos_k - neg_k)`` finishes on the host in
    Python ints (:func:`decode_sum`)."""
    base = exists if filt is None else exists & filt
    pos = base & ~sign
    neg = base & sign
    parts = [popcount(p & pos) for p in planes]
    parts += [popcount(p & neg) for p in planes]
    parts.append(popcount(base))
    return torch.stack(parts, dim=-1)


def minmax_vec(which, exists, sign, planes, filt):
    """Per-slice Min/Max partials via greedy plane descent: int32
    ``[..., D + 2]`` = ``[bit_0..bit_{D-1}, negative, count]`` — the
    chosen magnitude bits, whether the extreme is negative, and how many
    columns hold it (count 0 = no valued column in the slice).

    Min prefers the negative group (where the LARGEST magnitude wins),
    Max the non-negative group (largest magnitude wins too): one descent
    maximizing within the preferred group, or minimizing within the
    other group when the preferred one is empty."""
    base = exists if filt is None else exists & filt
    pos = base & ~sign
    neg = base & sign
    if which == "min":
        prefer, other = neg, pos
    else:
        prefer, other = pos, neg
    use_prefer = popcount(prefer) > 0
    cand = _where(use_prefer, prefer, other)
    maximize = use_prefer

    bits = [None] * len(planes)
    for k in reversed(range(len(planes))):
        b = planes[k]
        with_one = cand & b
        n1 = popcount(with_one)
        ntot = popcount(cand)
        # maximize: take bit 1 iff any candidate has it;
        # minimize: take bit 1 only when every candidate has it.
        choose1 = torch.where(maximize, n1 > 0, n1 == ntot)
        cand = _where(choose1, with_one, cand & ~b)
        bits[k] = choose1.to(torch.int32)
    negative = (use_prefer if which == "min" else ~use_prefer).to(torch.int32)
    return torch.stack(bits + [negative, popcount(cand)], dim=-1)


def decode_minmax(vec, depth: int) -> tuple[int, int] | None:
    """One slice's ``minmax_vec`` output -> ``(value, count)`` in
    Python ints, or None when the slice holds no valued column."""
    count = int(vec[depth + 1])
    if count <= 0:
        return None
    mag = 0
    for k in range(depth):
        if int(vec[k]):
            mag |= 1 << k
    return (-mag if int(vec[depth]) else mag), count


def decode_sum(vec, depth: int) -> tuple[int, int]:
    """One slice's ``sum_vec`` output -> ``(sum, count)`` in Python ints
    (exact at any depth: the weights never touch device arithmetic)."""
    total = 0
    for k in range(depth):
        total += (1 << k) * (int(vec[k]) - int(vec[depth + k]))
    return total, int(vec[2 * depth])
