"""Host (numpy) query evaluation — the degraded-mode data plane.

The port's copy of ``pilosa_tpu/exec/hosteval.py``.  The host planes are
authoritative (fragments write on the host and queue their changes for
the mirrors), and every kernel of the query path has a host
formulation: the fold algebra and the BSI ripple evaluate through
``plan.eval_expr_np`` (numpy, and the ripple's plain version on CPU
tensors), and TopN scoring is a popcount of ``row AND src`` per
candidate.  So while the card is quarantined (``device/health.py``) a
node keeps answering byte for byte from host memory — slower, but
correct by construction — and launches nothing on the card:

* ``rows`` / ``counts`` / ``count_total`` / ``agg_partials`` cover the
  Count/Bitmap algebra, Range/BSI comparisons and the BSI aggregates'
  partial vectors — the arrays the kernels produce, decoded by the same
  executor code.
* ``score_topn_parts`` fills the TopN scorer's count vectors from each
  fragment's host rows (``Fragment.row_words_host``), as the
  cross-fragment scorer K4 computes them on the card.

Every host answer is counted (``exec.hostEval.queries{kind:*}``), traced
(the ``hosteval`` span) and recorded as a ``hosteval`` site launch in
the launch telemetry (``/debug/perf``): the fallback is never silent.
"""

from __future__ import annotations

import time

import numpy as np

from pilosa_tpu_torch.exec import plan
from pilosa_tpu_torch.obs import perf as perf_mod
from pilosa_tpu_torch.ops import bitplane as bp


def popcount_words(arr: np.ndarray) -> int:
    """Popcount of a uint32 word array (numpy>=2 bitwise_count, else
    unpackbits) — the host analog of the fused popcount reduce."""
    if hasattr(np, "bitwise_count"):
        return int(np.bitwise_count(arr).sum())
    return int(np.unpackbits(arr.view(np.uint8)).sum())


class HostEvaluator:
    """Evaluates bitmap call trees over an executor's authoritative host
    planes.  Stateless beyond the executor handle — safe to share across
    request threads."""

    def __init__(self, executor):
        self.ex = executor

    def _count(self, what: str, n: int = 1) -> None:
        self.ex.holder.stats.count_with_custom_tags(
            "exec.hostEval.queries", n, [f"kind:{what}"]
        )

    @staticmethod
    def _record(reduce: str, n_rows: int, t0: float) -> None:
        """The pass streams each leaf row once: a ``hosteval`` site launch
        (the degraded-mode row of the /debug/perf table)."""
        if perf_mod.enabled():
            perf_mod.record_launch(
                "hosteval",
                reduce=reduce,
                rows=n_rows,
                n_bytes=perf_mod.plane_bytes(n_rows, bp.WORDS_PER_SLICE),
                total_ms=(time.monotonic() - t0) * 1e3,
                trace_id=perf_mod.current_trace_id(),
            )

    def _leaf_rows(self, index: str, leaves, targets, s: int) -> list:
        return [self.ex._leaf_row_host(index, leaf, s, target)
                for leaf, target in zip(leaves, targets)]

    def _slice_rows(self, index: str, c, slices, reduce: str = "row"):
        """Per-slice evaluated result rows (uint32[words] or None) for an
        already-BSI-rewritten call tree; its leaves resolve once."""
        expr, leaves = plan.decompose(c)
        targets = self.ex._leaf_targets(index, leaves)
        t0 = time.monotonic()
        out = {}
        for s in slices:
            rows = self._leaf_rows(index, leaves, targets, s)
            out[s] = plan.eval_expr_np(expr, rows, bp.WORDS_PER_SLICE)
        self._record(reduce, len(slices) * len(leaves), t0)
        return out

    def rows(self, index: str, c, slices: list[int]) -> dict:
        """``{slice: uint32[words] | None}`` — the host analog of the
        "row" reduce (None = identically-zero result)."""
        with self.ex.tracer.span("hosteval", kind="row", slices=len(slices)):
            self._count("row")
            return self._slice_rows(index, self.ex._rewrite_bsi(index, c), slices)

    def counts(self, index: str, c, slices: list[int]) -> dict:
        """``{slice: int}`` per-slice popcounts ("count" reduce)."""
        with self.ex.tracer.span("hosteval", kind="count", slices=len(slices)):
            self._count("count")
            rows = self._slice_rows(index, self.ex._rewrite_bsi(index, c), slices,
                                    reduce="count")
            return {s: (0 if r is None else popcount_words(r)) for s, r in rows.items()}

    def count_total(self, index: str, c, slices: list[int]) -> int:
        """Count(tree) summed over ``slices`` — the host analog of the
        "total" reduce (Python ints are unbounded: totals are
        identical)."""
        return sum(self.counts(index, c, slices).values())

    def agg_partials(self, index: str, rc, slices: list[int]) -> dict:
        """``{slice: partial vector}`` for a rewritten BSI aggregate call
        (BsiSum/BsiMin/BsiMax): the ripple's sum/min/max vectors through
        the host path are the arrays K8 returns, so the executor's decode
        is shared.  Slices with no planes at all are omitted (their
        all-zero vector decodes to "no data" just the same)."""
        with self.ex.tracer.span("hosteval", kind="agg", slices=len(slices)):
            self._count("agg")
            expr, leaves = plan.decompose(rc)
            targets = self.ex._leaf_targets(index, leaves)
            t0 = time.monotonic()
            out = {}
            for s in slices:
                rows = self._leaf_rows(index, leaves, targets, s)
                if all(
                    r is None
                    for r, leaf in zip(rows, leaves)
                    if leaf.name not in plan.NEUTRAL_LEAVES
                ):
                    continue
                out[s] = np.asarray(plan.eval_expr_np(expr, rows, bp.WORDS_PER_SLICE))
            self._record("agg", len(slices) * len(leaves), t0)
            return out

    # ------------------------------------------------------------------
    # TopN scoring
    # ------------------------------------------------------------------

    def score_topn_parts(self, parts) -> None:
        """Fill each TopState's dense count vector on the host.

        ``parts``: the executor's scored entries ``(st, SubRef, src row,
        src slot, fragment)``.  For every dense candidate (the positions
        ``st.dense_pos`` indexes, ids in candidate order) the count is
        ``popcount(row AND src)`` over the fragment's host rows — what
        K4 computes on the card, so ``top_score_arrays`` sees the same
        vectors.  Each part's src row is copied to the host once."""
        with self.ex.tracer.span("hosteval", kind="topn", parts=len(parts)):
            self._count("topn")
            t0 = time.monotonic()
            live = [p for p in parts if p[1] is not None and p[0].dense_pos is not None]
            srcs = [bp.to_host(p[2]) for p in live]
            n_rows = 0
            for (st, _sub, _src, _slot, frag), src in zip(live, srcs):
                ids = st.cand_ids[st.dense_pos]
                counts = np.zeros(len(ids), dtype=np.int32)
                for i, rid in enumerate(ids):
                    row = frag.row_words_host(int(rid))
                    if row is not None:
                        counts[i] = popcount_words(row & src)
                st.counts = counts
                n_rows += len(ids)
            self._record("topn", n_rows, t0)
