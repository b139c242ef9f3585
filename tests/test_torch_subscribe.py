"""Standing queries (``pilosa_tpu_torch/subscribe``), with the JAX
package's ``tests/test_subscribe.py`` run against the port: registry
compilation, the per-fragment listener lifecycle, the delta log's
overflow counters, the adjust / slice / full evaluation modes over one
node, the double-apply fences, an admission shed that requeues its batch
(through a stub admission object: the port's admission controller waits
for ``net/admission.py``), a randomized storm against the pull and the
host evaluator, and a subscription that survives a live 2->3 resize.
Only the harness differs: port nodes run with ``device="cpu"``, take
their ring as ``hosts=`` and meet through ``add_peer``, and the port's
client imports ``(rows, cols)``.

Then the cross-package check: a JAX node and a port node, fed the same
seeded write sequence, deliver the same update documents by long-poll
and the same SSE frames, apart from the subscription ids."""

from __future__ import annotations

import http.client
import json
import random
import time

import pytest

pytest.importorskip("torch")

from pilosa_tpu_torch.core.fragment import Fragment  # noqa: E402
from pilosa_tpu_torch.net.client import ClientError, InternalClient  # noqa: E402
from pilosa_tpu_torch.net.server import Server  # noqa: E402
from pilosa_tpu_torch.ops.bitplane import SLICE_WIDTH  # noqa: E402
from pilosa_tpu_torch.pql.parser import Query, parse_string  # noqa: E402
from pilosa_tpu_torch.rebalance.deltalog import DeltaLog  # noqa: E402
from pilosa_tpu_torch.subscribe import registry as reg  # noqa: E402
from pilosa_tpu_torch.subscribe.registry import SubscribeError  # noqa: E402


# ---------------------------------------------------------------------------
# registry compilation
# ---------------------------------------------------------------------------


def _compile(pql: str):
    q = parse_string(pql)
    return reg.compile_subscription(q.calls[0])


class TestRegistry:
    def test_count_bitmap(self):
        kind, inner, tree, keys, force = _compile(
            "Subscribe(Count(Bitmap(rowID=3, frame=f)))"
        )
        assert kind == reg.KIND_COUNT
        assert inner.name == "Count"
        assert tree.name == "Bitmap"
        assert keys == {("f", 3)}
        assert not force

    def test_bare_tree_wrapped_in_count(self):
        kind, inner, tree, keys, _ = _compile(
            "Subscribe(Intersect(Bitmap(rowID=1, frame=f), Bitmap(rowID=2, frame=g)))"
        )
        assert kind == reg.KIND_COUNT
        assert inner.name == "Count"
        assert keys == {("f", 1), ("g", 2)}

    def test_topn_forces_pull(self):
        kind, inner, tree, keys, force = _compile("Subscribe(TopN(frame=f, n=5))")
        assert kind == reg.KIND_TOPN
        assert tree is None
        assert keys == {("f", None)}
        assert force

    def test_range_is_frame_wildcard(self):
        _, _, _, keys, _ = _compile("Subscribe(Count(Range(frame=f, v > 10)))")
        assert keys == {("f", None)}

    def test_rejects_bad_shapes(self):
        for pql in (
            "Subscribe()",
            "Subscribe(Count(Bitmap(rowID=1)), Count(Bitmap(rowID=2)))",
            "Subscribe(SetBit(rowID=1, frame=f, columnID=2))",
            "Subscribe(Sum(frame=f, field=v))",
        ):
            with pytest.raises(SubscribeError):
                _compile(pql)


# ---------------------------------------------------------------------------
# fragment listener lifecycle (regression: a closed fragment must hold
# zero registered listeners)
# ---------------------------------------------------------------------------


class TestFragmentListeners:
    def _frag(self, tmp_path):
        return Fragment(str(tmp_path / "frag"), "i", "f", "standard", 0, device="cpu")

    def test_close_clears_listeners(self, tmp_path):
        frag = self._frag(tmp_path)
        calls = []
        frag.add_write_listener(lambda *a, **k: calls.append(a))
        frag.open()
        frag.set_bit(1, 2)
        assert calls, "listener must fire on a point write"
        assert frag.write_listener_count() == 1
        frag.close()
        assert frag.write_listener_count() == 0

    def test_retire_clears_listeners(self, tmp_path):
        frag = self._frag(tmp_path)
        frag.open()
        frag.add_write_listener(lambda *a, **k: None)
        assert frag.write_listener_count() == 1
        frag.mark_retired()
        assert frag.write_listener_count() == 0
        frag.close()

    def test_add_remove_dedupe(self, tmp_path):
        frag = self._frag(tmp_path)
        fn = lambda *a, **k: None  # noqa: E731
        frag.add_write_listener(fn)
        frag.add_write_listener(fn)
        assert frag.write_listener_count() == 1
        frag.remove_write_listener(fn)
        assert frag.write_listener_count() == 0

    def test_point_writes_are_exact_imports_are_not(self, tmp_path):
        frag = self._frag(tmp_path)
        frag.open()
        seen = []
        frag.add_write_listener(
            lambda f, sr, sc, cr, cc, exact: seen.append(
                (list(sr), list(cr), exact)
            )
        )
        frag.set_bit(1, 2)
        frag.set_bit(1, 2)  # no-op: must NOT notify
        frag.clear_bit(1, 2)
        frag.import_bulk([1, 1], [3, 3])  # raw request, dupes included
        frag.close()
        assert seen[0] == ([1], [], True)
        assert seen[1] == ([], [1], True)
        assert seen[2] == ([1, 1], [], False)
        assert len(seen) == 3


# ---------------------------------------------------------------------------
# per-slice delta-log overflow observability
# ---------------------------------------------------------------------------


class _Frag:
    def __init__(self, index="i", frame="f", view="standard", slice_i=0):
        self.index, self.frame, self.view, self.slice = index, frame, view, slice_i


class TestDeltaLogOverflowCounters:
    def test_overflow_counts_per_slice(self):
        log = DeltaLog(cap=2)
        log.start("i", 0)
        log.start("i", 1)
        f0, f1 = _Frag(slice_i=0), _Frag(slice_i=1)
        for c in range(5):
            log.record(f0, [1], [c], [], [])
        log.record(f1, [1], [0], [], [])
        assert log.overflow_counts() == {"i/0": 1}
        snap = log.snapshot()
        assert snap["i/0"]["overflows"] == 1
        assert snap["i/0"]["overflowed"] is True
        assert snap["i/1"]["overflows"] == 0
        # lifetime: survives stop/start of the same slice
        log.stop("i", 0)
        log.start("i", 0)
        for c in range(5):
            log.record(f0, [1], [c], [], [])
        assert log.overflow_counts() == {"i/0": 2}


# ---------------------------------------------------------------------------
# engine integration over one real node
# ---------------------------------------------------------------------------


def _boot(tmp_path, name, **kwargs):
    s = Server(
        str(tmp_path / name),
        device="cpu",
        floor_probe=False,
        anti_entropy_interval=3600,
        polling_interval=3600,
        **kwargs,
    )
    s.open()
    return s


def _import(client, index, frame, slice_i, bits):
    client.import_slice(index, frame, slice_i, [b[0] for b in bits], [b[1] for b in bits])


def _drain(client, sid, after):
    """Drain the retained update queue past ``after``; returns
    (last_update_or_None, new_cursor) and asserts version monotonicity."""
    last = None
    while True:
        status, data = client._request(
            "GET", f"/subscribe/{sid}/poll?after={after}&timeout_ms=100"
        )
        doc = json.loads(client._check(status, data))
        if doc.get("timeout"):
            return last, after
        assert doc["version"] > after, "versions must be monotonic"
        last, after = doc, doc["version"]


class TestEngineIncremental:
    def test_adjust_slice_and_full_paths(self, tmp_path):
        s = _boot(tmp_path, "node")
        try:
            c = InternalClient(s.host, timeout=10.0, device="cpu")
            c.create_index("i")
            c.create_frame("i", "f", {})
            mgr = s.subscribe

            single = mgr.register("i", 'Subscribe(Count(Bitmap(rowID=1, frame="f")))')
            compound = mgr.register(
                "i",
                'Subscribe(Count(Union(Bitmap(rowID=1, frame="f"),'
                ' Bitmap(rowID=2, frame="f"))))',
            )
            assert single.value == 0 and compound.value == 0
            assert single.fast_row == 1  # the exact ±n path compiled

            for col in range(8):
                c.execute_query("i", f'SetBit(frame="f", rowID=1, columnID={col})')
            c.execute_query("i", 'SetBit(frame="f", rowID=2, columnID=100)')
            assert mgr.flush()
            assert single.value == 8
            assert compound.value == 9
            assert mgr.evals["adjust"] > 0, "single-leaf counts must ±n"
            assert mgr.evals["slice"] > 0, "compound trees re-eval the slice"

            c.execute_query("i", 'ClearBit(frame="f", rowID=1, columnID=3)')
            assert mgr.flush()
            assert single.value == 7 and compound.value == 8

            # a duplicate point write changes nothing and emits nothing
            v = single.version
            c.execute_query("i", 'SetBit(frame="f", rowID=1, columnID=0)')
            assert mgr.flush()
            assert single.value == 7 and single.version == v
        finally:
            s.close()

    def test_overflow_forces_full_reeval(self, tmp_path):
        s = _boot(tmp_path, "node", subscribe_delta_cap=4)
        try:
            c = InternalClient(s.host, timeout=10.0, device="cpu")
            c.create_index("i")
            c.create_frame("i", "f", {})
            mgr = s.subscribe
            sub = mgr.register("i", 'Subscribe(Count(Bitmap(rowID=1, frame="f")))')
            # One import far over the 4-bit budget: the pending budget
            # overflows and the subscription re-bases from the planes.
            _import(c, "i", "f", 0, [(1, col) for col in range(64)])
            assert mgr.flush()
            assert sub.value == 64
            assert mgr.overflows >= 1
            snap = mgr.snapshot()
            assert snap["counters"]["overflows"] >= 1
        finally:
            s.close()

    def test_unregister_and_limit(self, tmp_path):
        s = _boot(tmp_path, "node", subscribe_max_subscriptions=2)
        try:
            c = InternalClient(s.host, timeout=10.0, device="cpu")
            c.create_index("i")
            c.create_frame("i", "f", {})
            mgr = s.subscribe
            a = mgr.register("i", 'Subscribe(Count(Bitmap(rowID=1, frame="f")))')
            mgr.register("i", 'Subscribe(Count(Bitmap(rowID=2, frame="f")))')
            with pytest.raises(SubscribeError):
                mgr.register("i", 'Subscribe(Count(Bitmap(rowID=3, frame="f")))')
            assert mgr.unregister(a.id)
            assert a.closed
            assert not mgr.unregister(a.id)
            mgr.register("i", 'Subscribe(Count(Bitmap(rowID=3, frame="f")))')
        finally:
            s.close()

    def test_http_surface(self, tmp_path):
        s = _boot(tmp_path, "node")
        try:
            c = InternalClient(s.host, timeout=10.0, device="cpu")
            c.create_index("i")
            c.create_frame("i", "f", {})
            status, data = c._request(
                "POST",
                "/subscribe",
                body=json.dumps(
                    {"index": "i", "query": 'Subscribe(Count(Bitmap(rowID=1, frame="f")))'}
                ).encode(),
            )
            assert status == 201
            doc = json.loads(data)
            assert doc["version"] == 1 and doc["value"] == 0

            c.execute_query("i", 'SetBit(frame="f", rowID=1, columnID=9)')
            assert s.subscribe.flush()
            upd, _ = _drain(c, doc["id"], doc["version"])
            assert upd is not None and upd["value"] == 1

            # bad queries are client errors, not 500s
            for q in (
                "Count(Bitmap(rowID=1))",  # not a Subscribe
                "Subscribe(Count(Range(rowID=1, frame=f, start=0, end=1)))",
                "not pql",
            ):
                status, _ = c._request(
                    "POST", "/subscribe",
                    body=json.dumps({"index": "i", "query": q}).encode(),
                )
                assert status == 400, q
            status, _ = c._request("GET", "/subscribe/nope/poll")
            assert status == 404

            status, data = c._request("GET", "/debug/subscriptions")
            snap = json.loads(c._check(status, data))
            assert snap["count"] == 1
            assert snap["subscriptions"][0]["id"] == doc["id"]

            status, data = c._request("DELETE", f"/subscribe/{doc['id']}")
            assert status == 200
            # a poll against the unregistered subscription reports gone
            status, _ = c._request("GET", f"/subscribe/{doc['id']}/poll")
            assert status in (404, 410)
        finally:
            s.close()


# ---------------------------------------------------------------------------
# slice evaluation on the card: Executor.count_slices (K2's "count" reduce)
# ---------------------------------------------------------------------------


COUNT_TREES = (
    "Bitmap(rowID=1, frame=f)",
    "Intersect(Bitmap(rowID=0, frame=f), Bitmap(rowID=1, frame=f))",
    "Union(Bitmap(rowID=0, frame=f), Bitmap(rowID=2, frame=f))",
    "Difference(Bitmap(rowID=0, frame=f), Bitmap(rowID=1, frame=f))",
    "Xor(Bitmap(rowID=1, frame=f), Bitmap(rowID=2, frame=f))",
    "Intersect(Bitmap(rowID=0, frame=f), Range(frame=n, v > 10))",
)


class TestCountSlices:
    """The engine's slice and full evaluations go through
    ``Executor.count_slices``; on the CPU its "count" reduce is the plain
    K2, held here against the JAX executor's Count of each slice."""

    @pytest.mark.parametrize("members", [1, 4])
    def test_per_slice_counts_equal_jax(self, tmp_path, members):
        import numpy as np

        from pilosa_tpu.core.holder import Holder as JHolder
        from pilosa_tpu.exec.executor import Executor as JExecutor
        from pilosa_tpu.pql import parse_string as jparse
        from pilosa_tpu_torch.core.holder import Holder as THolder
        from pilosa_tpu_torch.exec.executor import Executor as TExecutor
        from pilosa_tpu_torch.ops import bitplane as tbp

        rng = np.random.default_rng(7)
        n_slices = 5
        rows = rng.integers(0, 3, 3000)
        cols = rng.integers(0, n_slices * SLICE_WIDTH, 3000)
        vcols = rng.choice(n_slices * SLICE_WIDTH, 400, replace=False)
        vals = rng.integers(-50, 50, 400)
        if members > 1:
            tbp.set_local_members(["cpu"] * members)
        t, j = THolder(str(tmp_path / "t"), device="cpu"), JHolder(str(tmp_path / "j"))
        t.open()
        j.open()
        try:
            for h in (t, j):
                idx = h.create_index_if_not_exists("i")
                idx.create_frame_if_not_exists("f").import_bulk(rows, cols)
                n = idx.create_frame_if_not_exists("n")
                n.set_options(range_enabled=True)
                n.create_field("v", -100, 100)
                n.import_value("v", vcols, vals)
            tex, jex = TExecutor(t), JExecutor(j)

            def host_counts(*a, **k):
                raise AssertionError("count_slices answered from the host evaluator")

            tex.hosteval.counts = host_counts
            slices = [0, 2, 3, 4, 7]  # slice 7 holds nothing
            for tree in COUNT_TREES:
                got = tex.count_slices("i", parse_string(tree).calls[0], slices)
                want = {s: jex.execute("i", jparse(f"Count({tree})"), slices=[s])[0]
                        for s in slices}
                assert got == want, tree
        finally:
            t.close()
            j.close()
            tbp.set_local_members(None)

    def test_slice_evaluation_launches_count_slices_not_numpy(self, tmp_path, monkeypatch):
        from pilosa_tpu_torch.exec import plan

        s = _boot(tmp_path, "node")
        try:
            c = InternalClient(s.host, timeout=10.0, device="cpu")
            c.create_index("i")
            c.create_frame("i", "f", {})
            mgr = s.subscribe
            sub = mgr.register(
                "i", 'Subscribe(Count(Intersect(Bitmap(rowID=1, frame="f"),'
                ' Bitmap(rowID=2, frame="f"))))')
            calls = []
            orig = s.executor.count_slices

            def spy(index, c_, slices):
                calls.append(list(slices))
                return orig(index, c_, slices)

            def host_eval(*a, **k):
                raise AssertionError("a slice evaluation ran numpy over the host planes")

            monkeypatch.setattr(s.executor, "count_slices", spy)
            monkeypatch.setattr(plan, "eval_expr_np", host_eval)
            monkeypatch.setattr(s.executor.hosteval, "counts", host_eval)
            for col in (5, 2 * SLICE_WIDTH + 9):
                c.execute_query("i", f'SetBit(frame="f", rowID=1, columnID={col}) '
                                     f'SetBit(frame="f", rowID=2, columnID={col})')
                assert mgr.flush()
            assert sub.value == 2
            assert mgr.evals["slice"] >= 2
            assert [0] in calls and [2] in calls
            assert all(len(sl) == 1 for sl in calls), calls
        finally:
            s.close()

    def test_single_leaf_rebase_reads_the_row_count(self, tmp_path, monkeypatch):
        """The single-leaf Count re-bases a slice from the fragment's row
        count (kept by every write) with its stamp: no launch, no
        popcount, and the value the pull's."""
        from pilosa_tpu_torch.exec import hosteval

        s = _boot(tmp_path, "node")
        try:
            c = InternalClient(s.host, timeout=10.0, device="cpu")
            c.create_index("i")
            c.create_frame("i", "f", {})
            mgr = s.subscribe

            def no_eval(*a, **k):
                raise AssertionError("a single-leaf re-base evaluated the tree")

            monkeypatch.setattr(s.executor, "count_slices", no_eval)
            monkeypatch.setattr(hosteval, "popcount_words", no_eval)
            _import(c, "i", "f", 1, [(1, SLICE_WIDTH + 3), (1, SLICE_WIDTH + 4),
                                     (2, SLICE_WIDTH + 5)])
            sub = mgr.register("i", 'Subscribe(Count(Bitmap(rowID=1, frame="f")))')
            assert sub.value == 2
            # inexact imports mark their slices dirty: slice re-bases
            _import(c, "i", "f", 0, [(1, 9), (1, 10)])
            _import(c, "i", "f", 1, [(1, SLICE_WIDTH + 11)])
            c.execute_query("i", 'ClearBit(frame="f", rowID=1, columnID=9)')
            assert mgr.flush()
            assert mgr.evals["slice"] >= 1
            monkeypatch.undo()
            assert sub.value == 4
            assert sub.value == s.executor.execute("i", Query(calls=[sub.inner]))[0]
        finally:
            s.close()


# ---------------------------------------------------------------------------
# regressions: the drain/plane-read double-apply race, the
# registration window, admission-shed batch loss, sibling data dirs
# ---------------------------------------------------------------------------


class TestDeltaFences:
    def test_write_landing_during_rebase_not_double_applied(self, tmp_path):
        s = _boot(tmp_path, "node")
        try:
            c = InternalClient(s.host, timeout=10.0, device="cpu")
            c.create_index("i")
            c.create_frame("i", "f", {})
            mgr = s.subscribe
            sub = mgr.register("i", 'Subscribe(Count(Bitmap(rowID=1, frame="f")))')

            orig = mgr._slice_count
            raced = []

            def racing(sub_, slices):
                # Exact point write lands AFTER the drain but BEFORE
                # the plane read: the new base includes it, so its adj
                # delta (stamped at or below the base version) must be
                # dropped on the next batch, not re-applied.
                if not raced:
                    raced.append(True)
                    c.execute_query(
                        "i", 'SetBit(frame="f", rowID=1, columnID=7)'
                    )
                return orig(sub_, slices)

            mgr._slice_count = racing
            # an inexact single-bit import marks the slice dirty,
            # forcing the re-base that opens the race window
            _import(c, "i", "f", 0, [(1, 3)])
            assert mgr.flush()
            mgr._slice_count = orig
            assert mgr.flush()
            assert sub.value == 2, "col 7 must be counted exactly once"
            want = s.executor.execute("i", Query(calls=[sub.inner]))[0]
            assert sub.value == want
        finally:
            s.close()

    def test_write_during_registration_snapshot_not_lost(self, tmp_path):
        s = _boot(tmp_path, "node")
        try:
            c = InternalClient(s.host, timeout=10.0, device="cpu")
            c.create_index("i")
            c.create_frame("i", "f", {})
            mgr = s.subscribe

            orig = mgr._slice_count
            hit = []

            def racing(sub_, slices):
                # One write BEFORE the snapshot's plane read (included
                # in the base; its pending delta must be dropped) and
                # one AFTER it (not in the base; must be applied by
                # the notifier) — both inside the registration window.
                if not hit:
                    hit.append(True)
                    c.execute_query(
                        "i", 'SetBit(frame="f", rowID=1, columnID=1)'
                    )
                    res = orig(sub_, slices)
                    c.execute_query(
                        "i", 'SetBit(frame="f", rowID=1, columnID=2)'
                    )
                    return res
                return orig(sub_, slices)

            mgr._slice_count = racing
            sub = mgr.register("i", 'Subscribe(Count(Bitmap(rowID=1, frame="f")))')
            mgr._slice_count = orig
            assert mgr.flush()
            assert sub.value == 2, (
                "a write in the registration window must be neither "
                "lost nor double-counted"
            )
        finally:
            s.close()

    def test_admission_shed_requeues_batch(self, tmp_path):
        from pilosa_tpu_torch.net.resilience import ShedError

        s = _boot(tmp_path, "node")
        try:
            c = InternalClient(s.host, timeout=10.0, device="cpu")
            c.create_index("i")
            c.create_frame("i", "f", {})
            mgr = s.subscribe
            sub = mgr.register("i", 'Subscribe(Count(Bitmap(rowID=1, frame="f")))')

            class _Ticket:
                def release(self):
                    pass

            class _Shedding:
                def __init__(self, fails):
                    self.fails = fails
                    self.sheds = 0

                def acquire(self, cls, deadline=None):
                    if self.fails > 0:
                        self.fails -= 1
                        self.sheds += 1
                        raise ShedError("subscribe lane saturated")
                    return _Ticket()

            gate = _Shedding(fails=2)
            mgr.admission = gate
            c.execute_query("i", 'SetBit(frame="f", rowID=1, columnID=5)')
            assert mgr.flush(timeout=15.0)
            assert gate.sheds == 2, "the shed path must have been taken"
            assert sub.value == 1, "drained deltas must survive a shed"
        finally:
            s.close()

    def test_sibling_data_dir_not_cross_matched(self, tmp_path):
        s = _boot(tmp_path, "n1")
        try:
            mgr = s.subscribe

            class F:
                pass

            own = F()
            own.path = str(tmp_path / "n1" / "i" / "f" / "standard" / "0")
            sibling = F()
            sibling.path = str(tmp_path / "n10" / "i" / "f" / "standard" / "0")
            assert not mgr._foreign(own)
            assert mgr._foreign(sibling), (
                "/…/n10 must not prefix-match the /…/n1 node"
            )
        finally:
            s.close()


# ---------------------------------------------------------------------------
# randomized byte-identity storm: every delivered value equals the
# from-scratch hosteval pull at quiescence
# ---------------------------------------------------------------------------


class TestStorm:
    def test_randomized_storm_matches_oracle(self, tmp_path):
        rng = random.Random(0xC0FFEE)
        s = _boot(tmp_path, "node", subscribe_delta_cap=200)
        try:
            c = InternalClient(s.host, timeout=10.0, device="cpu")
            c.create_index("i")
            c.create_frame("i", "f", {})
            c.create_frame("i", "g", {})
            c.create_frame("i", "b", {"rangeEnabled": True})
            c.create_field("i", "b", "v", 0, 1000)
            mgr = s.subscribe

            subs = []
            for row in range(4):
                subs.append(mgr.register(
                    "i", f'Subscribe(Count(Bitmap(rowID={row}, frame="f")))'
                ))
            subs.append(mgr.register(
                "i",
                'Subscribe(Count(Intersect(Bitmap(rowID=0, frame="f"),'
                ' Bitmap(rowID=1, frame="f"))))',
            ))
            subs.append(mgr.register(
                "i",
                'Subscribe(Count(Union(Bitmap(rowID=2, frame="f"),'
                ' Bitmap(rowID=0, frame="g"))))',
            ))
            subs.append(mgr.register(
                "i",
                'Subscribe(Count(Difference(Bitmap(rowID=0, frame="f"),'
                ' Bitmap(rowID=1, frame="f"))))',
            ))
            subs.append(mgr.register("i", 'Subscribe(Count(Range(frame="b", v > 500)))'))
            topn = mgr.register("i", 'Subscribe(TopN(frame="f", n=3))')
            subs.append(topn)
            cursors = {sub.id: sub.version for sub in subs}

            def check_all():
                assert mgr.flush()
                for sub in subs:
                    want = s.executor.execute(
                        "i", Query(calls=[sub.inner])
                    )[0]
                    assert sub.value == want, (sub.pql, sub.value, want)
                    # the update stream is monotonic and ends at the
                    # oracle value
                    upd, cursors[sub.id] = _drain(c, sub.id, cursors[sub.id])
                    if upd is not None:
                        assert upd["value"] == sub.value_json

            for burst in range(6):
                for _ in range(40):
                    op = rng.random()
                    row = rng.randrange(4)
                    col = rng.randrange(2 * SLICE_WIDTH)
                    frame = rng.choice(["f", "f", "f", "g"])
                    if op < 0.55:
                        c.execute_query(
                            "i",
                            f'SetBit(frame="{frame}", rowID={row}, columnID={col})',
                        )
                    elif op < 0.8:
                        c.execute_query(
                            "i",
                            f'ClearBit(frame="{frame}", rowID={row}, columnID={col})',
                        )
                    else:
                        c.import_value(
                            "i", "b", "v", col // SLICE_WIDTH,
                            [col], [rng.randrange(1000)],
                        )
                if burst == 3:
                    # bulk import mid-storm: inexact notifications +
                    # possible overflow re-base
                    _import(
                        c, "i", "f", 0,
                        [(rng.randrange(4), rng.randrange(SLICE_WIDTH))
                         for _ in range(300)],
                    )
                s.tick_max_slices()
                check_all()

            # incremental arithmetic never drifted: byte-identical to a
            # from-scratch hosteval pull over every slice
            idx = s.holder.index("i")
            all_slices = list(range(idx.max_slice() + 1))
            for sub in subs:
                if sub.kind != reg.KIND_COUNT:
                    continue
                want = s.executor.hosteval.count_total(
                    "i", sub.tree, all_slices
                )
                assert sub.value == want, sub.pql
        finally:
            s.close()


# ---------------------------------------------------------------------------
# a subscription survives a live 2->3 resize
# ---------------------------------------------------------------------------


def _wire(servers, hosts):
    for s in servers:
        for h in hosts:
            if s.cluster.node_by_host(h) is None:
                s.add_peer(h)


def _wait_resize(host, timeout=90.0):
    client = InternalClient(host, timeout=10.0, device="cpu")
    deadline = time.time() + timeout
    while time.time() < deadline:
        status, data = client._request("GET", "/debug/rebalance")
        snap = json.loads(client._check(status, data))
        if not snap.get("running") and snap.get("transition") is None:
            return snap
        time.sleep(0.1)
    raise AssertionError("resize did not complete")


class TestResizeSurvival:
    def test_subscription_survives_2_to_3_resize(self, tmp_path):
        def boot(name, ring):
            s = Server(
                str(tmp_path / name),
                device="cpu",
                floor_probe=False,
                hosts=list(ring),
                anti_entropy_interval=3600,
                polling_interval=3600,
                rebalance_release_delay_ms=0.0,
                subscribe_refresh_ms=100.0,
            )
            s.open()
            return s

        s1 = boot("n1", ())
        s2 = boot("n2", (s1.host,))
        servers = [s1, s2]
        try:
            hosts2 = sorted([s1.host, s2.host])
            _wire(servers, hosts2)
            for s in servers:
                s.holder.create_index_if_not_exists("i")
                s.holder.index("i").create_frame_if_not_exists("f")
            c = InternalClient(s1.host, timeout=10.0, device="cpu")
            n_slices = 4
            for sl in range(n_slices):
                c.execute_query(
                    "i",
                    f'SetBit(frame="f", rowID=1, columnID={sl * SLICE_WIDTH + sl})',
                )
            for s in servers:
                s.tick_max_slices()

            sub = s1.subscribe.register(
                "i", 'Subscribe(Count(Bitmap(rowID=1, frame="f")))'
            )
            assert sub.value == n_slices
            cursor = sub.version
            epoch0 = sub.epoch

            s3 = boot("n3", hosts2)
            servers.append(s3)
            hosts3 = sorted(hosts2 + [s3.host])
            status, data = c._request(
                "POST", "/cluster/resize",
                body=json.dumps({"hosts": hosts3}).encode(),
            )
            c._check(status, data)
            _wait_resize(s1.host)

            # writes keep landing after the cutover; the subscription
            # keeps tracking them through the new topology
            for sl in range(n_slices):
                for attempt in range(20):
                    try:
                        c.execute_query(
                            "i",
                            f'SetBit(frame="f", rowID=1,'
                            f' columnID={sl * SLICE_WIDTH + 500})',
                        )
                        break
                    except (ClientError, ConnectionError):
                        time.sleep(0.1)

            want = 2 * n_slices
            deadline = time.time() + 30
            while time.time() < deadline and sub.value != want:
                time.sleep(0.1)
            assert sub.value == want, (sub.value, want)
            assert not sub.closed
            assert sub.epoch > epoch0, "topology move must re-stamp the epoch"
            assert s1.subscribe.epoch_flips >= 1

            # no lost updates: the stream drains monotonically to the
            # final absolute value
            upd, _ = _drain(c, sub.id, cursor)
            assert upd is not None and upd["value"] == want
        finally:
            for s in servers:
                s.close()


# ---------------------------------------------------------------------------
# cross-package: the same writes, the same update documents and SSE frames
# ---------------------------------------------------------------------------


CROSS_QUERIES = (
    'Subscribe(Count(Bitmap(rowID=1, frame="f")))',
    'Subscribe(Count(Intersect(Bitmap(rowID=0, frame="f"), Bitmap(rowID=1, frame="f"))))',
    'Subscribe(TopN(frame="f", n=3))',
)


def _cross_steps(seed=11):
    """Each step is one request: a few point writes, or an import."""
    rng = random.Random(seed)
    steps = []
    for i in range(8):
        if i == 5:
            bits = [(rng.randrange(3), rng.randrange(2 * SLICE_WIDTH)) for _ in range(60)]
            steps.append(("import", bits))
            continue
        calls = []
        for _ in range(rng.randrange(1, 5)):
            verb = "SetBit" if rng.random() < 0.75 else "ClearBit"
            calls.append(f'{verb}(frame="f", rowID={rng.randrange(3)}, '
                         f"columnID={rng.randrange(2 * SLICE_WIDTH)})")
        both = rng.randrange(2 * SLICE_WIDTH)  # moves the Intersect's count too
        calls += [f'SetBit(frame="f", rowID={r}, columnID={both})' for r in (0, 1)]
        steps.append(("pql", " ".join(calls)))
    return steps


def _sse_frames(host, sid, n_frames, out):
    """Read the subscription's SSE stream until ``n_frames`` update
    events arrived; keepalive and hello comments are skipped."""
    conn = http.client.HTTPConnection(host, timeout=60)
    conn.request("GET", f"/subscribe/{sid}/stream?after=0")
    resp = conn.getresponse()
    buf = b""
    try:
        while len(out) < n_frames:
            size = int(resp.fp.readline().strip() or b"0", 16)  # chunked transfer
            if size == 0:
                break
            buf += resp.fp.read(size)
            resp.fp.readline()
            while b"\n\n" in buf:
                frame, buf = buf.split(b"\n\n", 1)
                if frame.startswith(b"id:"):
                    out.append(frame)
    finally:
        conn.close()


def _run_cross(node, host, client_import, steps):
    import threading

    def post(path, body):
        conn = http.client.HTTPConnection(host, timeout=60)
        try:
            conn.request("POST", path, body=body)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    for path, body in (("/index/i", b""), ("/index/i/frame/f", b"")):
        assert post(path, body)[0] == 200
    subs = []
    for q in CROSS_QUERIES:
        st, body = post("/subscribe", json.dumps({"index": "i", "query": q}).encode())
        assert st == 201, body
        subs.append(json.loads(body))
    frames = {s["id"]: [] for s in subs}
    polls = {s["id"]: [] for s in subs}
    cursors = {s["id"]: 0 for s in subs}
    for kind, payload in steps:
        if kind == "pql":
            st, body = post("/index/i/query", payload.encode())
            assert st == 200, body
        else:
            for sl in sorted({c // SLICE_WIDTH for _, c in payload}):
                client_import(sl, [b for b in payload if b[1] // SLICE_WIDTH == sl])
        assert node.subscribe.flush(timeout=20)
        for s in subs:
            sid = s["id"]
            while True:
                conn = http.client.HTTPConnection(host, timeout=60)
                conn.request("GET", f"/subscribe/{sid}/poll?after={cursors[sid]}&timeout_ms=50")
                doc = json.loads(conn.getresponse().read())
                conn.close()
                if doc.get("timeout"):
                    break
                assert doc["version"] > cursors[sid]
                cursors[sid] = doc["version"]
                polls[sid].append(doc)
    readers = [threading.Thread(target=_sse_frames, args=(host, s["id"], cursors[s["id"]], frames[s["id"]]))
               for s in subs]
    for t in readers:
        t.start()
    for t in readers:
        t.join(timeout=30)

    def norm(sid, x):
        if isinstance(x, bytes):
            return x.replace(sid.encode(), b"SID")
        return {k: ("SID" if k == "id" else v) for k, v in x.items()}

    return ([norm(s["id"], {k: v for k, v in s.items() if k != "id"}) for s in subs],
            [[norm(s["id"], d) for d in polls[s["id"]]] for s in subs],
            [[norm(s["id"], f) for f in frames[s["id"]]] for s in subs])


class TestCrossPackageDelivery:
    def test_same_writes_same_updates_and_frames(self, tmp_path):
        from pilosa_tpu.net.client import InternalClient as JClient
        from pilosa_tpu.net.server import Server as JServer

        steps = _cross_steps()
        # One notification batch per step: the coalescing window outlasts
        # a step's request on both nodes.
        j = JServer(data_dir=str(tmp_path / "jax"), host="127.0.0.1:0", admission=False,
                    anti_entropy_interval=3600, polling_interval=3600, cache_flush_interval=3600,
                    subscribe_coalesce_ms=400.0)
        t = Server(str(tmp_path / "torch"), device="cpu", floor_probe=False,
                   anti_entropy_interval=3600, polling_interval=3600, subscribe_coalesce_ms=400.0)
        j.open()
        t.open()
        try:
            jc = JClient(j.host, timeout=30.0)
            tc = InternalClient(t.host, timeout=30.0, device="cpu")
            got_j = _run_cross(j, j.host, lambda sl, bits: jc.import_bits("i", "f", sl, bits), steps)
            got_t = _run_cross(t, t.host, lambda sl, bits: _import(tc, "i", "f", sl, bits), steps)
        finally:
            t.close()
            j.close()
        regs_j, polls_j, frames_j = got_j
        regs_t, polls_t, frames_t = got_t
        assert regs_t == regs_j
        assert polls_t == polls_j
        assert frames_t == frames_j
        assert all(len(p) >= 3 for p in polls_t), polls_t  # the values moved
        assert [len(f) for f in frames_t] == [p[-1]["version"] for p in polls_t]
