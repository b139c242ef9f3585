"""The cold tier (``pilosa_tpu_torch/tier``), with the JAX package's
``tests/test_tier.py`` cases run against the port: the object-store
backends, self-verifying fragment archives, demand hydration, LRU
demotion under a disk budget, time-quantum retention, the cold boot of a
node from the store alone and a resize that copies through the store.
Only the harness differs: a port ``Holder`` and ``Server`` run with
``device="cpu"``, and the port's client imports ``(rows, cols)``.  The
JAX file's two configuration cases (``TestPlumbing.test_config_*``) wait
for the port of ``config.py``.

Then the cross-package checks: a store that one package's
``TierManager.upload_all`` wrote cold-boots a node of the other, which
answers every query class with the bytes the writer's node answers; the
object keys and metadata are equal; and the port's hooks under the tier
(``Fragment.retire``, per-fragment write listeners, the view's cold
state, ``Holder.hot_slices``, the prefetcher's hydrate lane and
``plan.collect_leaf_calls``) behave as the JAX package's do."""

from __future__ import annotations

import http.client
import io
import json
import os
import tarfile
import threading
import time
from datetime import datetime

import numpy as np
import pytest

pytest.importorskip("torch")

from pilosa_tpu_torch.core import timequantum as tq  # noqa: E402
from pilosa_tpu_torch.core.fragment import (  # noqa: E402
    ArchiveChecksumError,
    FragmentRetiredError,
)
from pilosa_tpu_torch.core.holder import Holder  # noqa: E402
from pilosa_tpu_torch.net.client import ClientError, InternalClient  # noqa: E402
from pilosa_tpu_torch.net.server import Server  # noqa: E402
from pilosa_tpu_torch.ops.bitplane import SLICE_WIDTH  # noqa: E402
from pilosa_tpu_torch.tier import (  # noqa: E402
    HydrationError,
    LocalFSStore,
    TierManager,
    fragment_store_key,
    open_store,
    parse_fragment_store_key,
)
from pilosa_tpu_torch.tier.store import StoreChecksumError, StoreError, _ServedStore  # noqa: E402


def make_holder(tmp_path, name="data") -> Holder:
    h = Holder(str(tmp_path / name), device="cpu")
    h.open()
    return h


def seeded_frame(holder, n_bits=300, rows=5):
    idx = holder.create_index_if_not_exists("i")
    fr = idx.create_frame_if_not_exists("f")
    for c in range(n_bits):
        fr.set_bit("standard", c % rows, c)
    return fr


def wait_for(pred, timeout=10.0, every=0.02):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(every)
    return pred()


# ---------------------------------------------------------------------------
# object store backends
# ---------------------------------------------------------------------------


class TestLocalFSStore:
    def test_roundtrip_and_meta(self, tmp_path):
        s = LocalFSStore(str(tmp_path / "store"))
        meta = s.put("fragments/i/f/standard/0.tar", b"hello", extra={"x": 1})
        assert meta.size == 5
        assert s.get("fragments/i/f/standard/0.tar") == b"hello"
        got = s.get_meta("fragments/i/f/standard/0.tar")
        assert got.extra == {"x": 1}
        assert got.sha256 == meta.sha256
        assert [m.key for m in s.list("fragments/")] == ["fragments/i/f/standard/0.tar"]
        assert s.delete("fragments/i/f/standard/0.tar")
        assert not s.delete("fragments/i/f/standard/0.tar")
        assert s.get_meta("fragments/i/f/standard/0.tar") is None

    def test_get_rejects_corrupt_content_with_named_error(self, tmp_path):
        s = LocalFSStore(str(tmp_path / "store"))
        s.put("k/v.tar", b"payload")
        with open(tmp_path / "store" / "k" / "v.tar", "wb") as f:
            f.write(b"rotted!")
        with pytest.raises(StoreChecksumError):
            s.get("k/v.tar")

    def test_key_validation(self, tmp_path):
        s = LocalFSStore(str(tmp_path / "store"))
        for bad in ("", "/abs", "a/../b", "x.pmeta", "a//b"):
            with pytest.raises(StoreError):
                s.put(bad, b"")

    def test_missing_object_raises(self, tmp_path):
        s = LocalFSStore(str(tmp_path / "store"))
        with pytest.raises(StoreError):
            s.get("nope/nothing.tar")


class TestHTTPStore:
    def test_roundtrip_over_real_http(self, tmp_path):
        with _ServedStore(str(tmp_path / "store")) as url:
            s = open_store(url)
            s.put("a/b.tar", b"data", extra={"checksum": "ff"})
            assert s.get("a/b.tar") == b"data"
            assert s.get_meta("a/b.tar").extra == {"checksum": "ff"}
            assert s.get_meta("a/missing.tar") is None
            assert [m.key for m in s.list("a/")] == ["a/b.tar"]
            assert s.delete("a/b.tar")
            assert not s.delete("a/b.tar")

    def test_server_rejects_torn_upload(self, tmp_path):
        from pilosa_tpu_torch.tier.store import SHA_HEADER

        with _ServedStore(str(tmp_path / "store")) as url:
            host = url[len("http://"):]
            conn = http.client.HTTPConnection(host, timeout=10)
            conn.request("PUT", "/k.tar", body=b"bytes", headers={SHA_HEADER: "0" * 64})
            resp = conn.getresponse()
            assert resp.status == 422
            conn.close()

    def test_down_store_fails_fast_and_loud(self, tmp_path):
        from pilosa_tpu_torch.net import resilience as rz

        s = open_store(
            "http://127.0.0.1:1",  # nothing listens here
            retry=rz.RetryPolicy(attempts=1, backoff=0.001),
        )
        with pytest.raises(OSError):
            s.get("a/b.tar")


# ---------------------------------------------------------------------------
# self-verifying fragment tars
# ---------------------------------------------------------------------------


class TestArchiveChecksums:
    def _tar(self, holder) -> bytes:
        frag = holder.fragment("i", "f", "standard", 0)
        buf = io.BytesIO()
        frag.write_to(buf)
        return buf.getvalue()

    def test_archive_carries_checksum_entry_first(self, tmp_path):
        holder = make_holder(tmp_path)
        seeded_frame(holder)
        tf = tarfile.open(fileobj=io.BytesIO(self._tar(holder)))
        names = tf.getnames()
        assert names[0] == "checksum"
        doc = json.loads(tf.extractfile("checksum").read())
        assert set(doc["entries"]) == {"data", "cache"}

    def test_roundtrip_restores_identical_content(self, tmp_path):
        holder = make_holder(tmp_path)
        seeded_frame(holder)
        raw = self._tar(holder)
        other = make_holder(tmp_path, "other")
        fr = other.create_index("i").create_frame("f")
        frag = fr.create_view_if_not_exists("standard").create_fragment_if_not_exists(0)
        frag.read_from(io.BytesIO(raw))
        assert frag.count() == holder.fragment("i", "f", "standard", 0).count()
        assert frag.checksum() == holder.fragment("i", "f", "standard", 0).checksum()

    @staticmethod
    def _flip_data_byte(raw: bytes) -> bytes:
        """Corrupt one byte inside the data member's payload (tar padding
        between members is not covered by the checksums)."""
        tf = tarfile.open(fileobj=io.BytesIO(raw))
        member = tf.getmember("data")
        out = bytearray(raw)
        out[member.offset_data + 16] ^= 0xFF
        return bytes(out)

    def test_torn_payload_rejected_without_installing(self, tmp_path):
        holder = make_holder(tmp_path)
        seeded_frame(holder)
        raw = self._flip_data_byte(self._tar(holder))
        other = make_holder(tmp_path, "other")
        fr = other.create_index("i").create_frame("f")
        frag = fr.create_view_if_not_exists("standard").create_fragment_if_not_exists(0)
        before = frag.count()
        with pytest.raises(ArchiveChecksumError):
            frag.read_from(io.BytesIO(raw))
        assert frag.count() == before  # nothing half-installed

    def test_legacy_tar_without_checksum_still_restores(self, tmp_path):
        holder = make_holder(tmp_path)
        seeded_frame(holder)
        tf = tarfile.open(fileobj=io.BytesIO(self._tar(holder)))
        out = io.BytesIO()
        tw = tarfile.open(fileobj=out, mode="w|")
        for name in ("data", "cache"):  # strip the checksum entry
            payload = tf.extractfile(name).read()
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tw.addfile(info, io.BytesIO(payload))
        tw.close()
        other = make_holder(tmp_path, "other")
        fr = other.create_index("i").create_frame("f")
        frag = fr.create_view_if_not_exists("standard").create_fragment_if_not_exists(0)
        frag.read_from(io.BytesIO(out.getvalue()))
        assert frag.count() == 300

    def test_http_restore_rejects_torn_tar_with_422(self, tmp_path):
        holder = make_holder(tmp_path)
        seeded_frame(holder)
        raw = self._flip_data_byte(self._tar(holder))
        with Server(str(tmp_path / "srv"), device="cpu", floor_probe=False,
                    anti_entropy_interval=3600, polling_interval=3600) as s:
            c = InternalClient(s.host, device="cpu")
            c.create_index("i")
            c.create_frame("i", "f")
            with pytest.raises(ClientError) as ei:
                c.restore_slice("i", "f", "standard", 0, raw)
            assert ei.value.status == 422
            assert "torn" in str(ei.value)


# ---------------------------------------------------------------------------
# TierManager: hydration / demotion / budget
# ---------------------------------------------------------------------------


class TestHydrationAndDemotion:
    def _managed(self, tmp_path, **kwargs):
        store = LocalFSStore(str(tmp_path / "store"))
        holder = make_holder(tmp_path)
        fr = seeded_frame(holder)
        mgr = TierManager(holder, store, **kwargs)
        mgr.attach_all()
        return holder, fr, mgr

    def test_demote_then_first_touch_hydrates(self, tmp_path):
        holder, fr, mgr = self._managed(tmp_path)
        view = fr.view("standard")
        assert mgr.demote(view, 0)
        assert view.cold_slices() == {0}
        assert not os.path.exists(os.path.join(view.fragments_path, "0"))
        # metadata still resident: the slice is visible to planners
        assert view.fragment_slices() == {0}
        assert view.max_slice() == 0
        frag = view.fragment(0)  # first touch
        assert frag is not None and frag.count() == 300
        assert view.cold_slices() == set()
        key = fragment_store_key("i", "f", "standard", 0)
        assert mgr.snapshot()["fragments"][key]["history"][-3:] == ["cold", "hydrating", "hot"]

    def test_hydration_rides_the_hydrate_lane(self, tmp_path):
        """A manager built without a prefetcher hydrates on the shared
        one's lane, the one a server wires, never on its caller's thread."""
        import threading

        holder, fr, mgr = self._managed(tmp_path)
        view = fr.view("standard")
        assert mgr.demote(view, 0)
        threads = []
        owner = mgr._hydrate_owner

        def spy(*a, **k):
            threads.append(threading.current_thread().name)
            return owner(*a, **k)

        mgr._hydrate_owner = spy
        assert view.fragment(0).count() == 300
        assert threads == ["hbm-prefetch"]

    def test_demotion_aborts_when_a_write_races_the_upload(self, tmp_path):
        holder, fr, mgr = self._managed(tmp_path)
        view = fr.view("standard")
        frag = view.fragment(0)
        version = frag._version
        meta = mgr.upload_fragment(frag)
        frag.set_bit(7, 77)  # lands after the snapshot
        popped = view.demote_fragment(0, meta, expect=frag, expect_version=version)
        assert popped is None  # stayed hot: the upload is stale
        assert view.fragment(0) is frag

    def test_write_to_retired_fragment_revives_by_hydration(self, tmp_path):
        holder, fr, mgr = self._managed(tmp_path)
        view = fr.view("standard")
        frag = view.fragment(0)
        assert mgr.demote(view, 0)
        # a writer that captured the fragment before the demotion
        with pytest.raises(FragmentRetiredError):
            frag.set_bit(1, 1)
        # the view-level write revives through hydration, losing nothing
        assert view.set_bit(99, 42) is True
        assert view.fragment(0).count() == 301
        assert view.fragment(0).contains(99, 42)

    def test_hydration_failure_is_loud(self, tmp_path):
        holder, fr, mgr = self._managed(tmp_path)
        view = fr.view("standard")
        assert mgr.demote(view, 0)
        mgr.store.delete(fragment_store_key("i", "f", "standard", 0))
        with pytest.raises(HydrationError):
            view.fragment(0)
        # and a write cannot silently create an empty shadow either
        with pytest.raises(HydrationError):
            view.set_bit(0, 0)

    def test_concurrent_first_touch_hydrates_once(self, tmp_path):
        holder, fr, mgr = self._managed(tmp_path)
        view = fr.view("standard")
        assert mgr.demote(view, 0)
        results, errors = [], []

        def touch():
            try:
                results.append(view.fragment(0))
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=touch) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        assert len({id(f) for f in results}) == 1  # one install, shared

    def test_disk_budget_demotes_lru(self, tmp_path):
        store = LocalFSStore(str(tmp_path / "store"))
        holder = make_holder(tmp_path)
        idx = holder.create_index("i")
        fr = idx.create_frame("f")
        for s in range(3):
            for c in range(100):
                fr.set_bit("standard", c % 3, s * SLICE_WIDTH + c)
        mgr = TierManager(holder, store, disk_budget_bytes=1)
        mgr.attach_all()
        view = fr.view("standard")
        # establish LRU: slice 2 touched most recently
        view.fragment(0)
        view.fragment(1)
        view.fragment(2)
        demoted = mgr.enforce_disk_budget()
        assert demoted == 3  # budget of 1 byte: everything demotes
        assert view.cold_slices() == {0, 1, 2}
        # queries transparently hydrate back — byte-identical content
        assert view.fragment(1).count() == 100

    def test_hydrate_throttle_paces_reads(self, tmp_path):
        holder, fr, mgr = self._managed(tmp_path, hydrate_throttle_mbps=0.05)  # ~6.25 KB/s
        view = fr.view("standard")
        # The gate charges each read against the next (bursts of one are
        # free; the sustained rate is what's bounded): the second
        # hydration must wait out the first read's debt.
        assert mgr.demote(view, 0)
        view.fragment(0)
        assert mgr.demote(view, 0)
        t0 = time.monotonic()
        view.fragment(0)
        # the fragment tar is a few KB at ~6 KB/s: visible pacing
        assert time.monotonic() - t0 > 0.2


# ---------------------------------------------------------------------------
# retention (time-quantum views)
# ---------------------------------------------------------------------------


class TestRetention:
    def _frame_with_history(self, tmp_path):
        store = LocalFSStore(str(tmp_path / "store"))
        holder = make_holder(tmp_path)
        idx = holder.create_index("i")
        fr = idx.create_frame("f", time_quantum="YMD")
        for c in range(40):
            fr.set_bit("standard", 1, c, t=datetime(2024, 1, 1, 12))
            fr.set_bit("standard", 2, c, t=datetime(2024, 3, 1, 12))
        return store, holder, fr

    def test_parse_time_view(self):
        assert tq.parse_time_view("standard_2024") == ("standard", datetime(2024, 1, 1), "Y")
        assert tq.parse_time_view("standard_20240301") == ("standard", datetime(2024, 3, 1), "D")
        assert tq.parse_time_view("standard") is None
        assert tq.parse_time_view("standard_abc") is None

    def test_sweep_ages_exact_view_sets_then_deletes(self, tmp_path):
        store, holder, fr = self._frame_with_history(tmp_path)
        mgr = TierManager(holder, store, retention_age_s=30 * 86400.0,
                          retention_delete_s=90 * 86400.0)
        mgr.attach_all()
        out = mgr.sweep_retention(now=datetime(2024, 4, 15))
        # Jan 1 D-view (ended Jan 2, ~104d): DELETED.  Jan M-view (ended
        # Feb 1, ~74d) and Mar 1 D-view (ended Mar 2, ~44d): aged to the
        # store.  Mar M-view (ended Apr 1, 14d) and the Y-view (still
        # open): untouched.
        assert out == {"aged": 2, "deleted": 1}
        assert fr.view("standard_20240101") is None
        v = fr.view("standard_202401")
        assert v is not None and v.cold_slices() == {0}
        assert fr.view("standard_202403").cold_slices() == set()
        # deleted view's store object is gone too
        assert store.get_meta(fragment_store_key("i", "f", "standard_20240101", 0)) is None
        # aged view still answers queries by hydration
        assert fr.view("standard_202401").fragment(0).count() == 40

    def test_racing_writer_to_expired_view_revives(self, tmp_path):
        store, holder, fr = self._frame_with_history(tmp_path)
        mgr = TierManager(holder, store, retention_age_s=86400.0)
        mgr.attach_all()
        mgr.sweep_retention(now=datetime(2024, 6, 1))
        v = fr.view("standard_20240101")
        assert v.cold_slices() == {0}
        # a write to the aged view hydrates it back and lands — old bits
        # intact, new bit present, nothing silently lost
        fr.set_bit("standard", 5, 7, t=datetime(2024, 1, 1, 9))
        assert v.fragment(0).count() == 41
        assert v.fragment(0).contains(5, 7)

    def test_per_frame_override_beats_global(self, tmp_path):
        store, holder, fr = self._frame_with_history(tmp_path)
        fr.set_options(retention_age_s=10 * 365 * 86400.0)  # effectively off
        mgr = TierManager(holder, store, retention_age_s=86400.0)
        mgr.attach_all()
        out = mgr.sweep_retention(now=datetime(2024, 6, 1))
        assert out == {"aged": 0, "deleted": 0}

    def test_frame_meta_persists_retention(self, tmp_path):
        holder = make_holder(tmp_path)
        fr = holder.create_index("i").create_frame("f", time_quantum="YMD")
        fr.set_options(retention_age_s=5.0, retention_delete_s=9.0)
        holder.close()
        holder2 = make_holder(tmp_path)
        fr2 = holder2.frame("i", "f")
        assert fr2.retention_age_s == 5.0
        assert fr2.retention_delete_s == 9.0


# ---------------------------------------------------------------------------
# cold boot from the store alone
# ---------------------------------------------------------------------------


def _quiet_server(tmp_path, name, store_url, **kwargs) -> Server:
    return Server(
        str(tmp_path / name),
        device="cpu",
        floor_probe=False,
        tier_store=store_url,
        anti_entropy_interval=3600,
        polling_interval=3600,
        tier_sweep_interval_s=3600,
        **kwargs,
    )


def _import(client, index, frame, slice_i, bits):
    client.import_slice(index, frame, slice_i, [b[0] for b in bits], [b[1] for b in bits])


class TestColdBoot:
    def test_cold_boot_serves_byte_identical_results(self, tmp_path):
        store_url = str(tmp_path / "store")
        donor = _quiet_server(tmp_path, "donor", store_url)
        donor.open()
        c0 = InternalClient(donor.host, device="cpu")
        c0.create_index("i")
        c0.create_frame("i", "f", {"rangeEnabled": True})
        c0.create_field("i", "f", "val", 0, 1000)
        bits = [(c % 11, c) for c in range(2 * SLICE_WIDTH - 400, 2 * SLICE_WIDTH + 400)]
        for s in (1, 2):
            _import(c0, "i", "f", s, [b for b in bits if b[1] // SLICE_WIDTH == s])
        c0.import_value("i", "f", "val", 1, [2 * SLICE_WIDTH - 10, 2 * SLICE_WIDTH - 5], [7, 900])
        queries = [
            'Count(Bitmap(frame="f", rowID=1))',
            'Count(Union(Bitmap(frame="f", rowID=1), Bitmap(frame="f", rowID=2)))',
            'TopN(frame="f", n=5)',
            'Count(Range(frame="f", val > 5))',
        ]
        want = [c0.execute_pql("i", q) for q in queries]
        assert donor.tier.upload_all() == 3
        donor.close()

        cold = _quiet_server(tmp_path, "empty", store_url)
        cold.open()
        try:
            c1 = InternalClient(cold.host, device="cpu")
            snap = json.loads(c1._check(*c1._request("GET", "/debug/tier")))
            assert snap["fragments"], "bootstrap must register cold fragments"
            assert all(v["state"] == "cold" for v in snap["fragments"].values())
            got = [c1.execute_pql("i", q) for q in queries]
            for q, w, g in zip(queries, want, got):
                if hasattr(w, "__iter__"):
                    w = [(p.id, p.count) for p in w]
                    g = [(p.id, p.count) for p in g]
                assert g == w, f"{q}: {g} != {w}"
            snap = json.loads(c1._check(*c1._request("GET", "/debug/tier")))
            hot = {k for k, v in snap["fragments"].items() if v["state"] == "hot"}
            assert hot, "demand hydration must have engaged"
            for v in snap["fragments"].values():
                if v["state"] == "hot":
                    assert v["history"][-3:] == ["cold", "hydrating", "hot"]
        finally:
            cold.close()

    def test_store_riding_rebalance_copy(self, tmp_path):
        """A joining node restores slices from the object store instead
        of peer streams when the store holds fresh checksums."""
        from pilosa_tpu_torch.obs.stats import ExpvarStatsClient

        store_url = str(tmp_path / "store")
        a = _quiet_server(tmp_path, "a", store_url, stats=ExpvarStatsClient())
        a.open()
        b = _quiet_server(tmp_path, "b", store_url, stats=ExpvarStatsClient(), hosts=[a.host])
        b.open()  # joining node: not in the ring
        try:
            ca = InternalClient(a.host, device="cpu")
            ca.create_index("i")
            ca.create_frame("i", "f")
            b.holder.create_index_if_not_exists("i").create_frame_if_not_exists("f")
            for s in range(3):
                _import(ca, "i", "f", s, [(c % 7, s * SLICE_WIDTH + c) for c in range(120)])
            count_before = ca.execute_pql("i", 'Count(Bitmap(frame="f", rowID=1))')
            a.tier.upload_all()
            st, data = ca._request(
                "POST", "/cluster/resize",
                body=json.dumps({"hosts": sorted([a.host, b.host])}).encode(),
            )
            ca._check(st, data)
            snap = {}

            def done():
                nonlocal snap
                snap = json.loads(ca._check(*ca._request("GET", "/debug/rebalance")))
                return not snap.get("running") and snap.get("transition") is None

            assert wait_for(done, timeout=30.0, every=0.2), f"resize did not complete: {snap}"
            assert not snap.get("lastError"), snap
            # the copy rode the store, not peer streams
            vars_a = json.loads(ca._check(*ca._request("GET", "/debug/vars")))
            counts = (vars_a.get("stats") or {}).get("counts", {})
            store_restores = sum(v for k, v in counts.items()
                                 if k.startswith("cluster.rebalance.storeRestores"))
            assert store_restores > 0, counts
            assert ca.execute_pql("i", 'Count(Bitmap(frame="f", rowID=1))') == count_before
        finally:
            b.close()
            a.close()


# ---------------------------------------------------------------------------
# store-key helpers
# ---------------------------------------------------------------------------


class TestPlumbing:
    def test_fragment_store_key_roundtrip(self):
        key = fragment_store_key("idx", "fr", "standard_2024", 7)
        assert key == "fragments/idx/fr/standard_2024/7.tar"
        assert parse_fragment_store_key(key) == ("idx", "fr", "standard_2024", 7)
        assert parse_fragment_store_key("fragments/short.tar") is None
        assert parse_fragment_store_key("schema.json") is None


# ---------------------------------------------------------------------------
# the port's hooks under the tier, each against the JAX package's
# ---------------------------------------------------------------------------


def _jax_holder(path):
    from pilosa_tpu.core.holder import Holder as JHolder

    h = JHolder(str(path))
    h.open()
    return h


class TestCoreHooks:
    def test_frag_write_listener_fires_and_drops_at_retire(self, tmp_path):
        got = {"jax": [], "torch": []}
        holders = {"jax": _jax_holder(tmp_path / "j"), "torch": make_holder(tmp_path, "t")}
        for name, h in holders.items():
            fr = seeded_frame(h, n_bits=10)
            frag = h.fragment("i", "f", "standard", 0)
            frag.add_write_listener(lambda f, sr, sc, cr, cc, exact, name=name:
                                    got[name].append((list(sr), list(sc), list(cr), list(cc), exact)))
            assert frag.write_listener_count() == 1
            frag.set_bit(1, 3)
            frag.set_bit(1, 3)  # no change: no notification
            frag.clear_bit(2, 2)
            frag.import_bulk([4, 4], [5, 6])
            version = frag._version
            assert frag.mark_retired_if_version(version)
            frag.close()  # a demotion closes the retired fragment
            assert frag.write_listener_count() == 0
            with pytest.raises(Exception) as ei:
                frag.set_bit(0, 1)
            assert type(ei.value).__name__ == "FragmentRetiredError"
            with pytest.raises(Exception):
                frag.import_bulk([0], [1])
            fr.view("standard").remove_fragment(0)
            h.close()
        assert got["torch"] == got["jax"]
        assert got["torch"][:2] == [([1], [3], [], [], True), ([], [], [2], [2], True)]

    def test_version_token_refuses_after_a_write(self, tmp_path):
        h = make_holder(tmp_path)
        seeded_frame(h, n_bits=10)
        frag = h.fragment("i", "f", "standard", 0)
        v = frag._version
        frag.set_bit(9, 9)
        assert not frag.mark_retired_if_version(v)
        assert frag.set_bit(9, 10)  # still writable
        frag.add_write_listener(lambda *a: None)
        frag.close()
        assert frag.write_listener_count() == 0  # dropped at close
        h.close()

    def test_cold_state_matches_jax_view(self, tmp_path):
        out = {}
        for name, h in (("jax", _jax_holder(tmp_path / "j")), ("torch", make_holder(tmp_path, "t"))):
            fr = seeded_frame(h, n_bits=10)
            v = fr.view("standard")
            assert v.register_cold(3, {"m": 1})
            assert not v.register_cold(0, {"m": 2})  # a hot fragment holds it
            # no hydrator attached: a cold slice reads as absent
            out[name] = (sorted(v.fragment_slices()), v.max_slice(), sorted(v.cold_slices()),
                         v.cold_meta(3), v.fragment(3), v.remove_fragment(3), sorted(v.cold_slices()))
            v.register_cold(5, "x")
            v.drop_cold(5)
            assert v.cold_slices() == set()
            h.close()
        assert out["torch"] == out["jax"]

    def test_hot_slices_from_pool_mru(self, tmp_path):
        h = make_holder(tmp_path)
        fr = h.create_index("hotidx").create_frame("f")
        for s in (0, 1, 2):
            fr.set_bit("standard", 1, s * SLICE_WIDTH + 5)
        for s in (2, 0, 1):  # 1 is the most recently uploaded mirror
            h.fragment("hotidx", "f", "standard", s).device_plane()
        assert h.hot_slices(limit=32)["hotidx"] == [1, 0, 2]
        assert h.hot_slices(limit=1) == {"hotidx": [1]}
        h.close()

    def test_staging_puts_gossiped_hot_slices_first(self, tmp_path):
        h = make_holder(tmp_path)
        fr = h.create_index("i").create_frame("f")
        for s in range(5):
            fr.set_bit("standard", 1, s * SLICE_WIDTH + 5)
        staged = []

        class Recorder:
            def stage(self, frags, throttle_s=0.0):
                staged.extend(f.slice for f in frags)

                class Job:
                    total = len(frags)

                return Job()

        h.stage_device_mirrors(Recorder(), hot_slices={"i": [3, 1], "other": [0]})
        assert staged[:2] == [3, 1]
        assert sorted(staged) == [0, 1, 2, 3, 4]
        h.close()

    def test_hydrate_lane_runs_after_query_lane_and_relays(self):
        from pilosa_tpu_torch.device.prefetch import Prefetcher

        p = Prefetcher(max_workers=2)
        assert p.run_hydration(lambda: 41 + 1) == 42
        with pytest.raises(KeyError):
            p.run_hydration(lambda: {}["missing"])
        assert p.wait_idle(timeout=5)

    def test_collect_leaf_calls_matches_jax(self):
        from pilosa_tpu.exec import plan as jplan
        from pilosa_tpu.pql.parser import parse_string as jparse
        from pilosa_tpu_torch.exec import plan as tplan
        from pilosa_tpu_torch.pql.parser import parse_string as tparse

        for q in (
            "Count(Intersect(Bitmap(rowID=1, frame=f), Union(Bitmap(rowID=2), Range(frame=t, rowID=3, "
            'start="2017-01-01T00:00", end="2017-02-01T00:00"))))',
            "TopN(Difference(Bitmap(rowID=1), Bitmap(rowID=4)), frame=f, n=3)",
            "Subscribe(Count(Bitmap(columnID=7, frame=f)))",
        ):
            j = [(c.name, sorted(c.args.items())) for c in jplan.collect_leaf_calls(jparse(q).calls[0])]
            t = [(c.name, sorted(c.args.items())) for c in tplan.collect_leaf_calls(tparse(q).calls[0])]
            assert t == j and t


# ---------------------------------------------------------------------------
# cross-package: one store, either package's node
# ---------------------------------------------------------------------------


QUERIES = [
    'Count(Bitmap(frame="f", rowID=1))',
    'Bitmap(frame="f", rowID=2)',
    'Count(Intersect(Bitmap(frame="f", rowID=1), Bitmap(frame="f", rowID=3)))',
    'Count(Union(Bitmap(frame="f", rowID=1), Bitmap(frame="f", rowID=2)))',
    'Count(Difference(Bitmap(frame="f", rowID=1), Bitmap(frame="f", rowID=4)))',
    'Count(Xor(Bitmap(frame="f", rowID=0), Bitmap(frame="f", rowID=5)))',
    'TopN(frame="f", n=4)',
    'TopN(Bitmap(frame="f", rowID=1), frame="f", n=3)',
    'Count(Range(frame="t", rowID=1, start="2017-01-01T00:00", end="2017-03-01T00:00"))',
    'Count(Range(frame="v", val > 300))',
    'Sum(frame="v", field="val")',
    'Min(frame="v", field="val")',
    'Max(frame="v", field="val")',
]


def _post(host, path, body=b"", method="POST"):
    conn = http.client.HTTPConnection(host, timeout=60)
    try:
        conn.request(method, path, body=body, headers={"Accept": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _populate(host):
    rng = np.random.default_rng(7)
    for path, body in (
        ("/index/i", b""),
        ("/index/i/frame/f", b""),
        ("/index/i/frame/t", b'{"options": {"timeQuantum": "YMD"}}'),
        ("/index/i/frame/v", b'{"options": {"rangeEnabled": true}}'),
        ("/index/i/frame/v/field/val", b'{"type": "int", "min": 0, "max": 1000}'),
    ):
        assert _post(host, path, body)[0] == 200, path
    writes = []
    for _ in range(400):
        r = int(rng.integers(0, 6))
        c = int(rng.integers(0, 3 * SLICE_WIDTH))
        writes.append(f"SetBit(frame=f, rowID={r}, columnID={c})")
    for r, c, ts in ((1, 3, "2017-01-05T00:00"), (1, SLICE_WIDTH + 9, "2017-02-02T00:00"),
                     (2, 44, "2017-01-09T00:00")):
        writes.append(f'SetBit(frame=t, rowID={r}, columnID={c}, timestamp="{ts}")')
    st, body = _post(host, "/index/i/query", " ".join(writes).encode())
    assert st == 200, body
    for sl in range(3):
        cols = list(range(sl * SLICE_WIDTH, (sl + 1) * SLICE_WIDTH, SLICE_WIDTH // 7))
        body = json.dumps({"index": "i", "frame": "v", "field": "val", "slice": sl, "columnIDs": cols,
                           "values": [int(v) for v in rng.integers(0, 1000, len(cols))]})
        st, resp = _post(host, "/import-value", body.encode())
        assert st == 200, resp


def _answers(host):
    return [_post(host, "/index/i/query", q.encode()) for q in QUERIES]


def _store_listing(store):
    return [(m.key, m.size, m.sha256, m.extra) for m in store.list("")]


class TestCrossPackageStore:
    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_store_written_by_one_cold_boots_the_other(self, tmp_path, writer):
        from pilosa_tpu.net.server import Server as JServer
        from pilosa_tpu.tier import LocalFSStore as JStore
        from pilosa_tpu.tier import TierManager as JTier

        def jax_node(name, **kw):
            return JServer(data_dir=str(tmp_path / name), host="127.0.0.1:0", admission=False,
                           anti_entropy_interval=3600, polling_interval=3600,
                           cache_flush_interval=3600, tier_sweep_interval_s=3600, **kw)

        def torch_node(name, **kw):
            return Server(str(tmp_path / name), device="cpu", floor_probe=False,
                          anti_entropy_interval=3600, polling_interval=3600,
                          tier_sweep_interval_s=3600, **kw)

        # Both packages' nodes hold the same data; each uploads to a store
        # of its own, and the two stores must list the same objects.
        j, t = jax_node("jw"), torch_node("tw")
        j.open()
        t.open()
        try:
            for s in (j, t):
                _populate(s.host)
            want = {"jax": _answers(j.host), "torch": _answers(t.host)}
            assert want["jax"] == want["torch"]
            JTier(j.holder, JStore(str(tmp_path / "sj"))).upload_all()
            TierManager(t.holder, LocalFSStore(str(tmp_path / "st"))).upload_all()
        finally:
            j.close()
            t.close()
        sj, st = JStore(str(tmp_path / "sj")), LocalFSStore(str(tmp_path / "st"))
        lj = [(k, sz, sha, ex) for k, sz, sha, ex in
              ((m.key, m.size, m.sha256, m.extra) for m in sj.list(""))]
        lt = _store_listing(st)
        assert [x[0] for x in lj] == [x[0] for x in lt]  # keys
        assert [x[3] for x in lj] == [x[3] for x in lt]  # logical checksums
        assert sj.get("schema.json") == st.get("schema.json")
        # The reader of the other package cold-boots from the writer's store.
        src = str(tmp_path / ("sj" if writer == "jax" else "st"))
        reader = torch_node("tr", tier_store=src) if writer == "jax" else jax_node("jr", tier_store=src)
        reader.open()
        try:
            snap = json.loads(_post(reader.host, "/debug/tier", method="GET")[1])
            assert snap["countsByState"].get("cold", 0) == len(lt) - 1  # all but the schema
            assert _answers(reader.host) == want[writer]
            hydrated = json.loads(_post(reader.host, "/debug/tier", method="GET")[1])
            assert hydrated["countsByState"].get("hot", 0) > 0
        finally:
            reader.close()


def _members(raw: bytes) -> dict:
    tf = tarfile.open(fileobj=io.BytesIO(raw))
    return {m.name: tf.extractfile(m).read() for m in tf.getmembers()}


class TestStoreCLI:
    def test_backup_and_restore_through_a_store_match_the_jax_cli(self, tmp_path):
        """``backup --store`` of the port's CLI writes the objects the JAX
        CLI writes from the same node, and ``restore --store`` into an
        empty node answers as the source does."""
        from pilosa_tpu.cli.main import main as jmain
        from pilosa_tpu_torch.cli.main import main as tmain

        src = Server(str(tmp_path / "src"), device="cpu", floor_probe=False,
                     anti_entropy_interval=3600, polling_interval=3600)
        dst = Server(str(tmp_path / "dst"), device="cpu", floor_probe=False,
                     anti_entropy_interval=3600, polling_interval=3600)
        src.open()
        dst.open()
        try:
            _populate(src.host)
            want = _answers(src.host)
            with _ServedStore(str(tmp_path / "http-store")) as url:
                assert tmain(["backup", "--host", src.host, "-i", "i", "--store", url,
                                  "-v", ""]) == 0
            assert jmain(["backup", "--host", src.host, "-i", "i", "--store",
                              str(tmp_path / "jax-store"), "-v", ""]) == 0
            ts, js = LocalFSStore(str(tmp_path / "http-store")), LocalFSStore(str(tmp_path / "jax-store"))
            assert [m.key for m in ts.list("")] == [m.key for m in js.list("")]
            # Archive members compared by payload (tar headers carry mtimes).
            assert all(_members(ts.get(m.key)) == _members(js.get(m.key))
                       for m in js.list("fragments/"))
            for path, body in (("/index/i", b""), ("/index/i/frame/f", b""),
                               ("/index/i/frame/t", b'{"options": {"timeQuantum": "YMD"}}'),
                               ("/index/i/frame/v", b'{"options": {"rangeEnabled": true}}'),
                               ("/index/i/frame/v/field/val", b'{"type": "int", "min": 0, "max": 1000}')):
                assert _post(dst.host, path, body)[0] == 200
            assert tmain(["restore", "--host", dst.host, "-i", "i", "--store",
                              f"file://{tmp_path / 'http-store'}", "-v", ""]) == 0
            assert _answers(dst.host) == want
            assert tmain(["restore", "--host", dst.host, "-i", "nope", "--store",
                              str(tmp_path / "http-store")]) == 1
        finally:
            dst.close()
            src.close()
