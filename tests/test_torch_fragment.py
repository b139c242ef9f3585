"""The port's Fragment (dense tier, device mirror, fused-popcount TopN)
against ``pilosa_tpu.core.fragment.Fragment`` under the same seeded
writes: equal rows, counts and TopN pairs, and one on-disk format —
either package opens the other's fragment file with identical planes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.core.bitmap import RowBitmap as JRowBitmap  # noqa: E402
from pilosa_tpu.core.fragment import Fragment as JFragment  # noqa: E402
from pilosa_tpu.core.fragment import TopOptions as JTopOptions  # noqa: E402
from pilosa_tpu_torch.core.bitmap import RowBitmap as TRowBitmap  # noqa: E402
from pilosa_tpu_torch.core.fragment import Fragment as TFragment  # noqa: E402
from pilosa_tpu_torch.core.fragment import TopOptions as TTopOptions  # noqa: E402
from pilosa_tpu_torch.core.fragment import decode_cache_ids, encode_cache_ids  # noqa: E402
from pilosa_tpu_torch.ops import bitplane as tbp  # noqa: E402

SW = tbp.SLICE_WIDTH
SLICE = 2


def pair(tmp_path):
    j = JFragment(str(tmp_path / "jax" / "2"), "i", "f", "standard", SLICE)
    t = TFragment(str(tmp_path / "torch" / "2"), "i", "f", "standard", SLICE, device="cpu")
    j.open()
    t.open()
    return j, t


def seeded_writes(j, t, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 12, 3000)
    cols = SLICE * SW + rng.integers(0, SW, 3000)
    # Row r gets ~r-proportional density so TopN has a clear order plus ties.
    keep = rng.random(3000) < (rows + 1) / 12
    j.import_bulk(rows[keep], cols[keep])
    t.import_bulk(rows[keep], cols[keep])
    for r, c in zip(rng.integers(0, 14, 200), SLICE * SW + rng.integers(0, SW, 200)):
        assert j.set_bit(int(r), int(c)) == t.set_bit(int(r), int(c))
    for r, c in zip(rows[:150], cols[:150]):
        assert j.clear_bit(int(r), int(c)) == t.clear_bit(int(r), int(c))
    # Adversarial words: sign bit and the last word of the row.
    for c in (SLICE * SW + 31, SLICE * SW + SW - 1, SLICE * SW + SW - 32):
        assert j.set_bit(13, c) == t.set_bit(13, c)


def assert_same_rows(j, t, rows=range(16)):
    for r in rows:
        jw = j._row_words_host(r)
        tw = t.row_words_host(r)
        if jw is None or not jw.any():
            assert tw is None or not tw.any(), r
        else:
            np.testing.assert_array_equal(tw, jw, err_msg=f"row {r}")
        assert t.row_count(r) == j.row_count(r), r
    # The device mirror agrees with the host plane.
    mirror = tbp.to_host(t.device_plane())
    np.testing.assert_array_equal(mirror, t._plane)


def test_writes_match_jax(tmp_path):
    j, t = pair(tmp_path)
    seeded_writes(j, t)
    assert_same_rows(j, t)
    assert t.count() == j.count()
    assert t.row(3).count() == j.row(3).count()
    j.close()
    t.close()


def _src_pair(j, row_a, row_b=None):
    jw = j._row_words_host(row_a)
    if row_b is not None:
        jw = jw & j._row_words_host(row_b)
    return (
        JRowBitmap.from_segment(SLICE, jw.copy()),
        TRowBitmap.from_segment(SLICE, tbp.to_device(jw, "cpu")),
    )


@pytest.mark.parametrize(
    "opts",
    [
        {"n": 3},
        {"n": 0},
        {"n": 4, "src": (5,)},
        {"n": 2, "src": (7, 9)},
        {"n": 0, "src": (2,), "min_threshold": 40},
        {"n": 5, "src": (11,), "tanimoto_threshold": 30},
        {"row_ids": [1, 3, 3, 13, 99], "n": 1},
        {"row_ids": [0, 4, 8], "src": (6,)},
        {"n": 3, "min_threshold": 200},
    ],
)
def test_top_matches_jax(tmp_path, opts):
    j, t = pair(tmp_path)
    seeded_writes(j, t, seed=1)
    kw = dict(opts)
    src = kw.pop("src", None)
    jsrc = tsrc = None
    if src is not None:
        jsrc, tsrc = _src_pair(j, *src)
    jp = j.top(JTopOptions(src=jsrc, **kw))
    tp = t.top(TTopOptions(src=tsrc, **kw))
    assert [(p.id, p.count) for p in tp] == [(p.id, p.count) for p in jp]
    j.close()
    t.close()


def test_each_package_opens_the_others_file(tmp_path):
    j, t = pair(tmp_path)
    seeded_writes(j, t, seed=2)
    j.close()
    t.close()
    # Swap: the JAX package opens the port's file and vice versa.
    j2 = JFragment(t.path, "i", "f", "standard", SLICE)
    t2 = TFragment(j.path, "i", "f", "standard", SLICE, device="cpu")
    j2.open()
    t2.open()
    assert_same_rows(j2, t2)
    jp = j2.top(JTopOptions(n=5))
    tp = t2.top(TTopOptions(n=5))
    assert [(p.id, p.count) for p in tp] == [(p.id, p.count) for p in jp]
    j2.close()
    t2.close()


def test_op_log_replay_and_snapshot(tmp_path):
    t = TFragment(str(tmp_path / "0"), "i", "f", "standard", 0, device="cpu", max_op_n=50)
    t.open()
    for c in range(120):  # crosses two snapshots, leaves 20 ops in the log
        t.set_bit(c % 3, c * 7)
    t.clear_bit(0, 0)
    t.close()
    j = JFragment(t.path, "i", "f", "standard", 0)
    t2 = TFragment(t.path + "-copy", "i", "f", "standard", 0, device="cpu")
    with open(t.path, "rb") as src, open(t2.path, "wb") as dst:
        dst.write(src.read())
    j.open()
    t2.open()
    assert_same_rows(j, t2, rows=range(3))
    j.close()
    t2.close()


def test_install_plane_recounts(tmp_path):
    rng = np.random.default_rng(4)
    plane = rng.integers(0, 2**32, size=(5, tbp.WORDS_PER_SLICE), dtype=np.uint32)
    plane[2] = 0  # an all-zero row stays absent
    t = TFragment(str(tmp_path / "0"), "i", "f", "standard", 0, device="cpu")
    t.open()
    t.install_plane(plane)
    for r in range(5):
        assert t.row_count(r) == int(np.bitwise_count(plane[r]).sum())
    assert not t.has_row(2)
    totals = np.bitwise_count(plane).sum(axis=-1, dtype=np.int64)
    want = [int(r) for r in np.lexsort((np.arange(5), -totals))[:2]]
    assert [p.id for p in t.top(TTopOptions(n=2))] == want
    t.close()


def test_cache_ids_codec_matches_protobuf():
    from pilosa_tpu.net import wire_pb2

    for ids in ([], [0], [1, 300, 5, 1 << 40]):
        data = encode_cache_ids(ids)
        assert data == wire_pb2.Cache(IDs=ids).SerializeToString()
        assert decode_cache_ids(data) == ids
    assert decode_cache_ids(b"[1, 2]") == [1, 2]


def test_row_beyond_dense_budget_raises(tmp_path, monkeypatch):
    from pilosa_tpu_torch.core import fragment as fragment_mod

    monkeypatch.setattr(fragment_mod, "DENSE_ROW_BUDGET", 2)
    t = TFragment(str(tmp_path / "0"), "i", "f", "standard", 0, device="cpu")
    t.open()
    assert t.set_bit(5, 1) and t.set_bit(9, 1)
    # Rows past the dense budget no longer raise: they land in the sparse
    # tier and answer like plane rows.
    assert t.set_bit(7, 1)
    t.import_bulk([1, 2], [3, 4])
    assert sorted(t._slot_of) == [5, 9] and sorted(t._sparse) == [1, 2, 7]
    assert t.row_count(5) == t.row_count(9) == t.row_count(7) == 1 and t.has_row(7)
    assert t.row(2).bits() == [4] and t.contains(1, 3)
    t.close()


def test_row_bitmap_counts_match_jax():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 2**32, size=(3, tbp.WORDS_PER_SLICE), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(3, tbp.WORDS_PER_SLICE), dtype=np.uint32)
    ja, jb, ta, tb = JRowBitmap(), JRowBitmap(), TRowBitmap("cpu"), TRowBitmap("cpu")
    for s in range(3):
        ja.set_segment(s, a[s])
        ta.set_segment(s, a[s])
        if s != 1:  # slice 1 only on one side
            jb.set_segment(s, b[s])
            tb.set_segment(s, tbp.to_device(b[s], "cpu"))
    assert ta.count() == ja.count()
    assert ta.intersection_count(tb) == ja.intersection_count(jb)
    assert ta.bits()[:50] == ja.bits()[:50]
    assert ta.to_json_dict()["bits"] == ja.to_json_dict()["bits"]


@pytest.mark.parametrize("n_clears", [40, 3000, None])
def test_import_with_clears_matches_jax(tmp_path, n_clears):
    """import_bulk with clears (the overwrite half of a BSI value import):
    the same rows and counts as the JAX package, clears on absent rows
    doing nothing, and the mirror equal to the host plane — through
    and-not K7 entries that the next read applies for a small import,
    through the counted fallback past the queue's limit (None: twice
    the limit in clears)."""
    from pilosa_tpu_torch.ingest import scatter

    j, t = pair(tmp_path)
    seeded_writes(j, t)
    t.device_plane()  # a resident mirror, so the import queues or falls back
    limit = scatter.pending_limit(t._mirror.shape[0])
    n_clears = 2 * limit if n_clears is None else n_clears
    rng = np.random.default_rng(n_clears)
    set_rows = rng.integers(0, 12, 200)
    set_cols = SLICE * SW + rng.integers(0, SW, 200)
    clr_rows = rng.integers(0, 20, n_clears)  # rows 14-19 do not exist
    clr_cols = SLICE * SW + rng.integers(0, SW, n_clears)
    both = np.isin(clr_cols, set_cols)  # a bit must not be in both lists
    clr_rows, clr_cols = clr_rows[~both], clr_cols[~both]
    queued = len(set_rows) + int(np.isin(clr_rows, list(t._slot_of)).sum())  # plane bits
    before = scatter.counters()
    j.import_bulk(set_rows, set_cols, clr_rows, clr_cols)
    t.import_bulk(set_rows, set_cols, clr_rows, clr_cols)
    after = scatter.counters()
    assert after["launches"] == before["launches"]  # an import never launches
    if queued <= limit:
        assert after["fallbackInvalidations"] == before["fallbackInvalidations"]
        assert t._pending_n > 0
    else:
        assert after["fallbackInvalidations"] == before["fallbackInvalidations"] + 1
        assert t._mirror is None
    assert_same_rows(j, t, range(20))
    assert not any(t.has_row(r) for r in range(14, 20))
    j.close()
    t.close()
