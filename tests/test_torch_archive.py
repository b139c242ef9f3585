"""The port's block checksums, block sync, archives and CSV export
(``Fragment.blocks`` / ``checksum`` / ``block_data`` / ``merge_block`` /
``write_to`` / ``read_from`` / ``csv_chunks``) against
``pilosa_tpu.core.fragment.Fragment`` under the same seeded writes, on
both tiers (a dense budget of 4 rows sends the rest of the rows sparse):
equal checksums after every write path with a checksum cached before
it, equal block data and merges, archives written by either package
restored into the other with identical planes, blocks, checksums and
rank caches, torn archives rejected by both with nothing changed, and
``read_from`` over a resident mirror with queued deltas.  Integers and
bytes: the comparison is exact."""

import io
import tarfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.core import fragment as jfragment  # noqa: E402
from pilosa_tpu.core.fragment import Fragment as JFragment  # noqa: E402
from pilosa_tpu.core.fragment import PairSet as JPairSet  # noqa: E402
from pilosa_tpu_torch import device as tdevice  # noqa: E402
from pilosa_tpu_torch.core import fragment as tfragment  # noqa: E402
from pilosa_tpu_torch.core.fragment import Fragment as TFragment  # noqa: E402
from pilosa_tpu_torch.core.fragment import PairSet as TPairSet  # noqa: E402
from pilosa_tpu_torch.device.pool import PlanePool  # noqa: E402
from pilosa_tpu_torch.ops import bitplane as tbp  # noqa: E402

SW = tbp.SLICE_WIDTH
SLICE = 2
BASE = SLICE * SW
HB = tfragment.HASH_BLOCK_SIZE
BUDGETS = [4, 1 << 16]


@pytest.fixture(autouse=True)
def fresh_pool():
    """A pool of this test's own: the mirrors' accounting starts at 0."""
    pool = PlanePool()
    before = tdevice._set_pool(pool)
    yield pool
    tdevice._set_pool(before)


def pair(tmp_path, budget: int, name: str = "f"):
    j = JFragment(str(tmp_path / "jax" / name), "i", "f", "standard", SLICE,
                  dense_row_budget=budget)
    t = TFragment(str(tmp_path / "torch" / name), "i", "f", "standard", SLICE, device="cpu",
                  dense_row_budget=budget)
    j.open()
    t.open()
    return j, t


def seeded_bits(seed: int, n: int = 3000, max_row: int = 350):
    """Rows over four hash blocks (0-349) with row-dependent density, and
    the columns' edge words."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, max_row, n)
    cols = BASE + rng.integers(0, SW, n)
    keep = rng.random(n) < ((rows % 13) + 1) / 13
    rows, cols = rows[keep], cols[keep]
    edge_r = np.array([7, 99, 100, 199, 200, 349])
    edge_c = BASE + np.array([0, 31, SW - 32, SW - 1, 32, 1 << 16])
    return np.concatenate([rows, edge_r]), np.concatenate([cols, edge_c])


def load(j, t, seed: int = 0) -> None:
    rows, cols = seeded_bits(seed)
    j.import_bulk(rows, cols)
    t.import_bulk(rows, cols)


def assert_same(j, t, rows=range(360)) -> None:
    for r in rows:
        jw = j._row_words_host(r)
        tw = t.row_words_host(r)
        if jw is None or not jw.any():
            assert tw is None or not tw.any(), r
        else:
            np.testing.assert_array_equal(tw, jw, err_msg=f"row {r}")
        assert t.row_count(r) == j.row_count(r), r
    assert t.blocks() == j.blocks()
    assert t.checksum() == j.checksum()


def assert_cache_current(t) -> None:
    """The cached checksums equal a computation from scratch: no write
    path left a block it changed unmarked."""
    cached = t.blocks()
    t._block_sums.clear()
    t._dirty_blocks.clear()
    assert t.blocks() == cached


# ---------------------------------------------------------------------------
# block checksums: every write path keeps the cache current
# ---------------------------------------------------------------------------


def _write_set_dense(j, t, rng):
    for r, c in zip(rng.integers(0, 4, 20), BASE + rng.integers(0, SW, 20)):
        assert j.set_bit(int(r), int(c)) == t.set_bit(int(r), int(c))


def _write_set_sparse(j, t, rng):
    for r, c in zip(rng.integers(100, 350, 20), BASE + rng.integers(0, SW, 20)):
        assert j.set_bit(int(r), int(c)) == t.set_bit(int(r), int(c))


def _write_set_new_rows(j, t, rng):
    for r in (360, 451, 999):
        assert j.set_bit(r, BASE + 5) == t.set_bit(r, BASE + 5)


def _write_clear(j, t, rng):
    rows, cols = seeded_bits(0)
    for r, c in zip(rows[:40], cols[:40]):
        assert j.clear_bit(int(r), int(c)) == t.clear_bit(int(r), int(c))


def _write_clear_absent(j, t, rng):
    assert j.clear_bit(777, BASE + 1) == t.clear_bit(777, BASE + 1)


def _write_import(j, t, rng):
    rows = rng.integers(0, 500, 400)
    cols = BASE + rng.integers(0, SW, 400)
    j.import_bulk(rows, cols)
    t.import_bulk(rows, cols)


def _write_import_clears(j, t, rng):
    rows, cols = seeded_bits(0)
    sel = rng.random(len(rows)) < 0.2
    new_r = rng.integers(250, 300, 50)
    new_c = BASE + rng.integers(0, SW, 50)
    j.import_bulk(new_r, new_c, rows[sel], cols[sel])
    t.import_bulk(new_r, new_c, rows[sel], cols[sel])


def _write_merge(j, t, rng):
    for block in (0, 2, 3):
        remote = [JPairSet([block * HB + 1, block * HB + 2], [9, 10])]
        tremote = [TPairSet([block * HB + 1, block * HB + 2], [9, 10])]
        js, jc = j.merge_block(block, remote * 2)
        ts, tc = t.merge_block(block, tremote * 2)
        assert [(p.row_ids, p.column_ids) for p in ts + tc] == \
            [(p.row_ids, p.column_ids) for p in js + jc]


def _write_snapshot(j, t, rng):
    j.snapshot()
    t.snapshot()


WRITES = {
    "set_dense": _write_set_dense,
    "set_sparse": _write_set_sparse,
    "set_new_rows": _write_set_new_rows,
    "clear": _write_clear,
    "clear_absent": _write_clear_absent,
    "import": _write_import,
    "import_with_clears": _write_import_clears,
    "merge_block": _write_merge,
    "snapshot": _write_snapshot,
}


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("write", list(WRITES))
def test_blocks_follow_every_write_path(tmp_path, budget, write):
    j, t = pair(tmp_path, budget)
    load(j, t)
    assert_same(j, t)  # every block's checksum cached before the write
    WRITES[write](j, t, np.random.default_rng(list(WRITES).index(write)))
    assert_same(j, t)
    assert_cache_current(t)
    j.close()
    t.close()


@pytest.mark.parametrize("budget", BUDGETS)
def test_blocks_after_install_replay_and_reopen(tmp_path, budget):
    """``install_rows`` (the port's bulk replace) and a reopen clear the
    cache; an op-log replayed at open gives the JAX checksums."""
    j, t = pair(tmp_path, budget)
    load(j, t)
    t.blocks()
    rows, cols = seeded_bits(5, n=500)
    plane = np.zeros((400, tbp.WORDS_PER_SLICE), np.uint32)
    tbp.np_set_bulk(plane, rows, cols - BASE)
    t.install_plane(plane)
    assert_cache_current(t)
    for r, c in zip(rows[:30], cols[:30]):
        t.clear_bit(int(r), int(c))
    chk = t.blocks()
    t.close()
    t2 = TFragment(t.path, "i", "f", "standard", SLICE, device="cpu", dense_row_budget=budget)
    t2.open()
    assert t2.blocks() == chk
    j2 = JFragment(t.path, "i", "f", "standard", SLICE, dense_row_budget=budget)
    t2.close()
    j2.open()
    assert j2.blocks() == chk
    j2.close()
    j.close()


@pytest.mark.parametrize("budget", BUDGETS)
def test_block_data_and_merge_match_jax(tmp_path, budget):
    j, t = pair(tmp_path, budget)
    load(j, t, seed=3)
    for block in range(5):
        jd, td = j.block_data(block), t.block_data(block)
        assert (td.row_ids, td.column_ids) == (jd.row_ids, jd.column_ids)
    rng = np.random.default_rng(9)
    for block in range(4):
        local = j.block_data(block)
        replicas = []
        for _ in range(3):
            keep = rng.random(len(local.row_ids)) < 0.7
            extra_r = rng.integers(block * HB, block * HB + HB, 20).tolist()
            extra_c = rng.integers(0, SW, 20).tolist()
            replicas.append((np.asarray(local.row_ids)[keep].tolist() + extra_r,
                             np.asarray(local.column_ids)[keep].tolist() + extra_c))
        # Out-of-block rows and out-of-slice columns are dropped by both.
        replicas.append(([block * HB + HB, block * HB], [5, SW + 3]))
        js, jc = j.merge_block(block, [JPairSet(list(r), list(c)) for r, c in replicas])
        ts, tc = t.merge_block(block, [TPairSet(list(r), list(c)) for r, c in replicas])
        for a, b in zip(ts + tc, js + jc):
            assert (a.row_ids, a.column_ids) == (b.row_ids, b.column_ids)
        assert_same(j, t)
    with pytest.raises(jfragment.FragmentError, match="pair set mismatch"):
        j.merge_block(0, [JPairSet([1], [])])
    with pytest.raises(tfragment.FragmentError, match="pair set mismatch"):
        t.merge_block(0, [TPairSet([1], [])])
    assert_cache_current(t)
    j.close()
    t.close()


# ---------------------------------------------------------------------------
# archives
# ---------------------------------------------------------------------------


def members(archive: bytes) -> dict[str, bytes]:
    tr = tarfile.open(fileobj=io.BytesIO(archive))
    return {m.name: tr.extractfile(m).read() for m in tr}


def archive_of(frag) -> bytes:
    buf = io.BytesIO()
    frag.write_to(buf)
    return buf.getvalue()


@pytest.mark.parametrize("budget", BUDGETS)
def test_archives_are_equal_and_restore_across_packages(tmp_path, budget):
    j, t = pair(tmp_path, budget)
    load(j, t, seed=1)
    _write_set_sparse(j, t, np.random.default_rng(2))
    ja, ta = archive_of(j), archive_of(t)
    assert members(ta) == members(ja)
    assert list(members(ta)) == ["checksum", "data", "cache"]
    chunks = list(t.tar_chunks(chunk_bytes=1000))
    assert {len(c) for c in chunks[:-1]} == {1000}
    assert members(b"".join(chunks)) == members(ta)
    # Each package's archive into the other's empty fragment.
    j2, t2 = pair(tmp_path, budget, name="g")
    t2.read_from(io.BytesIO(ja))
    j2.read_from(io.BytesIO(ta))
    assert_same(j2, t2)
    assert t2.blocks() == t.blocks()
    assert t2.cache.ids() == j2.cache.ids() == j.cache.ids()
    assert [(p.id, p.count) for p in t2.cache.top()] == [(p.id, p.count) for p in j2.cache.top()]
    assert members(archive_of(t2)) == members(ja)
    # What read_from wrote is the fragment's file: it reopens the same.
    t2.close()
    t3 = TFragment(t2.path, "i", "f", "standard", SLICE, device="cpu", dense_row_budget=budget)
    t3.open()
    assert_same(j2, t3)
    for f in (j, t, j2, t3):
        f.close()


@pytest.mark.parametrize("damage", ["data", "cache", "checksum_entry"])
def test_torn_archive_is_rejected_and_changes_nothing(tmp_path, damage):
    j, t = pair(tmp_path, 4)
    load(j, t, seed=4)
    before = (t.blocks(), t.checksum(), t.cache.ids(), t._version)
    src = pair(tmp_path, 4, name="src")
    load(*src, seed=6)
    good = members(archive_of(src[1]))
    bad = dict(good)
    if damage == "checksum_entry":
        bad["checksum"] = b"{not json"
    else:
        payload = bytearray(bad[damage] or b"\x00")
        payload[len(payload) // 2] ^= 0xFF
        bad[damage] = bytes(payload)
    buf = io.BytesIO()
    tw = tarfile.open(fileobj=buf, mode="w")
    for name, payload in bad.items():
        info = tarfile.TarInfo(name)
        info.size = len(payload)
        tw.addfile(info, io.BytesIO(payload))
    tw.close()
    with pytest.raises(jfragment.ArchiveChecksumError) as je:
        j.read_from(io.BytesIO(buf.getvalue()))
    with pytest.raises(tfragment.ArchiveChecksumError) as te:
        t.read_from(io.BytesIO(buf.getvalue()))
    assert str(te.value) == str(je.value)
    assert (t.blocks(), t.checksum(), t.cache.ids(), t._version) == before
    assert_same(j, t)
    for f in (j, t, *src):
        f.close()


def test_archive_without_checksum_entry_installs(tmp_path):
    """Archives from before the checksum entry install unverified in both."""
    j, t = pair(tmp_path, 4)
    src_j, src_t = pair(tmp_path, 4, name="src")
    load(src_j, src_t, seed=8)
    old = members(archive_of(src_j))
    del old["checksum"]
    buf = io.BytesIO()
    tw = tarfile.open(fileobj=buf, mode="w")
    for name, payload in old.items():
        info = tarfile.TarInfo(name)
        info.size = len(payload)
        tw.addfile(info, io.BytesIO(payload))
    tw.close()
    j.read_from(io.BytesIO(buf.getvalue()))
    t.read_from(io.BytesIO(buf.getvalue()))
    assert_same(j, t)
    assert t.cache.ids() == j.cache.ids()
    for f in (j, t, src_j, src_t):
        f.close()


def test_read_from_replaces_a_resident_mirror_and_its_queue(tmp_path, fresh_pool):
    """A mirror uploaded and a queue of deltas on it, then a restore: the
    mirror and the queue go, the pool drops the entry (never below 0),
    the version and both epochs move, and the next read uploads the
    restored plane."""
    j, t = pair(tmp_path, 4)
    load(j, t, seed=2)
    old_mirror = t.device_plane()
    assert fresh_pool.contains(t._pool_key)
    for r, c in ((0, BASE + 3), (1, BASE + 4), (2, BASE + 70000)):
        j.set_bit(r, c)
        t.set_bit(r, c)
    assert t._pending_n > 0
    src_j, src_t = pair(tmp_path, 4, name="src")
    load(src_j, src_t, seed=7)
    archive = archive_of(src_j)
    version, w_epoch, m_epoch = t._version, tfragment.write_epoch(), tfragment.mirror_epoch()
    with fresh_pool.pinned(t._pool_key):
        t.read_from(io.BytesIO(archive))
        assert not fresh_pool.contains(t._pool_key)
    j.read_from(io.BytesIO(archive))
    assert t._mirror is None and t._pending_n == 0
    assert t._version > version
    assert tfragment.write_epoch() > w_epoch and tfragment.mirror_epoch() > m_epoch
    # The lease ended on a removed entry: nothing stays pinned or resident.
    assert sum(fresh_pool._pinned.values()) == 0
    assert sum(fresh_pool._resident.values()) == 0
    new_mirror = t.device_plane()
    assert sum(fresh_pool._resident.values()) == t.plane_nbytes
    assert new_mirror is not old_mirror
    np.testing.assert_array_equal(tbp.to_host(new_mirror), t._plane)
    assert_same(j, t)
    assert_same(src_j, t)
    for f in (j, t, src_j, src_t):
        f.close()


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("chunk_pairs", [1, 7, 1000, 1 << 20])
def test_csv_chunks_equal_the_native_formatter(tmp_path, budget, chunk_pairs):
    j, t = pair(tmp_path, budget)
    load(j, t, seed=11)
    t.set_bit(1 << 40, BASE + SW - 1)
    j.set_bit(1 << 40, BASE + SW - 1)
    tc = list(t.csv_chunks(chunk_pairs=chunk_pairs))
    jc = list(j.csv_chunks(chunk_pairs=chunk_pairs))
    assert tc == jc
    assert list(t.for_each_bit()) == list(j.for_each_bit())
    rows = np.asarray([r for r, _ in t.for_each_bit()], np.uint64)
    cols = np.asarray([c for _, c in t.for_each_bit()], np.uint64)
    want = "".join(f"{r},{c}\n" for r, c in zip(rows.tolist(), cols.tolist())).encode()
    assert b"".join(tc) == want
    j.close()
    t.close()
