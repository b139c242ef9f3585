"""The row table K2 and K3 read (``ops/tree_eval.RowTable``), on the CPU:
a table checked once is not walked again — a batch entry's hits and a
concatenation of checked tables read no base's shape in either wrapper —
while a table made unchecked is checked in full and raises on an index
out of range; a concatenation's row addresses equal those of the same
table checked from scratch."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu_torch.core.holder import Holder  # noqa: E402
from pilosa_tpu_torch.exec import plan  # noqa: E402
from pilosa_tpu_torch.exec.executor import Executor  # noqa: E402
from pilosa_tpu_torch.ops import interp as it  # noqa: E402
from pilosa_tpu_torch.ops import tree_eval as te  # noqa: E402
from pilosa_tpu_torch.pql import parse_string  # noqa: E402

W = 32768
INTERSECT = ("Intersect", ("leaf", 0), ("leaf", 1))
K3_AND = np.asarray([[it.OP_AND, 0, 1, 0]], np.int32)  # the first op register = leaf 0 & 1


class Recorder:
    """A base that counts reads of its ``shape`` (the check's pass over
    the bases) and otherwise acts as the tensor it holds."""

    def __init__(self, t: torch.Tensor, reads: list):
        self._t, self._reads = t, reads

    @property
    def shape(self):
        self._reads.append(1)
        return self._t.shape

    def __getattr__(self, name):
        return getattr(self._t, name)

    def __getitem__(self, i):
        return self._t[i]


def rows(rng, n: int) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, 2**32, size=(n, W), dtype=np.uint32).view(np.int32))


def table_of(bases, n: int, rng) -> te.RowTable:
    """``n`` slices x 2 leaves drawn from every row of every base."""
    heights = [b._t.shape[0] if isinstance(b, Recorder) else b.shape[0] for b in bases]
    idx = np.zeros((n, 2, 2), dtype=np.int64)
    idx[..., 0] = rng.integers(0, len(bases), size=(n, 2))
    idx[..., 1] = rng.integers(0, 1 << 20, size=(n, 2)) % np.asarray(heights)[idx[..., 0]]
    return te.RowTable(bases, idx)


def launch_both(table: te.RowTable) -> tuple:
    """Count through K2's and K3's wrappers (the plain versions here)."""
    k2 = te.tree_eval(table, plan.compile_program(INTERSECT), "count")
    k3 = it.interp("count", table, K3_AND, np.asarray([table.shape[1]], np.int32))
    return k2, k3[:, 0]


def test_batch_entry_is_checked_once_and_its_hits_read_no_base(tmp_path, monkeypatch):
    """The executor checks an entry's table in full when it builds it;
    every hit's table is checked by construction, so a served Count and
    both wrappers read no base of it again."""
    h = Holder(str(tmp_path), device="cpu")
    h.open()
    ex = Executor(h)
    full = {"n": 0}
    orig = te.RowTable.check

    def counted(self):
        if not self.checked:
            full["n"] += 1
        return orig(self)

    monkeypatch.setattr(te.RowTable, "check", counted)
    try:
        f = h.create_index("i").create_frame("f")
        rng = np.random.default_rng(3)
        for _ in range(400):
            f.set_bit("standard", int(rng.integers(0, 4)), int(rng.integers(0, 3 << 20)))
        q = parse_string("Count(Intersect(Bitmap(frame=f, rowID=0), Bitmap(frame=f, rowID=1)))")
        want = int(ex.execute("i", q)[0])
        assert full["n"] == 1
        (ent,) = ex._batch_cache.values()
        reads: list = []
        ent.refs = [Recorder(b, reads) for b in ent.table().bases]
        table = ent.table()
        assert table.checked
        assert int(ex.execute("i", q)[0]) == want
        k2, k3 = launch_both(table)
        assert int(k2.sum()) == int(k3.sum()) == want
        assert reads == [] and full["n"] == 1
    finally:
        ex.close()
        h.close()


@pytest.mark.parametrize("how", ["slices", "leaves"])
def test_concat_of_checked_tables_reads_no_base(how):
    rng = np.random.default_rng(11)
    reads: list = []
    parts = [table_of([Recorder(rows(rng, k), reads) for k in (1, 5)], 3, rng)
             for _ in range(3)]
    for t in parts:
        t.check()
    assert reads  # a full check walks the bases
    reads.clear()
    if how == "slices":
        table = te.RowTable.concat_slices(parts)
    else:
        table = te.RowTable.concat_leaves(parts, [[0], [1], [0, 1]])
    assert table.checked
    launch_both(table)
    assert reads == []


def test_concat_with_an_unchecked_part_is_checked_in_full():
    rng = np.random.default_rng(12)
    a = table_of([rows(rng, 2)], 2, rng)
    b = table_of([rows(rng, 3)], 2, rng)
    a.check()
    assert not te.RowTable.concat_slices([a, b]).checked
    assert not te.RowTable.concat_leaves([a, b], [[0], [1]]).checked


@pytest.mark.parametrize("how", ["slices", "leaves"])
def test_concat_addresses_equal_a_table_checked_from_scratch(how):
    rng = np.random.default_rng(13)
    parts = [table_of([rows(rng, 1), rows(rng, 4)], 2 + i, rng) for i in range(3)]
    if how == "leaves":
        parts = [te.RowTable(p.bases, p.index[:2]) for p in parts]
    for t in parts:
        t.check()
        t.addresses()
    if how == "slices":
        joined = te.RowTable.concat_slices(parts)
    else:
        joined = te.RowTable.concat_leaves(parts, [[1], [0, 1], [0]])
    fresh = te.RowTable(joined.bases, joined.index.copy())
    fresh.check()
    assert joined.checked and joined.addrs is not None
    assert torch.equal(joined.addresses(), fresh.addresses())
    np.testing.assert_array_equal(
        joined.addresses().numpy(),
        [[fresh.bases[b].data_ptr() + r * W * 4 for b, r in row] for row in fresh.index])


BAD_INDEX = {
    "row_past_base": (0, 2),
    "base_past_table": (2, 0),
    "negative_row": (1, -1),
}


@pytest.mark.parametrize("wrapper", ["k2", "k3"])
@pytest.mark.parametrize("bad", list(BAD_INDEX), ids=str)
def test_unchecked_table_out_of_range_raises(wrapper, bad):
    rng = np.random.default_rng(14)
    bases = [rows(rng, 2), rows(rng, 3)]
    table = table_of(bases, 3, rng)
    table.index[1, 1] = BAD_INDEX[bad]
    with pytest.raises(ValueError):
        if wrapper == "k2":
            te.tree_eval(table, plan.compile_program(INTERSECT), "count")
        else:
            it.interp("count", table, K3_AND, np.asarray([2], np.int32))
    assert not table.checked
