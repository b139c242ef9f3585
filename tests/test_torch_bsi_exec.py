"""BSI fields end to end on one node: a port ``Holder`` + ``Executor``
(device "cpu") and a JAX pair receive the same ``Frame.import_value``
calls and must answer every ``Range``/``Sum``/``Min``/``Max`` query of
``tests/test_bsi.py``'s property check identically (exact integers and
bitmaps), overwrite as the JAX package does, fail with the JAX
package's messages, and read each other's data directories."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.core.holder import Holder as JHolder  # noqa: E402
from pilosa_tpu.exec.executor import Executor as JExecutor  # noqa: E402
from pilosa_tpu.pql import parse_string as jparse  # noqa: E402
from pilosa_tpu_torch.core.bitmap import RowBitmap  # noqa: E402
from pilosa_tpu_torch.core.holder import Holder as THolder  # noqa: E402
from pilosa_tpu_torch.exec.executor import Executor as TExecutor  # noqa: E402
from pilosa_tpu_torch.ops import bsi_ripple as br  # noqa: E402
from pilosa_tpu_torch.ops import fused_popcount as fp  # noqa: E402
from pilosa_tpu_torch.pql import parse_string as tparse  # noqa: E402

SW = 1 << 20
OPS = ("<", "<=", "==", "!=", ">=", ">")



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU tensor ops: one thread each, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def norm(r):
    """A result as plain data, the same for both packages."""
    if isinstance(r, RowBitmap) or type(r).__name__ == "RowBitmap":
        return ("bitmap", list(r.bits()))
    if type(r).__name__ == "ValCount":
        return ("valcount", r.value, r.count)
    if isinstance(r, list):
        return ("pairs", [(p.id, p.count) for p in r])
    return r


class Pair2:
    """One port and one JAX node over their own data directories."""

    def __init__(self, tmp_path):
        self.tdir, self.jdir = str(tmp_path / "torch"), str(tmp_path / "jax")
        self.t, self.j = THolder(self.tdir, device="cpu"), JHolder(self.jdir)
        self.t.open()
        self.j.open()
        self.tex, self.jex = TExecutor(self.t), JExecutor(self.j)

    def frames(self, name="f"):
        return [h.create_index_if_not_exists("i").create_frame_if_not_exists(name)
                for h in (self.t, self.j)]

    def field(self, lo, hi, name="v", frame="f"):
        for f in self.frames(frame):
            f.set_options(range_enabled=True)
            f.create_field(name, lo, hi)

    def import_value(self, field, cols, vals, frame="f"):
        for h in (self.t, self.j):
            h.frame("i", frame).import_value(field, cols, vals)

    def ask(self, q: str):
        """(port answer, JAX answer) as plain data, or the error text."""
        out = []
        for ex, parse in ((self.tex, tparse), (self.jex, jparse)):
            try:
                out.append([norm(r) for r in ex.execute("i", parse(q))])
            except Exception as e:  # noqa: BLE001 — compare the messages
                out.append(("error", str(e)))
        return out

    def same(self, q: str):
        got, want = self.ask(q)
        assert got == want, q
        return got

    def close(self):
        self.tex.close()
        self.jex.close()
        self.t.close()
        self.j.close()


@pytest.fixture
def pair(tmp_path):
    p = Pair2(tmp_path)
    yield p
    p.close()


def rand_data(rng, lo, hi, n, n_slices):
    """tests/test_bsi.py's draw: the declared bounds and 0 always present."""
    cols = rng.choice(n_slices * SW, size=n, replace=False)
    vals = rng.integers(lo, hi + 1, size=n)
    vals[0], vals[1] = lo, hi
    if lo <= 0 <= hi and n > 2:
        vals[2] = 0
    return cols.astype(np.int64), vals.astype(np.int64)


@pytest.mark.parametrize("lo,hi", [(-1000, 1000), (0, 255), (-4, 3), (-(1 << 33), 1 << 33)])
def test_query_set_matches_jax(pair, lo, hi):
    """The query set of tests/test_bsi.py:192-240, answered equally, and
    equal to the per-column reference; plus, for one field, comparisons
    composed with bitmaps, a Bitmap-call result and a TopN src."""
    rng = np.random.default_rng(abs(lo) + hi)
    pair.field(lo, hi)
    cols, vals = rand_data(rng, lo, hi, 500, 3)
    pair.import_value("v", cols, vals)
    ref = dict(zip(cols.tolist(), vals.tolist()))
    rows = rng.integers(0, 3, 3000)
    bcols = rng.integers(0, 3 * SW, 3000)
    for h in (pair.t, pair.j):
        h.frame("i", "f").import_bulk(rows, bcols)
    bcols = np.concatenate([bcols, cols[:100]])  # bitmap rows that meet valued columns
    rows = np.concatenate([rows, np.ones(100, np.int64)])
    for h in (pair.t, pair.j):
        h.frame("i", "f").import_bulk(rows[-100:], bcols[-100:])

    preds = sorted({lo, hi, lo - 1, hi + 1, 0, 1, -1, (lo + hi) // 2, int(vals[7]), int(vals[11])})
    pyops = {"<": np.less, "<=": np.less_equal, "==": np.equal, "!=": np.not_equal,
             ">=": np.greater_equal, ">": np.greater}
    v_all = np.asarray(list(ref.values()))
    for op in OPS:
        for p in preds:
            got = pair.same(f"Count(Range(frame=f, v {op} {p}))")[0]
            assert got == int(pyops[op](v_all, p).sum())
    for a, b in [(lo, hi), (-1, 1), (0, 0), (5, 2), (lo - 99, hi + 99)]:
        got = pair.same(f"Count(Range(frame=f, v >< [{a}, {b}]))")[0]
        assert got == int(((v_all >= a) & (v_all <= b)).sum())
    assert pair.same("Sum(frame=f, field=v)")[0] == ("valcount", int(v_all.sum()), len(v_all))
    vmin, vmax = int(v_all.min()), int(v_all.max())
    assert pair.same("Min(frame=f, field=v)")[0] == ("valcount", vmin, int((v_all == vmin).sum()))
    assert pair.same("Max(frame=f, field=v)")[0] == ("valcount", vmax, int((v_all == vmax).sum()))
    pos = v_all[v_all > 0]
    assert pair.same("Sum(Range(frame=f, v > 0), frame=f, field=v)")[0] == (
        "valcount", int(pos.sum()), len(pos))
    got = pair.same("Count(Intersect(Range(frame=f, v >= 0), Range(frame=f, v <= 1)))")[0]
    assert got == int(((v_all >= 0) & (v_all <= 1)).sum())
    if (lo, hi) != (-1000, 1000):
        return  # one field's composed shapes suffice (each is a JAX compile)
    for q in [
        "Count(Intersect(Bitmap(frame=f, rowID=1), Range(frame=f, v >< [-1, 200])))",
        "Count(Union(Bitmap(frame=f, rowID=0), Range(frame=f, v > 2)))",
        "Count(Difference(Range(frame=f, v != 0), Bitmap(frame=f, rowID=1)))",
        "Count(Xor(Range(frame=f, v < 3), Range(frame=f, v > -3)))",
        "Intersect(Bitmap(frame=f, rowID=1), Range(frame=f, v >= 0))",
        "Range(frame=f, v < 0)",
        "Min(Bitmap(frame=f, rowID=1), frame=f, field=v)",
        "Max(Intersect(Bitmap(frame=f, rowID=1), Range(frame=f, v < 100)), frame=f, field=v)",
        "Sum(Bitmap(frame=f, rowID=2), frame=f, field=v)",
        "Min(Bitmap(frame=f, rowID=77), frame=f, field=v)",
        "Sum(Bitmap(frame=f, rowID=77), frame=f, field=v)",
        "TopN(Range(frame=f, v > 0), frame=f, n=3)",
    ]:
        pair.same(q)


def test_comparisons_run_on_the_ripple_kernel(pair, monkeypatch):
    """A Count's root comparison is one count-mode launch; inside a fold
    it is a row-mode launch and the fold's outer op + count is K1; an
    aggregate is one launch."""
    pair.field(-100, 100)
    rng = np.random.default_rng(0)
    cols, vals = rand_data(rng, -100, 100, 200, 2)
    pair.import_value("v", cols, vals)
    calls = []
    for name in ("bsi_cmp", "bsi_sum", "bsi_minmax"):
        real = getattr(br, name)
        monkeypatch.setattr(br, name, lambda *a, _r=real, _n=name, **k: (
            calls.append((_n, k.get("count", a[4] if len(a) > 4 else False))) or _r(*a, **k)))
    real_k1 = fp.row_popcounts
    monkeypatch.setattr(
        fp, "row_popcounts", lambda *a, **k: calls.append(("k1",)) or real_k1(*a, **k))
    pair.tex.execute("i", tparse("Count(Range(frame=f, v > 3))"))
    assert calls == [("bsi_cmp", True)]
    calls.clear()
    pair.tex.execute("i", tparse("Count(Intersect(Range(frame=f, v > 3), Range(frame=f, v < 50)))"))
    assert calls == [("bsi_cmp", False), ("bsi_cmp", False), ("k1",)]
    calls.clear()
    pair.tex.execute("i", tparse("Sum(Range(frame=f, v > 3), frame=f, field=v)"))
    assert calls == [("bsi_cmp", False), ("bsi_sum", False)]


def test_overwrite_matches_jax(pair):
    """tests/test_bsi.py:154: a re-import clears stale magnitude and sign
    bits; zero stores sign 0."""
    pair.field(-1000, 1000)
    pair.import_value("v", [5, 9], [1000, -1000])
    assert pair.same("Sum(frame=f, field=v)")[0] == ("valcount", 0, 2)
    pair.import_value("v", [5], [-1])
    pair.import_value("v", [9], [3])
    pair.import_value("v", [SW + 1], [-7])
    pair.import_value("v", [SW + 1], [0])
    assert pair.same("Sum(frame=f, field=v)")[0] == ("valcount", 2, 3)
    assert pair.same("Min(frame=f, field=v)")[0] == ("valcount", -1, 1)
    assert pair.same("Max(frame=f, field=v)")[0] == ("valcount", 3, 1)
    pair.same("Count(Range(frame=f, v == 0))")
    pair.same("Count(Range(frame=f, v < 0))")
    tf, jf = pair.t.frame("i", "f"), pair.j.frame("i", "f")
    for s in (0, 1):
        tfr = tf.view("field_v").fragment(s)
        jfr = jf.view("field_v").fragment(s)
        for r in range(12):
            want = jfr._row_words_host(r)
            got = tfr.row_words_host(r)
            if want is None or not want.any():
                assert got is None or not got.any()
            else:
                np.testing.assert_array_equal(got, want)


def test_schema_errors_match_jax(pair):
    """tests/test_bsi.py:457 and the rewrite's argument errors: the same
    messages from both packages."""
    for h in (pair.t, pair.j):
        h.create_index_if_not_exists("i").create_frame_if_not_exists("f")
    queries = [
        "Count(Range(frame=f, v > 1))",  # not range-enabled
        "Sum(frame=f, field=v)",
        "Count(Range(frame=nope, v > 1))",
    ]
    for q in queries:
        got, want = pair.ask(q)
        assert got == want and got[0] == "error", q
    for f in pair.frames():
        f.set_options(range_enabled=True)
    pair.field(0, 10, name="w")
    queries = [
        "Count(Range(frame=f, v > 1))",  # unknown field
        "Sum(frame=f, field=v)",
        "Sum(frame=f)",
        "Max(Bitmap(frame=f, rowID=1), Bitmap(frame=f, rowID=2), frame=f, field=w)",
        "Count(Range(frame=f, w > 1, v < 2))",  # two comparisons
        "Count(Range(frame=f, w > 1.5))",  # not an integer
        'Count(Range(frame=f, w > "x"))',
        "Count(Range(frame=f, w >< [1]))",  # between not a two-int list
        "Count(Range(frame=f, w >< 4))",
        "Count(Range(frame=f, w >< [1, 2.5]))",
        "Count(Range(frame=f, w >< [1, 2, 3]))",
    ]
    for q in queries:
        got, want = pair.ask(q)
        assert got == want and got[0] == "error", q
    tf = pair.t.frame("i", "f")
    with pytest.raises(Exception, match="field already exists"):
        tf.create_field("w", 0, 1)
    with pytest.raises(Exception, match="field not found"):
        tf.import_value("nope", [1], [1])
    with pytest.raises(Exception, match="out of range"):
        tf.import_value("w", [1], [11])
    g = pair.t.index("i").create_frame_if_not_exists("g")
    with pytest.raises(Exception, match="does not support range queries"):
        g.create_field("v", 0, 10)


def test_field_views_interoperate(tmp_path):
    """A JAX-written data dir with a field view opens in the port with
    identical planes and answers, and the reverse."""
    rng = np.random.default_rng(9)
    cols, vals = rand_data(rng, -300, 5000, 400, 3)
    queries = ["Count(Range(frame=f, v > 17))", "Sum(frame=f, field=v)", "Min(frame=f, field=v)",
               "Max(frame=f, field=v)", "Count(Range(frame=f, v >< [-5, 900]))"]
    for writer in ("jax", "torch"):
        p = Pair2(tmp_path / writer)
        p.field(-300, 5000)
        holder = p.j if writer == "jax" else p.t
        holder.frame("i", "f").import_value("v", cols, vals)
        ex = p.jex if writer == "jax" else p.tex
        parse = jparse if writer == "jax" else tparse
        want = [[norm(r) for r in ex.execute("i", parse(q))] for q in queries]
        path = p.jdir if writer == "jax" else p.tdir
        p.close()
        if writer == "jax":
            h = THolder(path, device="cpu")
            h.open()
            ex2, parse2 = TExecutor(h), tparse
        else:
            h = JHolder(path)
            h.open()
            ex2, parse2 = JExecutor(h), jparse
        try:
            f = h.frame("i", "f")
            assert f.range_enabled and [x.to_dict() for x in f.bsi_fields()] == [
                {"name": "v", "type": "int", "min": -300, "max": 5000}]
            got = [[norm(r) for r in ex2.execute("i", parse2(q))] for q in queries]
            assert got == want
        finally:
            ex2.close()
            h.close()


def test_field_delete_and_list(pair):
    pair.field(-5, 5)
    pair.field(0, 9, name="a")
    tf, jf = pair.t.frame("i", "f"), pair.j.frame("i", "f")
    assert [x.to_dict() for x in tf.bsi_fields()] == [x.to_dict() for x in jf.bsi_fields()]
    assert tf.schema_dict() == jf.schema_dict()
    pair.import_value("v", [1, 2], [-5, 5])
    for f in (tf, jf):
        f.delete_field("v")
    assert tf.view("field_v") is None
    assert pair.ask("Sum(frame=f, field=v)")[0] == pair.ask("Sum(frame=f, field=v)")[1]
    with open(tf.meta_path) as a, open(jf.meta_path) as b:
        assert a.read() == b.read()
