"""Time-quantum views on the port against ``pilosa_tpu``: the view-name
functions for every quantum on seeded times; ``SetBit(timestamp=)``,
``Frame.import_bulk`` with timestamps and a protobuf ``/import`` with
timestamps create the same views with the same planes; and
``Range(frame, rowID, start, end)`` answers equally, plain and composed,
with the same errors."""

import json
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.core import timequantum as jtq  # noqa: E402
from pilosa_tpu.net import wire_pb2 as pb  # noqa: E402
from pilosa_tpu.net.server import Server as JServer  # noqa: E402
from pilosa_tpu_torch.core import timequantum as ttq  # noqa: E402
from pilosa_tpu_torch.net.server import Server as TServer  # noqa: E402

SW = 1 << 20
N_SLICES = 3
QUANTUMS = ("Y", "YM", "YMD", "YMDH", "M", "MD", "MDH", "D", "DH", "H")
BASE = datetime(2017, 2, 20, 5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU tensor ops: one thread each, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_times(rng, n: int, days: int = 40) -> list[datetime]:
    return [BASE + timedelta(minutes=int(m)) for m in rng.integers(0, days * 24 * 60, n)]


@pytest.mark.parametrize("quantum", QUANTUMS)
def test_view_names_match_jax(quantum):
    rng = np.random.default_rng(len(quantum))
    times = seeded_times(rng, 40, days=800)
    for t in times:
        want = jtq.views_by_time("standard", t, quantum)
        assert ttq.views_by_time("standard", t, quantum) == want
    for a, b in zip(times[::2], times[1::2]):
        start, end = min(a, b), max(a, b)
        assert ttq.views_by_time_range("standard", start, end, quantum) == \
            jtq.views_by_time_range("standard", start, end, quantum)


def http(host: str, method: str, path: str, body: bytes = b"", headers=None):
    req = urllib.request.Request(
        f"http://{host}{path}", data=body if method != "GET" else None, method=method,
        headers=headers or {},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def ask(host: str, pql: str):
    status, data = http(host, "POST", "/index/i/query", pql.encode())
    return status, json.loads(data)


@pytest.fixture
def servers(tmp_path):
    j = JServer(data_dir=str(tmp_path / "jax"), host="127.0.0.1:0", anti_entropy_interval=3600,
                polling_interval=3600, cache_flush_interval=3600)
    t = TServer(str(tmp_path / "torch"), device="cpu", polling_interval=3600)
    j.open()
    t.open()
    try:
        for s in (j, t):
            assert http(s.host, "POST", "/index/i")[0] == 200
            assert http(s.host, "POST", "/index/i/frame/t",
                        b'{"options": {"timeQuantum": "YMD"}}')[0] == 200
            assert http(s.host, "POST", "/index/i/frame/f")[0] == 200
        yield j, t
    finally:
        t.close()
        j.close()


def ns(t: datetime) -> int:
    return int(t.replace(tzinfo=timezone.utc).timestamp()) * 1_000_000_000


def load(j, t, rng):
    """SetBits with timestamps over HTTP, then a protobuf /import of bits
    with timestamps spread over 40 days (some without one), to both."""
    writes = []
    for _ in range(60):
        r, c = int(rng.integers(0, 4)), int(rng.integers(0, N_SLICES * SW))
        ts = seeded_times(rng, 1)[0].strftime("%Y-%m-%dT%H:%M")
        writes.append(f'SetBit(frame=t, rowID={r}, columnID={c}, timestamp="{ts}")')
    writes.append('SetBit(frame=t, rowID=1, columnID=5, timestamp="2017-13-01T00:00")')
    for q in writes:
        assert ask(t.host, q) == ask(j.host, q), q
    rows = rng.integers(0, 4, 4000)
    cols = rng.integers(0, SW, 4000)  # slice 0: one ImportRequest
    stamps = np.asarray([ns(x) for x in seeded_times(rng, 4000)], dtype=np.int64)
    stamps[::7] = 0  # no timestamp: the standard view only
    body = pb.ImportRequest(Index="i", Frame="t", Slice=0, RowIDs=rows.tolist(),
                            ColumnIDs=cols.tolist(), Timestamps=stamps.tolist()).SerializeToString()
    hdr = {"Content-Type": "application/x-protobuf", "Accept": "application/x-protobuf"}
    assert http(t.host, "POST", "/import", body, hdr) == http(j.host, "POST", "/import", body, hdr)
    frows, fcols = rng.integers(0, 2, 3000), rng.integers(0, N_SLICES * SW, 3000)
    for s in (j, t):
        s.holder.frame("i", "f").import_bulk(frows, fcols)


def test_time_views_and_ranges_match_jax(servers):
    j, t = servers
    rng = np.random.default_rng(3)
    load(j, t, rng)
    jf, tf = j.holder.frame("i", "t"), t.holder.frame("i", "t")
    assert sorted(tf.views()) == sorted(jf.views())
    assert len(tf.views()) > 20
    for name, jv in jf.views().items():
        tv = tf.view(name)
        assert tv.fragment_slices() == {s for s in range(N_SLICES) if jv.fragment(s) is not None}
        for s in tv.fragment_slices():
            for r in range(4):
                want = jv.fragment(s)._row_words_host(r)
                got = tv.fragment(s).row_words_host(r)
                if want is None:
                    assert got is None
                else:
                    np.testing.assert_array_equal(got, want)
    spans = [("2017-02-21T00:00", "2017-02-25T00:00"),  # inside one month
             ("2017-02-26T00:00", "2017-03-05T13:00"),  # across the month boundary
             ("2017-01-01T00:00", "2018-01-01T00:00"),  # the whole year
             ("2017-03-31T00:00", "2017-02-01T00:00"),  # an empty span
             ("2016-01-01T00:00", "2016-05-01T00:00")]  # no view in it
    queries = []
    for a, b in spans:
        rt = f'Range(frame=t, rowID=1, start="{a}", end="{b}")'
        queries += [f"Count({rt})", rt,
                    f"Count(Intersect({rt}, Bitmap(frame=f, rowID=0)))",
                    f"Count(Union({rt}, Range(frame=t, rowID=2, start=\"{a}\", end=\"{b}\")))",
                    f"Difference(Bitmap(frame=f, rowID=1), {rt})",
                    f"TopN({rt}, frame=f, n=2)"]
    queries += [
        'Count(Range(frame=f, rowID=1, start="2017-01-01T00:00", end="2018-01-01T00:00"))',
        'Count(Range(frame=t, rowID=1, end="2018-01-01T00:00"))',
        'Count(Range(frame=t, rowID=1, start="2017-01-01", end="2018-01-01T00:00"))',
        'Count(Range(frame=t, rowID=1, columnID=2, start="2017-01-01T00:00", '
        'end="2018-01-01T00:00"))',
        'Count(Range(frame=t, start="2017-01-01T00:00", end="2018-01-01T00:00"))',
        'Count(Range(frame=nope, rowID=1, start="2017-01-01T00:00", end="2018-01-01T00:00"))',
    ]
    nonzero = 0
    for q in queries:
        got, want = ask(t.host, q), ask(j.host, q)
        assert got == want, q
        nonzero += bool(want[0] == 200 and want[1]["results"][0])
    assert nonzero > 10


def test_frame_import_with_datetimes_matches_jax(tmp_path):
    """Frame.import_bulk with datetime timestamps directly (no wire)."""
    from pilosa_tpu.core.holder import Holder as JHolder
    from pilosa_tpu_torch.core.holder import Holder as THolder

    rng = np.random.default_rng(8)
    rows, cols = rng.integers(0, 3, 2000), rng.integers(0, 2 * SW, 2000)
    times = seeded_times(rng, 2000, days=6)
    times[::5] = [None] * len(times[::5])
    out = []
    for holder in (THolder(str(tmp_path / "t"), device="cpu"), JHolder(str(tmp_path / "j"))):
        holder.open()
        f = holder.create_index_if_not_exists("i").create_frame_if_not_exists("t")
        f.set_options(time_quantum="YMDH")
        f.import_bulk(rows, cols, times)
        views = {}
        for name, v in f.views().items():
            for s in range(2):
                frag = v.fragment(s)
                if frag is None:
                    continue
                get = getattr(frag, "row_words_host", None) or frag._row_words_host
                words = [get(r) for r in range(3)]
                views[(name, s)] = [None if w is None else w.tobytes() for w in words]
        out.append(views)
        holder.close()
    assert out[0] == out[1]
    assert len(out[0]) > 100
