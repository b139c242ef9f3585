"""The port's container codec and the plain versions of K5 (anchored
membership count) and K6 (payload expansion) against the JAX package's
``encode_row`` / ``decode_payload`` / ``membership_*`` /
``expand_payload`` / ``anchored_count_exec`` on seeded inputs — exact
equality, the format choice included."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pilosa_tpu.exec import plan as jplan  # noqa: E402
from pilosa_tpu.ops import bitplane as jbp  # noqa: E402
from pilosa_tpu_torch.exec import plan as tplan  # noqa: E402
from pilosa_tpu_torch.ops import anchored_count as tac  # noqa: E402
from pilosa_tpu_torch.ops import bitplane as tbp  # noqa: E402
from pilosa_tpu_torch.ops import expand_payload as tep  # noqa: E402

SW = tbp.SLICE_WIDTH


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the cores: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def auto_format():
    """Both packages start from the default policy and restore it."""
    for bp in (jbp, tbp):
        bp.configure_plane_format(mode="auto", sparse_max_bytes=65536, rle_max_bytes=65536)
    yield
    for bp in (jbp, tbp):
        bp.configure_plane_format(mode="auto", sparse_max_bytes=65536, rle_max_bytes=65536)


def _configure(**kw):
    for bp in (jbp, tbp):
        bp.configure_plane_format(**kw)


def _scattered(rng, card):
    return np.sort(rng.choice(SW, size=card, replace=False)).astype(np.uint32)


def _clustered(rng, card, runs=8):
    run_len = max(1, card // runs)
    cols = set()
    for st in rng.choice(SW - run_len, size=runs, replace=False):
        cols.update(range(int(st), int(st) + run_len))
    return np.array(sorted(cols), dtype=np.uint32)


def _runs(n_runs, run_len, gap):
    """n_runs runs of run_len positions, gap apart (a row of n_runs runs)."""
    starts = np.arange(n_runs, dtype=np.int64) * (run_len + gap)
    return (starts[:, None] + np.arange(run_len)[None, :]).ravel().astype(np.uint32)


def _cases(rng):
    """(name, sorted offsets): every format, the threshold straddles and
    the sentinel edges — positions 0 and 2^20 - 1, a run ending at 2^20,
    the empty row."""
    cases = [
        ("empty", np.array([], dtype=np.uint32)),
        ("first", np.array([0], dtype=np.uint32)),
        ("last", np.array([SW - 1], dtype=np.uint32)),
        ("edges", np.array([0, 31, 32, SW - 32, SW - 1], dtype=np.uint32)),
        ("full", np.arange(SW, dtype=np.uint32)),
        ("run_to_end", np.arange(SW - 1000, SW, dtype=np.uint32)),
        ("sparse_16384", _scattered(rng, 16384)),
        ("sparse_16385", _scattered(rng, 16385)),
        ("runs_8192", _runs(8192, 3, 5)),
        ("runs_8193", _runs(8193, 3, 5)),
        ("runs_64_word_edges", _runs(64, 40, 24)),
    ]
    for card in (3, 77, 1000, 10_000, 60_000):
        cases.append((f"scattered_{card}", _scattered(rng, card)))
        cases.append((f"clustered_{card}", _clustered(rng, card)))
    return cases


CASES = [name for name, _ in _cases(np.random.default_rng(0))]


def _case(name):
    return dict(_cases(np.random.default_rng(0)))[name]


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize(
    "policy",
    [{}, {"mode": "dense"}, {"sparse_max_bytes": 32768}, {"rle_max_bytes": 1024}],
    ids=["auto", "dense", "sparse_cap_32k", "rle_cap_1k"],
)
def test_encode_row_matches_jax(name, policy):
    """Same format, payload and byte count as the JAX package for every
    row and policy; decode_payload inverts both."""
    _configure(**policy)
    offs = _case(name)
    jf, jp, jn = jbp.encode_row(offs)
    tf, tp, tn = tbp.encode_row(offs)
    assert (tf, tn) == (jf, jn)
    np.testing.assert_array_equal(tp, jp)
    if policy.get("mode") == "dense":
        assert tf == tbp.FMT_DENSE
    back = tbp.np_row_to_columns(tbp.decode_payload(tf, tp))
    np.testing.assert_array_equal(back, offs.astype(np.uint64))
    np.testing.assert_array_equal(tbp.decode_payload(tf, tp), jbp.decode_payload(jf, jp))


def test_format_thresholds():
    """The straddles pick the formats the JAX package picks: 16,384
    positions fit the sparse cap, 16,385 do not; 8,192 runs fit the RLE
    cap, 8,193 do not; tightening a cap reclassifies."""
    fmt = {name: tbp.encode_row(_case(name))[0] for name in CASES}
    assert fmt["sparse_16384"] == tbp.FMT_SPARSE and fmt["sparse_16385"] == tbp.FMT_DENSE
    assert fmt["runs_8192"] == tbp.FMT_RLE and fmt["runs_8193"] != tbp.FMT_RLE
    assert fmt["full"] == tbp.FMT_RLE and fmt["empty"] == tbp.FMT_SPARSE
    _configure(sparse_max_bytes=32768)
    assert tbp.encode_row(_case("sparse_16384"))[0] == tbp.FMT_DENSE
    _configure(rle_max_bytes=1024)
    assert tbp.encode_row(_case("runs_8192"))[0] != tbp.FMT_RLE


def _device_payload(fmt, payload):
    """The real entries of an encoded payload, as the fragment pages them."""
    return tbp.to_device(tbp.payload_entries(fmt, payload), "cpu")


def _probe(rng, offs):
    """Positions to ask about: random, the row's own, and the edges."""
    extra = offs[rng.integers(0, len(offs), 64)] if len(offs) else []
    return np.unique(np.concatenate([
        rng.choice(SW, size=512), extra, [0, 1, 31, 32, SW - 32, SW - 1],
    ]).astype(np.uint32))


@pytest.mark.parametrize("name", CASES)
def test_membership_matches_jax(name):
    """Plain K5 membership (dense words, positions, runs — real entries,
    no sentinel) answers as the JAX kernels do on their padded
    payloads."""
    offs = _case(name)
    rng = np.random.default_rng(len(offs))
    probe = _probe(rng, offs)
    pos = torch.from_numpy(probe.astype(np.int64))
    dense = tbp.np_columns_to_row(offs)
    want = np.asarray(jbp.membership_dense(jnp.asarray(dense), jnp.asarray(probe)))
    got = tbp.membership_dense(tbp.to_device(dense, "cpu"), pos).numpy()
    np.testing.assert_array_equal(got, want)
    for fmt, jmember in ((tbp.FMT_SPARSE, jbp.membership_sparse),
                         (tbp.FMT_RLE, jbp.membership_rle)):
        if fmt == tbp.FMT_SPARSE:
            jp = np.full(jbp.payload_bucket(len(offs)), jbp.FMT_SENTINEL, np.uint32)
            jp[: len(offs)] = offs
        else:
            runs = jbp.np_positions_to_runs(offs)
            jp = np.full((jbp.payload_bucket(len(runs)), 2), jbp.FMT_SENTINEL, np.uint32)
            jp[: len(runs)] = runs
        want = np.asarray(jmember(jnp.asarray(jp), jnp.asarray(probe)))
        got = tbp.membership(fmt, _device_payload(fmt, jp), pos).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(fmt))


@pytest.mark.parametrize("name", CASES)
def test_expand_matches_jax(name):
    """Plain K6 (through the wrapper's job table, into a destination
    row) equals ``bp.expand_payload`` for the row's format and for the
    other compressed format."""
    offs = _case(name)
    fmt, payload, _ = tbp.encode_row(offs)
    runs = tbp.np_positions_to_runs(offs)
    forms = [(fmt, payload), (tbp.FMT_SPARSE, offs), (tbp.FMT_RLE, runs)]
    dests = [torch.full((tbp.WORDS_PER_SLICE,), -1, dtype=torch.int32) for _ in forms]
    tep.expand_payloads([(f, _device_payload(f, p), d) for (f, p), d in zip(forms, dests)])
    want = tbp.np_columns_to_row(offs)
    for (f, p), d in zip(forms, dests):
        jp = np.asarray(jbp.expand_payload(f, jnp.asarray(p))) if len(p) else want
        np.testing.assert_array_equal(tbp.to_host(d), jp, err_msg=str(f))
        np.testing.assert_array_equal(tbp.to_host(d), want, err_msg=str(f))


def _padded(fmt, payload, length):
    out = np.full((length,) + payload.shape[1:], jbp.FMT_SENTINEL, dtype=np.uint32)
    out[: len(payload)] = payload
    return out


TREES = [
    ("Intersect", ("leaf", 0), ("leaf", 1), ("leaf", 2)),
    ("Difference", ("leaf", 0), ("Union", ("leaf", 1), ("leaf", 2))),
    ("Intersect", ("leaf", 0), ("Xor", ("leaf", 1), ("leaf", 2))),
    ("Intersect", ("leaf", 0), ("Union",)),
    ("Difference", ("leaf", 0)),
]


@pytest.mark.parametrize("expr", TREES, ids=range(len(TREES)))
def test_anchored_count_matches_jax(expr):
    """Plain K5 over a mix of formats, absent rows and anchor sizes (1
    position, 0, many) in one call equals the JAX package's anchored
    program run per format signature on padded payloads."""
    rng = np.random.default_rng(11)
    makers = [
        lambda: _scattered(rng, 500),
        lambda: _clustered(rng, 4000),
        lambda: _scattered(rng, 30_000),  # dense format
        lambda: None,  # absent row
    ]
    slices = []
    for s in range(6):
        anchor = [_scattered(rng, 700), np.array([SW - 1], np.uint32), np.array([], np.uint32),
                  _clustered(rng, 3000), np.arange(SW - 64, SW, dtype=np.uint32),
                  _scattered(rng, 32768)][s]
        rows = [makers[(s + i) % 4]() for i in range(3)]
        slices.append((anchor, rows))
    offsets = np.zeros(len(slices) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(a) for a, _ in slices])
    positions = np.concatenate([a for a, _ in slices]).astype(np.uint32)
    leaves, want = [], []
    for anchor, rows in slices:
        enc = [None if r is None else tbp.encode_row(r) for r in rows]
        leaves.append([None if e is None else (e[0], _device_payload(e[0], e[1])) for e in enc])
        if not len(anchor):
            want.append(0)
            continue
        fmts = tuple(jbp.FMT_SPARSE if e is None else e[0] for e in enc)
        pays = []
        for e in enc:
            if e is None:
                p = np.full((1, jbp.PAYLOAD_BUCKET_FLOOR), jbp.FMT_SENTINEL, np.uint32)
            elif e[0] == jbp.FMT_DENSE:
                p = e[1][None]
            else:
                p = _padded(e[0], e[1], len(e[1]))[None]
            pays.append(jnp.asarray(p))
        a = _padded(jbp.FMT_SPARSE, anchor, jbp.payload_bucket(len(anchor)))[None]
        want.append(int(np.asarray(jplan.anchored_count_exec(expr, fmts, jnp.asarray(a), pays))[0]))
    got = tplan.anchored_count(expr, positions, offsets, leaves, "cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_compile_program_and_checks():
    """The postfix program left-folds as the JAX program does, and the
    wrapper refuses malformed programs and anchors instead of guessing."""
    assert tplan.compile_program(("Intersect", ("leaf", 0), ("leaf", 1), ("leaf", 2))) == [
        0, 1, tac.OP_AND, 2, tac.OP_AND]
    assert tplan.compile_program(("Union",)) == [tac.OP_ZERO]
    with pytest.raises(ValueError):
        tac.check_program([0, tac.OP_AND], 1)
    with pytest.raises(ValueError):
        tac.check_program([0, 1], 2)
    with pytest.raises(ValueError):
        tac.check_program([3], 2)
    deep = [0] * 65 + [tac.OP_OR] * 64
    with pytest.raises(ValueError):
        tac.check_program(deep, 1)
    row = [(tbp.FMT_SPARSE, torch.zeros(0, dtype=torch.int32))]
    with pytest.raises(ValueError):
        tac.anchored_count([0], np.array([SW], np.uint32), np.array([0, 1], np.int64), [row], "cpu")
    with pytest.raises(ValueError):
        tep.expand_payloads([(tbp.FMT_RLE, torch.zeros(3, dtype=torch.int32),
                              torch.zeros(tbp.WORDS_PER_SLICE, dtype=torch.int32))])


def test_k5_k6_raise_off_the_cpu_and_without_their_library(monkeypatch):
    """A tensor the kernels cannot launch on (the meta device) raises in
    both wrappers, and where the rows are on the card a missing library
    raises out of both: no path computes the plain version instead."""
    from pilosa_tpu_torch.ops import _build

    meta = torch.empty(tbp.WORDS_PER_SLICE, dtype=torch.int32, device="meta")
    before = (tac.launches, tep.launches)
    with pytest.raises(ValueError):
        tep.expand_payloads([(tbp.FMT_DENSE, meta, meta)])
    with pytest.raises(ValueError):
        tac.anchored_count([0], np.array([5], np.uint32), np.array([0, 1], np.int64),
                           [[(tbp.FMT_DENSE, meta)]], "meta")

    def no_library(name):
        raise _build.KernelBuildError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(tep, "_fn", None)
    monkeypatch.setattr(tac, "_fn", None)
    # As for rows on the card: the device checks pass, the build fails.
    monkeypatch.setattr(tep, "_check", lambda jobs: torch.device("cuda"))
    monkeypatch.setattr(tac, "_device", lambda d: torch.device("cuda", 0))
    row = torch.zeros(tbp.WORDS_PER_SLICE, dtype=torch.int32)
    pos = torch.tensor([1, 9], dtype=torch.int32)
    with pytest.raises(_build.KernelBuildError):
        tep.expand_payloads([(tbp.FMT_SPARSE, pos, row)])
    monkeypatch.setattr(tac, "_check", lambda *a: None)
    with pytest.raises(_build.KernelBuildError):
        tac.anchored_count([0], np.array([5], np.uint32), np.array([0, 1], np.int64),
                           [[(tbp.FMT_SPARSE, pos)]], "cuda")
    assert (tac.launches, tep.launches) == before
