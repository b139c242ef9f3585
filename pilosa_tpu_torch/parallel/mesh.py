"""Device-mesh execution: slices sharded over member devices.

The port's counterpart of ``pilosa_tpu/parallel/mesh.py``.  The
reference distributes slices over nodes and reduces over HTTP
(executor.go:1149-1243 mapReduce); within a host the same map lives on
a mesh of member devices:

* **slices axis** — the unbounded column axis, 2^20 columns a slice.
  Slices are disjoint column ranges, so a cross-slice "Union" of result
  rows is a merge, never an OR; the only cross-slice reduces are sums
  for counts and the per-row totals of TopN.
* **rows axis** — shards a plane's row dimension for TopN scoring (one
  row block a member, scored against the slice's src row).

A :class:`Mesh` is a (slices × rows) grid of member devices — the cards
of a host, or a list of logical members a caller set
(``bitplane.set_local_members``; a device may appear more than once) —
and, in a multi-host run, the process group (``parallel/multihost.py``).
A :class:`Sharded` array is its per-member blocks and their offsets: no
device holds the whole.  The executor's sharded batch is an
``ops/tree_eval.ShardedTable``: one K2/K3 row table a member, over the
mirrors homed there.

The reduces launch on each member — K2 (``plan.tree_eval``) for a Count
tree, K9 (``ops/mesh_topn.py``) for TopN's per-row scores, ``top_k``
(``ops/top_k.py``) for the rank — and sum across members in int64 on
the host, then across processes with one ``all_reduce(SUM)``.  A
cross-member sum runs under the process-wide collective lock
(``plan.run_collective``) and, given a ``DeviceHealth``, under its
watchdog and the ``collective`` breaker path: a trip or a quarantine
degrades to the per-member partials, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pilosa_tpu_torch.exec import plan
from pilosa_tpu_torch.ops import bitplane as bp
from pilosa_tpu_torch.ops import mesh_topn, top_k
from pilosa_tpu_torch.ops.tree_eval import RowTable, ShardedTable  # noqa: F401 — re-export
from pilosa_tpu_torch.parallel import multihost

AXIS_SLICES = "slices"
AXIS_ROWS = "rows"

class Mesh:
    """A (slices × rows) grid of member devices; ``group`` is the process
    group a multi-host run reduces over (None on one host)."""

    __slots__ = ("devices", "group")

    def __init__(self, devices, group=None):
        grid = [list(map(torch.device, row)) for row in devices]
        if not grid or not grid[0] or any(len(r) != len(grid[0]) for r in grid):
            raise ValueError("a mesh is a non-empty (slices x rows) grid of devices")
        self.devices = grid
        self.group = group

    @property
    def shape(self) -> dict:
        return {AXIS_SLICES: len(self.devices), AXIS_ROWS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def flat(self) -> list[torch.device]:
        """Members in slice-major order."""
        return [d for row in self.devices for d in row]


def default_slices_mesh() -> Mesh | None:
    """A 1-D slices mesh over the participating local members, built anew
    at each call; None with fewer than two (the executor then runs the
    one-device path)."""
    devs = bp.participating_devices()
    if len(devs) < 2:
        return None
    return Mesh([[d] for d in devs], multihost.group())


def slice_mesh(n_devices: int | None = None, row_shards: int = 1) -> Mesh:
    """A (slices, rows) mesh over the first ``n_devices`` local members.

    ``row_shards`` splits the row axis (TopN scoring parallelism); the
    remaining members shard the slice axis."""
    devs = bp.local_members()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"n_devices {n} > {len(devs)} local members")
    if n % row_shards != 0:
        raise ValueError(f"n_devices {n} not divisible by row_shards {row_shards}")
    grid = [list(devs[i * row_shards:(i + 1) * row_shards]) for i in range(n // row_shards)]
    return Mesh(grid, multihost.group())


def plane_spec() -> tuple:
    return (AXIS_SLICES, AXIS_ROWS, None)


@dataclass
class Sharded:
    """A global array as per-member blocks: ``blocks[i]`` lies on
    ``mesh.flat()[i]`` and starts at ``offsets[i]`` (one index per axis)
    of the global ``shape``.  Blocks are int32 bit-views of the uint32
    words."""

    blocks: list
    offsets: list
    shape: tuple
    mesh: Mesh

    def numpy(self) -> np.ndarray:
        """The global array as uint32 words (a host copy)."""
        out = np.zeros(self.shape, dtype=np.uint32)
        for b, off in zip(self.blocks, self.offsets):
            idx = tuple(slice(o, o + n) for o, n in zip(off, b.shape))
            out[idx] = bp.to_host(b).reshape(b.shape)
        return out


def shard(host: np.ndarray, mesh: Mesh, spec: tuple) -> Sharded:
    """Place a uint32 host array on ``mesh``: an axis named
    ``AXIS_SLICES`` / ``AXIS_ROWS`` in ``spec`` splits into equal
    contiguous blocks over that mesh axis (its length must divide), any
    other axis stays whole.  Member (i, j) of the grid gets block i of
    the slices axis and block j of the rows axis."""
    host = np.ascontiguousarray(host, dtype=np.uint32)
    if len(spec) != host.ndim:
        raise ValueError(f"spec {spec} does not match an array of {host.ndim} axes")
    n_of = {AXIS_SLICES: len(mesh.devices), AXIS_ROWS: len(mesh.devices[0]), None: 1}
    for ax, name in enumerate(spec):
        if host.shape[ax] % n_of[name]:
            raise ValueError(f"axis {ax} of {host.shape[ax]} does not split over {n_of[name]}")
    blocks, offsets = [], []
    for i, row in enumerate(mesh.devices):
        for j, dev in enumerate(row):
            pos = {AXIS_SLICES: i, AXIS_ROWS: j, None: 0}
            idx, off = [], []
            for ax, name in enumerate(spec):
                n = host.shape[ax] // n_of[name]
                off.append(pos[name] * n)
                idx.append(slice(pos[name] * n, pos[name] * n + n))
            blocks.append(bp.to_device(host[tuple(idx)], dev))
            offsets.append(tuple(off))
    return Sharded(blocks, offsets, tuple(host.shape), mesh)


def shard_planes(planes: np.ndarray, mesh: Mesh) -> Sharded:
    """Place ``uint32[n_slices, rows, words]`` onto the mesh, slice axis
    over AXIS_SLICES and row axis over AXIS_ROWS.  Pads the slice and row
    axes up to the mesh (zero slices contribute nothing to any query),
    as the JAX package does."""
    n_sl, n_rw = len(mesh.devices), len(mesh.devices[0])
    s, r, _ = planes.shape
    pad_s, pad_r = (-s) % n_sl, (-r) % n_rw
    if pad_s or pad_r:
        planes = np.pad(planes, ((0, pad_s), (0, pad_r), (0, 0)))
    return shard(planes, mesh, plane_spec())


# ---------------------------------------------------------------------------
# The distributed reduces (JAX parallel/mesh.py:113-309)
# ---------------------------------------------------------------------------


def _collective_degraded(exc, health) -> bool:
    """Whether a collective failure degrades to the per-member partials
    (a watchdog trip, a quarantined path) rather than propagates; counted
    when it does."""
    if health is None:
        return False
    from pilosa_tpu_torch.device import health as health_mod

    degraded = isinstance(exc, (health_mod.LaunchWatchdogTimeout,
                                health_mod.CollectiveUnavailable))
    if degraded:
        plan.note_collective_fallback()
    return degraded


def _global_sum(values: np.ndarray, mesh: Mesh) -> np.ndarray:
    if mesh.group is None:
        return values
    return multihost.all_reduce_sum(values, mesh.group)


def _pair_table(block: torch.Tensor) -> RowTable:
    """K2's table over one member's leaf block int32 ``[s, L, r, words]``:
    one table "slice" a (slice, row) pair, leaf ``l`` its row of leaf
    ``l`` — read in place."""
    s, n_leaves, r, words = block.shape
    base = block.reshape(s * n_leaves * r, words)
    si, li, ri = np.meshgrid(np.arange(s), np.arange(n_leaves), np.arange(r), indexing="ij")
    rows = (si * n_leaves * r + li * r + ri).transpose(0, 2, 1).reshape(s * r, n_leaves)
    index = np.stack([np.zeros_like(rows), rows], axis=-1).astype(np.int64)
    return RowTable([base], index, words=words)


def count_tree(expr: tuple, leaf_planes: Sharded) -> np.ndarray:
    """Per-(slice, row) partials of a tree over the leaf planes, one K2
    "count" launch a member (``_count_tree``, JAX ``mesh.py:113``):
    int32 ``[n_slices, rows]`` in the global layout."""
    out = np.zeros((leaf_planes.shape[0], leaf_planes.shape[2]), dtype=np.int32)
    launched = [(b, off, plan.tree_eval(expr, "count", _pair_table(b)))
                for b, off in zip(leaf_planes.blocks, leaf_planes.offsets)]
    for b, off, cnt in launched:
        s, _, r, _ = b.shape
        out[off[0]:off[0] + s, off[2]:off[2] + r] = cnt.cpu().numpy().reshape(s, r)
    return out


def distributed_count(expr: tuple, leaf_planes: Sharded, n_partials: int | None = None,
                      health=None) -> int:
    """Count(tree) where each leaf is a full sharded plane.

    ``leaf_planes``: uint32 ``[n_slices, n_leaves, rows, words]`` sharded
    ``(slices, None, rows, None)``.  The cross-member reduce — one K2
    "total" launch a member, summed in int64 — runs as a collective
    whenever the partial count is within ``MAX_ONDEVICE_COUNT_PARTIALS``
    (the JAX package's limb budget; the port's kernels sum in 64 bits,
    but both routes stay reachable); beyond that the per-partial host sum
    takes over.  Callers whose planes carry zero padding may pass the
    real slice-row count as ``n_partials``.  A watchdog trip or a
    quarantined collective path (``health``) degrades to the per-partial
    host sum instead of wedging."""
    if n_partials is None:
        n_partials = leaf_planes.shape[0] * leaf_planes.shape[2]
    mesh = leaf_planes.mesh
    if n_partials <= plan.MAX_ONDEVICE_COUNT_PARTIALS:
        try:
            local = plan.run_collective(
                lambda: plan.total_count([_pair_table(b) for b in leaf_planes.blocks],
                                         lambda t: plan.tree_eval(expr, "total", t)),
                health,
            )
            return int(_global_sum(np.asarray([local], dtype=np.int64), mesh)[0])
        except Exception as e:
            if not _collective_degraded(e, health):
                raise
    local = int(count_tree(expr, leaf_planes).sum(dtype=np.int64))
    return int(_global_sum(np.asarray([local], dtype=np.int64), mesh)[0])


def topn_partials(plane: Sharded, src: Sharded) -> np.ndarray:
    """Per-(slice, row) ``|row AND src|``, one K9 "partials" launch a
    member (``_topn_partials``, JAX ``mesh.py:187``): int32 ``[n_slices,
    rows]``."""
    out = np.zeros(plane.shape[:2], dtype=np.int32)
    src_of = _src_blocks(plane, src)
    launched = [(b, off, mesh_topn.mesh_topn(b, sb, "partials"))
                for b, off, sb in zip(plane.blocks, plane.offsets, src_of)]
    for b, off, part in launched:
        s, r, _ = b.shape
        out[off[0]:off[0] + s, off[1]:off[1] + r] = part.cpu().numpy()
    return out


def _src_blocks(plane: Sharded, src: Sharded) -> list[torch.Tensor]:
    """Each plane block's src rows on its member: the src block of the
    same slice block, moved only where it lies on another device."""
    by_off = {off[0]: b for b, off in zip(src.blocks, src.offsets)}
    out = []
    for b, off in zip(plane.blocks, plane.offsets):
        sb = by_off[off[0]]
        out.append(sb if sb.device == b.device else sb.to(b.device))
    return out


def topn_totals(plane: Sharded, src: Sharded) -> np.ndarray:
    """Per-row ``|row AND src|`` totals over every slice of this process:
    one K9 "total" launch a member, the row blocks' sums placed and the
    slice blocks' added in int64 (``_topn_total_fn``, JAX
    ``mesh.py:206``)."""
    per = np.zeros(plane.shape[1], dtype=np.int64)
    src_of = _src_blocks(plane, src)
    launched = [(b, off, mesh_topn.mesh_topn(b, sb, "total"))
                for b, off, sb in zip(plane.blocks, plane.offsets, src_of)]
    for b, off, tot in launched:
        per[off[1]:off[1] + b.shape[1]] += tot.cpu().numpy()
    return per


def distributed_topn(plane: Sharded, src: Sharded, k: int, health=None):
    """TopN(Src=...) over a sharded fragment stack: returns ``(counts,
    row_ids)`` host arrays, count descending, ties toward the lower id —
    the reference's Pair sort (cache.go:316-330).

    The cross-member per-row reduce (K9 "total" a member, summed in
    int64) runs as a collective within the partial budget; the final
    rank of the ``[rows]`` vector keeps the host stable argsort for the
    exact reference tie-break, as in the JAX package.  A watchdog trip or
    a quarantined collective path (``health``) degrades to the
    per-partial host sum."""
    per = None
    if plane.shape[0] <= plan.MAX_ONDEVICE_COUNT_PARTIALS:
        try:
            per = plan.run_collective(lambda: topn_totals(plane, src), health)
        except Exception as e:
            if not _collective_degraded(e, health):
                raise
    if per is None:
        per = topn_partials(plane, src).astype(np.int64).sum(axis=0)
    per = _global_sum(per, plane.mesh)
    k = min(k, per.shape[0])
    ids = np.argsort(-per, kind="stable")[:k]
    return per[ids], ids


# ---------------------------------------------------------------------------
# The full sharded step: mutate + query + TopN (JAX mesh.py:264-309)
# ---------------------------------------------------------------------------


def _fold_updates(rows_upd, words_upd, masks) -> tuple:
    """Combine duplicate (row, word) targets by OR (the host write path's
    ``np.bitwise_or.at`` pre-combine): ``(rows, words, masks)`` unique,
    sorted by (row, word)."""
    rows_upd = np.asarray(rows_upd, dtype=np.int64)
    words_upd = np.asarray(words_upd, dtype=np.int64)
    masks = np.asarray(masks, dtype=np.uint32)
    key = rows_upd * (1 << 32) + words_upd
    uniq, inv = np.unique(key, return_inverse=True)
    out = np.zeros((masks.shape[0], len(uniq)), dtype=np.uint32)
    for i, u in enumerate(inv):
        out[:, u] |= masks[:, i]
    return uniq >> 32, uniq & 0xFFFFFFFF, out


def query_step(mesh: Mesh):
    """The end-to-end step over ``mesh``: applies a batch of bit
    mutations (scatter-OR), then runs Count(Intersect(r0, r1)) and a TopN
    scoring pass — the write+read cycle of SURVEY.md §3.2/§3.3.

    Returns ``step(planes, rows_upd, words_upd, masks) -> (planes,
    count, top_counts, top_ids)``: ``planes`` a :class:`Sharded`
    ``uint32[n_slices, rows, words]`` sharded ``(slices, rows, None)``,
    updated IN PLACE (the JAX step returned a new array; in place keeps
    one copy on the card) and returned; the update batch indexes
    ``[n_upd]`` (row, word) targets within every slice, ``masks`` uint32
    ``[n_slices, n_upd]``.  Duplicate targets are OR-combined on the host
    first, so any batch is one K7 launch a member.  ``count`` is the
    per-slice int32 ``[n_slices]`` of one K2 launch a slice block;
    ``top_counts`` / ``top_ids`` the top 4 of the per-row totals (K9 a
    member, summed in int64) by the ``top_k`` kernel."""

    def step(planes: Sharded, rows_upd, words_upd, masks):
        if planes.mesh is not mesh:
            raise ValueError("planes are not sharded over this step's mesh")
        n_slices, n_rows, words = planes.shape
        rows_u, words_u, masks_u = _fold_updates(rows_upd, words_upd, masks)
        # Write path: one K7 launch a member over its block viewed as one
        # plane of s x r rows; entries sorted by flat word, none twice.
        for b, off in zip(planes.blocks, planes.offsets):
            s, r, _ = b.shape
            mine = (rows_u >= off[1]) & (rows_u < off[1] + r)
            if not mine.any():
                continue
            local = (rows_u[mine] - off[1]) * words + words_u[mine]
            flat = (np.arange(s)[:, None] * (r * words) + local[None, :]).reshape(-1)
            m = masks_u[off[0]:off[0] + s][:, mine].reshape(-1)
            order = np.argsort(flat, kind="stable")
            plan.scatter_apply_many(
                [b.view(s * r, words)], np.zeros(len(flat), dtype=np.int32),
                flat[order].astype(np.uint32), m[order], np.zeros(len(flat), dtype=np.uint32))
        # Read path: Count(Intersect(row0, row1)) per slice — one K2 launch
        # a slice block, on the member that holds row 0.
        loc = _row_blocks(planes)
        count = np.zeros(n_slices, dtype=np.int32)
        counts = []
        for i0 in sorted({off[0] for off in planes.offsets}):
            b0, r0 = loc[(i0, 0)]
            b1, r1 = loc[(i0, 1)]
            if b1.device != b0.device:
                b1 = b1.to(b0.device)
            s = b0.shape[0]
            bases = [b0.view(-1, words)] if b1 is b0 else [b0.view(-1, words),
                                                            b1.reshape(-1, words)]
            idx = np.zeros((s, 2, 2), dtype=np.int64)
            idx[:, 0, 1] = np.arange(s) * b0.shape[1] + r0
            idx[:, 1, 0] = len(bases) - 1
            idx[:, 1, 1] = np.arange(s) * b1.shape[1] + r1
            counts.append((i0, s, plan.tree_eval(("Intersect", ("leaf", 0), ("leaf", 1)),
                                                 "count", RowTable(bases, idx, words=words))))
        for i0, s, cnt in counts:
            count[i0:i0 + s] = cnt.cpu().numpy()
        # TopN: per-row intersection counts with row 0 as src (K9 a member,
        # read in place), the global top 4 by the top_k kernel.
        b_src = {i0: loc[(i0, 0)] for i0 in {off[0] for off in planes.offsets}}
        dev0 = planes.blocks[0].device
        per = torch.zeros(n_rows, dtype=torch.int64, device=dev0)
        for b, off in zip(planes.blocks, planes.offsets):
            sb, sr = b_src[off[0]]
            src = sb[:, sr, :]
            if src.device != b.device:
                src = src.to(b.device)
            per[off[1]:off[1] + b.shape[1]] += mesh_topn.mesh_topn(b, src, "total").to(dev0)
        per = torch.from_numpy(_global_sum(per.cpu().numpy(), mesh)).to(dev0) \
            if mesh.group is not None else per
        top_counts, top_ids = top_k.top_k(per, 4)
        return planes, count, top_counts, top_ids

    return step


def _row_blocks(planes: Sharded) -> dict:
    """``(slice offset, global row) -> (block, row within it)`` for every
    block of a ``(slices, rows, None)`` plane stack."""
    out = {}
    for b, off in zip(planes.blocks, planes.offsets):
        for r in range(b.shape[1]):
            out[(off[0], off[1] + r)] = (b, r)
    return out
