"""Elastic-cluster rebalancing — live node join/leave with background
slice migration and write-forwarding cutover.

The reference design fixes the node set at boot and punts on resharding
entirely; this subsystem makes topology changes a background operation
against a serving cluster:

* :mod:`pilosa_tpu_torch.rebalance.plan` — the slice-ownership diff between
  the old and new jump-hash rings, as a per-slice migration plan;
* :mod:`pilosa_tpu_torch.rebalance.deltalog` — the bounded per-slice write
  log a migration source keeps during its copy window, replayed to the
  target after the bulk copy (cutover-scoped anti-entropy);
* :mod:`pilosa_tpu_torch.rebalance.migrate` — the coordinator state machine
  (copy -> replay -> checksum-verify -> atomic per-slice ownership
  flip -> release) plus the per-node topology-event application every
  member runs.

Reads route on the OLD ring until a slice's fragment is
checksum-verified on its new owner; writes go to BOTH rings' owners
for the whole transition (`Cluster.write_nodes`); the transition is
resumable (persisted per-slice state) and abortable (both rings stay
valid throughout).
"""

from pilosa_tpu_torch.rebalance.deltalog import DeltaLog
from pilosa_tpu_torch.rebalance.migrate import RebalanceError, Rebalancer
from pilosa_tpu_torch.rebalance.plan import SliceMove, compute_plan

__all__ = [
    "DeltaLog",
    "RebalanceError",
    "Rebalancer",
    "SliceMove",
    "compute_plan",
]
