"""Quorum replication: tunable W-of-N writes, hinted handoff, and
read-repair (Dynamo-class consistency; DeCandia et al. SOSP'07,
Lakshman & Malik 2010).

Modules: ``versions`` (per-slice monotonic write versions),
``hints`` (bounded per-(replica, slice) hinted-handoff log),
``quorum`` (the W-of-N write coordinator + hint replayer),
``repair`` (version-checked reads with newest->stale convergence).
"""

from pilosa_tpu_torch.replicate.hints import HintLog
from pilosa_tpu_torch.replicate.quorum import (
    CONSISTENCY_LEVELS,
    READ_CONSISTENCY_HEADER,
    WRITE_CONSISTENCY_HEADER,
    WRITE_VERSION_HEADER,
    QuorumWriteError,
    ReadConsistencyError,
    Replication,
    required_acks,
    validate_level,
)
from pilosa_tpu_torch.replicate.repair import RepairError
from pilosa_tpu_torch.replicate.versions import VersionStore

__all__ = [
    "CONSISTENCY_LEVELS",
    "READ_CONSISTENCY_HEADER",
    "WRITE_CONSISTENCY_HEADER",
    "WRITE_VERSION_HEADER",
    "HintLog",
    "QuorumWriteError",
    "ReadConsistencyError",
    "RepairError",
    "Replication",
    "VersionStore",
    "required_acks",
    "validate_level",
]
