"""Anti-entropy: background convergence of replicas.

Three levels (reference: holder.go:357-556, fragment.go:1317-1498,
driven by server.go:200-236 every 10 minutes): column-attribute sync,
row-attribute sync, and fragment block sync with majority-consensus
merge.
"""

from pilosa_tpu_torch.sync.syncer import FragmentSyncer, HolderSyncer

__all__ = ["FragmentSyncer", "HolderSyncer"]
