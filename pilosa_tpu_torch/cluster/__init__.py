"""Cluster layer: placement (topology) and schema broadcast."""
