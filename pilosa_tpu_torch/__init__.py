"""pilosa_tpu_torch — the PyTorch/CUDA port of pilosa_tpu.

A bitmap index served over HTTP: PQL ``Count``/``TopN`` and set algebra
over dense slice-row bit-planes (2^20 columns x 32768 uint32 words each)
held in device memory, BSI integer fields (``Range`` comparisons,
``Sum``/``Min``/``Max``) and time-quantum views.  The package mirrors the module layout of
``pilosa_tpu`` (``ops/``, ``core/``, ``exec/``, ``net/``, ...) so every
module has one reference module it is checked against; it imports
``torch`` and never ``jax``.

Plane words travel as int32 bit-views of the uint32 words (PyTorch's CPU
build has neither ``~`` nor shifts for uint32, and no popcount at all);
the last step of every count — bitwise op, popcount, reduce — is one
launch of the hand-written CUDA kernel in ``ops/csrc/fused_popcount.cu``,
queued writes reach a fragment's device mirror through the
delta-scatter kernel in ``ops/csrc/delta_scatter.cu``, and integer
fields are compared and aggregated by the ripple kernel in
``ops/csrc/bsi_ripple.cu``, which reads the field's planes in place.  Nodes speak the
reference's HTTP+protobuf wire and form a cluster with replicas.

Entry points default to ``device="cuda"`` and raise when CUDA is absent;
the CPU runs only when the caller passes ``device="cpu"``.
"""

from pilosa_tpu_torch.ops.bitplane import SLICE_WIDTH

__version__ = "0.1.0"

__all__ = ["SLICE_WIDTH", "__version__"]
