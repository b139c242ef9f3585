"""Bit-plane ops on torch tensors and the hand-written CUDA kernels."""
