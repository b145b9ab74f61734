"""Wrappers of the hand-written CUDA kernels (sources in ``ops/csrc``),
each beside its plain PyTorch version."""
