"""Attention ops of the serving path and the CUDA kernels behind them."""
