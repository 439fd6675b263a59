"""Tensor ops and the CUDA kernels' wrappers."""
