"""Hand-written CUDA kernels for Hopper and small shared ops."""
