"""Operators: attention, the fused residual/LayerNorm and FFN forwards, and the CUDA kernels (ops/cuda)."""
