"""Ops of the port: the fused loss with its CUDA kernels, and resizing."""
