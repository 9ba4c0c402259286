"""Ops of the port: the fused loss and the warp table with their CUDA kernels,
the warp's resampling primitives, and resizing."""
