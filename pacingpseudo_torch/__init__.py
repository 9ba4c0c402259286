"""PyTorch/CUDA port of pacingpseudo_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX package, which stays the reference:
nothing here imports JAX or ``pacingpseudo_tpu``.  Tensors are NCHW.
Entry points run on ``device="cuda"`` unless the caller passes ``"cpu"``.
"""
