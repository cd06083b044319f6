"""gstx_torch: the PyTorch/CUDA port of gstx for NVIDIA Hopper.

Mirrors the layout of the JAX package ``gstx`` (``core``, ``kernels``,
``models``, ``ops``, ``decode``) and imports nothing of it: where it needs a
framework-free piece (configs, special token ids, the checkpoint converter)
it keeps its own copy.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
