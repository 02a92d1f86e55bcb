"""PyTorch + CUDA port of the geo-distributed LLM serving system.

The JAX package ``repro`` is the reference; this package computes the same
functions in PyTorch, with the reference's TPU (Pallas) kernels written by
hand for Hopper (``kernels/csrc``).  It imports neither ``jax`` nor
anything under ``repro``: the reference's numpy-only modules it needs
(``core``, ``configs``, ``serving/faults.py``) are copied.  Entry points
run on the card unless the caller passes ``device="cpu"``.
"""
