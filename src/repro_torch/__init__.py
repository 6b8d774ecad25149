"""PyTorch/CUDA port of the TROOP reproduction, for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package imports nothing
of it.  Its layout mirrors the JAX one: ``configs``, ``core``, ``kernels``
(hand-written CUDA kernels under ``kernels/csrc`` with their plain PyTorch
versions), ``models``, ``serve``, ``launch`` and ``bridge`` (JAX parameter
trees, as numpy arrays, into the port's modules).  Entry points run on the
CUDA card unless the caller passes ``device="cpu"``.
"""
