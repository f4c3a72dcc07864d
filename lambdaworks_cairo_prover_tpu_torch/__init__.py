"""PyTorch + CUDA port of the STARK prover/verifier for Cairo programs.

The JAX package ``lambdaworks_cairo_prover_tpu`` beside it is the reference:
this package keeps its module tree, names and ``(16, ...)`` limb layout, and
must give the same field values, digests and proof bytes.  Bulk arithmetic
runs through hand-written CUDA kernels (``csrc/``) on CUDA tensors and
through their plain PyTorch versions on CPU tensors.  Nothing here imports
JAX.
"""

__version__ = "0.1.0"
