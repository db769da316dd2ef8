"""SCAIL on PyTorch + CUDA: the port of the `scail_tpu` pose-to-video
sampling path to one NVIDIA H100.

The JAX package `scail_tpu` stays the reference; this package keeps its
module names (ops, models, diffusion, engine, cli) so each module's
counterpart is easy to find.  Plain tensor code is PyTorch; the hot-path
attention kernels are hand-written CUDA C++ for sm_90a (csrc/), built on
first use.  This package never imports jax.
"""

__version__ = "0.1.0"
