"""Quality evals on PyTorch (counterpart of scail_tpu/evals): FVD on I3D,
FID on InceptionV3, CLIP score, LPIPS, the LAION aesthetic head and HPS.

The networks run on the card by default; a CUDA device without CUDA raises.
Their convolutions and matmuls run in full f32 (`full_f32`), as the JAX
functions compute, whatever the caller's TF32 setting.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuBLAS matmuls and cuDNN convolutions inside the block
    (PyTorch lets cuDNN use TF32 by default, which moves an f32 network's
    output by ~1e-3 relative); the caller's settings come back afterwards."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
