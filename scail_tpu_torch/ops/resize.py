"""Separable bicubic/bilinear resize with torch-compatible numerics
(counterpart of scail_tpu/ops/resize.py).

The (out, in) weight matrices come from the shared numpy functions in
scail_tpu/native/resize_kernels.py and are applied with two einsums, which
is exact where F.interpolate's kernels differ (antialias, border taps).
"""

from __future__ import annotations

import torch

from scail_tpu.native.resize_kernels import lin_matrix, resize_matrix


def _apply(x, mat_h, mat_w):
    xf = x.float()
    if mat_h is not None:
        xf = torch.einsum("oh,...hw->...ow", torch.from_numpy(mat_h).to(x.device), xf)
    if mat_w is not None:
        xf = torch.einsum("ow,...hw->...ho", torch.from_numpy(mat_w).to(x.device), xf)
    return xf.to(x.dtype)


def resize_bicubic(x, out_h: int, out_w: int, *, antialias: bool = False):
    """x (..., H, W) -> (..., out_h, out_w), computed in f32."""
    in_h, in_w = x.shape[-2:]
    return _apply(x, resize_matrix(in_h, out_h, antialias) if in_h != out_h else None,
                  resize_matrix(in_w, out_w, antialias) if in_w != out_w else None)


def resize_bilinear(x, out_h: int, out_w: int, *, antialias: bool = False,
                    align_corners: bool = False):
    """torch-compatible bilinear (the 0.5x pose downsample)."""
    in_h, in_w = x.shape[-2:]
    return _apply(
        x,
        lin_matrix(in_h, out_h, antialias, align_corners) if in_h != out_h else None,
        lin_matrix(in_w, out_w, antialias, align_corners) if in_w != out_w else None)
