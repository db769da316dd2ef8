"""Separable bicubic/bilinear resize with torch-compatible numerics
(counterpart of scail_tpu/ops/resize.py, scail_tpu/native/resize_kernels.py
and the host resize of scail_tpu/native).

The (out, in) weight matrices are built in numpy here, the port's own copy of
the JAX package's builders, and applied as two matrix products: with torch on
a tensor's device (`resize_bicubic`, `resize_bilinear`), or with numpy on the
host for the data loader (`resize_bicubic_host`, `resize_bilinear_host`).
Both are exact where F.interpolate's kernels differ (antialias, border taps).

torch's bicubic uses the Keys cubic with a = -0.75 (antialias=False, taps
clamped to the border) and the PIL-compatible a = -0.5 kernel scaled by the
downscale factor (antialias=True, out-of-range taps dropped and the rest
renormalised).  SCAIL uses the first for CLIP preprocessing and the second
for the video resize and crop.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    x = np.abs(x)
    x2, x3 = x * x, x * x * x
    return np.where(x <= 1, (a + 2) * x3 - (a + 3) * x2 + 1,
                    np.where(x < 2, a * x3 - 5 * a * x2 + 8 * a * x - 4 * a, 0.0))


@lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int, antialias: bool) -> np.ndarray:
    """Row-stochastic (out_size, in_size) float32 bicubic weight matrix."""
    scale = in_size / out_size
    a = -0.5 if antialias else -0.75
    ks = max(scale, 1.0) if antialias else 1.0
    support = 2.0 * ks
    out = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale - 0.5
        idx = np.arange(int(np.floor(center - support)) + 1, int(np.ceil(center + support)) + 1)
        w = _cubic((idx - center) / ks, a)
        if antialias:
            m = (idx >= 0) & (idx < in_size)
            out[i, idx[m]] = w[m] / w[m].sum()
        else:
            np.add.at(out[i], np.clip(idx, 0, in_size - 1), w / w.sum())
    return out.astype(np.float32)


@lru_cache(maxsize=256)
def lin_matrix(in_size: int, out_size: int, antialias: bool, align_corners: bool) -> np.ndarray:
    """torch-compatible (out_size, in_size) float32 bilinear weight matrix."""
    scale = in_size / out_size
    ks = max(scale, 1.0) if antialias else 1.0
    out = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        if align_corners and out_size > 1:
            center = i * (in_size - 1) / (out_size - 1)
        else:
            center = (i + 0.5) * scale - 0.5
        idx = np.arange(int(np.floor(center - ks)) + 1, int(np.ceil(center + ks)) + 1)
        w = np.maximum(0.0, 1.0 - np.abs((idx - center) / ks))
        if w.sum() > 0:
            w = w / w.sum()
        np.add.at(out[i], np.clip(idx, 0, in_size - 1), w)
    return out.astype(np.float32)


def _matrices(kind, in_h, in_w, out_h, out_w, antialias, align_corners):
    def one(n_in, n_out):
        if n_in == n_out:
            return None
        if kind == "bicubic":
            return resize_matrix(n_in, n_out, antialias)
        return lin_matrix(n_in, n_out, antialias, align_corners)

    return one(in_h, out_h), one(in_w, out_w)


def _apply(x, mat_h, mat_w):
    xf = x.float()
    if mat_h is not None:
        xf = torch.einsum("oh,...hw->...ow", torch.from_numpy(mat_h).to(x.device), xf)
    if mat_w is not None:
        xf = torch.einsum("ow,...hw->...ho", torch.from_numpy(mat_w).to(x.device), xf)
    return xf.to(x.dtype)


def resize_bicubic(x, out_h: int, out_w: int, *, antialias: bool = False):
    """x (..., H, W) tensor -> (..., out_h, out_w), computed in f32."""
    return _apply(x, *_matrices("bicubic", *x.shape[-2:], out_h, out_w, antialias, False))


def resize_bilinear(x, out_h: int, out_w: int, *, antialias: bool = False,
                    align_corners: bool = False):
    """torch-compatible bilinear on a tensor (the 0.5x pose downsample)."""
    return _apply(x, *_matrices("bilinear", *x.shape[-2:], out_h, out_w, antialias,
                                align_corners))


def _apply_host(x, mat_h, mat_w) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32)
    if mat_h is not None:
        x = np.matmul(mat_h, x)
    if mat_w is not None:
        x = np.matmul(x, mat_w.T)
    return np.ascontiguousarray(x, dtype=np.float32)


def resize_bicubic_host(x: np.ndarray, out_h: int, out_w: int, *,
                        antialias: bool = False) -> np.ndarray:
    """(..., H, W) numpy -> (..., out_h, out_w) float32 on the host."""
    return _apply_host(x, *_matrices("bicubic", *x.shape[-2:], out_h, out_w, antialias, False))


def resize_bilinear_host(x: np.ndarray, out_h: int, out_w: int, *, antialias: bool = False,
                         align_corners: bool = False) -> np.ndarray:
    return _apply_host(x, *_matrices("bilinear", *x.shape[-2:], out_h, out_w, antialias,
                                     align_corners))


def center_crop(x: np.ndarray, top: int, left: int, oh: int, ow: int) -> np.ndarray:
    """(T, C, H, W) crop to float32 (T, C, oh, ow)."""
    return np.ascontiguousarray(x[:, :, top:top + oh, left:left + ow], dtype=np.float32)
