"""SCAIL 3D rotary position embeddings (counterpart of scail_tpu/ops/rotary.py).

The fused DiT sequence [ref | video | pose] has three rotary regimes: ref
tokens at t = 0, video tokens at t = 1..T, and half-resolution pose tokens
whose cos/sin are taken from the full-resolution grid at a +120 W offset and
2x2 average-pooled after the trig.  Head-dim split for 128: t 44, h 42, w 42.
The tables are built on the host in float32 numpy and moved to the device.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch


class RopeTables(NamedTuple):
    """cos/sin for the fused [ref | video | pose] sequence, shape (S, head_dim)."""

    cos: torch.Tensor
    sin: torch.Tensor
    ref_len: int
    video_len: int
    pose_len: int


def rotate_half(x, interleaved: bool = True):
    """interleaved: (x0, x1) -> (-x1, x0) per adjacent pair; otherwise the
    halves are swapped: (a, b) -> (-b, a)."""
    if interleaved:
        x2 = x.unflatten(-1, (x.shape[-1] // 2, 2))
        return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).flatten(-2)
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def apply_rotary(x, cos, sin, interleaved: bool = True):
    """x: (..., S, D); cos/sin broadcast against x.  Computed in x.dtype."""
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    return x * cos + rotate_half(x, interleaved) * sin


def _axis_freqs(dim: int, theta: float) -> np.ndarray:
    """1 / theta^(2i/dim), i = 0..dim/2-1, float32."""
    return (1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim)
            ).astype(np.float32)


def _segment_angles(grid_t, grid_h, grid_w, ft, fh, fw, interleaved):
    """(T, H, W, D) angles: broadcast-concat of the per-axis outer products,
    frequencies pair-repeated (interleaved) or half-concatenated."""

    def rep(a):
        return np.repeat(a, 2, axis=-1) if interleaved else np.concatenate([a, a], axis=-1)

    at = rep(np.outer(np.asarray(grid_t, np.float32), ft))
    ah = rep(np.outer(np.asarray(grid_h, np.float32), fh))
    aw = rep(np.outer(np.asarray(grid_w, np.float32), fw))
    T, H, W = len(at), len(ah), len(aw)
    return np.concatenate([
        np.broadcast_to(at[:, None, None, :], (T, H, W, at.shape[-1])),
        np.broadcast_to(ah[None, :, None, :], (T, H, W, ah.shape[-1])),
        np.broadcast_to(aw[None, None, :, :], (T, H, W, aw.shape[-1])),
    ], axis=-1)


@lru_cache(maxsize=16)
def scail_rope_numpy(head_dim: int, rope_T: int, rope_H: int, rope_W: int, h_shift: int = 0,
                     w_shift: int = 0, pose_h_offset: int = 0, pose_w_offset: int = 120,
                     theta: float = 10000.0, interleaved: bool = True):
    """(cos, sin, ref_len, video_len, pose_len) with (S, head_dim) float32 tables."""
    if rope_H % 2 or rope_W % 2:
        raise ValueError(f"pose pooling needs an even latent grid, got {rope_H}x{rope_W}")
    dim_t = head_dim - 4 * (head_dim // 6)
    dim_h = (head_dim // 6) * 2
    ft, fh, fw = (_axis_freqs(d, theta) for d in (dim_t, dim_h, dim_h))
    grid_h = np.arange(h_shift, h_shift + rope_H, dtype=np.float64)
    grid_w = np.arange(w_shift, w_shift + rope_W, dtype=np.float64)
    frames = np.arange(1, rope_T + 1, dtype=np.float64)

    ref_ang = _segment_angles(np.zeros((1,)), grid_h, grid_w, ft, fh, fw,
                              interleaved).reshape(-1, head_dim)
    vid_ang = _segment_angles(frames, grid_h, grid_w, ft, fh, fw,
                              interleaved).reshape(-1, head_dim)
    pose_ang = _segment_angles(
        frames,
        np.arange(pose_h_offset + h_shift, pose_h_offset + h_shift + rope_H, dtype=np.float64),
        np.arange(pose_w_offset + w_shift, pose_w_offset + w_shift + rope_W, dtype=np.float64),
        ft, fh, fw, interleaved)

    def pool2x2(v):  # avg_pool2d(kernel=2, stride=2) over (H, W), after the trig
        T, H, W, D = v.shape
        return v.reshape(T, H // 2, 2, W // 2, 2, D).mean(axis=(2, 4), dtype=np.float32)

    cos = np.concatenate([np.cos(ref_ang), np.cos(vid_ang),
                          pool2x2(np.cos(pose_ang)).reshape(-1, head_dim)], axis=0)
    sin = np.concatenate([np.sin(ref_ang), np.sin(vid_ang),
                          pool2x2(np.sin(pose_ang)).reshape(-1, head_dim)], axis=0)
    pose_len = rope_T * (rope_H // 2) * (rope_W // 2)
    return (np.ascontiguousarray(cos, np.float32), np.ascontiguousarray(sin, np.float32),
            ref_ang.shape[0], vid_ang.shape[0], pose_len)


def build_scail_rope(head_dim: int, rope_T: int, rope_H: int, rope_W: int, *,
                     h_shift: int = 0, w_shift: int = 0, pose_h_offset: int = 0,
                     pose_w_offset: int = 120, theta: float = 10000.0,
                     interleaved: bool = True, device=None) -> RopeTables:
    """Fused-sequence cos/sin for [ref | video | pose] token order, as float32
    tensors on `device`.  rope_T/H/W are post-patch grid sizes."""
    cos, sin, ref_len, video_len, pose_len = scail_rope_numpy(
        head_dim, rope_T, rope_H, rope_W, h_shift, w_shift, pose_h_offset,
        pose_w_offset, float(theta), bool(interleaved))
    # copies: the cached numpy tables are shared by every caller
    return RopeTables(torch.tensor(cos, device=device), torch.tensor(sin, device=device),
                      ref_len, video_len, pose_len)
