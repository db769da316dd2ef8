"""Invisible watermark (the port's numpy copy of
scail_tpu/inference/watermark.py; reference: sgm/inference/helpers.py:16-60).

The reference embeds a 48-bit mark via the `imwatermark` package's
dwtDct method (not a dependency of this project).  This is a self-contained
functional equivalent of that scheme — quantization-index modulation of
the DC coefficient of 4x4 DCT blocks over the one-level Haar LL band of
the U/V chroma channels — with the DECODER the reference never ships,
so the roundtrip is testable: embed is imperceptible (>40 dB PSNR) and
`decode_watermark` recovers the bits by per-bit majority vote across
blocks, surviving mild noise.

Same payload contract as the reference: WATERMARK_MESSAGE spells
"StableDiffusionV1" through its bit pattern (helpers.py:52-58); images
are floats in [0, 1], channels-last (b, h, w, 3) or (n, b, h, w, 3).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

# helpers.py:52-58 (the reference's exact constant)
WATERMARK_MESSAGE = 0b101100111110110010010000011110111011000110011110
WATERMARK_BITS = [int(bit) for bit in bin(WATERMARK_MESSAGE)[2:]]

# BT.601 full-range RGB<->YUV (what cv2.cvtColor uses in imwatermark)
_RGB2YUV = np.array([[0.299, 0.587, 0.114],
                     [-0.14713, -0.28886, 0.436],
                     [0.615, -0.51499, -0.10001]], np.float64)
_YUV2RGB = np.linalg.inv(_RGB2YUV)

_BLOCK = 4
_DELTA = 36.0 / 255.0  # imwatermark's scale 36 on the 0-255 range


def _dct_mat(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0] *= np.sqrt(0.5)
    return m


_D4 = _dct_mat(_BLOCK)


def _haar2(x):
    """One-level 2D Haar split; returns (LL, (LH, HL, HH)) on even-cropped
    input."""
    h, w = x.shape[0] & ~1, x.shape[1] & ~1
    x = x[:h, :w]
    a, b = x[0::2, 0::2], x[0::2, 1::2]
    c, d = x[1::2, 0::2], x[1::2, 1::2]
    return ((a + b + c + d) / 2.0,
            ((a - b + c - d) / 2.0, (a + b - c - d) / 2.0,
             (a - b - c + d) / 2.0))


def _ihaar2(ll, bands):
    lh, hl, hh = bands
    a = (ll + lh + hl + hh) / 2.0
    b = (ll - lh + hl - hh) / 2.0
    c = (ll + lh - hl - hh) / 2.0
    d = (ll - lh - hl + hh) / 2.0
    out = np.empty((2 * ll.shape[0], 2 * ll.shape[1]), ll.dtype)
    out[0::2, 0::2], out[0::2, 1::2] = a, b
    out[1::2, 0::2], out[1::2, 1::2] = c, d
    return out


def _blocks(ll):
    bh, bw = ll.shape[0] // _BLOCK, ll.shape[1] // _BLOCK
    return ll[: bh * _BLOCK, : bw * _BLOCK].reshape(
        bh, _BLOCK, bw, _BLOCK).transpose(0, 2, 1, 3), bh, bw


def _embed_channel(ch: np.ndarray, bits: Sequence[int]) -> np.ndarray:
    ll, bands = _haar2(ch)
    blk, bh, bw = _blocks(ll)
    dct = _D4 @ blk @ _D4.T
    dc = dct[..., 0, 0]
    idx = (np.arange(bh * bw) % len(bits)).reshape(bh, bw)
    bit = np.asarray(bits, np.float64)[idx]
    # QIM: snap DC to the lattice 2*DELTA*k + DELTA*(bit + 0.5)
    q = np.floor(dc / (2 * _DELTA))
    cand = [2 * _DELTA * (q + o) + _DELTA * (bit / 2.0 + 0.25)
            for o in (-1.0, 0.0, 1.0)]
    cand = np.stack(cand)
    dc_new = cand[np.argmin(np.abs(cand - dc), axis=0),
                  *np.indices(dc.shape)]
    dct[..., 0, 0] = dc_new
    blk_new = _D4.T @ dct @ _D4
    ll2 = ll.copy()
    ll2[: bh * _BLOCK, : bw * _BLOCK] = blk_new.transpose(
        0, 2, 1, 3).reshape(bh * _BLOCK, bw * _BLOCK)
    out = ch.copy()
    rec = _ihaar2(ll2, bands)
    out[: rec.shape[0], : rec.shape[1]] = rec
    return out


def _decode_channel(ch: np.ndarray, n_bits: int):
    ll, _ = _haar2(ch)
    blk, bh, bw = _blocks(ll)
    dc = (_D4 @ blk @ _D4.T)[..., 0, 0]
    frac = np.mod(dc, 2 * _DELTA) / _DELTA  # in [0,2): bit0 ~ 0.25, bit1 ~ 0.75... mod 1
    bit_votes = (np.mod(frac, 1.0) > 0.5).astype(np.int64).reshape(-1)
    idx = np.arange(bh * bw) % n_bits
    ones = np.bincount(idx, weights=bit_votes, minlength=n_bits)
    total = np.bincount(idx, minlength=n_bits)
    return ones, total


class WatermarkEmbedder:
    """(helpers.py:16-50): callable filter over sampled images."""

    def __init__(self, watermark: Sequence[int] = WATERMARK_BITS):
        self.watermark = list(watermark)
        self.num_bits = len(self.watermark)

    def __call__(self, image):
        """image (b, h, w, 3) or (n, b, h, w, 3) floats in [0, 1]."""
        x = np.asarray(image, np.float64)
        squeeze = x.ndim == 4
        if squeeze:
            x = x[None]
        n, b, h, w, _ = x.shape
        flat = x.reshape(n * b, h, w, 3)
        out = np.empty_like(flat)
        for k in range(flat.shape[0]):
            yuv = flat[k] @ _RGB2YUV.T
            for c in (1, 2):  # chroma only, like imwatermark's [0,36,36]
                yuv[:, :, c] = _embed_channel(yuv[:, :, c], self.watermark)
            out[k] = yuv @ _YUV2RGB.T
        out = np.clip(out, 0.0, 1.0).reshape(x.shape)
        if squeeze:
            out = out[0]
        return out.astype(np.asarray(image).dtype)


def decode_watermark(image, n_bits: int = len(WATERMARK_BITS)) -> List[int]:
    """Majority-vote blind decode of one image (h, w, 3) or (b, h, w, 3)."""
    x = np.asarray(image, np.float64)
    if x.ndim == 3:
        x = x[None]
    ones = np.zeros(n_bits)
    total = np.zeros(n_bits)
    for img in x:
        yuv = img @ _RGB2YUV.T
        for c in (1, 2):
            o, t = _decode_channel(yuv[:, :, c], n_bits)
            ones += o
            total += t
    return (ones * 2 > total).astype(int).tolist()


# the ready-made filter the reference exposes (helpers.py:59-60)
embed_watermark = WatermarkEmbedder(WATERMARK_BITS)
