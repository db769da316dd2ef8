"""2D local attention for the CogView cuda2d model (counterpart of
scail_tpu/ops/local_attn_2d.py, itself a rebuild of the reference's
`localAttention` CUDA extension as gathers and einsums).

The contract, as the JAX docstring pins it:
  * feature maps are channels-first grids (N, C, H, W);
  * `f_similar(q, k, kH, kW, causal)` scores query (i, j) against the keys
    of the kH x kW window centred on its key position: (N, H, W, field);
  * the key grid may be coarser (H = r · Hk): query (i, j) centres on
    (i // r, j // r);
  * window positions outside the grid score zero and weigh a zero value
    (zero padding): they still take part in the softmax;
  * `causal` keeps the window offsets at or before the centre in raster
    order: field = (kH·kW + 1) // 2;
  * `f_weighting(v, w, kH, kW, causal)` is the adjoint gather: (N, C, H, W),
    out[i, j] = Σ_f w[i, j, f] · v[window_f(i, j)].

No Pallas kernel stands behind it in JAX, so torch gathers and einsums
carry it here too, and autograd gives the backward.  Two changes of form,
same sums: only the `field` offsets that are used are gathered, and a
coarser key grid is contracted at its own resolution (the queries viewed
as (hk, r, wk, r) blocks) instead of repeating the window patches r² times.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_field(kH: int, kW: int) -> int:
    return (kH * kW + 1) // 2


def _window_patches(x, kH: int, kW: int, count: int):
    """x (N, C, H, W) -> (N, C, count, H, W): the first `count` raster
    offsets of each position's zero-padded kH x kW window, centred at
    (kH // 2, kW // 2)."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (kW // 2, kW - 1 - kW // 2, kH // 2, kH - 1 - kH // 2))
    offs = [(ki, kj) for ki in range(kH) for kj in range(kW)][:count]
    return torch.stack([xp[:, :, ki:ki + h, kj:kj + w] for ki, kj in offs], dim=2)


def _field(kH, kW, causal):
    return causal_field(kH, kW) if causal else kH * kW


def f_similar(q, k, kH: int, kW: int, causal: bool = False):
    """q (N, C, H, W), k (N, C, Hk, Wk) with H = r · Hk -> raw scores (N, H,
    W, field) in f32 (the caller scales)."""
    n, c, h, w = q.shape
    hk, wk = k.shape[-2:]
    r = h // hk
    patches = _window_patches(k, kH, kW, _field(kH, kW, causal)).float()
    q6 = q.float().reshape(n, c, hk, r, wk, r)
    s = torch.einsum("nciajb,ncfij->niajbf", q6, patches)
    return s.reshape(n, h, w, -1)


def f_weighting(v, w, kH: int, kW: int, causal: bool = False):
    """v (N, C, Hv, Wv), w (N, H, W, field) with H = r · Hv -> (N, C, H, W)
    window-weighted sums of v, in v's dtype."""
    n, c, hv, wv = v.shape
    h, ww = w.shape[1:3]
    r = h // hv
    patches = _window_patches(v, kH, kW, _field(kH, kW, causal))
    w6 = w.to(v.dtype).reshape(n, hv, r, wv, r, -1)
    out = torch.einsum("niajbf,ncfij->nciajb", w6, patches)
    return out.reshape(n, c, h, ww)
