"""What the port's zoo models share: parameter containers named as the JAX
trees (a per-layer module for each index of the stacked (L, ...) leaves, so
`convert/from_jax.py` `lm_state_dict_from_jax` / `encoder_state_dict_from_jax`
bridge them), the explicit attention of the JAX forwards (f32 logits, the
mask, softmax in f32, the probabilities cast to v's dtype), a preallocated KV
cache, rotary helpers and the random init; for the encoders, the patch
embedding, the pre-LN ViT block and the released layouts' per-layer names.

A model is built on its device, or on the meta device and then drawn one
parameter at a time on the device by `init_weights_` (N(0, 0.02), norm
scales one, biases zero, cast to the dtype once drawn): a 7B model never
passes through host memory.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.common import container, linear, parameter, random_init_
from scail_tpu_torch.ops.norms import layer_norm
from scail_tpu_torch.ops.rotary import apply_rotary


def norm(d: int, bias: bool = False, device=None) -> nn.Module:
    """{scale (d,) ones[, bias (d,) zeros]}."""
    kids = dict(scale=parameter(d, fill=1.0, device=device))
    if bias:
        kids["bias"] = parameter(d, fill=0.0, device=device)
    return container(**kids)


def lin(d_in: int, d_out: int, bias: bool = False, device=None) -> nn.Linear:
    return linear(d_in, d_out, bias=bias, device=device)


def experts(E: int, d_out: int, d_in: int, device=None) -> nn.Module:
    """{weight (E, d_out, d_in)}: expert e's linear is weight[e]."""
    return container(weight=parameter(E, d_out, d_in, device=device))


def table(n: int, d: int, device=None) -> nn.Parameter:
    return parameter(n, d, device=device)


class LM(nn.Module):
    """Base of the zoo's models: the random init."""

    def init_weights_(self, generator: torch.Generator, *, device=None, dtype=None):
        random_init_(self, generator, 0.02, device=device, dtype=dtype)
        return self


def attend(q, k, v, *, valid=None, bias=None, scale: float = 1.0, fill: float = -1e30):
    """softmax(q kᵀ · scale) v over (b, s, n, hd) q and (b, t, n_kv, hd) k, v
    (k and v repeated over the query groups), logits in f32.  `valid` (…, s,
    t) bool masks with `fill`; `bias` (…, s, t) is added.  Returns (b, s,
    n·hd) in v's dtype."""
    n, nkv = q.shape[2], k.shape[2]
    if nkv != n:
        k = k.repeat_interleave(n // nkv, dim=2)
        v = v.repeat_interleave(n // nkv, dim=2)
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    if scale != 1.0:
        logits = logits * scale
    if valid is not None:
        logits = logits.masked_fill(~valid, fill)
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bnqk,bknd->bqnd", probs, v)
    return o.reshape(*o.shape[:2], -1)


class KVCache:
    """k, v (L, b, max_len, n_kv, hd) and the filled length: the JAX caches'
    layout, filled in place."""

    def __init__(self, num_layers: int, batch: int, max_len: int, n_kv: int, head_dim: int,
                 *, device=None, dtype=torch.float32):
        shape = (num_layers, batch, max_len, n_kv, head_dim)
        self.k = torch.zeros(shape, device=device, dtype=dtype)
        self.v = torch.zeros(shape, device=device, dtype=dtype)
        self.length = 0

    def update(self, li: int, k, v):
        """Write layer li's new rows at `length`; returns its filled k, v."""
        s = k.shape[1]
        if self.length + s > self.k.shape[2]:
            raise ValueError(f"the cache holds {self.k.shape[2]} positions, "
                             f"{self.length + s} asked")
        self.k[li, :, self.length:self.length + s] = k
        self.v[li, :, self.length:self.length + s] = v
        return self.k[li, :, :self.length + s], self.v[li, :, :self.length + s]


def kv_attend(q, k, v, cache: Optional[KVCache], li: int, positions, *, scale, prefix=None):
    """Causal attention of the new rows, through the cache when one is given,
    with an optional learned KV prefix (n_kv, P, hd) pair always visible."""
    if cache is not None:
        k, v = cache.update(li, k, v)
    valid = torch.arange(k.shape[1], device=q.device)[None] <= positions[:, None]
    if prefix is not None:
        b = q.shape[0]
        pk, pv = (p.transpose(0, 1)[None].expand(b, -1, -1, -1).to(k.dtype) for p in prefix)
        k, v = torch.cat([k, pk], dim=1), torch.cat([v, pv], dim=1)
        valid = torch.cat([valid, valid.new_ones(valid.shape[0], pk.shape[1])], dim=1)
    return attend(q, k, v, valid=valid, scale=scale)


def inv_freq(rot_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device)
                            / rot_dim))


def pick(sd: Dict, names: Dict[str, str]) -> Dict[str, torch.Tensor]:
    """{port name: sd[source name]} as tensors, in their stored dtype."""
    return {dst: torch.as_tensor(sd[src]) for dst, src in names.items()}


def stacked(sd: Dict, L: int, names: Dict[str, str], fmt: str) -> Dict[str, torch.Tensor]:
    """Per-layer names: {f'layers.{i}.{dst}': sd[fmt.format(i) + src]}; a
    source that starts with '/' is taken as a whole format."""
    out = {}
    for i in range(L):
        for dst, src in names.items():
            key = src[1:].format(i) if src.startswith("/") else fmt.format(i) + src
            out[f"layers.{i}.{dst}"] = torch.as_tensor(sd[key])
    return out


def interleaved_rope(x, positions, rot_dim: int, theta: float):
    """The first rot_dim dims of each head rotated pairwise (interleaved),
    angles positions · theta^(-2j/rot_dim); the rest pass through.  x (b,
    s, n, hd); positions (s,) or (b, s)."""
    ang = positions.float()[..., None] * inv_freq(rot_dim, theta, x.device)
    cos = ang.cos().repeat_interleave(2, dim=-1).unsqueeze(-2)
    sin = ang.sin().repeat_interleave(2, dim=-1).unsqueeze(-2)
    x_rot = apply_rotary(x[..., :rot_dim], cos, sin, interleaved=True)
    return torch.cat([x_rot, x[..., rot_dim:]], dim=-1)


def neox_rope(x, ids, rot_dim: int):
    """Non-interleaved (GPT-NeoX) rotary of x's last axis (rot_dim wide),
    angles indexed per token: ids (b, s), base 10000."""
    ang = ids.float()[..., None] * inv_freq(rot_dim, 10000.0, x.device)
    emb = torch.cat([ang, ang], dim=-1)[:, :, None]
    a, b = x.chunk(2, dim=-1)
    return x * emb.cos().to(x.dtype) + torch.cat([-b, a], dim=-1) * emb.sin().to(x.dtype)


def mask_bias(mask):
    """A (b, s, s) 0/1 mask -> the additive (b, 1, s, s) bias: 0 or -10000."""
    if mask is None:
        return None
    zero = torch.zeros((), device=mask.device)
    return torch.where(mask[:, None] > 0, zero, -10000.0)


# ---------------------------------------------------------------------------
# the encoder zoo's shared pieces (vit, mae, yolos, cait, eva2, evaclip)
# ---------------------------------------------------------------------------
def patch_conv(c_in: int, d: int, p: int, device=None) -> nn.Module:
    """{weight (d, c_in, p, p), bias (d,)}: the patch embedding, stride p
    (the JAX tree's HWIO kernel, transposed by the bridge)."""
    return container(weight=parameter(d, c_in, p, p, device=device),
                     bias=parameter(d, fill=0.0, device=device))


def patchify(conv, images, stride: int):
    """(b, C, H, W) images -> (b, (H/p)(W/p), d) patch tokens in the
    parameters' dtype: the convolution without its bias, row-major over the
    grid, then the bias (as the JAX NHWC conv, reshape and add)."""
    x = F.conv2d(images.to(conv.weight.dtype), conv.weight, stride=stride)
    return x.flatten(2).transpose(1, 2) + conv.bias


def dense(x, layer):
    """x @ layerᵀ (+ bias) through a {weight (out, in)[, bias]} holder."""
    return F.linear(x, layer.weight, getattr(layer, "bias", None))


class ViTLayer(nn.Module):
    """Pre-LN ViT block parameters: ln1, q, k, v, proj, ln2, fc1, fc2."""

    def __init__(self, d: int, f: int, device=None):
        super().__init__()
        self.ln1, self.ln2 = norm(d, True, device), norm(d, True, device)
        self.q, self.k, self.v = (lin(d, d, True, device) for _ in range(3))
        self.proj = lin(d, d, True, device)
        self.fc1, self.fc2 = lin(d, f, True, device), lin(f, d, True, device)


def vit_block(x, p: ViTLayer, num_heads: int, eps: float):
    """Pre-LN block: x + proj(attn(LN(x))), then x + fc2(gelu(fc1(LN(x))))
    with the exact GELU (the JAX vit / mae / yolos block)."""
    hd = x.shape[-1] // num_heads
    y = layer_norm(x, p.ln1.scale, p.ln1.bias, eps=eps)
    q, k, v = (dense(y, w).unflatten(-1, (num_heads, hd)) for w in (p.q, p.k, p.v))
    x = x + dense(attend(q, k, v, scale=hd ** -0.5), p.proj)
    y = layer_norm(x, p.ln2.scale, p.ln2.bias, eps=eps)
    return x + dense(F.gelu(dense(y, p.fc1)), p.fc2)


def hf_vit_layers(sd: Dict, L: int, fmt: str) -> Dict[str, torch.Tensor]:
    """HF ViT-family layer names (ViT, ViTMAE, YOLOS) -> `ViTLayer` names."""
    return sat_linears(sd, L, {
        "ln1": "layernorm_before", "ln2": "layernorm_after", "q": "attention.attention.query",
        "k": "attention.attention.key", "v": "attention.attention.value",
        "proj": "attention.output.dense", "fc1": "intermediate.dense", "fc2": "output.dense"},
        fmt, norms=("ln1", "ln2"))


def sat_linears(sd: Dict, L: int, names: Dict[str, str], fmt: str,
                norms=()) -> Dict[str, torch.Tensor]:
    """Per-layer linears and LayerNorms of a released layout (SAT or HF):
    {dst: src} with .weight / .bias each; a dst in `norms` takes its weight
    as `scale`."""
    return stacked(sd, L, {f"{dst}.{'scale' if dst in norms and leaf == 'weight' else leaf}":
                           f"{src}.{leaf}" for dst, src in names.items()
                           for leaf in ("weight", "bias")}, fmt)
