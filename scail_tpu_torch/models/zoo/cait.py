"""CaiT, Class-Attention in Image Transformers (counterpart of
scail_tpu/models/zoo/cait.py): ViT blocks with talking-heads attention (a
linear over the heads on the f32 scores before the softmax, `proj_l`, and on
the f32 probabilities after it, `proj_w`; cast to v's dtype only before P·V)
and LayerScale residuals; then class-attention stages where the class token
queries [cls | patch tokens]; a final LayerNorm and a linear classifier.

State-dict names mirror the JAX tree (`patch_embed`, `enc_cls`, `enc_pos`,
`enc_layers.{i}.*`, `dec_cls`, `dec_layers.{i}.*`, `dec_final_ln`,
`classifier`); `cait_from_sat` reads the SAT EncoderDecoderModel names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.common import parameter
from scail_tpu_torch.models.zoo.common import (LM, dense, lin, norm, patch_conv, patchify,
                                               pick, sat_linears, stacked, table)
from scail_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class CaiTConfig:
    image_size: int = 224
    patch_size: int = 16
    in_channels: int = 3
    dim: int = 192
    num_heads: int = 4
    num_layers: int = 24
    dec_num_layers: int = 2
    inner_hidden_size: int = 768
    num_classes: int = 1000
    eps: float = 1e-6

    @property
    def head_dim(self):
        return self.dim // self.num_heads


class CaiTEncLayer(nn.Module):
    def __init__(self, cfg: CaiTConfig, device=None):
        super().__init__()
        d, f, n = cfg.dim, cfg.inner_hidden_size, cfg.num_heads
        self.ln1, self.ln2 = norm(d, True, device), norm(d, True, device)
        self.qkv, self.dense = lin(d, 3 * d, True, device), lin(d, d, True, device)
        self.proj_l, self.proj_w = lin(n, n, True, device), lin(n, n, True, device)
        self.fc1, self.fc2 = lin(d, f, True, device), lin(f, d, True, device)
        self.gamma1, self.gamma2 = parameter(d, device=device), parameter(d, device=device)


class CaiTDecLayer(nn.Module):
    def __init__(self, cfg: CaiTConfig, device=None):
        super().__init__()
        d, f = cfg.dim, cfg.inner_hidden_size
        self.ln1, self.ln2 = norm(d, True, device), norm(d, True, device)
        self.q, self.kv = lin(d, d, True, device), lin(d, 2 * d, True, device)
        self.dense = lin(d, d, True, device)
        self.fc1, self.fc2 = lin(d, f, True, device), lin(f, d, True, device)
        self.gamma1, self.gamma2 = parameter(d, device=device), parameter(d, device=device)


def _head_mix(s, layer):
    """A linear over the heads axis of f32 (b, n, q, k) scores."""
    return (torch.einsum("bnqk,mn->bmqk", s, layer.weight.float())
            + layer.bias.float()[None, :, None, None])


def _talking_heads(y, p, n: int, hd: int):
    b, s, d = y.shape
    q, k, v = (t.unflatten(-1, (n, hd)) for t in dense(y, p.qkv).chunk(3, dim=-1))
    scores = torch.einsum("bqnd,bknd->bnqk", (q * hd ** -0.5).float(), k.float())
    probs = _head_mix(torch.softmax(_head_mix(scores, p.proj_l), dim=-1), p.proj_w)
    o = torch.einsum("bnqk,bknd->bqnd", probs.to(v.dtype), v).reshape(b, s, d)
    return dense(o, p.dense)


class CaiT(LM):
    def __init__(self, cfg: CaiTConfig, device="cuda"):
        super().__init__()
        self.config = cfg
        d = cfg.dim
        self.patch_embed = patch_conv(cfg.in_channels, d, cfg.patch_size, device)
        self.enc_cls = table(1, d, device)
        self.enc_pos = table((cfg.image_size // cfg.patch_size) ** 2 + 1, d, device)
        self.enc_layers = nn.ModuleList(CaiTEncLayer(cfg, device) for _ in range(cfg.num_layers))
        self.dec_cls = table(1, d, device)
        self.dec_layers = nn.ModuleList(CaiTDecLayer(cfg, device)
                                        for _ in range(cfg.dec_num_layers))
        self.dec_final_ln = norm(d, True, device)
        self.classifier = lin(d, cfg.num_classes, True, device)

    def forward(self, images):
        """images (b, C, H, W) -> class logits (b, num_classes)."""
        cfg = self.config
        n, hd, d = cfg.num_heads, cfg.head_dim, cfg.dim
        x = patchify(self.patch_embed, images, cfg.patch_size)
        b = x.shape[0]
        x = torch.cat([self.enc_cls[None].expand(b, 1, d), x], dim=1) + self.enc_pos[None]
        for p in self.enc_layers:
            y = layer_norm(x, p.ln1.scale, p.ln1.bias, eps=cfg.eps)
            x = x + p.gamma1 * _talking_heads(y, p, n, hd)
            y = layer_norm(x, p.ln2.scale, p.ln2.bias, eps=cfg.eps)
            x = x + p.gamma2 * dense(F.gelu(dense(y, p.fc1)), p.fc2)
        h = self.dec_cls[None].expand(b, 1, d)
        for p in self.dec_layers:
            y = layer_norm(torch.cat([h, x], dim=1), p.ln1.scale, p.ln1.bias, eps=cfg.eps)
            q = dense(y[:, :1], p.q).unflatten(-1, (n, hd))
            k, v = (t.unflatten(-1, (n, hd)) for t in dense(y, p.kv).chunk(2, dim=-1))
            s = torch.einsum("bqnd,bknd->bnqk", (q * hd ** -0.5).float(), k.float())
            o = torch.einsum("bnqk,bknd->bqnd", torch.softmax(s, dim=-1).to(v.dtype), v)
            h = h + p.gamma1 * dense(o.reshape(b, 1, d), p.dense)
            y = layer_norm(h, p.ln2.scale, p.ln2.bias, eps=cfg.eps)
            h = h + p.gamma2 * dense(F.gelu(dense(y, p.fc1)), p.fc2)
        h = layer_norm(h, self.dec_final_ln.scale, self.dec_final_ln.bias, eps=cfg.eps)
        return dense(h[:, 0], self.classifier)


def cait_from_sat(sd: Dict, cfg: CaiTConfig) -> Dict[str, torch.Tensor]:
    """The reference CaiT (SAT EncoderDecoderModel) state dict ->
    `CaiT.state_dict()` names."""
    enc, dec = "encoder.transformer.", "decoder.transformer."
    out = pick(sd, {"patch_embed.weight": "encoder.mixins.patch_embedding.proj.weight",
                    "patch_embed.bias": "encoder.mixins.patch_embedding.proj.bias",
                    "enc_pos": enc + "position_embeddings.weight",
                    "dec_final_ln.scale": dec + "final_layernorm.weight",
                    "dec_final_ln.bias": dec + "final_layernorm.bias",
                    "classifier.weight": "decoder.mixins.cls.classifier.weight",
                    "classifier.bias": "decoder.mixins.cls.classifier.bias"})
    out["enc_cls"] = torch.as_tensor(sd[enc + "word_embeddings.weight"])[:1]
    out["dec_cls"] = torch.as_tensor(sd[dec + "word_embeddings.weight"])[:1]
    Le, Ld = cfg.num_layers, cfg.dec_num_layers
    layers = enc + "layers.{}."
    out.update({f"enc_{k}": v for k, v in sat_linears(sd, Le, {
        "ln1": "input_layernorm", "qkv": "attention.query_key_value",
        "dense": "attention.dense", "proj_l": "/encoder.mixins.attn.proj_l.{}",
        "proj_w": "/encoder.mixins.attn.proj_w.{}", "ln2": "post_attention_layernorm",
        "fc1": "mlp.dense_h_to_4h", "fc2": "mlp.dense_4h_to_h"}, layers,
        norms=("ln1", "ln2")).items()})
    out.update({f"enc_{k}": v for k, v in stacked(sd, Le, {
        "gamma1": "/encoder.mixins.enc_forward.gamma_1.{}",
        "gamma2": "/encoder.mixins.enc_forward.gamma_2.{}"}, layers).items()})
    layers = dec + "layers.{}."
    out.update({f"dec_{k}": v for k, v in sat_linears(sd, Ld, {
        "ln1": "input_layernorm", "q": "cross_attention.query", "kv": "cross_attention.key_value",
        "dense": "cross_attention.dense", "ln2": "post_cross_attention_layernorm",
        "fc1": "mlp.dense_h_to_4h", "fc2": "mlp.dense_4h_to_h"}, layers,
        norms=("ln1", "ln2")).items()})
    out.update({f"dec_{k}": v for k, v in stacked(sd, Ld, {
        "gamma1": "/decoder.mixins.dec_forward.gamma_1.{}",
        "gamma2": "/decoder.mixins.dec_forward.gamma_2.{}"}, layers).items()})
    return out
