"""Wan2.1 3D causal VAE on PyTorch (counterpart of scail_tpu/models/wan_vae.py).

dim 96, z 16, dim_mult [1, 2, 4, 4], 2 res blocks, temporal downsample
[False, True, True]: 4x temporal and 8x8 spatial compression.  Two exactly
equivalent modes, as in the JAX package:

  * full-sequence: every causal conv pads time on the left by 2; the two
    stateful resample layers use their closed forms;
  * streamed: a loop over temporal chunks with per-conv 2-frame caches --
    encode runs input chunks [1, 4, 4, ...], decode one latent frame at a
    time -- for clips whose full-resolution activations do not fit.

Layout inside is channels-first (b, c, t, h, w) for F.conv3d/conv2d; the
public `vae_encode`/`vae_decode` keep the JAX package's (b, t, c, h, w).
Convolutions are plain torch (cuDNN), as the JAX package leaves them to XLA.
State-dict paths mirror the JAX parameter tree and the reference's module
paths; WanVAE(vae_pth=...) loads Wan2.1_VAE.pth (convert/wan_vae_ckpt.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.convert.torch_ckpt import load_mapped_, load_torch_state_dict
from scail_tpu_torch.convert.wan_vae_ckpt import wan_vae_source
from scail_tpu_torch.models.common import container, random_init_
from scail_tpu_torch.ops.norms import channel_rms_norm
from scail_tpu_torch.utils.registry import register

CACHE_T = 2

WAN_LATENT_MEAN = np.asarray([
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
], np.float32)
WAN_LATENT_STD = np.asarray([
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
], np.float32)


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self):
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    @property
    def enc_dims(self):
        return [self.dim * u for u in (1,) + tuple(self.dim_mult)]

    @property
    def dec_dims(self):
        dm = tuple(self.dim_mult)
        return [self.dim * u for u in (dm[-1],) + dm[::-1]]

    @property
    def latent_mean(self):
        return WAN_LATENT_MEAN if self.z_dim == 16 else np.zeros((self.z_dim,), np.float32)

    @property
    def latent_std(self):
        return WAN_LATENT_STD if self.z_dim == 16 else np.ones((self.z_dim,), np.float32)


# ---------------------------------------------------------------------------
# Parameter tree: nested dicts of shapes -> ModuleDicts / leaf containers
# ---------------------------------------------------------------------------
def _param_tree(cfg: WanVAEConfig) -> Dict:
    def conv3(cin, cout, k=(3, 3, 3)):
        return {"weight": (cout, cin, *k), "bias": (cout,)}

    def conv2(cin, cout, k=(3, 3)):
        return {"weight": (cout, cin, *k), "bias": (cout,)}

    def rms(c):
        return {"gamma": (c,)}

    def resblock(cin, cout):
        p = {"residual": {"0": rms(cin), "2": conv3(cin, cout), "3": rms(cout),
                          "6": conv3(cout, cout)}}
        if cin != cout:
            p["shortcut"] = conv3(cin, cout, (1, 1, 1))
        return p

    def attn(c):
        return {"norm": rms(c), "to_qkv": conv2(c, 3 * c, (1, 1)), "proj": conv2(c, c, (1, 1))}

    z2 = cfg.z_dim * 2
    enc_dims = cfg.enc_dims
    enc = {"conv1": conv3(3, enc_dims[0]), "downsamples": {}}
    site = 0
    for i, (cin, cout) in enumerate(zip(enc_dims[:-1], enc_dims[1:])):
        for r in range(cfg.num_res_blocks):
            enc["downsamples"][str(site)] = resblock(cin if r == 0 else cout, cout)
            site += 1
        if i != len(cfg.dim_mult) - 1:
            p = {"resample": {"1": conv2(cout, cout)}}
            if cfg.temporal_downsample[i]:
                p["time_conv"] = conv3(cout, cout, (3, 1, 1))
            enc["downsamples"][str(site)] = p
            site += 1
    d = enc_dims[-1]
    enc["middle"] = {"0": resblock(d, d), "1": attn(d), "2": resblock(d, d)}
    enc["head"] = {"0": rms(d), "2": conv3(d, z2)}

    dec_dims = cfg.dec_dims
    temporal_up = cfg.temporal_downsample[::-1]
    d0 = dec_dims[0]
    dec = {"conv1": conv3(cfg.z_dim, d0),
           "middle": {"0": resblock(d0, d0), "1": attn(d0), "2": resblock(d0, d0)},
           "upsamples": {}}
    site = 0
    for i, (cin, cout) in enumerate(zip(dec_dims[:-1], dec_dims[1:])):
        cin_eff = cin // 2 if i in (1, 2, 3) else cin
        for r in range(cfg.num_res_blocks + 1):
            dec["upsamples"][str(site)] = resblock(cin_eff if r == 0 else cout, cout)
            site += 1
        if i != len(cfg.dim_mult) - 1:
            p = {"resample": {"1": conv2(cout, cout // 2)}}
            if temporal_up[i]:
                p["time_conv"] = conv3(cout, cout * 2, (3, 1, 1))
            dec["upsamples"][str(site)] = p
            site += 1
    dec["head"] = {"0": rms(dec_dims[-1]), "2": conv3(dec_dims[-1], 3)}
    return {"encoder": enc, "decoder": dec, "conv1": conv3(z2, z2, (1, 1, 1)),
            "conv2": conv3(cfg.z_dim, cfg.z_dim, (1, 1, 1))}


def _to_module(tree, device) -> nn.Module:
    if all(isinstance(v, dict) for v in tree.values()):
        return nn.ModuleDict({k: _to_module(v, device) for k, v in tree.items()})
    return container(**{k: nn.Parameter(torch.empty(shape, device=device), requires_grad=False)
                        for k, shape in tree.items()})


class WanVAEModel(nn.Module):
    """Parameter holder: .encoder, .decoder, .conv1, .conv2 as in the JAX tree."""

    def __init__(self, cfg: WanVAEConfig, device=None):
        super().__init__()
        self.config = cfg
        for k, v in _param_tree(cfg).items():
            setattr(self, k, _to_module(v, device))

    def init_weights_(self, generator: torch.Generator) -> None:
        """N(0, 1/fan_in) conv weights, zero biases, unit gammas."""
        random_init_(self, generator, lambda name, p: (1.0 / p[0].numel()) ** 0.5)


# ---------------------------------------------------------------------------
# Primitive layers (channels-first)
# ---------------------------------------------------------------------------
def _conv3d(p, x, *, stride=(1, 1, 1), t_pad: int, s_pad: int, cache=None):
    """Causal conv3d: left-pad time by t_pad (or prepend `cache` frames)."""
    if cache is not None:
        x = torch.cat([cache.to(x.dtype), x], dim=2)
        t_pad = 0
    x = F.pad(x, (s_pad, s_pad, s_pad, s_pad, t_pad, 0))
    return F.conv3d(x, p.weight.to(x.dtype), p.bias.to(x.dtype), stride=stride)


def _conv2d(p, x, *, stride=(1, 1), pad=((1, 1), (1, 1))):
    """Per-frame conv2d over (b*t, c, h, w)."""
    b, c, t, h, w = x.shape
    xx = x.transpose(1, 2).reshape(b * t, c, h, w)
    xx = F.pad(xx, (pad[1][0], pad[1][1], pad[0][0], pad[0][1]))
    y = F.conv2d(xx, p.weight.to(x.dtype), p.bias.to(x.dtype), stride=stride)
    return y.reshape(b, t, *y.shape[1:]).transpose(1, 2)


def _rms(p, x):
    return channel_rms_norm(x, p.gamma, dim=1)


def _upsample2x(x):
    return x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)


def _interleave_double(y):
    """(b, 2c, t, h, w) -> (b, c, 2t, h, w) frame interleave."""
    b, c2, t, h, w = y.shape
    c = c2 // 2
    return y.reshape(b, 2, c, t, h, w).permute(0, 2, 3, 1, 4, 5).reshape(b, c, 2 * t, h, w)


class _Cache:
    """Per-conv frame caches (the reference's feat_cache).  `store=None` is
    full-sequence mode: convs use causal zero padding."""

    def __init__(self, store: Optional[Dict[str, torch.Tensor]]):
        self.store = store
        self.new: Dict[str, torch.Tensor] = {}

    def enabled(self):
        return self.store is not None

    def pull(self, name: str, x, n_frames: int = CACHE_T):
        if self.store is None:
            return None
        cache = self.store[name]
        self.new[name] = torch.cat([cache.to(x.dtype), x], dim=2)[:, :, -n_frames:]
        return cache


class _ZeroCache(_Cache):
    """Cache view for the first chunk: zero context, records the caches."""

    def __init__(self):
        super().__init__(None)

    def enabled(self):
        return True

    def pull(self, name, x, n_frames=CACHE_T):
        zero = x.new_zeros((x.shape[0], x.shape[1], n_frames, *x.shape[3:]))
        self.new[name] = torch.cat([zero, x], dim=2)[:, :, -n_frames:]
        return zero


def _causal3(p, x, cache: _Cache, site: str):
    return _conv3d(p, x, t_pad=2, s_pad=1, cache=cache.pull(site, x))


def _residual_block(p, x, cache: _Cache, prefix: str):
    h = _conv3d(p["shortcut"], x, t_pad=0, s_pad=0) if "shortcut" in p else x
    r = p["residual"]
    y = _causal3(r["2"], F.silu(_rms(r["0"], x)), cache, prefix + "/2")
    y = _causal3(r["6"], F.silu(_rms(r["3"], y)), cache, prefix + "/6")
    return y + h


def _attention_block(p, x):
    """Single-head per-frame self-attention; plain math with an f32 softmax."""
    b, c, t, h, w = x.shape
    qkv = _conv2d(p["to_qkv"], _rms(p["norm"], x), pad=((0, 0), (0, 0)))
    qkv = qkv.permute(0, 2, 3, 4, 1).reshape(b * t, h * w, 3, c)
    q, k, v = qkv.unbind(2)
    logits = torch.einsum("bqc,bkc->bqk", q.float(), k.float())
    probs = torch.softmax(logits * (c ** -0.5), dim=-1).to(v.dtype)
    o = torch.einsum("bqk,bkc->bqc", probs, v).reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
    return x + _conv2d(p["proj"], o, pad=((0, 0), (0, 0)))


def _resample(p, x, mode: str, cache: _Cache, prefix: str, first_chunk: bool):
    if mode == "upsample3d":
        if cache.enabled():
            if first_chunk:
                b, c, _, h, w = x.shape
                cache.new[prefix + "/time_conv"] = x.new_zeros((b, c, CACHE_T, h, w))
            else:
                c = cache.pull(prefix + "/time_conv", x)
                x = _interleave_double(_conv3d(p["time_conv"], x, t_pad=2, s_pad=0, cache=c))
        elif x.shape[2] > 1:
            y = _conv3d(p["time_conv"], x[:, :, 1:], t_pad=2, s_pad=0)
            x = torch.cat([x[:, :, :1], _interleave_double(y)], dim=2)
        return _conv2d(p["resample"]["1"], _upsample2x(x))
    if mode == "upsample2d":
        return _conv2d(p["resample"]["1"], _upsample2x(x))
    # downsample2d / downsample3d: ZeroPad2d((0, 1, 0, 1)) + 3x3 stride-2 conv
    y = _conv2d(p["resample"]["1"], x, stride=(2, 2), pad=((0, 1), (0, 1)))
    if mode == "downsample3d":
        if cache.enabled():
            if first_chunk:
                cache.new[prefix + "/time_conv"] = y[:, :, -1:]
            else:
                c = cache.pull(prefix + "/time_conv", y, n_frames=1)
                y = _conv3d(p["time_conv"], y, stride=(2, 1, 1), t_pad=0, s_pad=0, cache=c)
        elif y.shape[2] >= 3:  # fewer frames leave no stride-2 window
            tail = _conv3d(p["time_conv"], y, stride=(2, 1, 1), t_pad=0, s_pad=0)
            y = torch.cat([y[:, :, :1], tail], dim=2)
        else:
            y = y[:, :, :1]
    return y


def _encoder(p, x, cfg: WanVAEConfig, cache: _Cache, first_chunk: bool):
    x = _causal3(p["conv1"], x, cache, "conv1")
    site = 0
    for i in range(len(cfg.dim_mult)):
        for _ in range(cfg.num_res_blocks):
            x = _residual_block(p["downsamples"][str(site)], x, cache, f"downsamples/{site}")
            site += 1
        if i != len(cfg.dim_mult) - 1:
            mode = "downsample3d" if cfg.temporal_downsample[i] else "downsample2d"
            x = _resample(p["downsamples"][str(site)], x, mode, cache, f"downsamples/{site}",
                          first_chunk)
            site += 1
    x = _residual_block(p["middle"]["0"], x, cache, "middle/0")
    x = _attention_block(p["middle"]["1"], x)
    x = _residual_block(p["middle"]["2"], x, cache, "middle/2")
    x = F.silu(_rms(p["head"]["0"], x))
    return _causal3(p["head"]["2"], x, cache, "head/2")


def _decoder(p, x, cfg: WanVAEConfig, cache: _Cache, first_chunk: bool):
    x = _causal3(p["conv1"], x, cache, "conv1")
    x = _residual_block(p["middle"]["0"], x, cache, "middle/0")
    x = _attention_block(p["middle"]["1"], x)
    x = _residual_block(p["middle"]["2"], x, cache, "middle/2")
    temporal_up = cfg.temporal_downsample[::-1]
    site = 0
    for i in range(len(cfg.dim_mult)):
        for _ in range(cfg.num_res_blocks + 1):
            x = _residual_block(p["upsamples"][str(site)], x, cache, f"upsamples/{site}")
            site += 1
        if i != len(cfg.dim_mult) - 1:
            mode = "upsample3d" if temporal_up[i] else "upsample2d"
            x = _resample(p["upsamples"][str(site)], x, mode, cache, f"upsamples/{site}",
                          first_chunk)
            site += 1
    x = F.silu(_rms(p["head"]["0"], x))
    return _causal3(p["head"]["2"], x, cache, "head/2")


def _streamed(stage, p, cfg, x, chunks):
    """Run `stage` chunk by chunk along time, carrying the conv caches."""
    probe = _ZeroCache()
    outs = [stage(p, x[:, :, :chunks[0]], cfg, probe, True)]
    caches = probe.new
    t0 = chunks[0]
    for n in chunks[1:]:
        c = _Cache(caches)
        outs.append(stage(p, x[:, :, t0:t0 + n], cfg, c, False))
        caches = {**caches, **c.new}
        t0 += n
    return torch.cat(outs, dim=2)


def _stat(values, x):
    return torch.from_numpy(values).to(x.device).reshape(1, -1, 1, 1, 1)


def vae_encode(model: WanVAEModel, cfg: WanVAEConfig, video, *, streamed: bool = False):
    """video (b, T, 3, H, W) in [-1, 1], T = 1 + 4k -> normalised latent
    (b, 1 + k, z, H/8, W/8) f32 (the mu path)."""
    x = video.permute(0, 2, 1, 3, 4).to(cfg.compute_dtype)
    T = x.shape[2]
    if streamed:
        if (T - 1) % 4:
            raise ValueError(f"the streamed encoder takes 1 + 4k frames, got {T}")
        out = _streamed(_encoder, model.encoder, cfg, x, [1] + [4] * ((T - 1) // 4))
    else:
        out = _encoder(model.encoder, x, cfg, _Cache(None), True)
    mu = _conv3d(model.conv1, out, t_pad=0, s_pad=0)[:, :cfg.z_dim].float()
    mu = (mu - _stat(cfg.latent_mean, mu)) / _stat(cfg.latent_std, mu)
    return mu.permute(0, 2, 1, 3, 4)


def vae_decode(model: WanVAEModel, cfg: WanVAEConfig, z, *, streamed: bool = False):
    """z (b, t, z, h, w) normalised latent -> (b, T, 3, H, W) in [-1, 1] f32."""
    zl = z.permute(0, 2, 1, 3, 4).float()
    zl = (zl * _stat(cfg.latent_std, zl) + _stat(cfg.latent_mean, zl)).to(cfg.compute_dtype)
    x = _conv3d(model.conv2, zl, t_pad=0, s_pad=0)
    if streamed:
        out = _streamed(_decoder, model.decoder, cfg, x, [1] * x.shape[2])
    else:
        out = _decoder(model.decoder, x, cfg, _Cache(None), True)
    return out.float().clamp(-1.0, 1.0).permute(0, 2, 1, 3, 4)


@register(alias="sgm.models.wan_vae.WanVAE")
class WanVAE:
    """Reference-surface wrapper: holds the model and encodes/decodes."""

    def __init__(self, z_dim: int = 16, vae_pth: str = None, dtype="torch.bfloat16",
                 device=None):
        self.config = WanVAEConfig(z_dim=z_dim,
                                   dtype="bfloat16" if "bfloat16" in str(dtype) else "float32")
        self.model: Optional[WanVAEModel] = None
        self.checkpoint_path = None
        if vae_pth and os.path.exists(str(vae_pth)):
            # the file's tensors, memory-mapped on the CPU in its dtype; the
            # engine moves them to its device
            self.checkpoint_path = str(vae_pth)
            self.model = WanVAEModel(self.config, device="meta")
            load_mapped_(self.model, load_torch_state_dict(self.checkpoint_path), wan_vae_source,
                         what=f"Wan VAE {self.checkpoint_path}")

    def init(self, generator: torch.Generator, cfg: WanVAEConfig = None, device=None):
        self.config = cfg or self.config
        self.model = WanVAEModel(self.config, device=device)
        self.model.init_weights_(generator)
        self.model.to(self.config.compute_dtype)
        return self.model

    def encode(self, video, streamed: bool = True):
        return vae_encode(self.model, self.config, video, streamed=streamed)

    def decode(self, z, streamed: bool = True):
        return vae_decode(self.model, self.config, z, streamed=streamed)
