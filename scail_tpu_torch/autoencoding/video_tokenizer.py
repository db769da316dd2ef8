"""MagViT2-lite causal video tokenizer (counterpart of
scail_tpu/autoencoding/video_tokenizer.py; reference
sgm/modules/autoencoding/magvit2_pytorch.py:1044-1893 VideoTokenizer).

Layout (B, C, T, H, W), the reference's; the JAX package is time-major and
channels-last, so its bridge transposes.  The layer types are the JAX
package's: 'residual', 'consecutive_residual', 'compress_space' and
'compress_time', with causal conv3d (:54-62), squeeze-excite residual units,
the first-frame padding contract (encode pads time_downsample_factor - 1
lead frames, decode crops them) and the LFQ between encoder and decoder.
Module names are the reference's (`conv_in.conv`, `encoder_layers.{i}...`,
`decoder_layers.{j}...`, `quantizers.project_*`, `conv_out.conv`), those
video_tokenizer_params_from_torch reads (:374-450).  As in the JAX encode,
the final channel LayerNorm (`encoder_layers.{n}.1`) is kept for the state
dict and not applied (the reference's own layer walk truncates it out).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.autoencoding.regularizers import LFQ

LayerSpec = Union[str, Tuple[str, int]]


class CausalConv3d(nn.Module):
    """(magvit2_pytorch.py:891-927) zero left pad of kt - 1 + (1 - stride)
    frames, same spatial pad, stride in time only."""

    def __init__(self, c_in, c_out, kernel: Tuple[int, int, int], time_stride: int = 1,
                 device=None):
        super().__init__()
        self.time_stride = time_stride
        self.conv = nn.Conv3d(c_in, c_out, kernel, stride=(time_stride, 1, 1), device=device)

    def forward(self, x):
        kt, kh, kw = self.conv.kernel_size
        tp = kt - 1 + (1 - self.time_stride)
        x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, tp, 0))
        return self.conv(x)


def _frames(x):
    """(b, c, t, h, w) -> (b t, c, h, w)."""
    b, c, t, h, w = x.shape
    return x.transpose(1, 2).reshape(b * t, c, h, w)


def _unframes(y, b):
    bt, c, h, w = y.shape
    return y.reshape(b, bt // b, c, h, w).transpose(1, 2)


class SqueezeExcite(nn.Module):
    """(magvit2_pytorch.py:193-241) attention-pooled context per frame, then
    a two-layer gate; the last conv zero with bias -10, so the unit starts
    near the identity."""

    def __init__(self, dim, device=None):
        super().__init__()
        hidden = max(16, dim // 2)
        self.to_k = nn.Conv2d(dim, 1, 1, device=device)
        self.net = nn.Sequential(nn.Conv2d(dim, hidden, 1, device=device), nn.LeakyReLU(0.1),
                                 nn.Conv2d(hidden, dim, 1, device=device), nn.Sigmoid())

    def forward(self, x):
        b, c, t, h, w = x.shape
        xf = _frames(x).reshape(b * t, c, h * w)
        ctx = F.conv2d(_frames(x), self.to_k.weight, self.to_k.bias).reshape(b * t, 1, h * w)
        ctx = torch.softmax(ctx.float(), dim=-1).to(x.dtype)
        pooled = torch.einsum("bkn,bcn->bkc", ctx, xf)[:, 0]  # (bt, c)
        w0, w2 = self.net[0], self.net[2]
        g = F.leaky_relu(F.linear(pooled, w0.weight[:, :, 0, 0], w0.bias), 0.1)
        g = F.linear(g, w2.weight[:, :, 0, 0], w2.bias)
        gates = torch.sigmoid(g).reshape(b, t, c).transpose(1, 2)[..., None, None]
        return gates * x


class ResidualUnit(nn.Module):
    """x + SE(elu(conv1x1(elu(causal_conv3d(x))))), `fn.{0,2,4}` as the
    reference's Residual(Sequential(...))."""

    def __init__(self, dim, kernel_size: int = 3, device=None):
        super().__init__()
        k = kernel_size
        self.fn = nn.Sequential(CausalConv3d(dim, dim, (k, k, k), device=device), nn.ELU(),
                                nn.Conv3d(dim, dim, 1, device=device), nn.ELU(),
                                SqueezeExcite(dim, device))

    def forward(self, x):
        return x + self.fn(x)


class SpatialDownsample2x(nn.Module):
    def __init__(self, dim, dim_out, k: int = 3, device=None):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim_out, k, stride=2, padding=k // 2, device=device)

    def forward(self, x):
        return _unframes(self.conv(_frames(x)), x.shape[0])


class TimeDownsample2x(nn.Module):
    """Causal stride-2 conv over time (magvit2_pytorch.py:781-808)."""

    def __init__(self, dim, dim_out, k: int = 3, device=None):
        super().__init__()
        self.conv = nn.Conv1d(dim, dim_out, k, stride=2, device=device)

    def forward(self, x):
        k = self.conv.kernel_size[0]
        x = F.pad(x, (0, 0, 0, 0, k - 1, 0))
        w = self.conv.weight[:, :, :, None, None]
        return F.conv3d(x, w, self.conv.bias, stride=(2, 1, 1))


class SpatialUpsample2x(nn.Module):
    """1x1 conv to 4x channels, silu, depth-to-space with the channel order
    (c p1 p2) (magvit2_pytorch.py:810-845)."""

    def __init__(self, dim, dim_out, device=None):
        super().__init__()
        self.net = nn.Sequential(nn.Conv2d(dim, dim_out * 4, 1, device=device), nn.SiLU())

    def forward(self, x):
        b = x.shape[0]
        y = _unframes(F.silu(self.net[0](_frames(x))), b)
        _, c4, t, h, w = y.shape
        c = c4 // 4
        y = y.reshape(b, c, 2, 2, t, h, w).permute(0, 1, 4, 5, 2, 6, 3)
        return y.reshape(b, c, t, 2 * h, 2 * w)


class TimeUpsample2x(nn.Module):
    """1x1 conv to 2x channels, silu, depth-to-time with the order (c p)."""

    def __init__(self, dim, dim_out, device=None):
        super().__init__()
        self.net = nn.Sequential(nn.Conv1d(dim, dim_out * 2, 1, device=device), nn.SiLU())

    def forward(self, x):
        b, c, t, h, w = x.shape
        conv = self.net[0]
        y = F.silu(F.conv3d(x, conv.weight[:, :, :, None, None], conv.bias))
        c2 = y.shape[1] // 2
        y = y.reshape(b, c2, 2, t, h, w).transpose(2, 3)
        return y.reshape(b, c2, 2 * t, h, w)


@dataclasses.dataclass
class VideoTokenizerConfig:
    """The JAX package's defaults (video_tokenizer.py:186-201)."""

    layers: Tuple[LayerSpec, ...] = (
        "residual", "compress_space", ("consecutive_residual", 2), "compress_time", "residual")
    init_dim: int = 64
    channels: int = 3
    codebook_size: int = 2 ** 18
    num_codebooks: int = 1
    input_conv_kernel_size: Tuple[int, int, int] = (7, 7, 7)
    output_conv_kernel_size: Tuple[int, int, int] = (3, 3, 3)
    residual_conv_kernel_size: int = 3
    max_dim: int = 2 ** 30
    lfq_entropy_loss_weight: float = 0.1
    lfq_commitment_loss_weight: float = 1.0
    lfq_diversity_gamma: float = 2.5


def _plan(cfg: VideoTokenizerConfig):
    """Static layer plan: (type, dim_in, dim_out, n) per layer, the latent
    dim and the time downsample factor (video_tokenizer.py:204-229)."""
    plan = []
    dim = cfg.init_dim
    tdf = 1
    for spec in cfg.layers:
        typ, *ps = (spec,) if isinstance(spec, str) else spec
        if typ == "residual":
            plan.append(("residual", dim, dim, 1))
        elif typ == "consecutive_residual":
            plan.append(("residual", dim, dim, ps[0]))
        elif typ in ("compress_space", "compress_time"):
            out = min(ps[0] if ps else dim * 2, cfg.max_dim)
            plan.append((typ, dim, out, 1))
            dim = out
            tdf *= 2 if typ == "compress_time" else 1
        else:
            raise ValueError(f"unsupported lite layer type {typ!r} "
                             "(attention variants are out of scope)")
    return plan, dim, tdf


def _residual(dim, n, k, device):
    units = [ResidualUnit(dim, k, device) for _ in range(n)]
    return units[0] if n == 1 else nn.Sequential(*units)


class _Head(nn.Module):
    """conv_out and the crop of the padded lead frames: the last layer of the
    decoder, which the adaptive GAN weight differentiates."""

    def __init__(self, conv_out: CausalConv3d, time_padding: int):
        super().__init__()
        self.conv_out, self.time_padding = conv_out, time_padding

    def forward(self, feats):
        return self.conv_out(feats)[:, :, self.time_padding:]


class VideoTokenizer(nn.Module):
    """encode -> LFQ -> decode with the causal first-frame padding contract.
    video (B, C, T, H, W); T + time_downsample_factor - 1 must divide by the
    factor (17 frames at the default plan)."""

    def __init__(self, config: VideoTokenizerConfig = None, device=None, **kw):
        super().__init__()
        self.cfg = cfg = config or VideoTokenizerConfig(**kw)
        self.plan, self.latent_dim, self.time_downsample_factor = _plan(cfg)
        self.time_padding = self.time_downsample_factor - 1
        k = cfg.residual_conv_kernel_size
        self.conv_in = CausalConv3d(cfg.channels, cfg.init_dim, cfg.input_conv_kernel_size,
                                    device=device)
        enc, dec = [], []
        for typ, din, dout, n in self.plan:
            if typ == "residual":
                enc.append(_residual(din, n, k, device))
                dec.insert(0, _residual(din, n, k, device))
            elif typ == "compress_space":
                enc.append(SpatialDownsample2x(din, dout, device=device))
                dec.insert(0, SpatialUpsample2x(dout, din, device=device))
            else:
                enc.append(TimeDownsample2x(din, dout, device=device))
                dec.insert(0, TimeUpsample2x(dout, din, device=device))
        # the reference's final channel norm, kept for the state dict only
        enc.append(nn.Sequential(nn.Identity(), nn.LayerNorm(self.latent_dim, device=device),
                                 nn.Identity()))
        self.encoder_layers = nn.ModuleList(enc)
        self.decoder_layers = nn.ModuleList(dec)
        self.conv_out = CausalConv3d(cfg.init_dim, cfg.channels, cfg.output_conv_kernel_size,
                                     device=device)
        self.quantizers = LFQ(dim=self.latent_dim, codebook_size=cfg.codebook_size,
                              num_codebooks=cfg.num_codebooks,
                              diversity_gamma=cfg.lfq_diversity_gamma,
                              entropy_loss_weight=cfg.lfq_entropy_loss_weight,
                              commitment_loss_weight=cfg.lfq_commitment_loss_weight,
                              device=device)

    def init_random_(self, generator: torch.Generator):
        """torch's conv default U(+-1/sqrt(fan_in)) for kernels and biases,
        the squeeze-excite gates' last conv zero with bias -10, the norm one
        and zero, the LFQ projections as init_lfq (VideoTokenizer.init_params)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
                    b = 1.0 / math.sqrt(m.weight[0].numel())
                    m.weight.uniform_(-b, b, generator=generator)
                    m.bias.uniform_(-b, b, generator=generator)
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
            for m in self.modules():
                if isinstance(m, SqueezeExcite):
                    m.net[2].weight.zero_()
                    m.net[2].bias.fill_(-10.0)
        self.quantizers.init_random_(generator)
        return self

    def encode(self, video):
        """(B, C, T, H, W) -> latent features (B, latent_dim, T', H', W')."""
        x = F.pad(video, (0, 0, 0, 0, self.time_padding, 0))
        x = self.conv_in(x)
        for layer in self.encoder_layers[:-1]:
            x = layer(x)
        return x

    def quantize(self, feats, training: bool = True):
        """(quantized, indices (B, T', H', W'), aux_loss, breakdown)."""
        q, indices, aux, breakdown = self.quantizers.quantize(feats.movedim(1, -1), training)
        return q.movedim(-1, 1), indices, aux, breakdown

    def decode_features(self, quantized):
        """The decoder up to conv_out (the adaptive weight's features)."""
        x = quantized
        for layer in self.decoder_layers:
            x = layer(x)
        return x

    def decode(self, quantized):
        return self.conv_out(self.decode_features(quantized))[:, :, self.time_padding:]

    def decode_from_indices(self, indices):
        return self.decode(self.quantizers.indices_to_codes(indices).movedim(-1, 1))

    def tokenize(self, video):
        return self.quantize(self.encode(video), training=False)[1]

    def forward(self, video, training: bool = True):
        """Full autoencode: (recon, aux_loss, {'indices', the LFQ breakdown})."""
        quantized, indices, aux, breakdown = self.quantize(self.encode(video), training)
        return self.decode(quantized), aux, {"indices": indices, **breakdown}

    def trainer_parts(self) -> Dict[str, nn.Module]:
        """The AutoencoderTrainer's encoder, regularizer (the LFQ, in the
        module's training mode), decoder body and head (conv_out + crop)."""
        return {"encoder": _Call(self, "encode"), "regularizer": self.quantizers,
                "decoder_body": _Call(self, "decode_features"),
                "decoder_head": _Head(self.conv_out, self.time_padding)}


class _Call(nn.Module):
    """One method of a module as a module (its parameters are the owner's)."""

    def __init__(self, owner: nn.Module, method: str):
        super().__init__()
        self.owner, self.method = owner, method

    def forward(self, x):
        return getattr(self.owner, self.method)(x)
