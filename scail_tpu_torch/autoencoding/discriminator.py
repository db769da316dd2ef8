"""GAN discriminators for autoencoder training (counterpart of
scail_tpu/autoencoding/discriminator.py).

- `NLayerDiscriminator`: the Pix2Pix PatchGAN of the reference's image GAN
  loss (sgm/modules/autoencoding/lpips/model/model.py:20-91) under its
  names (`main.{i}.*`), so the JAX package's
  nlayer_discriminator_params_from_torch reads its state dict
  (discriminator.py:78-160).  Its BatchNorms normalise with the batch's
  statistics (biased variance) in every step, as the JAX _batch_norm
  (:60-69) does, which is what torch's BatchNorm2d computes in train mode;
  the running buffers exist for the reference's state-dict layout, are
  updated only while the module is in train mode, and are never read.
- `VideoDiscriminator`: the JAX package's counterpart of the reference's
  Discriminator3D (:163-327): 3D residual blocks that halve t, h and w by
  space-to-channel, then 2D residual blocks with (1 + elu)-feature linear
  space attention and a GEGLU feed-forward, then conv3x3, flatten and a
  linear logit.  Layout (b, c, t, h, w); the frame count must halve
  evenly through the 3D blocks, as the JAX function's reshape requires.

Both are training-only (no released weights); N(0, 0.02) conv init.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _lrelu(x, slope):
    return F.leaky_relu(x, slope)


# ---------------------------------------------------------------------------
# NLayerDiscriminator (PatchGAN)
# ---------------------------------------------------------------------------
class NLayerDiscriminator(nn.Module):
    """conv(4, s2) + LReLU(0.2); n_layers - 1 x [conv(4, s2, no bias), BN,
    LReLU]; conv(4, s1, no bias), BN, LReLU; the 1-channel logit conv(4, s1);
    padding 1 everywhere.  x (b, c, h, w) in [-1, 1] -> (b, 1, h', w')."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3, device=None):
        super().__init__()
        self.n_layers = n_layers
        seq = [nn.Conv2d(input_nc, ndf, 4, 2, 1, device=device), nn.LeakyReLU(0.2)]
        nf_mult = 1
        for n in range(1, n_layers):
            nf_prev, nf_mult = nf_mult, min(2 ** n, 8)
            seq += [nn.Conv2d(ndf * nf_prev, ndf * nf_mult, 4, 2, 1, bias=False, device=device),
                    nn.BatchNorm2d(ndf * nf_mult, device=device), nn.LeakyReLU(0.2)]
        nf_prev, nf_mult = nf_mult, min(2 ** n_layers, 8)
        seq += [nn.Conv2d(ndf * nf_prev, ndf * nf_mult, 4, 1, 1, bias=False, device=device),
                nn.BatchNorm2d(ndf * nf_mult, device=device), nn.LeakyReLU(0.2),
                nn.Conv2d(ndf * nf_mult, 1, 4, 1, 1, device=device)]
        self.main = nn.Sequential(*seq)

    def init_random_(self, generator: torch.Generator):
        """The GAN weights_init (model.py:8-17): conv N(0, 0.02), conv bias 0,
        BN weight N(1, 0.02), BN bias 0."""
        with torch.no_grad():
            for m in self.main:
                if isinstance(m, nn.Conv2d):
                    m.weight.normal_(0.0, 0.02, generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.BatchNorm2d):
                    m.weight.normal_(1.0, 0.02, generator=generator)
                    m.bias.zero_()
        return self

    def forward(self, x):
        for m in self.main:
            if isinstance(m, nn.BatchNorm2d):
                keep = self.training
                x = F.batch_norm(x, m.running_mean if keep else None,
                                 m.running_var if keep else None, m.weight.to(x.dtype),
                                 m.bias.to(x.dtype), training=True, momentum=m.momentum,
                                 eps=m.eps)
            elif isinstance(m, nn.Conv2d):
                bias = None if m.bias is None else m.bias.to(x.dtype)
                x = F.conv2d(x, m.weight.to(x.dtype), bias, m.stride, m.padding)
            else:
                x = m(x)
        return x


# ---------------------------------------------------------------------------
# the video discriminator
# ---------------------------------------------------------------------------
class _RMSNormC(nn.Module):
    def __init__(self, c, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, device=device))

    def forward(self, x):
        """x (..., c)."""
        n = x.float()
        n = n * torch.rsqrt(n.square().mean(-1, keepdim=True) + 1e-6)
        return (n * self.scale).to(x.dtype)


class LinearSpaceAttention(nn.Module):
    """Linear attention over the spatial positions with (1 + elu) feature
    maps, pre-RMSNorm, bias-free qkv and out projections."""

    def __init__(self, c, heads, dim_head, device=None):
        super().__init__()
        self.heads = heads
        self.norm = _RMSNormC(c, device)
        self.qkv = nn.Linear(c, 3 * heads * dim_head, bias=False, device=device)
        self.out = nn.Linear(heads * dim_head, c, bias=False, device=device)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x.permute(0, 2, 3, 1).reshape(b, h * w, c))
        q, k, v = self.qkv(y).chunk(3, dim=-1)
        dh = q.shape[-1] // self.heads

        def split(t):
            return t.reshape(b, h * w, self.heads, dh).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        qf = F.elu(q.float()) + 1.0
        kf = F.elu(k.float()) + 1.0
        kv = torch.einsum("bnsd,bnse->bnde", kf, v.float())
        z = torch.einsum("bnsd,bnd->bns", qf, kf.sum(dim=2)) + 1e-6
        out = torch.einsum("bnsd,bnde->bnse", qf, kv) / z[..., None]
        out = out.transpose(1, 2).reshape(b, h * w, self.heads * dh)
        out = self.out(out.to(x.dtype))
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class GEGLUFeedForward(nn.Module):
    """Pre-RMSNorm GEGLU feed-forward over channels (magvit2 FeedForward,
    images=True); gelu in its tanh form, jax.nn.gelu's default."""

    def __init__(self, c, mult, device=None):
        super().__init__()
        inner = int(c * mult * 2 / 3)
        self.norm = _RMSNormC(c, device)
        self.proj_in = nn.Linear(c, 2 * inner, bias=False, device=device)
        self.proj_out = nn.Linear(inner, c, bias=False, device=device)

    def forward(self, x):
        y = self.proj_in(self.norm(x.permute(0, 2, 3, 1)))
        a, g = y.chunk(2, dim=-1)
        return self.proj_out(F.gelu(g, approximate="tanh") * a).permute(0, 3, 1, 2)


def _space_to_channel(x, dims: int):
    """(b, c, [t,] h, w) -> (b, c * 2^dims, [t/2,] h/2, w/2), the channel
    index c * 2^dims + the offsets (t, h, w order), as the JAX reshape."""
    b, c, *sp = x.shape
    if any(n % 2 for n in sp):
        raise ValueError(f"space-to-channel needs even sizes, got {tuple(sp)}")
    shape = [b, c]
    for n in sp:
        shape += [n // 2, 2]
    x = x.reshape(shape)
    outer = [2 + 2 * i for i in range(dims)]
    inner = [3 + 2 * i for i in range(dims)]
    x = x.permute(0, 1, *inner, *outer)
    return x.reshape(b, c * 2 ** dims, *[n // 2 for n in sp])


class _Block3D(nn.Module):
    def __init__(self, cin, cout, device=None):
        super().__init__()
        self.conv_res = nn.Conv3d(cin, cout, 1, stride=2, device=device)
        self.conv1 = nn.Conv3d(cin, cout, 3, padding=1, device=device)
        self.conv2 = nn.Conv3d(cout, cout, 3, padding=1, device=device)
        self.down = nn.Conv3d(cout * 8, cout, 1, device=device)

    def forward(self, x):
        res = self.conv_res(x)
        y = _lrelu(self.conv2(_lrelu(self.conv1(x), 0.1)), 0.1)
        y = self.down(_space_to_channel(y, 3))
        return (y + res) / math.sqrt(2.0)


class _Block2D(nn.Module):
    def __init__(self, cin, cout, downsample, heads, dim_head, ff_mult, device=None):
        super().__init__()
        self.downsample = downsample
        self.conv_res = nn.Conv2d(cin, cout, 1, stride=2 if downsample else 1, device=device)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, device=device)
        if downsample:
            self.down = nn.Conv2d(cout * 4, cout, 1, device=device)
        self.attn = LinearSpaceAttention(cout, heads, dim_head, device)
        self.ff = GEGLUFeedForward(cout, ff_mult, device)

    def forward(self, x):
        res = self.conv_res(x)
        y = _lrelu(self.conv2(_lrelu(self.conv1(x), 0.1)), 0.1)
        if self.downsample:
            y = self.down(_space_to_channel(y, 2))
        x = (y + res) / math.sqrt(2.0)
        x = x + self.attn(x)
        return x + self.ff(x)


class VideoDiscriminator(nn.Module):
    """The layer plan of init_video_discriminator (discriminator.py:163-252):
    log2(image_size) - 2 blocks, the first log2(frame_num) of them 3D.
    x (b, c, t, h, w) in [-1, 1] -> (b,) logits (more 2D blocks than time
    halvings fold the remaining frames into the batch: (b t,))."""

    def __init__(self, *, dim: int = 16, image_size: int = 64, frame_num: int = 8,
                 channels: int = 3, max_dim: int = 512, attn_heads: int = 4,
                 attn_dim_head: int = 8, ff_mult: int = 4, device=None):
        super().__init__()
        num_layers = int(math.log2(image_size) - 2)
        t_layers = int(math.log2(frame_num))
        assert 2 ** t_layers == frame_num, "frame_num must be a power of 2"
        assert t_layers <= num_layers, (
            f"need log2(frames)={t_layers} <= log2(min_res)-2={num_layers} so time fully "
            "collapses before the 2D stage")
        dims = [channels] + [min(dim * 4 * 2 ** i, max_dim) for i in range(num_layers)]
        blocks = []
        for ind in range(num_layers):
            cin, cout = dims[ind], dims[ind + 1]
            if ind < t_layers:
                blocks.append(_Block3D(cin, cout, device))
            else:
                blocks.append(_Block2D(cin, cout, ind != num_layers - 1, attn_heads,
                                       attn_dim_head, ff_mult, device))
        self.blocks = nn.ModuleList(blocks)
        n_down = num_layers if t_layers >= num_layers else num_layers - 1
        fmap = image_size // 2 ** n_down
        self.head_conv = nn.Conv2d(dims[-1], dims[-1], 3, padding=1, device=device)
        self.head_linear = nn.Linear(fmap * fmap * dims[-1], 1, device=device)

    def init_random_(self, generator: torch.Generator):
        """Conv kernels N(0, 0.02), biases 0; attention and feed-forward
        kernels N(0, 0.02), norms 1; the logit linear N(0, 1/latent_dim)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                    m.weight.normal_(0.0, 0.02, generator=generator)
                    m.bias.zero_()
                elif isinstance(m, nn.Linear) and m is not self.head_linear:
                    m.weight.normal_(0.0, 0.02, generator=generator)
                elif isinstance(m, _RMSNormC):
                    m.scale.fill_(1.0)
            lin = self.head_linear
            lin.weight.normal_(0.0, 1.0 / math.sqrt(lin.in_features), generator=generator)
            lin.bias.zero_()
        return self

    def forward(self, x):
        for blk in self.blocks:
            if isinstance(blk, _Block3D):
                x = blk(x)
                if x.shape[2] == 1:
                    x = x[:, :, 0]  # time is gone: 2D from here
            else:
                if x.dim() == 5:  # fold the frames left into the batch
                    b, c, t, h, w = x.shape
                    x = x.transpose(1, 2).reshape(b * t, c, h, w)
                x = blk(x)
        x = _lrelu(self.head_conv(x), 0.1)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # JAX's (h, w, c) order
        return self.head_linear(x)[:, 0]
