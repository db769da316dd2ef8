"""The taming Encoder / Decoder stacks (counterpart of the encoder and decoder
of scail_tpu/autoencoding/vqgan.py), as the KL autoencoder uses them.

NCHW, with the reference's module names (`conv_in`, `down.{i}.block.{j}`,
`down.{i}.attn.{j}`, `down.{i}.downsample.conv`, `mid.{block_1, attn_1,
block_2}`, `up.{i}...`, `norm_out`, `conv_out`), so the released
`encoder.*` / `decoder.*` tensors load as they are.  GroupNorm(32, eps 1e-6)
with f32 statistics; swish; the mid-block attention is one head over every
position (16,384 of them in a 1024 x 1024 decode), by
`scaled_dot_product_attention`.  The VQ quantiser, MOVQ's spatially
modulated norms and the VQ model shells are not ported.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.unet import conv, group_norm, nearest_up


def _swish(x):
    return F.silu(x)


def _norm(c, device):
    return nn.GroupNorm(32, c, eps=1e-6, device=device)


def _conv(c_in, c_out, k, device, stride=1, padding=None):
    return nn.Conv2d(c_in, c_out, k, stride=stride, padding=k // 2 if padding is None else padding,
                     device=device)


class ResnetBlock(nn.Module):
    def __init__(self, c_in, c_out, device=None):
        super().__init__()
        self.norm1, self.conv1 = _norm(c_in, device), _conv(c_in, c_out, 3, device)
        self.norm2, self.conv2 = _norm(c_out, device), _conv(c_out, c_out, 3, device)
        if c_in != c_out:
            self.nin_shortcut = _conv(c_in, c_out, 1, device)

    def forward(self, x):
        h = conv(self.conv1, _swish(group_norm(self.norm1, x)))
        h = conv(self.conv2, _swish(group_norm(self.norm2, h)))
        if hasattr(self, "nin_shortcut"):
            x = conv(self.nin_shortcut, x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, c, device=None):
        super().__init__()
        self.norm = _norm(c, device)
        for name in ("q", "k", "v", "proj_out"):
            setattr(self, name, _conv(c, c, 1, device))

    def forward(self, x):
        b, c, h, w = x.shape
        n = group_norm(self.norm, x)
        q, k, v = (conv(getattr(self, name), n).reshape(b, 1, c, h * w).transpose(2, 3)
                   for name in ("q", "k", "v"))
        out = F.scaled_dot_product_attention(q, k, v)  # scale c^-1/2
        return x + conv(self.proj_out, out.transpose(2, 3).reshape(b, c, h, w))


class _Resample(nn.Module):
    def __init__(self, c, device, down):
        super().__init__()
        self.down = down
        self.conv = _conv(c, c, 3, device, stride=2 if down else 1, padding=0 if down else 1)

    def forward(self, x):
        if self.down:  # pad right and bottom, then a stride-2 VALID conv
            return conv(self.conv, F.pad(x, (0, 1, 0, 1)))
        return conv(self.conv, nearest_up(x))


def _level(blocks, attns, resample=None):
    m = nn.Module()
    m.block, m.attn = nn.ModuleList(blocks), nn.ModuleList(attns)
    if resample is not None:
        setattr(m, "downsample" if resample.down else "upsample", resample)
    return m


def _mid(c, device):
    m = nn.Module()
    m.block_1, m.attn_1, m.block_2 = ResnetBlock(c, c, device), AttnBlock(c, device), \
        ResnetBlock(c, c, device)
    return m


def _mid_apply(mid, h):
    return mid.block_2(mid.attn_1(mid.block_1(h)))


def _level_apply(level, h):
    for j, blk in enumerate(level.block):
        h = blk(h)
        if len(level.attn):
            h = level.attn[j](h)
    resample = getattr(level, "downsample", None) or getattr(level, "upsample", None)
    return h if resample is None else resample(h)


class Encoder(nn.Module):
    def __init__(self, *, ch, ch_mult=(1, 2, 4, 8), num_res_blocks, attn_resolutions=(),
                 in_channels=3, resolution=256, z_channels, double_z=True, device=None, **_):
        super().__init__()
        self.conv_in = _conv(in_channels, ch, 3, device)
        curr_res, in_mult = resolution, (1,) + tuple(ch_mult)
        self.down = nn.ModuleList()
        block_in = ch
        for i, mult in enumerate(ch_mult):
            block_in, block_out = ch * in_mult[i], ch * mult
            blocks, attns = [], []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(block_in, block_out, device))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock(block_in, device))
            down = None
            if i != len(ch_mult) - 1:
                down = _Resample(block_in, device, down=True)
                curr_res //= 2
            self.down.append(_level(blocks, attns, down))
        self.mid = _mid(block_in, device)
        self.norm_out = _norm(block_in, device)
        self.conv_out = _conv(block_in, 2 * z_channels if double_z else z_channels, 3, device)

    def forward(self, x):
        h = conv(self.conv_in, x)
        for level in self.down:
            h = _level_apply(level, h)
        h = _mid_apply(self.mid, h)
        return conv(self.conv_out, _swish(group_norm(self.norm_out, h)))


class Decoder(nn.Module):
    def __init__(self, *, ch, out_ch, ch_mult=(1, 2, 4, 8), num_res_blocks,
                 attn_resolutions=(), resolution=256, z_channels, device=None, **_):
        super().__init__()
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (len(ch_mult) - 1)
        self.conv_in = _conv(z_channels, block_in, 3, device)
        self.mid = _mid(block_in, device)
        ups = []
        for i in reversed(range(len(ch_mult))):
            block_out = ch * ch_mult[i]
            blocks, attns = [], []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, block_out, device))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock(block_in, device))
            up = None
            if i != 0:
                up = _Resample(block_in, device, down=False)
                curr_res *= 2
            ups.insert(0, _level(blocks, attns, up))
        self.up = nn.ModuleList(ups)
        self.norm_out = _norm(block_in, device)
        self.conv_out = _conv(block_in, out_ch, 3, device)

    def forward(self, z):
        h = _mid_apply(self.mid, conv(self.conv_in, z))
        for i in reversed(range(len(self.up))):
            h = _level_apply(self.up[i], h)
        return conv(self.conv_out, _swish(group_norm(self.norm_out, h)))

