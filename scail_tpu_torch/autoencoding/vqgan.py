"""The taming Encoder / Decoder stacks, MOVQ's spatially modulated decoder and
the VQ model shells VQModel and MOVQ (counterpart of
scail_tpu/autoencoding/vqgan.py: the stacks :29-264, SpatialNorm :67-95,
VQModel :266-320, MOVQ :323-331).

NCHW, with the reference's module names (`conv_in`, `down.{i}.block.{j}`,
`down.{i}.attn.{j}`, `down.{i}.downsample.conv`, `mid.{block_1, attn_1,
block_2}`, `up.{i}...`, `norm_out`, `conv_out`), so the released
`encoder.*` / `decoder.*` tensors load as they are.  GroupNorm(32, eps 1e-6)
with f32 statistics; swish; the mid-block attention is one head over every
position (16,384 of them in a 1024 x 1024 decode), by
`scaled_dot_product_attention`.

MOVQ (reference movq_modules.py:34-53): with `zq_ch` set, every norm of the
decoder's resnet and attention blocks and its norm_out is a SpatialNorm, the
GroupNorm (`norm_layer`) times the 1x1 conv `conv_y` of the quantized latent
nearest-resized to the features, plus the 1x1 conv `conv_b` of it.  The
model shells carry the reference's names (`encoder.*`, `decoder.*`,
`quantize.embedding.weight`, `quant_conv.*`, `post_quant_conv.*`), so
released VQGAN and MOVQ files load as they are and the JAX package's
vqmodel_params_from_torch reads the port's state dict.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.autoencoding.regularizers import VectorQuantizer, measure_perplexity
from scail_tpu_torch.models.unet import conv, group_norm, init_random_, nearest_up
from scail_tpu_torch.utils.registry import register


def _swish(x):
    return F.silu(x)


def _norm(c, device):
    return nn.GroupNorm(32, c, eps=1e-6, device=device)


def _conv(c_in, c_out, k, device, stride=1, padding=None):
    return nn.Conv2d(c_in, c_out, k, stride=stride, padding=k // 2 if padding is None else padding,
                     device=device)


class SpatialNorm(nn.Module):
    """GroupNorm modulated by the quantized latent (MOVQ)."""

    def __init__(self, c, zq_ch, device=None):
        super().__init__()
        self.norm_layer = _norm(c, device)
        self.conv_y = _conv(zq_ch, c, 1, device)
        self.conv_b = _conv(zq_ch, c, 1, device)

    def forward(self, x, zq):
        h, w = x.shape[-2:]
        zh, zw = zq.shape[-2:]
        # nearest resize as F.interpolate(mode='nearest'): source row i * zh // h
        ih = torch.arange(h, device=zq.device) * zh // h
        iw = torch.arange(w, device=zq.device) * zw // w
        zq = zq[:, :, ih][:, :, :, iw]
        return group_norm(self.norm_layer, x) * conv(self.conv_y, zq) + conv(self.conv_b, zq)


def _normalizer(c, device, zq_ch=None):
    return _norm(c, device) if zq_ch is None else SpatialNorm(c, zq_ch, device)


def normalize(norm, x, zq=None):
    """A GroupNorm, or a SpatialNorm of x on zq."""
    return norm(x, zq) if isinstance(norm, SpatialNorm) else group_norm(norm, x)


class ResnetBlock(nn.Module):
    def __init__(self, c_in, c_out, device=None, zq_ch=None):
        super().__init__()
        self.norm1, self.conv1 = _normalizer(c_in, device, zq_ch), _conv(c_in, c_out, 3, device)
        self.norm2 = _normalizer(c_out, device, zq_ch)
        self.conv2 = _conv(c_out, c_out, 3, device)
        if c_in != c_out:
            self.nin_shortcut = _conv(c_in, c_out, 1, device)

    def forward(self, x, zq=None):
        h = conv(self.conv1, _swish(normalize(self.norm1, x, zq)))
        h = conv(self.conv2, _swish(normalize(self.norm2, h, zq)))
        if hasattr(self, "nin_shortcut"):
            x = conv(self.nin_shortcut, x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, c, device=None, zq_ch=None):
        super().__init__()
        self.norm = _normalizer(c, device, zq_ch)
        for name in ("q", "k", "v", "proj_out"):
            setattr(self, name, _conv(c, c, 1, device))

    def forward(self, x, zq=None):
        b, c, h, w = x.shape
        n = normalize(self.norm, x, zq)
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


def _mid(c, device, zq_ch=None):
    m = nn.Module()
    m.block_1, m.attn_1, m.block_2 = ResnetBlock(c, c, device, zq_ch), \
        AttnBlock(c, device, zq_ch), ResnetBlock(c, c, device, zq_ch)
    return m


def _mid_apply(mid, h, zq=None):
    return mid.block_2(mid.attn_1(mid.block_1(h, zq), zq), zq)


def _level_apply(level, h, zq=None):
    for j, blk in enumerate(level.block):
        h = blk(h, zq)
        if len(level.attn):
            h = level.attn[j](h, zq)
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
    """zq_ch set: MOVQ's decoder, every norm a SpatialNorm on the quantized
    latent zq (zq_ch channels)."""

    def __init__(self, *, ch, out_ch, ch_mult=(1, 2, 4, 8), num_res_blocks,
                 attn_resolutions=(), resolution=256, z_channels, zq_ch=None, device=None, **_):
        super().__init__()
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (len(ch_mult) - 1)
        self.conv_in = _conv(z_channels, block_in, 3, device)
        self.mid = _mid(block_in, device, zq_ch)
        ups = []
        for i in reversed(range(len(ch_mult))):
            block_out = ch * ch_mult[i]
            blocks, attns = [], []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, block_out, device, zq_ch))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock(block_in, device, zq_ch))
            up = None
            if i != 0:
                up = _Resample(block_in, device, down=False)
                curr_res *= 2
            ups.insert(0, _level(blocks, attns, up))
        self.up = nn.ModuleList(ups)
        self.norm_out = _normalizer(block_in, device, zq_ch)
        self.conv_out = _conv(block_in, out_ch, 3, device)

    def body(self, z, zq=None):
        """Everything before conv_out (the adaptive GAN weight's last layer):
        the features swish(norm_out(h))."""
        h = _mid_apply(self.mid, conv(self.conv_in, z), zq)
        for i in reversed(range(len(self.up))):
            h = _level_apply(self.up[i], h, zq)
        return _swish(normalize(self.norm_out, h, zq))

    def forward(self, z, zq=None):
        return conv(self.conv_out, self.body(z, zq))



# ---------------------------------------------------------------------------
# model shells (vqgan.py:266-331; reference sgm/models/vqgan.py:19-392)
# ---------------------------------------------------------------------------
@register(alias="sgm.models.vqgan.VQModel")
class VQModel(nn.Module):
    """VQGAN: encoder -> 1x1 quant_conv -> nearest-code VQ (straight-through)
    -> 1x1 post_quant_conv -> decoder; NCHW.  Trainable (the
    AutoencoderTrainer takes trainer_parts())."""

    movq = False

    def __init__(self, ddconfig: Dict, n_embed: int, embed_dim: int, beta: float = 0.25,
                 device=None, **_):
        super().__init__()
        # the VQ path: quant_conv takes z_channels, so no doubled moments head
        self.ddconfig = dict(ddconfig, double_z=False)
        self.n_embed, self.embed_dim, self.beta = n_embed, embed_dim, beta
        z = self.ddconfig["z_channels"]
        self.encoder = Encoder(**self.ddconfig, device=device)
        self.decoder = Decoder(**dict(self.ddconfig, zq_ch=embed_dim if self.movq else None),
                               device=device)
        self.quantize = VectorQuantizer(n_embed, embed_dim, beta=beta, device=device)
        self.quant_conv = nn.Conv2d(z, embed_dim, 1, device=device)
        self.post_quant_conv = nn.Conv2d(embed_dim, z, 1, device=device)

    def init_random_(self, generator: torch.Generator, device=None):
        """torch's default conv init U(+-1/sqrt(fan_in)) for weights and
        biases, norms one and zero, the codebook U(-1/n_embed, 1/n_embed), as
        VQModel.init_params draws them."""
        init_random_(self, generator, device=device)
        self.quantize.init_random_(generator)
        return self

    def encode(self, x):
        """x (b, 3, H, W) -> (quant, vq loss, indices (b, h, w))."""
        h = conv(self.quant_conv, self.encoder(x))
        quant, log = self.quantize(h)
        return quant, log["loss/vq"], log["min_encoding_indices"]

    def decode(self, quant):
        return self.decoder(conv(self.post_quant_conv, quant), quant if self.movq else None)

    def decode_code(self, code_b):
        """(b, h, w) codebook indices -> the reconstruction."""
        return self.decode(self.quantize.get_codebook_entry(code_b))

    def forward(self, x):
        quant, diff, _ = self.encode(x)
        return self.decode(quant), diff

    def codebook_stats(self, x):
        _, _, idx = self.encode(x)
        return measure_perplexity(idx.reshape(-1), self.n_embed)

    def trainer_parts(self) -> Dict[str, nn.Module]:
        """The AutoencoderTrainer's encoder, regularizer, decoder body and
        decoder head over this model's modules (the head is decoder.conv_out,
        the reference's get_last_layer)."""
        return {"encoder": _VQEncode(self.encoder, self.quant_conv),
                "regularizer": self.quantize,
                "decoder_body": _VQDecodeBody(self.post_quant_conv, self.decoder, self.movq),
                "decoder_head": self.decoder.conv_out}


class _VQEncode(nn.Module):
    def __init__(self, encoder, quant_conv):
        super().__init__()
        self.encoder, self.quant_conv = encoder, quant_conv

    def forward(self, x):
        return conv(self.quant_conv, self.encoder(x))


class _VQDecodeBody(nn.Module):
    def __init__(self, post_quant_conv, decoder, movq):
        super().__init__()
        self.post_quant_conv, self.decoder, self.movq = post_quant_conv, decoder, movq

    def forward(self, quant):
        return self.decoder.body(conv(self.post_quant_conv, quant), quant if self.movq else None)


@register(alias="sgm.models.vqgan.MOVQ")
class MOVQ(VQModel):
    """MoVQ: a VQModel whose decoder's every norm is modulated by the quantized
    latent (decoder(quant2, quant), reference vqgan.py:94-97)."""

    movq = True
