"""The SD-family UNet on PyTorch (counterpart of scail_tpu/models/unet.py).

UNetModel with ResBlocks (optionally scale-shift normed, optionally up- or
down-sampling), the conv-UNet AttentionBlock in both QKV orders, and the
SpatialTransformer (conv or linear projections, GEGLU feed-forward,
self- and cross-attention); NoTimeUNetModel zeroes its timesteps.

Layout NCHW.  The modules carry the reference's names (`input_blocks.N.M.*`,
`middle_block.M.*`, `output_blocks.N.M.*`, `time_embed.{0,2}`,
`label_emb.*`, `out.{0,2}`), so a released SD / SDXL state dict loads as it
is.  The block plan is the JAX model's, derived from the config as the
reference's constructor derives its ModuleLists.  The JAX model computes in
f32 (the YAMLs' dtype) and so does this one: weights are cast to the input's
dtype, GroupNorm statistics are f32 (eps 1e-5, 1e-6 in the
SpatialTransformer), attention is `scaled_dot_product_attention` (the JAX
model's attention is XLA einsum + softmax, not a Pallas kernel).

As in the JAX `attention_block`, the conv-UNet AttentionBlock holds a `norm`
but does not apply it before its qkv projection.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.common import dense, silu, timestep_embedding
from scail_tpu_torch.ops.norms import layer_norm
from scail_tpu_torch.utils.registry import register


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def group_norm(norm: nn.GroupNorm, x):
    """GroupNorm with f32 statistics, the result in x's dtype."""
    y = F.group_norm(x.float(), norm.num_groups, norm.weight.float(), norm.bias.float(),
                     norm.eps)
    return y.to(x.dtype)


def _layer_norm(norm: nn.LayerNorm, x):
    return layer_norm(x, norm.weight, norm.bias, eps=norm.eps)


def conv(layer: nn.Conv2d, x):
    """The layer's convolution (1-D, 2-D or 3-D) with its weights in x's dtype."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    fn = {nn.Conv1d: F.conv1d, nn.Conv2d: F.conv2d, nn.Conv3d: F.conv3d}[type(layer)]
    return fn(x, layer.weight.to(x.dtype), bias, stride=layer.stride, padding=layer.padding)


def attention(q, k, v):
    """softmax(q k^T / sqrt(d)) v over (b, heads, s, d)."""
    return F.scaled_dot_product_attention(q, k, v)


def _zero(module: nn.Module) -> nn.Module:
    """Mark a module whose random init is zero (the reference's zero_module)."""
    module.zero_init = True
    return module


def _conv2d(c_in, c_out, k, device, stride=1, zero=False, dims=2):
    """A dims-D convolution with 'same' padding; k an int or one size a dim."""
    k = (k,) * dims if isinstance(k, int) else tuple(k)
    cls = {2: nn.Conv2d, 3: nn.Conv3d}[dims]
    layer = cls(c_in, c_out, k, stride=stride, padding=tuple(d // 2 for d in k), device=device)
    return _zero(layer) if zero else layer


def _group_norm(c, device, eps=1e-5):
    return nn.GroupNorm(32, c, eps=eps, device=device)


def nearest_up(x):
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def avg_down(x):
    return F.avg_pool2d(x, 2, 2)


def init_random_(module: nn.Module, generator: torch.Generator, zero_modules: bool = True,
                 device=None):
    """Random weights as the JAX init draws them: convolutions and linears
    U(+-1/sqrt(fan_in)) (torch's default), zero where marked zero_init (when
    `zero_modules`), norms one and zero, embeddings N(0, 1).  A module on the
    meta device is first made on `device` (the generator's by default); the
    parameters are drawn one at a time in named_modules order."""
    device = device or generator.device
    if any(p.is_meta for p in module.parameters()):
        module.to_empty(device=device)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)):
                if zero_modules and getattr(m, "zero_init", False):
                    for p in m.parameters(recurse=False):
                        p.zero_()
                    continue
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0, generator=generator)
    return module


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
class ResBlock(nn.Module):
    """dims 3 (the VideoResBlock's time stack): x (b, c, t, h, w), convolutions
    of `kernel_size`; with exchange_temb_dims, emb is (b, t, emb_ch) and its
    projection broadcasts over (h, w) of each frame."""

    def __init__(self, c_in, emb_ch, c_out=None, *, use_scale_shift_norm=False, up=False,
                 down=False, dims=2, kernel_size=3, exchange_temb_dims=False, device=None):
        super().__init__()
        c_out = c_out or c_in
        self.use_scale_shift_norm, self.up, self.down = use_scale_shift_norm, up, down
        self.exchange_temb_dims = exchange_temb_dims
        self.in_layers = nn.Sequential(_group_norm(c_in, device), nn.SiLU(),
                                       _conv2d(c_in, c_out, kernel_size, device, dims=dims))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_ch, 2 * c_out if use_scale_shift_norm else c_out,
                                 device=device))
        self.out_layers = nn.Sequential(
            _group_norm(c_out, device), nn.SiLU(), nn.Dropout(0.0),
            _conv2d(c_out, c_out, kernel_size, device, zero=True, dims=dims))
        self.skip_connection = (nn.Identity() if c_out == c_in
                                else _conv2d(c_in, c_out, 1, device, dims=dims))

    def forward(self, x, emb):
        h = silu(group_norm(self.in_layers[0], x))
        if self.up:
            h, x = nearest_up(h), nearest_up(x)
        elif self.down:
            h, x = avg_down(h), avg_down(x)
        h = conv(self.in_layers[2], h)
        emb_out = dense(self.emb_layers[1], silu(emb)).to(h.dtype)
        if self.exchange_temb_dims:
            emb_out = emb_out.transpose(1, 2)  # (b, t, c) -> (b, c, t)
        while emb_out.dim() < h.dim():
            emb_out = emb_out[..., None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = silu(group_norm(self.out_layers[0], h) * (1 + scale) + shift)
        else:
            h = silu(group_norm(self.out_layers[0], h + emb_out))
        h = conv(self.out_layers[3], h)
        skip = x if isinstance(self.skip_connection, nn.Identity) else conv(self.skip_connection, x)
        return skip + h


class AttentionBlock(nn.Module):
    """Full self-attention over the spatial positions.  legacy_order: heads
    split before q/k/v (QKVAttentionLegacy); else q, k, v each over all heads
    (QKVAttention)."""

    def __init__(self, c, num_heads, legacy_order, device=None):
        super().__init__()
        self.num_heads, self.legacy_order = num_heads, legacy_order
        self.norm = _group_norm(c, device)
        self.qkv = nn.Conv1d(c, 3 * c, 1, device=device)
        self.proj_out = _zero(nn.Conv1d(c, c, 1, device=device))

    def forward(self, x, emb=None, context=None):
        b, c, hh, ww = x.shape
        xs = x.reshape(b, c, hh * ww)
        qkv = conv(self.qkv, xs)  # (b, 3c, t)
        heads, ch = self.num_heads, c // self.num_heads
        if self.legacy_order:
            q, k, v = qkv.reshape(b, heads, 3 * ch, -1).split(ch, dim=2)
        else:
            q, k, v = (t.reshape(b, heads, ch, -1) for t in qkv.chunk(3, dim=1))
        h = attention(*(t.transpose(2, 3) for t in (q, k, v)))  # (b, heads, t, ch)
        h = conv(self.proj_out, h.transpose(2, 3).reshape(b, c, -1))
        return (xs + h).reshape(b, c, hh, ww)


class CrossAttention(nn.Module):
    def __init__(self, query_dim, context_dim, heads, dim_head, device=None):
        super().__init__()
        context_dim = context_dim or query_dim
        inner = heads * dim_head
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False, device=device)
        self.to_k = nn.Linear(context_dim, inner, bias=False, device=device)
        self.to_v = nn.Linear(context_dim, inner, bias=False, device=device)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim, device=device), nn.Dropout(0.0))

    def forward(self, x, context=None):
        context = x if context is None else context
        b, s, _ = x.shape

        def split(t):
            return t.reshape(b, t.shape[1], self.heads, -1).transpose(1, 2)

        q, k, v = (split(dense(lin, src)) for lin, src in
                   ((self.to_q, x), (self.to_k, context), (self.to_v, context)))
        out = attention(q, k, v).transpose(1, 2).reshape(b, s, -1)
        return dense(self.to_out[0], out)


class GEGLU(nn.Module):
    def __init__(self, dim, inner, device=None):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner, device=device)

    def forward(self, x):
        h, gate = dense(self.proj, x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4, device=None):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.Sequential(GEGLU(dim, inner, device), nn.Dropout(0.0),
                                 nn.Linear(inner, dim, device=device))

    def forward(self, x):
        return dense(self.net[2], self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, n_heads, d_head, context_dim=None, disable_self_attn=False,
                 device=None):
        super().__init__()
        self.disable_self_attn = disable_self_attn
        self.attn1 = CrossAttention(dim, context_dim if disable_self_attn else None, n_heads,
                                    d_head, device)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head, device)
        self.ff = FeedForward(dim, device=device)
        for i in (1, 2, 3):
            setattr(self, f"norm{i}", nn.LayerNorm(dim, device=device))

    def forward(self, x, context=None):
        x = self.attn1(_layer_norm(self.norm1, x),
                       context if self.disable_self_attn else None) + x
        x = self.attn2(_layer_norm(self.norm2, x), context) + x
        return self.ff(_layer_norm(self.norm3, x)) + x


class SpatialTransformer(nn.Module):
    def __init__(self, c_in, n_heads, d_head, depth=1, context_dim=None,
                 disable_self_attn=False, use_linear=False, device=None):
        super().__init__()
        inner = n_heads * d_head
        if context_dim is not None and not isinstance(context_dim, (list, tuple)):
            context_dim = [context_dim]
        if context_dim is not None and len(context_dim) != depth:
            context_dim = depth * [context_dim[0]]
        context_dim = context_dim or [None] * depth
        self.use_linear = use_linear
        self.norm = _group_norm(c_in, device, eps=1e-6)
        if use_linear:
            self.proj_in = nn.Linear(c_in, inner, device=device)
            self.proj_out = _zero(nn.Linear(inner, c_in, device=device))
        else:
            self.proj_in = nn.Conv2d(c_in, inner, 1, device=device)
            self.proj_out = _zero(nn.Conv2d(inner, c_in, 1, device=device))
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, n_heads, d_head, context_dim[d], disable_self_attn,
                                  device) for d in range(depth)])

    def forward(self, x, emb=None, context=None):
        contexts = context if isinstance(context, list) else [context]
        b, _, hh, ww = x.shape
        x_in = x
        x = group_norm(self.norm, x)
        if not self.use_linear:
            x = conv(self.proj_in, x)
        x = x.flatten(2).transpose(1, 2)  # (b, hw, c)
        if self.use_linear:
            x = dense(self.proj_in, x)
        for i, blk in enumerate(self.transformer_blocks):
            x = blk(x, contexts[0 if len(contexts) == 1 else i])
        if self.use_linear:
            x = dense(self.proj_out, x)
        x = x.transpose(1, 2).reshape(b, -1, hh, ww)
        if not self.use_linear:
            x = conv(self.proj_out, x)
        return x + x_in


class Downsample(nn.Module):
    def __init__(self, c_in, c_out, use_conv, device=None):
        super().__init__()
        if use_conv:
            self.op = _conv2d(c_in, c_out, 3, device, stride=2)

    def forward(self, x, emb=None, context=None):
        return conv(self.op, x) if hasattr(self, "op") else avg_down(x)


class Upsample(nn.Module):
    def __init__(self, c_in, c_out, use_conv, device=None):
        super().__init__()
        if use_conv:
            self.conv = _conv2d(c_in, c_out, 3, device)

    def forward(self, x, emb=None, context=None):
        x = nearest_up(x)
        return conv(self.conv, x) if hasattr(self, "conv") else x


# ---------------------------------------------------------------------------
# UNetModel
# ---------------------------------------------------------------------------
def _heads_for(ch, num_heads, num_head_channels, use_spatial_transformer, legacy):
    """Heads and head width at `ch` channels, as the reference resolves them."""
    if num_head_channels == -1:
        heads, dim_head = num_heads, ch // num_heads
    else:
        heads, dim_head = ch // num_head_channels, num_head_channels
    if legacy:
        dim_head = ch // heads if use_spatial_transformer else num_head_channels
    return heads, dim_head


def unet_plan(in_channels, model_channels, num_res_blocks, attention_resolutions,
              channel_mult=(1, 2, 4, 8), conv_resample=True, num_heads=-1,
              num_head_channels=-1, num_heads_upsample=-1, resblock_updown=False,
              use_spatial_transformer=False, transformer_depth=1, context_dim=None, legacy=True,
              disable_self_attentions=None, num_attention_blocks=None,
              disable_middle_self_attn=False, transformer_depth_middle=None):
    """{input, middle, output, out_ch}: lists of layer specs per block, the
    JAX model's plan."""
    if num_heads_upsample == -1:
        num_heads_upsample = num_heads
    if isinstance(transformer_depth, int):
        transformer_depth = len(channel_mult) * [transformer_depth]
    if transformer_depth_middle is None:
        transformer_depth_middle = transformer_depth[-1]
    if isinstance(num_res_blocks, int):
        num_res_blocks = len(channel_mult) * [num_res_blocks]

    def attn_spec(ch, level, up, depth=None, disabled_sa=None):
        heads, dim_head = _heads_for(
            ch, num_heads_upsample if (up and not use_spatial_transformer) else num_heads,
            num_head_channels, use_spatial_transformer, legacy)
        if not use_spatial_transformer:
            return {"kind": "attn", "ch": ch, "heads": heads}
        if disabled_sa is None:
            disabled_sa = (disable_self_attentions[level]
                           if disable_self_attentions is not None else False)
        return {"kind": "st", "ch": ch, "heads": heads, "dim_head": dim_head,
                "depth": transformer_depth[level] if depth is None else depth,
                "disable_self_attn": disabled_sa}

    def res(c_in, c_out, up=False, down=False):
        return {"kind": "res", "c_in": c_in, "c_out": c_out, "up": up, "down": down}

    def with_attn(level, i):
        return num_attention_blocks is None or i < num_attention_blocks[level]

    inputs: List[List[dict]] = [[{"kind": "in_conv"}]]
    chans = [model_channels]
    ch, ds = model_channels, 1
    for level, mult in enumerate(channel_mult):
        for nr in range(num_res_blocks[level]):
            layers = [res(ch, mult * model_channels)]
            ch = mult * model_channels
            if ds in attention_resolutions and with_attn(level, nr):
                layers.append(attn_spec(ch, level, up=False))
            inputs.append(layers)
            chans.append(ch)
        if level != len(channel_mult) - 1:
            inputs.append([res(ch, ch, down=True)] if resblock_updown else
                          [{"kind": "down", "c_in": ch, "use_conv": conv_resample}])
            chans.append(ch)
            ds *= 2
    middle = [res(ch, ch), attn_spec(ch, len(channel_mult) - 1, False,
                                     transformer_depth_middle, disable_middle_self_attn),
              res(ch, ch)]
    outputs: List[List[dict]] = []
    for level, mult in list(enumerate(channel_mult))[::-1]:
        for i in range(num_res_blocks[level] + 1):
            layers = [res(ch + chans.pop(), model_channels * mult)]
            ch = model_channels * mult
            if ds in attention_resolutions and with_attn(level, i):
                layers.append(attn_spec(ch, level, up=True))
            if level and i == num_res_blocks[level]:
                layers.append(res(ch, ch, up=True) if resblock_updown else
                              {"kind": "up", "c_in": ch, "use_conv": conv_resample})
                ds //= 2
            outputs.append(layers)
    return {"input": inputs, "middle": middle, "output": outputs, "out_ch": ch}


@register(alias=("sgm.modules.diffusionmodules.openaimodel.UNetModel",))
class UNetModel(nn.Module):
    """SD-style 2-D UNet.  forward(x (b, c, H, W), timesteps (b,), context
    (b, S, context_dim), y): y the class labels or the adm vector of a
    class-conditional model."""

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks, attention_resolutions, dropout: float = 0.0,
                 channel_mult=(1, 2, 4, 8), conv_resample: bool = True, dims: int = 2,
                 num_classes=None, use_checkpoint: bool = False, num_heads: int = -1,
                 num_head_channels: int = -1, num_heads_upsample: int = -1,
                 use_scale_shift_norm: bool = False, resblock_updown: bool = False,
                 use_new_attention_order: bool = False, use_spatial_transformer: bool = False,
                 transformer_depth=1, context_dim=None, legacy: bool = True,
                 disable_self_attentions=None, num_attention_blocks=None,
                 disable_middle_self_attn: bool = False, use_linear_in_transformer: bool = False,
                 adm_in_channels: Optional[int] = None, transformer_depth_middle=None,
                 dtype: str = "fp32", device=None, **_ignored):
        super().__init__()
        if dims != 2:
            raise NotImplementedError("only 2-D UNets exist in the config zoo")
        if use_spatial_transformer != (context_dim is not None):
            raise ValueError("context_dim goes with use_spatial_transformer")
        if num_heads == -1 and num_head_channels == -1:
            raise ValueError("set num_heads or num_head_channels")
        if not isinstance(num_res_blocks, int) and len(num_res_blocks) != len(channel_mult):
            raise ValueError("num_res_blocks needs one entry per channel_mult level")
        if dropout:
            raise NotImplementedError("dropout > 0: the port's UNet serves inference only")
        self.in_channels, self.model_channels = in_channels, model_channels
        self.out_channels, self.num_classes = out_channels, num_classes
        self.adm_in_channels = adm_in_channels
        self.use_linear_in_transformer = use_linear_in_transformer
        self.context_dim = context_dim
        ted = self.time_embed_dim = model_channels * 4
        self.plan = unet_plan(in_channels, model_channels, num_res_blocks,
                              attention_resolutions, channel_mult, conv_resample, num_heads,
                              num_head_channels, num_heads_upsample, resblock_updown,
                              use_spatial_transformer, transformer_depth, context_dim, legacy,
                              disable_self_attentions, num_attention_blocks,
                              disable_middle_self_attn, transformer_depth_middle)

        def layer(spec):
            kind = spec["kind"]
            if kind == "in_conv":
                return _conv2d(in_channels, model_channels, 3, device)
            if kind == "res":
                return ResBlock(spec["c_in"], ted, spec["c_out"],
                                use_scale_shift_norm=use_scale_shift_norm, up=spec["up"],
                                down=spec["down"], device=device)
            if kind == "attn":
                return AttentionBlock(spec["ch"], spec["heads"], not use_new_attention_order,
                                      device)
            if kind == "st":
                return SpatialTransformer(spec["ch"], spec["heads"], spec["dim_head"],
                                          spec["depth"], context_dim, spec["disable_self_attn"],
                                          use_linear_in_transformer, device)
            cls = Downsample if kind == "down" else Upsample
            return cls(spec["c_in"], spec["c_in"], spec["use_conv"], device)

        def blocks(specs):
            return nn.ModuleList([nn.ModuleList([layer(s) for s in blk]) for blk in specs])

        self.time_embed = nn.Sequential(nn.Linear(model_channels, ted, device=device), nn.SiLU(),
                                        nn.Linear(ted, ted, device=device))
        if num_classes is not None:
            if isinstance(num_classes, int):
                self.label_emb = nn.Embedding(num_classes, ted, device=device)
            elif num_classes == "continuous":
                self.label_emb = nn.Linear(1, ted, device=device)
            elif num_classes in ("timestep", "sequential"):
                d_in = model_channels if num_classes == "timestep" else adm_in_channels
                mlp = nn.Sequential(nn.Linear(d_in, ted, device=device), nn.SiLU(),
                                    nn.Linear(ted, ted, device=device))
                # the reference's label_emb.1 (after its Timestep) / label_emb.0
                self.label_emb = (nn.Sequential(nn.Identity(), mlp) if num_classes == "timestep"
                                  else nn.Sequential(mlp))
            else:
                raise ValueError(f"num_classes {num_classes!r}")
        self.input_blocks = blocks(self.plan["input"])
        self.middle_block = nn.ModuleList([layer(s) for s in self.plan["middle"]])
        self.output_blocks = blocks(self.plan["output"])
        self.out = nn.Sequential(_group_norm(self.plan["out_ch"], device), nn.SiLU(),
                                 _conv2d(model_channels, out_channels, 3, device, zero=True))
        self.requires_grad_(False)
        self.eval()

    def init_random_(self, generator: torch.Generator, zero_modules: bool = True, device=None):
        return init_random_(self, generator, zero_modules, device)

    def _label(self, y, dtype):
        le = self.label_emb
        if isinstance(self.num_classes, int):
            return le.weight[y].to(dtype)
        if self.num_classes == "continuous":
            return dense(le, y.reshape(-1, 1).to(dtype))
        if self.num_classes == "timestep":
            z, mlp = timestep_embedding(y, self.model_channels, dtype=dtype), le[1]
        else:
            z, mlp = y.to(dtype), le[0]
        return dense(mlp[2], silu(dense(mlp[0], z)))

    @staticmethod
    def _layer(layer, h, emb, context):
        return layer(h, emb) if isinstance(layer, ResBlock) else (
            conv(layer, h) if isinstance(layer, nn.Conv2d) else layer(h, emb, context))

    def forward(self, x, timesteps, context=None, y=None):
        if (y is not None) != (self.num_classes is not None):
            raise ValueError("y must be given exactly when the model is class-conditional")
        t_emb = timestep_embedding(timesteps, self.model_channels, dtype=x.dtype)
        emb = dense(self.time_embed[2], silu(dense(self.time_embed[0], t_emb)))
        if self.num_classes is not None:
            emb = emb + self._label(y, emb.dtype)
        hs, h = [], x
        for blk in self.input_blocks:
            for layer in blk:
                h = self._layer(layer, h, emb, context)
            hs.append(h)
        for layer in self.middle_block:
            h = self._layer(layer, h, emb, context)
        for blk in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=1)
            for layer in blk:
                h = self._layer(layer, h, emb, context)
        h = silu(group_norm(self.out[0], h.to(x.dtype)))
        return conv(self.out[2], h)


@register(alias=("sgm.modules.diffusionmodules.openaimodel.NoTimeUNetModel",))
class NoTimeUNetModel(UNetModel):
    """Zeroes the timesteps before the forward."""

    def forward(self, x, timesteps, context=None, y=None):
        return super().forward(x, torch.zeros_like(timesteps), context, y)
