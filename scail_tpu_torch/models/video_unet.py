"""The SVD spatio-temporal video UNet on PyTorch (counterpart of
scail_tpu/models/video_unet.py).

AlphaBlender, VideoTransformerBlock, SpatialVideoTransformer,
VideoResBlock and VideoUNet, built on the 2-D UNet's blocks
(models/unet.py: ResBlock, SpatialTransformer, CrossAttention, FeedForward,
Downsample / Upsample and `unet_plan`).  Frames are folded into the batch:
x is (B*T, C, H, W) and `num_video_frames` is T.  The temporal stacks
reshape to (B, C, T, H, W) around their 3-D convolutions and to (B*H*W, T,
C) around their time attention.

The modules carry sgm's names (`input_blocks.N.M.time_stack.*`,
`.time_mixer.mix_factor`, `.time_pos_embed.{0,2}`, ...), so an SVD state
dict loads as it is (`video_unet_state_dict_from_sgm` checks and picks its
keys).  It computes in f32, as the JAX model and the 2-D UNet do; no TPU
kernel lies on it (XLA in JAX: einsum attention, convolutions).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from scail_tpu_torch.models.common import dense, silu, timestep_embedding
from scail_tpu_torch.models.unet import (CrossAttention, Downsample,
                                         FeedForward, ResBlock, SpatialTransformer, UNetModel,
                                         Upsample, _conv2d, _group_norm, _layer_norm, conv,
                                         group_norm, init_random_, unet_plan)
from scail_tpu_torch.utils.registry import register


class AlphaBlender(nn.Module):
    """alpha * spatial + (1 - alpha) * temporal; alpha the fixed factor,
    sigmoid of the learned one, or 1 on image-only frames
    (learned_with_images)."""

    def __init__(self, alpha: float, merge_strategy: str = "fixed", device=None):
        super().__init__()
        if merge_strategy not in ("fixed", "learned", "learned_with_images"):
            raise ValueError(f"merge_strategy {merge_strategy!r}")
        self.merge_strategy, self.alpha = merge_strategy, float(alpha)
        self.mix_factor = nn.Parameter(torch.full((1,), self.alpha, device=device),
                                       requires_grad=False)

    def forward(self, x_spatial, x_temporal, image_only_indicator=None):
        """Token space: inputs (B*T, S, C); else (B, C, T, H, W).  The
        indicator is (B, T)."""
        if self.merge_strategy == "fixed":
            alpha = self.mix_factor
        elif self.merge_strategy == "learned":
            alpha = torch.sigmoid(self.mix_factor)
        else:
            if image_only_indicator is None:
                raise ValueError("learned_with_images needs image_only_indicator")
            alpha = torch.where(image_only_indicator.bool(),
                                torch.ones((), dtype=x_spatial.dtype, device=x_spatial.device),
                                torch.sigmoid(self.mix_factor).to(x_spatial.dtype))
            alpha = (alpha.reshape(-1, 1, 1) if x_spatial.dim() == 3
                     else alpha[:, None, :, None, None])
        alpha = alpha.to(x_spatial.dtype)
        return alpha * x_spatial + (1.0 - alpha) * x_temporal


class VideoTransformerBlock(nn.Module):
    """Attention over time at every token position (inner == dim)."""

    def __init__(self, dim, n_heads, d_head, context_dim=None, ff_in=False,
                 disable_self_attn=False, disable_temporal_crossattention=False, device=None):
        super().__init__()
        inner = n_heads * d_head
        if inner != dim:
            raise ValueError("the VideoUNet builds its time blocks at inner == dim")
        self.disable_self_attn = disable_self_attn
        if ff_in:
            self.norm_in = nn.LayerNorm(dim, device=device)
            self.ff_in = FeedForward(dim, device=device)
        self.attn1 = CrossAttention(inner, context_dim if disable_self_attn else None, n_heads,
                                    d_head, device)
        self.ff = FeedForward(inner, device=device)
        self.norm1 = nn.LayerNorm(inner, device=device)
        if not disable_temporal_crossattention:
            self.norm2 = nn.LayerNorm(inner, device=device)
            self.attn2 = CrossAttention(inner, context_dim, n_heads, d_head, device)
        self.norm3 = nn.LayerNorm(inner, device=device)

    def forward(self, x, context=None, timesteps: int = 1):
        bt, s, c = x.shape
        b = bt // timesteps
        x = x.reshape(b, timesteps, s, c).transpose(1, 2).reshape(b * s, timesteps, c)
        if hasattr(self, "ff_in"):
            x = self.ff_in(_layer_norm(self.norm_in, x)) + x
        x = self.attn1(_layer_norm(self.norm1, x),
                       context if self.disable_self_attn else None) + x
        if hasattr(self, "attn2"):
            x = self.attn2(_layer_norm(self.norm2, x), context) + x
        x = self.ff(_layer_norm(self.norm3, x)) + x
        return x.reshape(b, s, timesteps, c).transpose(1, 2).reshape(bt, s, c)


class SpatialVideoTransformer(SpatialTransformer):
    def __init__(self, c_in, n_heads, d_head, depth=1, context_dim=None, time_context_dim=None,
                 ff_in=False, use_spatial_context=False, merge_factor=0.5,
                 merge_strategy="fixed", max_time_embed_period=10000, use_linear=False,
                 disable_self_attn=False, disable_temporal_crossattention=False, device=None):
        super().__init__(c_in, n_heads, d_head, depth, context_dim, disable_self_attn,
                         use_linear, device)
        inner = n_heads * d_head
        if use_spatial_context:
            time_context_dim = context_dim
        self.use_spatial_context = use_spatial_context
        self.max_time_embed_period = max_time_embed_period
        self.time_stack = nn.ModuleList([VideoTransformerBlock(
            inner, n_heads, d_head, time_context_dim, ff_in, disable_self_attn,
            disable_temporal_crossattention, device) for _ in range(depth)])
        self.time_pos_embed = nn.Sequential(nn.Linear(c_in, 4 * c_in, device=device), nn.SiLU(),
                                            nn.Linear(4 * c_in, c_in, device=device))
        self.time_mixer = AlphaBlender(merge_factor, merge_strategy, device)

    def forward(self, x, emb=None, context=None, time_context=None, timesteps: int = 1,
                image_only_indicator=None):
        bt, c, hh, ww = x.shape
        x_in = x
        if self.use_spatial_context:
            # the first frame's context, for every spatial position
            time_context = context[::timesteps].repeat_interleave(hh * ww, dim=0)
        elif time_context is not None:
            time_context = time_context.repeat_interleave(hh * ww, dim=0)
            if time_context.dim() == 2:
                time_context = time_context[:, None]
        x = group_norm(self.norm, x)
        if not self.use_linear:
            x = conv(self.proj_in, x)
        x = x.flatten(2).transpose(1, 2)
        if self.use_linear:
            x = dense(self.proj_in, x)
        frames = torch.arange(timesteps, device=x.device).repeat(bt // timesteps)
        t_emb = timestep_embedding(frames, c, max_period=self.max_time_embed_period,
                                   dtype=x.dtype)
        emb = dense(self.time_pos_embed[2], silu(dense(self.time_pos_embed[0], t_emb)))[:, None]
        for blk, mix in zip(self.transformer_blocks, self.time_stack):
            x = blk(x, context)
            x_mix = mix(x + emb, time_context, timesteps)
            x = self.time_mixer(x, x_mix, image_only_indicator)
        if self.use_linear:
            x = dense(self.proj_out, x)
        x = x.transpose(1, 2).reshape(bt, -1, hh, ww)
        if not self.use_linear:
            x = conv(self.proj_out, x)
        return x + x_in


class VideoResBlock(ResBlock):
    """The 2-D ResBlock, then a 3-D one over (T, H, W) blended in."""

    def __init__(self, c_in, emb_ch, c_out=None, *, video_kernel_size=3, merge_factor=0.5,
                 merge_strategy="fixed", use_scale_shift_norm=False, up=False, down=False,
                 device=None):
        super().__init__(c_in, emb_ch, c_out, use_scale_shift_norm=use_scale_shift_norm, up=up,
                         down=down, device=device)
        c_out = c_out or c_in
        self.time_stack = ResBlock(c_out, emb_ch, c_out, dims=3, kernel_size=video_kernel_size,
                                   exchange_temb_dims=True, device=device)
        self.time_mixer = AlphaBlender(merge_factor, merge_strategy, device)

    def forward(self, x, emb, num_video_frames: int = 1, image_only_indicator=None):
        x = super().forward(x, emb)
        bt, c, hh, ww = x.shape
        b = bt // num_video_frames
        x5 = x.reshape(b, num_video_frames, c, hh, ww).transpose(1, 2)  # (b, c, t, h, w)
        mixed = self.time_stack(x5, emb.reshape(b, num_video_frames, -1))
        x5 = self.time_mixer(x5, mixed, image_only_indicator)
        return x5.transpose(1, 2).reshape(bt, c, hh, ww)


@register(alias=("sgm.modules.diffusionmodules.video_model.VideoUNet",))
class VideoUNet(nn.Module):
    """forward(x (B*T, C, H, W), timesteps (B*T,), context (B*T, S, D), y,
    time_context, num_video_frames=T, image_only_indicator (B, T))."""

    _label = UNetModel._label

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks: int, attention_resolutions, dropout: float = 0.0,
                 channel_mult=(1, 2, 4, 8), conv_resample: bool = True, dims: int = 2,
                 num_classes=None, use_checkpoint: bool = False, num_heads: int = -1,
                 num_head_channels: int = -1, num_heads_upsample: int = -1,
                 use_scale_shift_norm: bool = False, resblock_updown: bool = False,
                 transformer_depth=1, transformer_depth_middle: Optional[int] = None,
                 context_dim: Optional[int] = None, time_downup: bool = False,
                 time_context_dim: Optional[int] = None, extra_ff_mix_layer: bool = False,
                 use_spatial_context: bool = False, merge_strategy: str = "fixed",
                 merge_factor: float = 0.5, video_kernel_size=3,
                 use_linear_in_transformer: bool = False, adm_in_channels: Optional[int] = None,
                 disable_temporal_crossattention: bool = False,
                 max_ddpm_temb_period: int = 10000, dtype: str = "fp32", device=None,
                 **_ignored):
        super().__init__()
        if context_dim is None:
            raise ValueError("the VideoUNet needs context_dim")
        if dims != 2:
            raise NotImplementedError("only dims=2 exists in the config zoo")
        if num_heads == -1 and num_head_channels == -1:
            raise ValueError("set num_heads or num_head_channels")
        if dropout:
            raise NotImplementedError("dropout > 0: the port's VideoUNet serves inference only")
        self.in_channels, self.model_channels = in_channels, model_channels
        self.out_channels, self.num_classes = out_channels, num_classes
        self.adm_in_channels = adm_in_channels
        self.use_linear_in_transformer = use_linear_in_transformer
        ted = self.time_embed_dim = model_channels * 4
        # the JAX model's plan: the 2-D UNet's with spatial transformers,
        # heads = ch // num_head_channels (legacy off)
        self.plan = unet_plan(in_channels, model_channels, num_res_blocks,
                              attention_resolutions, channel_mult, conv_resample, num_heads,
                              num_head_channels, num_heads_upsample, resblock_updown,
                              use_spatial_transformer=True, transformer_depth=transformer_depth,
                              context_dim=context_dim, legacy=False,
                              transformer_depth_middle=transformer_depth_middle)

        def layer(spec):
            kind = spec["kind"]
            if kind == "in_conv":
                return _conv2d(in_channels, model_channels, 3, device)
            if kind == "res":
                return VideoResBlock(spec["c_in"], ted, spec["c_out"],
                                     video_kernel_size=video_kernel_size,
                                     merge_factor=merge_factor, merge_strategy=merge_strategy,
                                     use_scale_shift_norm=use_scale_shift_norm, up=spec["up"],
                                     down=spec["down"], device=device)
            if kind == "st":
                return SpatialVideoTransformer(
                    spec["ch"], spec["heads"], spec["dim_head"], spec["depth"], context_dim,
                    time_context_dim, extra_ff_mix_layer, use_spatial_context, merge_factor,
                    merge_strategy, max_ddpm_temb_period, use_linear_in_transformer,
                    disable_temporal_crossattention=disable_temporal_crossattention,
                    device=device)
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
        """The 2-D UNet's random init; each AlphaBlender holds merge_factor."""
        init_random_(self, generator, zero_modules, device)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, AlphaBlender):
                    m.mix_factor.fill_(m.alpha)
        return self

    def forward(self, x, timesteps, context=None, y=None, time_context=None,
                num_video_frames: Optional[int] = None, image_only_indicator=None):
        if (y is not None) != (self.num_classes is not None):
            raise ValueError("y must be given exactly when the model is class-conditional")
        if not num_video_frames:
            raise ValueError("num_video_frames is required")
        t_emb = timestep_embedding(timesteps, self.model_channels, dtype=x.dtype)
        emb = dense(self.time_embed[2], silu(dense(self.time_embed[0], t_emb)))
        if self.num_classes is not None:
            emb = emb + self._label(y, emb.dtype)

        def apply(layer, h):
            if isinstance(layer, VideoResBlock):
                return layer(h, emb, num_video_frames, image_only_indicator)
            if isinstance(layer, SpatialVideoTransformer):
                return layer(h, None, context, time_context, num_video_frames,
                             image_only_indicator)
            if isinstance(layer, nn.Conv2d):
                return conv(layer, h)
            return layer(h)

        hs, h = [], x
        for blk in self.input_blocks:
            for layer in blk:
                h = apply(layer, h)
            hs.append(h)
        for layer in self.middle_block:
            h = apply(layer, h)
        for blk in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=1)
            for layer in blk:
                h = apply(layer, h)
        h = silu(group_norm(self.out[0], h.to(x.dtype)))
        return conv(self.out[2], h)


def video_unet_state_dict_from_sgm(sd: Dict, model: VideoUNet) -> Dict[str, torch.Tensor]:
    """An sgm VideoUNet state dict (the keys of `model.diffusion_model.` with
    that prefix stripped) -> `model`'s state dict, f32: the same names,
    each checked against the model's shape (counterpart of
    `video_unet_params_from_torch`).  A missing key or a wrong shape
    raises; keys the model does not hold are ignored."""
    out = {}
    for name, want in model.state_dict().items():
        if name not in sd:
            raise KeyError(f"the state dict lacks {name}")
        t = torch.as_tensor(sd[name]).float()
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the model's {tuple(want.shape)}")
        out[name] = t
    return out
