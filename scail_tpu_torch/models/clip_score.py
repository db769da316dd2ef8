"""Full CLIP (vision + text towers + projections) for the CLIP score, on
PyTorch (counterpart of scail_tpu/models/clip_score.py).

The reference scores with open_clip ViT-g-14 (eval/eval_clip_score.py:
46-100); the aesthetic score runs on openai ViT-L/14 and HPSv2 on a
fine-tuned open_clip ViT-H-14.  Semantics are HF transformers' CLIPModel:
pre-LN blocks with biased projections, the causal mask on the text tower,
EOS pooling (the first position holding eos_token_id), class-token pooling
and a post-LN on the vision tower, bias-free projections.  Attention is the
JAX function's math: products, then an f32 softmax.

The module's state_dict names are HF's (`vision_model.encoder.layers.{i}.
self_attn.q_proj.weight`, ...), so an HF checkpoint loads as it is;
`clip_state_dict_from_open_clip` maps the open_clip layout (fused qkv
`in_proj`, `resblocks`, `visual.proj`) onto those names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.common import (container, dense, gelu_exact, linear, parameter,
                                           quick_gelu, random_init_)
from scail_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class ClipScoreConfig:
    # ViT-g-14 (open_clip) geometry by default
    vision_width: int = 1408
    vision_layers: int = 40
    vision_heads: int = 16
    vision_mlp: int = 6144
    image_size: int = 224
    patch_size: int = 14
    text_width: int = 1024
    text_layers: int = 24
    text_heads: int = 16
    text_mlp: int = 4096
    vocab_size: int = 49408
    context_length: int = 77
    embed_dim: int = 1024
    hidden_act: str = "gelu"     # laion models; openai CLIP uses quick_gelu
    eos_token_id: int = 49407
    eps: float = 1e-5
    dtype: str = "float32"

    @property
    def compute_dtype(self):
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    @classmethod
    def vit_g14(cls, **kw) -> "ClipScoreConfig":
        """open_clip ViT-g-14 (the reference CLIP-score model)."""
        return cls(**kw)

    @classmethod
    def vit_l14(cls, **kw) -> "ClipScoreConfig":
        """openai CLIP ViT-L/14, the LAION aesthetic-score backbone
        (eval/eval_aes.py loads clip.load('ViT-L/14'))."""
        return cls(**{**dict(vision_width=1024, vision_layers=24, vision_heads=16,
                             vision_mlp=4096, text_width=768, text_layers=12, text_heads=12,
                             text_mlp=3072, embed_dim=768, hidden_act="quick_gelu"), **kw})

    @classmethod
    def vit_h14(cls, **kw) -> "ClipScoreConfig":
        """open_clip ViT-H-14, the HPSv2 backbone (eval/eval_hps.py:57-69
        loads CLIP-ViT-H-14-laion2B-s32B-b79K + the HPS_v2 fine-tune)."""
        return cls(**{**dict(vision_width=1280, vision_layers=32, vision_heads=16,
                             vision_mlp=5120, text_width=1024, text_layers=24, text_heads=16,
                             text_mlp=4096, embed_dim=1024), **kw})


def _ln(d, device):
    return container(weight=parameter(d, fill=1.0, device=device),
                     bias=parameter(d, fill=0.0, device=device))


def _encoder(d, mlp, layers, device) -> nn.Module:
    def layer():
        return container(
            layer_norm1=_ln(d, device), layer_norm2=_ln(d, device),
            self_attn=container(**{n: linear(d, d, device=device)
                                   for n in ("q_proj", "k_proj", "v_proj", "out_proj")}),
            mlp=container(fc1=linear(d, mlp, device=device), fc2=linear(mlp, d, device=device)))

    return container(layers=nn.ModuleList([layer() for _ in range(layers)]))


class ClipScoreModel(nn.Module):
    """Both towers and their projections; `image_embed` and `text_embed`
    return the unnormalised (b, embed_dim) embeddings."""

    def __init__(self, cfg: ClipScoreConfig, device=None):
        super().__init__()
        self.cfg = cfg
        vd, td, p = cfg.vision_width, cfg.text_width, cfg.patch_size
        n_patches = (cfg.image_size // p) ** 2
        self.vision_model = container(
            embeddings=container(
                class_embedding=parameter(vd, device=device),
                patch_embedding=nn.Conv2d(3, vd, p, stride=p, bias=False, device=device),
                position_embedding=nn.Embedding(n_patches + 1, vd, device=device)),
            pre_layrnorm=_ln(vd, device),  # HF's attribute is spelled so
            encoder=_encoder(vd, cfg.vision_mlp, cfg.vision_layers, device),
            post_layernorm=_ln(vd, device))
        self.text_model = container(
            embeddings=container(
                token_embedding=nn.Embedding(cfg.vocab_size, td, device=device),
                position_embedding=nn.Embedding(cfg.context_length, td, device=device)),
            encoder=_encoder(td, cfg.text_mlp, cfg.text_layers, device),
            final_layer_norm=_ln(td, device))
        self.visual_projection = linear(vd, cfg.embed_dim, bias=False, device=device)
        self.text_projection = linear(td, cfg.embed_dim, bias=False, device=device)
        self.eval()
        self.requires_grad_(False)

    def init_random_(self, generator: torch.Generator, std: float = 0.02):
        """Random-init smoke mode, as init_clip_params draws it: every weight
        and embedding N(0, std), biases 0, LayerNorm scales 1."""
        random_init_(self, generator, std)
        with torch.no_grad():
            for name, prm in self.named_parameters():
                if name.endswith("weight") and ("layer_norm" in name or "layrnorm" in name
                                                or "layernorm" in name):
                    prm.fill_(1.0)
        return self

    def _block(self, x, p, nh, mask_bias=None):
        """HF CLIPEncoderLayer: pre-LN attention + pre-LN MLP."""
        cfg = self.cfg
        b, s, d = x.shape
        hd = d // nh
        y = layer_norm(x, p.layer_norm1.weight, p.layer_norm1.bias, eps=cfg.eps)
        a = p.self_attn
        q, k, v = (dense(lin, y).reshape(b, s, nh, hd) for lin in (a.q_proj, a.k_proj, a.v_proj))
        logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * (hd ** -0.5)
        if mask_bias is not None:
            logits = logits + mask_bias
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, s, d)
        x = x + dense(a.out_proj, o)
        y = layer_norm(x, p.layer_norm2.weight, p.layer_norm2.bias, eps=cfg.eps)
        act = gelu_exact if cfg.hidden_act == "gelu" else quick_gelu
        return x + dense(p.mlp.fc2, act(dense(p.mlp.fc1, y)))

    def image_embed(self, images):
        """images: (b, 3, H, W), CLIP-normalised -> (b, embed_dim)."""
        cfg, vm = self.cfg, self.vision_model
        cdtype = cfg.compute_dtype
        emb = vm.embeddings
        x = F.conv2d(images.to(cdtype), emb.patch_embedding.weight.to(cdtype),
                     stride=cfg.patch_size)
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # (b, patches, width), row-major patches
        cls = emb.class_embedding.to(cdtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight.to(cdtype)[None]
        x = layer_norm(x, vm.pre_layrnorm.weight, vm.pre_layrnorm.bias, eps=cfg.eps)
        for p in vm.encoder.layers:
            x = self._block(x, p, cfg.vision_heads)
        pooled = layer_norm(x[:, 0], vm.post_layernorm.weight, vm.post_layernorm.bias,
                            eps=cfg.eps)
        return dense(self.visual_projection, pooled)

    def text_embed(self, ids):
        """ids: (b, S) int, padded to context_length -> (b, embed_dim)."""
        cfg, tm = self.cfg, self.text_model
        cdtype = cfg.compute_dtype
        b, s = ids.shape
        x = tm.embeddings.token_embedding.weight[ids].to(cdtype)
        x = x + tm.embeddings.position_embedding.weight.to(cdtype)[None, :s]
        causal = torch.full((s, s), float("-inf"), device=x.device).triu(1)[None, None]
        for p in tm.encoder.layers:
            x = self._block(x, p, cfg.text_heads, mask_bias=causal)
        x = layer_norm(x, tm.final_layer_norm.weight, tm.final_layer_norm.bias, eps=cfg.eps)
        # EOS pooling: the first position equal to eos_token_id (HF CLIP)
        eos_pos = (ids == cfg.eos_token_id).int().argmax(dim=-1)
        return dense(self.text_projection, x[torch.arange(b, device=x.device), eos_pos])


def clip_state_dict_from_hf(sd: Mapping[str, torch.Tensor],
                            model: ClipScoreModel) -> Dict[str, torch.Tensor]:
    """The tensors of an HF CLIPModel state dict that the model holds (its
    `logit_scale` and position-id buffers are not part of the towers); a
    missing one raises and names it."""
    missing = [k for k in model.state_dict() if k not in sd]
    if missing:
        raise KeyError(f"HF CLIP state dict lacks {len(missing)} tensors, e.g. {missing[:3]}")
    return {k: sd[k] for k in model.state_dict()}


def clip_state_dict_from_open_clip(sd: Mapping[str, torch.Tensor],
                                   cfg: ClipScoreConfig) -> Dict[str, torch.Tensor]:
    """An open_clip CLIP state dict (the reference's scoring checkpoints and
    HPS_v2*.pt['state_dict']) under the model's HF names: the fused
    attn.in_proj_{weight,bias} split into q / k / v, (visual.)transformer.
    resblocks.{i} with ln_1 / ln_2 and mlp.c_fc / c_proj, the (width,
    embed) projections transposed to nn.Linear's (embed, width)."""
    out = {}

    def tower(src, dst, layers):
        for i in range(layers):
            s, d = f"{src}transformer.resblocks.{i}.", f"{dst}.encoder.layers.{i}."
            for part, w, b in zip(("q_proj", "k_proj", "v_proj"),
                                  sd[s + "attn.in_proj_weight"].chunk(3, dim=0),
                                  sd[s + "attn.in_proj_bias"].chunk(3, dim=0)):
                out[d + f"self_attn.{part}.weight"], out[d + f"self_attn.{part}.bias"] = w, b
            for a, b in (("attn.out_proj", "self_attn.out_proj"), ("ln_1", "layer_norm1"),
                         ("ln_2", "layer_norm2"), ("mlp.c_fc", "mlp.fc1"),
                         ("mlp.c_proj", "mlp.fc2")):
                out[d + b + ".weight"], out[d + b + ".bias"] = sd[s + a + ".weight"], \
                    sd[s + a + ".bias"]

    tower("visual.", "vision_model", cfg.vision_layers)
    tower("", "text_model", cfg.text_layers)
    for a, b in (("visual.ln_pre", "vision_model.pre_layrnorm"),
                 ("visual.ln_post", "vision_model.post_layernorm"),
                 ("ln_final", "text_model.final_layer_norm")):
        out[b + ".weight"], out[b + ".bias"] = sd[a + ".weight"], sd[a + ".bias"]
    out.update({
        "vision_model.embeddings.class_embedding": sd["visual.class_embedding"],
        "vision_model.embeddings.patch_embedding.weight": sd["visual.conv1.weight"],
        "vision_model.embeddings.position_embedding.weight": sd["visual.positional_embedding"],
        "text_model.embeddings.token_embedding.weight": sd["token_embedding.weight"],
        "text_model.embeddings.position_embedding.weight": sd["positional_embedding"],
        "visual_projection.weight": sd["visual.proj"].t(),
        "text_projection.weight": sd["text_projection"].t(),
    })
    return out


def load_clip_score_state_dict(model: ClipScoreModel, sd: Mapping[str, torch.Tensor]):
    """An HF or open_clip state dict (told apart by `visual.conv1.weight`)
    into `model`, strict."""
    if "visual.conv1.weight" in sd:
        mapped = clip_state_dict_from_open_clip(sd, model.cfg)
    else:
        mapped = clip_state_dict_from_hf(sd, model)
    model.load_state_dict({k: v.contiguous() for k, v in mapped.items()}, strict=True)
    return model
