"""The SD-era conditioning embedders on PyTorch (counterpart of
scail_tpu/diffusion/embedders.py): the HF-CLIP text encoder, the open_clip
text encoders v1 / v2 and the ConcatTimestepEmbedderND size and score
conditioner.

One text tower, built on the CLIP blocks of models/clip_score.py (HF
CLIPTextModel names: `text_model.embeddings.*`, `text_model.encoder.layers.
{i}.*`, `text_model.final_layer_norm`, and `text_projection` for open_clip),
serves all three text embedders; each layer choice ('last', 'pooled',
'hidden' with layer_idx, 'penultimate') is a hidden state of one pass.  The
tower is made on the meta device and filled by `init` (random weights from a
generator, smoke mode) or `load_state_dict` (an HF CLIPTextModel or an
open_clip state dict, read with `load_torch_state_dict`).

Tokenizer: with a tokenizer path that exists, HF transformers' AutoTokenizer,
which must load (a directory that does not load raises; the JAX embedders
fall back to the hash tokenizer on any error); otherwise a deterministic
hash tokenizer over zlib.crc32 (evals/clip_score.py `hash_token_ids`; the
JAX one hashes with Python's `hash()`, which changes from process to
process).  HF CLIP pads with the EOS id, open_clip with 0.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from scail_tpu_torch.evals.clip_score import hash_token_ids
from scail_tpu_torch.models.clip_score import (ClipScoreConfig, _encoder, _ln, encoder_block,
                                               open_clip_tower)
from scail_tpu_torch.models.common import container, linear, timestep_embedding
from scail_tpu_torch.ops.norms import layer_norm
from scail_tpu_torch.utils.registry import register


@register(alias="sgm.modules.diffusionmodules.openaimodel.Timestep")
class Timestep:
    def __init__(self, dim: int):
        self.dim = dim

    def __call__(self, t):
        return timestep_embedding(torch.as_tensor(t), self.dim)


@register(alias="sgm.modules.encoders.modules.ConcatTimestepEmbedderND")
class ConcatTimestepEmbedderND:
    """Each scalar of a (b, d) value through the sinusoidal table, then
    concatenated: (b, d) -> (b, d * outdim).  SDXL conditions on the
    original size, the crop corner, the target size and the aesthetic score
    so."""

    is_trainable = False
    ucg_rate = 0.0
    input_key = None
    legacy_ucg_val = None

    def __init__(self, outdim: int):
        self.outdim = outdim
        self.timestep = Timestep(outdim)

    def __call__(self, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        if x.dim() == 1:
            x = x[:, None]
        if x.dim() != 2:
            raise ValueError(f"ConcatTimestepEmbedderND takes (b, d), got {tuple(x.shape)}")
        b, dims = x.shape
        return self.timestep(x.reshape(-1)).reshape(b, dims * self.outdim)


def _text_cfg(width: int, layers: int, heads: int, mlp: int, act: str,
              vocab_size: int = 49408, context_length: int = 77,
              embed_dim: Optional[int] = None) -> ClipScoreConfig:
    # CLIP's EOT token is the last id of the vocabulary
    return ClipScoreConfig(text_width=width, text_layers=layers, text_heads=heads,
                           text_mlp=mlp, hidden_act=act, vocab_size=vocab_size,
                           context_length=context_length, embed_dim=embed_dim or width,
                           eos_token_id=vocab_size - 1)


class ClipTextTower(nn.Module):
    """The text half of CLIP; `hidden(ids, n)` returns the hidden states
    after the first n blocks and after all of them (before the final
    LayerNorm)."""

    def __init__(self, cfg: ClipScoreConfig, with_projection: bool, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.text_width
        self.text_model = container(
            embeddings=container(
                token_embedding=nn.Embedding(cfg.vocab_size, d, device=device),
                position_embedding=nn.Embedding(cfg.context_length, d, device=device)),
            encoder=_encoder(d, cfg.text_mlp, cfg.text_layers, device),
            final_layer_norm=_ln(d, device))
        if with_projection:
            self.text_projection = linear(d, cfg.embed_dim, bias=False, device=device)
        self.requires_grad_(False)
        self.eval()

    def init_random_(self, generator: torch.Generator, device=None):
        """As the JAX init draws them: linears and the projection N(0, 0.02),
        biases 0, LayerNorms one and zero, the token table N(0, 0.02), the
        positions N(0, 0.01); on the generator's device."""
        self.to_empty(device=device or generator.device)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if "layer_norm" in name:
                    p.fill_(1.0 if name.endswith("weight") else 0.0)
                elif name.endswith("bias"):
                    p.zero_()
                else:
                    p.normal_(0.0, 0.01 if "position_embedding" in name else 0.02,
                              generator=generator)
        return self

    def final_ln(self, x):
        ln = self.text_model.final_layer_norm
        return layer_norm(x, ln.weight, ln.bias, eps=self.cfg.eps)

    def hidden(self, ids, n_sel: int):
        cfg, tm = self.cfg, self.text_model
        cdtype = cfg.compute_dtype
        s = ids.shape[1]
        x = tm.embeddings.token_embedding.weight[ids].to(cdtype)
        x = x + tm.embeddings.position_embedding.weight.to(cdtype)[None, :s]
        causal = torch.full((s, s), float("-inf"), device=x.device).triu(1)[None, None]
        sel = x
        for i, p in enumerate(tm.encoder.layers):
            x = encoder_block(cfg, x, p, cfg.text_heads, mask_bias=causal)
            if i + 1 == n_sel:
                sel = x
        return sel, x


def text_state_dict_from_open_clip(sd, cfg: ClipScoreConfig):
    """An open_clip text state dict (token_embedding, positional_embedding,
    transformer.resblocks, ln_final, text_projection (width, embed) at the
    top) under ClipTextTower's names."""
    out = {}
    open_clip_tower(sd, out, "", "text_model", cfg.text_layers)
    out["text_model.embeddings.token_embedding.weight"] = sd["token_embedding.weight"]
    out["text_model.embeddings.position_embedding.weight"] = sd["positional_embedding"]
    out["text_model.final_layer_norm.weight"] = sd["ln_final.weight"]
    out["text_model.final_layer_norm.bias"] = sd["ln_final.bias"]
    out["text_projection.weight"] = sd["text_projection"].t()
    return out


def _hash_tokenizer(cfg: ClipScoreConfig, pad: int) -> Callable:
    def call(texts):
        ids = hash_token_ids(list(texts), cfg)
        if pad:
            ids[ids == 0] = pad  # hashed word ids are >= 1
        return ids

    return call


def load_tokenizer(path, cfg: ClipScoreConfig, pad: int) -> Callable:
    """texts -> (n, context_length) int64 ids.  A path that exists must load
    with transformers' AutoTokenizer (else this raises); without one, the
    crc32 hash tokenizer."""
    if not (path and os.path.exists(str(path))):
        return _hash_tokenizer(cfg, pad)
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(path)
    except Exception as e:
        raise RuntimeError(f"tokenizer at {path} does not load: {e}") from e

    def call(texts):
        return np.asarray(tok(list(texts), truncation=True, max_length=cfg.context_length,
                              padding="max_length", return_tensors="np").input_ids, np.int64)

    return call


class _TextEmbedder:
    """Shared plumbing: the tower on meta until init / load, the tokenizer,
    and the call that tokenizes and runs the tower on its device."""

    is_trainable = False
    ucg_rate = 0.0
    input_key = "txt"
    legacy_ucg_val = None
    with_projection = False

    def _setup(self, cfg, tokenizer_path, pad, checkpoint_path):
        self.cfg = cfg
        self.model = ClipTextTower(cfg, self.with_projection, device="meta")
        self.loaded = False
        self.tokenizer = load_tokenizer(tokenizer_path, cfg, pad)
        if checkpoint_path and os.path.exists(str(checkpoint_path)):
            from scail_tpu_torch.convert.torch_ckpt import load_torch_state_dict

            self.load_state_dict(load_torch_state_dict(checkpoint_path))

    @property
    def device(self):
        return next(self.model.parameters()).device

    def init(self, generator: torch.Generator, device=None):
        self.model.init_random_(generator, device)
        return self.model

    def load_tower_state_dict(self, mapped, device=None):
        """A state dict under ClipTextTower's own names, onto `device` (the
        CPU by default); a missing tensor raises."""
        keys = set(self.model.state_dict())
        missing = sorted(keys - set(mapped))
        if missing:
            raise KeyError(f"{type(self).__name__} state dict lacks {len(missing)} tensors, "
                           f"e.g. {missing[:3]}")
        self.model.to_empty(device=device or "cpu")
        self.model.load_state_dict({k: mapped[k] for k in keys}, strict=True)
        self.loaded = True
        return self.model

    def _ids(self, texts):
        if self.device.type == "meta":  # never initialised: smoke weights from seed 0
            self.init(torch.Generator().manual_seed(0))
        return torch.from_numpy(self.tokenizer(list(texts))).to(self.device)


@register(alias="sgm.modules.encoders.modules.FrozenCLIPEmbedder")
class FrozenCLIPEmbedder(_TextEmbedder):
    """layer 'last': the final-LN hidden states; 'pooled': the final-LN state
    at the first EOS, (b, 1, d); 'hidden': hidden state layer_idx (0 = the
    embeddings) before the final LN.  always_return_pooled adds the pooled
    (b, d) output."""

    LAYERS = ("last", "pooled", "hidden")

    def __init__(self, version: Optional[str] = None, max_length: int = 77, freeze: bool = True,
                 layer: str = "last", layer_idx: Optional[int] = None,
                 always_return_pooled: bool = False, width: int = 768, layers: int = 12,
                 heads: int = 12, mlp: int = 3072, vocab_size: int = 49408,
                 checkpoint_path: Optional[str] = None, tokenizer_path: Optional[str] = None,
                 **_):
        if layer not in self.LAYERS:
            raise ValueError(f"layer {layer!r} not in {self.LAYERS}")
        if layer == "hidden" and (layer_idx is None or abs(layer_idx) > layers):
            raise ValueError(f"layer 'hidden' needs |layer_idx| <= {layers}, got {layer_idx}")
        self.layer, self.layer_idx, self.return_pooled = layer, layer_idx, always_return_pooled
        self.max_length = max_length
        cfg = _text_cfg(width, layers, heads, mlp, act="quick_gelu", vocab_size=vocab_size,
                        context_length=max_length)
        self._setup(cfg, tokenizer_path or version, cfg.eos_token_id, checkpoint_path)

    def load_state_dict(self, sd, device=None):
        """An HF CLIPTextModel state dict (keys under text_model.*)."""
        return self.load_tower_state_dict(sd, device)

    @torch.no_grad()
    def __call__(self, texts):
        ids = self._ids(texts)
        L = self.cfg.text_layers
        n_sel = self.layer_idx % (L + 1) if self.layer == "hidden" else L
        sel, last = self.model.hidden(ids, n_sel)
        out = sel
        pooled = None
        if self.layer != "hidden" or self.return_pooled:
            h = self.model.final_ln(last)
            eos = (ids == self.cfg.eos_token_id).int().argmax(dim=-1)
            pooled = h[torch.arange(ids.shape[0], device=ids.device), eos]
            out = {"last": h, "pooled": pooled[:, None, :]}.get(self.layer, sel)
        return (out, pooled) if self.return_pooled else out


_OPEN_CLIP_ARCHS = {
    # width, layers, heads, mlp, embed_dim of the text towers
    "ViT-H-14": (1024, 24, 16, 4096, 1024),
    "ViT-bigG-14": (1280, 32, 20, 5120, 1280),
    "ViT-g-14": (1024, 24, 16, 4096, 1024),
    "ViT-L-14": (768, 12, 12, 3072, 768),
}


@register(alias="sgm.modules.encoders.modules.FrozenOpenCLIPEmbedder2")
class FrozenOpenCLIPEmbedder2(_TextEmbedder):
    """The open_clip text tower.  legacy: the final LN of the hidden state at
    the chosen depth.  Not legacy (SDXL): that hidden state without the final
    LN, and pooled = final_ln(last)[argmax(ids)] @ text_projection."""

    LAYERS = ("pooled", "last", "penultimate")
    with_projection = True

    def __init__(self, arch: str = "ViT-H-14", version: Optional[str] = None,
                 max_length: int = 77, freeze: bool = True, layer: str = "last",
                 always_return_pooled: bool = False, legacy: bool = True,
                 checkpoint_path: Optional[str] = None, tokenizer_path: Optional[str] = None,
                 **_):
        if layer not in ("last", "penultimate"):
            raise NotImplementedError(f"open_clip layer {layer!r}")
        if always_return_pooled and legacy:
            raise ValueError("always_return_pooled needs legacy=False")
        self.layer, self.layer_idx = layer, {"last": 0, "penultimate": 1}[layer]
        self.legacy, self.return_pooled = legacy, always_return_pooled
        self.max_length = max_length
        w, L, h, m, e = _OPEN_CLIP_ARCHS[arch]
        # open_clip pads with 0 and pools at argmax(ids): EOT is the largest id
        self._setup(_text_cfg(w, L, h, m, act="gelu", embed_dim=e), tokenizer_path or version,
                    0, checkpoint_path)

    def load_state_dict(self, sd, device=None):
        """An open_clip CLIP state dict (token_embedding, transformer.resblocks,
        ln_final, text_projection at the top level)."""
        return self.load_tower_state_dict(text_state_dict_from_open_clip(sd, self.cfg), device)

    @torch.no_grad()
    def __call__(self, texts):
        ids = self._ids(texts)
        sel, last = self.model.hidden(ids, self.cfg.text_layers - self.layer_idx)
        if self.legacy:
            return self.model.final_ln(sel)
        o = self.model.final_ln(last)
        pooled = o[torch.arange(ids.shape[0], device=ids.device), ids.argmax(dim=-1)]
        pooled = pooled @ self.model.text_projection.weight.t().to(pooled.dtype)
        return (sel, pooled) if self.return_pooled else sel


@register(alias="sgm.modules.encoders.modules.FrozenOpenCLIPEmbedder")
class FrozenOpenCLIPEmbedder(FrozenOpenCLIPEmbedder2):
    """v1: always the final LN of the hidden state at the chosen depth (v2's
    legacy path)."""

    LAYERS = ("last", "penultimate")

    def __init__(self, arch: str = "ViT-H-14", version: Optional[str] = None,
                 max_length: int = 77, freeze: bool = True, layer: str = "last", **kw):
        kw.pop("legacy", None)
        super().__init__(arch=arch, version=version, max_length=max_length, freeze=freeze,
                         layer=layer, legacy=True, **kw)
