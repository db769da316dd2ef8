"""umt5-xxl text encoder on PyTorch (counterpart of scail_tpu/models/umt5.py).

T5 specifics kept: no attention scaling and an f32 softmax; T5LayerNorm is
an RMS norm; the FFN is gated, fc1(x) * GELU_tanh(gate(x)); per-layer
bidirectional relative-position buckets.

Two faults of the JAX wrapper are not copied: a tokenizer that fails to
load raises instead of being swapped silently for the fallback, and the
fallback tokenizer (used only when no tokenizer path exists) hashes words
with zlib.crc32, which is the same in every process.
"""

from __future__ import annotations

import dataclasses
import math
import os
import zlib
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from scail_tpu_torch.convert.torch_ckpt import (load_mapped_, load_torch_state_dict,
                                                mapped_state_dict)
from scail_tpu_torch.models.common import container, gelu_tanh, linear, parameter, random_init_
from scail_tpu_torch.ops.norms import rms_norm
from scail_tpu_torch.utils.registry import register


@dataclasses.dataclass(frozen=True)
class UMT5Config:
    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    max_dist: int = 128
    eps: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def head_dim(self):
        return self.dim_attn // self.num_heads

    @property
    def compute_dtype(self):
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]


@lru_cache(maxsize=16)
def relative_position_buckets(lq: int, lk: int, num_buckets: int = 32,
                              max_dist: int = 128) -> np.ndarray:
    """Bidirectional T5 buckets (the JAX package's numpy function; its module
    imports jax, so the few lines are repeated here)."""
    rel_pos = np.arange(lk)[None, :] - np.arange(lq)[:, None]
    nb = num_buckets // 2
    rel_buckets = (rel_pos > 0).astype(np.int64) * nb
    rel_pos = np.abs(rel_pos)
    max_exact = nb // 2
    large = max_exact + (np.log(np.maximum(rel_pos, 1) / max_exact)
                         / math.log(max_dist / max_exact) * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    rel_buckets += np.where(rel_pos < max_exact, rel_pos, large)
    return rel_buckets.astype(np.int32)


class UMT5Block(nn.Module):
    def __init__(self, cfg: UMT5Config, device=None):
        super().__init__()
        d, da, df = cfg.dim, cfg.dim_attn, cfg.dim_ffn
        lin = lambda i, o: linear(i, o, bias=False, device=device)  # noqa: E731
        self.norm1 = container(scale=parameter(d, fill=1.0, device=device))
        self.q, self.k, self.v, self.o = lin(d, da), lin(d, da), lin(d, da), lin(da, d)
        self.pos_emb = parameter(cfg.num_buckets, cfg.num_heads, device=device)
        self.norm2 = container(scale=parameter(d, fill=1.0, device=device))
        self.gate, self.fc1, self.fc2 = lin(d, df), lin(d, df), lin(df, d)


class UMT5Encoder(nn.Module):
    def __init__(self, cfg: UMT5Config, device=None):
        super().__init__()
        self.config = cfg
        self.token_embedding = parameter(cfg.vocab_size, cfg.dim, device=device)
        self.layers = nn.ModuleList(UMT5Block(cfg, device) for _ in range(cfg.num_layers))
        self.norm = container(scale=parameter(cfg.dim, fill=1.0, device=device))

    def init_weights_(self, generator: torch.Generator, *, device=None, dtype=None) -> None:
        """The JAX package's init scales (T5-style fan-in normals).  An encoder
        built on the meta device is made on `device` one parameter at a time,
        each cast to `dtype` once drawn (common.random_init_)."""
        cfg = self.config
        d, nh = cfg.dim, cfg.num_heads
        stds = {"token_embedding": 1.0, "q": (d * cfg.dim_attn) ** -0.5, "k": d ** -0.5,
                "v": d ** -0.5, "o": (nh * cfg.head_dim) ** -0.5,
                "pos_emb": (2 * cfg.num_buckets * nh) ** -0.5,
                "gate": d ** -0.5, "fc1": d ** -0.5, "fc2": cfg.dim_ffn ** -0.5}

        def std(name, p):
            parts = name.split(".")
            return stds[parts[-2] if parts[-1] == "weight" else parts[-1]]

        random_init_(self, generator, std, device=device, dtype=dtype)

    def forward(self, ids, mask):
        """ids/mask (b, S) -> mask-zeroed (b, S, dim) states."""
        cfg = self.config
        cdtype = cfg.compute_dtype
        b, S = ids.shape
        nh, hd = cfg.num_heads, cfg.head_dim
        x = self.token_embedding[ids].to(cdtype)
        buckets = torch.from_numpy(relative_position_buckets(
            S, S, cfg.num_buckets, cfg.max_dist).astype(np.int64)).to(ids.device)
        neg = -1e9 if cdtype == torch.float32 else -3.38e38
        mask_bias = torch.where(mask[:, None, None, :] > 0, 0.0, neg).float()
        for blk in self.layers:
            pos_bias = blk.pos_emb.float()[buckets].permute(2, 0, 1)[None]  # (1, nh, S, S)
            y = rms_norm(x, blk.norm1.scale, eps=cfg.eps)
            q, k, v = (torch.matmul(y, lin.weight.to(cdtype).t()).unflatten(-1, (nh, hd))
                       for lin in (blk.q, blk.k, blk.v))
            logits = torch.einsum("binc,bjnc->bnij", q.float(), k.float()) + pos_bias + mask_bias
            probs = torch.softmax(logits, dim=-1).to(v.dtype)
            o = torch.einsum("bnij,bjnc->binc", probs, v).flatten(2)
            x = x + torch.matmul(o, blk.o.weight.to(cdtype).t())
            y = rms_norm(x, blk.norm2.scale, eps=cfg.eps)
            ff = (torch.matmul(y, blk.fc1.weight.to(cdtype).t())
                  * gelu_tanh(torch.matmul(y, blk.gate.weight.to(cdtype).t())))
            x = x + torch.matmul(ff, blk.fc2.weight.to(cdtype).t())
        x = rms_norm(x, self.norm.scale, eps=cfg.eps)
        return x * mask[:, :, None].to(x.dtype)


def umt5_encode(model: UMT5Encoder, ids, mask):
    return model(ids, mask)


# UMT5Encoder.state_dict() key inside layer {i} -> the reference T5Encoder's
# name inside blocks.{i} (models_t5_umt5-xxl-enc-bf16.pth)
_BLOCK_NAMES = {
    "norm1.scale": "norm1.weight", "q.weight": "attn.q.weight", "k.weight": "attn.k.weight",
    "v.weight": "attn.v.weight", "o.weight": "attn.o.weight",
    "pos_emb": "pos_embedding.embedding.weight", "norm2.scale": "norm2.weight",
    "gate.weight": "ffn.gate.0.weight", "fc1.weight": "ffn.fc1.weight",
    "fc2.weight": "ffn.fc2.weight",
}


def umt5_source(name: str):
    """(key in the reference's file, layout fix) of a UMT5Encoder parameter:
    the names differ, the (out, in) layouts do not."""
    if name == "token_embedding":
        return "token_embedding.weight", None
    if name == "norm.scale":
        return "norm.weight", None
    _, i, rest = name.split(".", 2)
    return f"blocks.{i}.{_BLOCK_NAMES[rest]}", None


def umt5_state_dict_from_torch(sd, cfg: UMT5Config):
    """The reference encoder's state dict -> `UMT5Encoder(cfg).state_dict()`,
    in the file's dtype (the JAX package's umt5_params_from_state_dict)."""
    return mapped_state_dict(UMT5Encoder(cfg, device="meta"), sd, umt5_source,
                             "umt5 checkpoint")[0]


class StableHashTokenizer:
    """Deterministic word-hash tokenizer for runs without tokenizer files.
    zlib.crc32 gives the same ids in every process (Python's hash() does not)."""

    def __init__(self, seq_len: int, vocab_size: int = 256384):
        self.seq_len = seq_len
        self.vocab_size = vocab_size

    def __call__(self, texts, return_mask=True):
        ids = np.zeros((len(texts), self.seq_len), np.int64)
        mask = np.zeros((len(texts), self.seq_len), np.int64)
        for r, t in enumerate(texts):
            toks = [zlib.crc32(w.encode("utf-8")) % (self.vocab_size - 2) + 2
                    for w in t.split()][: self.seq_len - 1] + [1]  # eos
            ids[r, : len(toks)] = toks
            mask[r, : len(toks)] = 1
        return ids, mask


class _HFTok:
    """HuggingFace tokenizer with the reference's whitespace cleaning."""

    def __init__(self, tok, seq_len):
        self.tok = tok
        self.seq_len = seq_len

    @staticmethod
    def _clean(text: str) -> str:
        import html
        import re

        return re.sub(r"\s+", " ", html.unescape(html.unescape(text))).strip()

    def __call__(self, texts, return_mask=True):
        enc = self.tok([self._clean(t) for t in texts], padding="max_length", truncation=True,
                       max_length=self.seq_len, return_tensors="np")
        return enc["input_ids"], enc["attention_mask"]


@register(alias="sgm.modules.encoders.umt5.T5EncoderModel")
class T5EncoderModel:
    """Conditioner embedder: tokenize -> encode -> mask-zero."""

    is_trainable = False
    ucg_rate = 0.0
    input_key = "txt"
    legacy_ucg_val = None

    def __init__(self, max_length: int = 512, checkpoint_path=None, tokenizer_path=None,
                 dtype="bfloat16", varlen_text=False, uncond_text_length=1, **kw):
        self.config = UMT5Config(dtype="bfloat16" if "bf" in str(dtype) else "float32")
        self.max_length = max_length
        self.varlen_text = varlen_text
        self.uncond_text_length = uncond_text_length
        # the text length is padded to a multiple of this (the JAX engine
        # sets it to its shard count; one device here)
        self.cond_length_multiple = 1
        self.model = None
        self.checkpoint_path = None
        if tokenizer_path and os.path.exists(str(tokenizer_path)):
            from transformers import AutoTokenizer

            self.tokenizer = _HFTok(AutoTokenizer.from_pretrained(tokenizer_path), max_length)
        else:
            self.tokenizer = StableHashTokenizer(max_length, self.config.vocab_size)
        if checkpoint_path and os.path.exists(str(checkpoint_path)):
            # the file's tensors, memory-mapped on the CPU in its dtype; the
            # engine moves them to its device
            self.checkpoint_path = str(checkpoint_path)
            self.model = UMT5Encoder(self.config, device="meta")
            load_mapped_(self.model, load_torch_state_dict(self.checkpoint_path), umt5_source,
                         what=f"umt5 {self.checkpoint_path}")

    def init(self, generator: torch.Generator, cfg: UMT5Config = None, device=None):
        self.config = cfg or self.config
        if isinstance(self.tokenizer, StableHashTokenizer):
            self.tokenizer.vocab_size = self.config.vocab_size
        self.model = UMT5Encoder(self.config, device="meta")
        self.model.init_weights_(generator, device=device, dtype=self.config.compute_dtype)
        return self.model

    def __call__(self, texts):
        ids, mask = self.tokenizer(texts, return_mask=True)
        return self.encode(ids, mask)

    def encode(self, ids, mask):
        """The states of token ids under their mask; with `varlen_text`,
        trimmed to the valid tokens (varlen_length)."""
        dev = self.model.token_embedding.device
        z = self.model(torch.as_tensor(np.asarray(ids), dtype=torch.long, device=dev),
                       torch.as_tensor(np.asarray(mask), dtype=torch.long, device=dev))
        if self.varlen_text:
            if z.shape[0] != 1:
                raise ValueError(f"varlen_text encodes one prompt at a time, got {z.shape[0]}")
            z = z[:, :varlen_length(int(np.asarray(mask)[0].sum()), self.cond_length_multiple,
                                    self.uncond_text_length)]
        return z


def varlen_length(num_valid: int, multiple: int, uncond_text_length: int) -> int:
    """The text length under varlen_text (the JAX T5EncoderModel's trim):
    the valid tokens padded to `multiple`, or `uncond_text_length` tokens
    for a prompt of one token or none (the unconditional one)."""
    if num_valid > 1:
        return num_valid + (-num_valid) % multiple
    return uncond_text_length
