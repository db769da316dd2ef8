"""T5 encoder-decoder (counterpart of scail_tpu/models/zoo/t5.py): relative
attention buckets shared from each stack's first block, RMS layer norm, no
1/sqrt(d) scaling, a gated-GELU (tanh) or ReLU MLP, a tied or separate LM
head; a KV cache for the decoder (cross-attention keys and values computed
once from the encoder states) and greedy decoding over it.

State-dict names mirror the JAX tree (`shared`, `{encoder,decoder}.layers.{i}.
{ln_attn,attn.{q,k,v,o},ln_cross,cross.*,ln_mlp,wi0,wi1|wi,wo}`, `*.rel_bias`,
`*.final_ln`, `lm_head`); `t5_from_hf` reads HF `T5ForConditionalGeneration`
names.  The bucket table is the JAX numpy function (float64 logs), built on
the host once per (lq, lk): torch's f32 log parts from it at bucket edges.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.common import container, gelu_tanh
from scail_tpu_torch.models.zoo.common import LM, dense, lin, norm, pick, stacked, table
from scail_tpu_torch.ops.norms import rms_norm


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    dim: int = 512
    dim_kv: int = 64              # per head
    num_heads: int = 6
    inner_hidden_size: int = 1024
    num_layers: int = 8           # encoder layers
    num_decoder_layers: int = 8
    num_buckets: int = 32
    max_distance: int = 128
    eps: float = 1e-6
    gated_mlp: bool = True        # v1.1 gated GELU; False: ReLU
    tie_word_embeddings: bool = False


@lru_cache(maxsize=32)
def rel_buckets(lq: int, lk: int, num_buckets: int, max_dist: int,
                bidirectional: bool) -> np.ndarray:
    """HF T5 _relative_position_bucket on the host: (lq, lk) int64 (cached:
    do not write to it)."""
    ctx = np.arange(lq)[:, None]
    mem = np.arange(lk)[None, :]
    rel = mem - ctx
    buckets = np.zeros((lq, lk), np.int64)
    nb = num_buckets
    if bidirectional:
        nb //= 2
        buckets += (rel > 0).astype(np.int64) * nb
        rel = np.abs(rel)
    else:
        rel = -np.minimum(rel, 0)
    max_exact = nb // 2
    is_small = rel < max_exact
    with np.errstate(divide="ignore"):
        large = max_exact + (
            np.log(np.maximum(rel, 1) / max_exact)
            / np.log(max_dist / max_exact) * (nb - max_exact)
        ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(is_small, rel, large)
    return buckets


def _heads_proj(inner: int, d: int, device):
    return container(q=lin(d, inner, device=device), k=lin(d, inner, device=device),
                     v=lin(d, inner, device=device), o=lin(inner, d, device=device))


class T5Layer(nn.Module):
    def __init__(self, cfg: T5Config, decoder: bool, device=None):
        super().__init__()
        d, f, inner = cfg.dim, cfg.inner_hidden_size, cfg.num_heads * cfg.dim_kv
        self.ln_attn, self.ln_mlp = norm(d, device=device), norm(d, device=device)
        self.attn = _heads_proj(inner, d, device)
        if cfg.gated_mlp:
            self.wi0, self.wi1 = lin(d, f, device=device), lin(d, f, device=device)
        else:
            self.wi = lin(d, f, device=device)
        self.wo = lin(f, d, device=device)
        if decoder:
            self.ln_cross = norm(d, device=device)
            self.cross = _heads_proj(inner, d, device)


def _stack(cfg: T5Config, L: int, decoder: bool, device):
    return container(layers=nn.ModuleList(T5Layer(cfg, decoder, device) for _ in range(L)),
                     rel_bias=table(cfg.num_buckets, cfg.num_heads, device),
                     final_ln=norm(cfg.dim, device=device))


def _attend(q, k, v, pos_bias=None, mask_bias=None):
    """T5 attention of (b, s, n, hd) q over k, v: f32 logits, no scaling, the
    position bias then the mask bias added, softmax in f32."""
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    if pos_bias is not None:
        logits = logits + pos_bias
    if mask_bias is not None:
        logits = logits + mask_bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bnqk,bknd->bqnd", probs, v)
    return o.reshape(*o.shape[:2], -1)


def _mask_bias(mask):
    """(b, t) 0/1 -> (b, 1, 1, t): 0 or -1e9."""
    zero = torch.zeros((), device=mask.device)
    return torch.where(mask[:, None, None, :] > 0, zero, -1e9)


class T5KVCache:
    """k, v (Ld, b, max_len, n, dkv) of the decoder's self-attention, filled in
    place; ck, cv (Ld, b, S_enc, n, dkv) the cross-attention's, fixed."""

    def __init__(self, k, v, ck, cv):
        self.k, self.v, self.ck, self.cv = k, v, ck, cv
        self.length = 0


class T5(LM):
    def __init__(self, cfg: T5Config, device="cuda"):
        super().__init__()
        self.config = cfg
        self.shared = table(cfg.vocab_size, cfg.dim, device)
        self.encoder = _stack(cfg, cfg.num_layers, False, device)
        self.decoder = _stack(cfg, cfg.num_decoder_layers, True, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = lin(cfg.dim, cfg.vocab_size, device=device)

    # -- pieces ------------------------------------------------------------
    def _split(self, x):
        return x.unflatten(-1, (self.config.num_heads, self.config.dim_kv))

    def _pos_bias(self, stack, lq, lk, bidirectional, rows=None):
        """(1, n, rows, lk) position bias from the host bucket table."""
        cfg = self.config
        b = rel_buckets(lq, lk, cfg.num_buckets, cfg.max_distance, bidirectional)
        if rows is not None:
            b = b[rows]
        idx = torch.tensor(b, device=stack.rel_bias.device)
        return stack.rel_bias[idx].permute(2, 0, 1)[None]

    def _mlp(self, p, x):
        y = rms_norm(x, p.ln_mlp.scale, eps=self.config.eps)
        if self.config.gated_mlp:
            h = gelu_tanh(dense(y, p.wi0)) * dense(y, p.wi1)
        else:
            h = F.relu(dense(y, p.wi))
        return x + dense(h, p.wo)

    def _self_attn(self, p, y, pos_bias, mask_bias):
        q, k, v = (self._split(dense(y, w)) for w in (p.q, p.k, p.v))
        return dense(_attend(q, k, v, pos_bias, mask_bias), p.o)

    def _head(self, x):
        cfg = self.config
        x = rms_norm(x, self.decoder.final_ln.scale, eps=cfg.eps)
        if cfg.tie_word_embeddings:
            return F.linear(x * (cfg.dim ** -0.5), self.shared)
        return dense(x, self.lm_head)

    # -- the JAX entry points -----------------------------------------------
    def encode(self, ids, mask):
        """ids, mask (b, S) -> encoder states (b, S, d)."""
        cfg = self.config
        S = ids.shape[1]
        x = self.shared[ids]
        pos_bias = self._pos_bias(self.encoder, S, S, True)
        mask_bias = _mask_bias(mask)
        for p in self.encoder.layers:
            y = rms_norm(x, p.ln_attn.scale, eps=cfg.eps)
            x = x + self._self_attn(p.attn, y, pos_bias, mask_bias)
            x = self._mlp(p, x)
        return rms_norm(x, self.encoder.final_ln.scale, eps=cfg.eps)

    def decode(self, dec_ids, enc_states, enc_mask):
        """Full decoder pass: dec_ids (b, S) -> logits (b, S, vocab)."""
        cfg = self.config
        S = dec_ids.shape[1]
        x = self.shared[dec_ids]
        pos_bias = self._pos_bias(self.decoder, S, S, False)
        causal = torch.triu(torch.full((S, S), -1e9, device=x.device), diagonal=1)[None, None]
        xmask = _mask_bias(enc_mask)
        for p in self.decoder.layers:
            y = rms_norm(x, p.ln_attn.scale, eps=cfg.eps)
            x = x + self._self_attn(p.attn, y, pos_bias, causal)
            y = rms_norm(x, p.ln_cross.scale, eps=cfg.eps)
            k, v = (self._split(dense(enc_states, w)) for w in (p.cross.k, p.cross.v))
            o = _attend(self._split(dense(y, p.cross.q)), k, v, None, xmask)
            x = x + dense(o, p.cross.o)
            x = self._mlp(p, x)
        return self._head(x)

    def forward(self, ids, mask, dec_ids):
        return self.decode(dec_ids, self.encode(ids, mask), mask)

    def init_cache(self, enc_states, max_len: int) -> T5KVCache:
        """The decoder's cache for up to max_len positions, its cross-attention
        keys and values projected from enc_states once."""
        cfg = self.config
        b, S = enc_states.shape[:2]
        ck = torch.stack([self._split(dense(enc_states, p.cross.k)) for p in self.decoder.layers])
        cv = torch.stack([self._split(dense(enc_states, p.cross.v)) for p in self.decoder.layers])
        shape = (cfg.num_decoder_layers, b, max_len, cfg.num_heads, cfg.dim_kv)
        z = dict(device=enc_states.device, dtype=enc_states.dtype)
        return T5KVCache(torch.zeros(shape, **z), torch.zeros(shape, **z), ck, cv)

    def decode_cached(self, dec_ids, cache: T5KVCache, enc_mask):
        """Decoder step(s): dec_ids (b, s) appended at cache.length; returns
        logits (b, s, vocab) and advances the cache.  The self-attention
        reads the filled rows; the position-bias rows are those of the new
        positions in the (max_len, max_len) table."""
        cfg = self.config
        s = dec_ids.shape[1]
        max_len = cache.k.shape[2]
        pos0 = cache.length
        if pos0 + s > max_len:
            raise ValueError(f"the cache holds {max_len} positions, {pos0 + s} asked")
        end = pos0 + s
        x = self.shared[dec_ids]
        pos_bias = self._pos_bias(self.decoder, max_len, max_len, False,
                                  rows=slice(pos0, end))[..., :end]
        positions = pos0 + torch.arange(s, device=x.device)
        zero = torch.zeros((), device=x.device)
        causal = torch.where(torch.arange(end, device=x.device)[None] <= positions[:, None],
                             zero, -1e9)[None, None]
        xmask = _mask_bias(enc_mask)
        for li, p in enumerate(self.decoder.layers):
            y = rms_norm(x, p.ln_attn.scale, eps=cfg.eps)
            cache.k[li, :, pos0:end] = self._split(dense(y, p.attn.k))
            cache.v[li, :, pos0:end] = self._split(dense(y, p.attn.v))
            o = _attend(self._split(dense(y, p.attn.q)), cache.k[li, :, :end],
                        cache.v[li, :, :end], pos_bias, causal)
            x = x + dense(o, p.attn.o)
            y = rms_norm(x, p.ln_cross.scale, eps=cfg.eps)
            o = _attend(self._split(dense(y, p.cross.q)), cache.ck[li], cache.cv[li], None, xmask)
            x = x + dense(o, p.cross.o)
            x = self._mlp(p, x)
        cache.length = end
        return self._head(x)


@torch.no_grad()
def t5_greedy_decode(model: T5, ids, mask, max_new_tokens: int, start_token_id: int = 0,
                     eos_token_id: Optional[int] = None):
    """Greedy decoding: the encoder once, then one cached decoder step a
    token.  Rows that emitted eos stay at eos; the loop stops when every row
    has.  Returns (b, <= max_new_tokens) tokens after the start token."""
    enc = model.encode(ids, mask)
    b = ids.shape[0]
    cache = model.init_cache(enc, max_new_tokens + 1)
    step = torch.full((b, 1), start_token_id, dtype=torch.long, device=ids.device)
    done = torch.zeros(b, dtype=torch.bool, device=ids.device)
    out = []
    for _ in range(max_new_tokens):
        nxt = model.decode_cached(step, cache, mask)[:, -1].argmax(-1)
        if eos_token_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
            done |= nxt == eos_token_id
        out.append(nxt)
        step = nxt[:, None]
        if eos_token_id is not None and bool(done.all()):
            break
    return torch.stack(out, dim=1)


def t5_from_hf(sd: Dict, cfg: T5Config) -> Dict[str, torch.Tensor]:
    """HF T5ForConditionalGeneration state dict -> `T5.state_dict()` names."""
    out = pick(sd, {"shared": "shared.weight",
                    "encoder.final_ln.scale": "encoder.final_layer_norm.weight",
                    "decoder.final_ln.scale": "decoder.final_layer_norm.weight"})
    rel = "block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    for stack, L, decoder in (("encoder", cfg.num_layers, False),
                              ("decoder", cfg.num_decoder_layers, True)):
        out[f"{stack}.rel_bias"] = torch.as_tensor(sd[f"{stack}.{rel}"])
        mlp = 2 if decoder else 1
        names = {"ln_attn.scale": "layer.0.layer_norm.weight",
                 "ln_mlp.scale": f"layer.{mlp}.layer_norm.weight",
                 "wo.weight": f"layer.{mlp}.DenseReluDense.wo.weight"}
        names.update({f"attn.{n}.weight": f"layer.0.SelfAttention.{n}.weight" for n in "qkvo"})
        if cfg.gated_mlp:
            names["wi0.weight"] = f"layer.{mlp}.DenseReluDense.wi_0.weight"
            names["wi1.weight"] = f"layer.{mlp}.DenseReluDense.wi_1.weight"
        else:
            names["wi.weight"] = f"layer.{mlp}.DenseReluDense.wi.weight"
        if decoder:
            names["ln_cross.scale"] = "layer.1.layer_norm.weight"
            names.update({f"cross.{n}.weight": f"layer.1.EncDecAttention.{n}.weight"
                          for n in "qkvo"})
        out.update({f"{stack}.{k}": v for k, v in
                    stacked(sd, L, names, f"{stack}.block.{{}}.").items()})
    if not cfg.tie_word_embeddings:
        out.update(pick(sd, {"lm_head.weight": "lm_head.weight"}))
    return out
