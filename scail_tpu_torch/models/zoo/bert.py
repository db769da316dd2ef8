"""BERT / RoBERTa encoders (counterpart of scail_tpu/models/zoo/bert.py):
post-LN blocks over token + position + token-type embeddings, exact-GELU
MLPs, a tanh pooler.  RoBERTa is the same forward with mask-derived
positions offset past the pad id.

State-dict names mirror the JAX tree (`tok`, `pos`, `token_type`, `emb_ln`,
`layers.{i}.{q,k,v,ao,ln1,fc1,fc2,ln2}`, `pooler`); the JAX leaf `type` is
`token_type` here (nn.Module owns `type`).  `bert_from_hf` / `roberta_from_hf`
read HF `BertModel` / `RobertaModel` names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from scail_tpu_torch.models.zoo.common import (LM, attend, dense, lin, norm, pick,
                                               sat_linears, table)
from scail_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    num_heads: int = 12
    num_layers: int = 12
    inner_hidden_size: int = 3072
    max_len: int = 512
    type_vocab_size: int = 2
    eps: float = 1e-12
    position_style: str = "bert"   # "roberta": mask-derived, past the pad id
    pad_token_id: int = 1          # RoBERTa's padding_idx


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        d, f = cfg.dim, cfg.inner_hidden_size
        self.q, self.k, self.v, self.ao = (lin(d, d, True, device) for _ in range(4))
        self.ln1, self.ln2 = norm(d, True, device), norm(d, True, device)
        self.fc1, self.fc2 = lin(d, f, True, device), lin(f, d, True, device)


class Bert(LM):
    def __init__(self, cfg: BertConfig, device="cuda"):
        super().__init__()
        self.config = cfg
        d = cfg.dim
        self.tok = table(cfg.vocab_size, d, device)
        self.pos = table(cfg.max_len, d, device)
        self.token_type = table(cfg.type_vocab_size, d, device)
        self.emb_ln = norm(d, True, device)
        self.layers = nn.ModuleList(BertLayer(cfg, device) for _ in range(cfg.num_layers))
        self.pooler = lin(d, d, True, device)

    def trunk(self, ids, mask=None, token_type_ids=None):
        """ids, mask (b, s) -> the sequence output (b, s, d); masked keys get
        -1e30 on the f32 logits."""
        cfg = self.config
        b, s = ids.shape
        n, hd = cfg.num_heads, cfg.dim // cfg.num_heads
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(ids)
        if cfg.position_style == "roberta":
            nonpad = (ids != cfg.pad_token_id).long()
            pos = self.pos[torch.cumsum(nonpad, dim=1) * nonpad + cfg.pad_token_id]
        else:
            pos = self.pos[:s][None]
        x = self.tok[ids] + pos + self.token_type[token_type_ids]
        x = layer_norm(x, self.emb_ln.scale, self.emb_ln.bias, eps=cfg.eps)
        if mask is None:
            mask = torch.ones_like(ids)
        zero = torch.zeros((), device=ids.device)
        bias = torch.where(mask[:, None, None, :] > 0, zero, -1e30)
        for lp in self.layers:
            q, k, v = (dense(x, w).unflatten(-1, (n, hd)) for w in (lp.q, lp.k, lp.v))
            o = attend(q, k, v, bias=bias, scale=hd ** -0.5)
            x = layer_norm(x + dense(o, lp.ao), lp.ln1.scale, lp.ln1.bias, eps=cfg.eps)
            h = F.gelu(dense(x, lp.fc1))
            x = layer_norm(x + dense(h, lp.fc2), lp.ln2.scale, lp.ln2.bias, eps=cfg.eps)
        return x

    def forward(self, ids, mask=None, token_type_ids=None):
        """-> (sequence output (b, s, d), pooled output (b, d))."""
        x = self.trunk(ids, mask, token_type_ids)
        return x, torch.tanh(dense(x[:, 0], self.pooler))


def bert_from_hf(sd: Dict, cfg: BertConfig) -> Dict[str, torch.Tensor]:
    """HF BertModel state dict -> `Bert.state_dict()` names."""
    out = pick(sd, {"tok": "embeddings.word_embeddings.weight",
                    "pos": "embeddings.position_embeddings.weight",
                    "token_type": "embeddings.token_type_embeddings.weight",
                    "emb_ln.scale": "embeddings.LayerNorm.weight",
                    "emb_ln.bias": "embeddings.LayerNorm.bias",
                    "pooler.weight": "pooler.dense.weight", "pooler.bias": "pooler.dense.bias"})
    out.update(sat_linears(sd, cfg.num_layers, {
        "q": "attention.self.query", "k": "attention.self.key", "v": "attention.self.value",
        "ao": "attention.output.dense", "ln1": "attention.output.LayerNorm",
        "fc1": "intermediate.dense", "fc2": "output.dense", "ln2": "output.LayerNorm"},
        "encoder.layer.{}.", norms=("ln1", "ln2")))
    return out


def roberta_from_hf(sd: Dict, cfg: BertConfig) -> Dict[str, torch.Tensor]:
    """HF RobertaModel state dict (with or without the `roberta.` prefix of
    the task heads' checkpoints) -> `Bert.state_dict()` names."""
    return bert_from_hf({k[len("roberta."):] if k.startswith("roberta.") else k: v
                         for k, v in sd.items()}, cfg)
