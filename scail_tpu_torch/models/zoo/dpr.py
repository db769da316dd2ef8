"""DPR dense-passage-retrieval encoders and reader (counterpart of
scail_tpu/models/zoo/dpr.py): BERT trunks; the encoders return the cls
embedding (with an optional projection), the reader start / end logits per
token and a relevance logit per passage.

State-dict names mirror the JAX trees: `bert.*` (models/zoo/bert.py, its
pooler kept, zero where HF has none), `proj`, `qa_outputs`, `qa_classifier`.
`dpr_encoder_from_hf` / `dpr_reader_from_hf` read HF `DPRQuestionEncoder` /
`DPRContextEncoder` / `DPRReader` names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from scail_tpu_torch.models.zoo.bert import Bert, BertConfig, bert_from_hf
from scail_tpu_torch.models.zoo.common import LM, dense, lin, pick


@dataclasses.dataclass(frozen=True)
class DPRConfig:
    bert: BertConfig = BertConfig()
    projection_dim: int = 0


class DPREncoder(LM):
    """Question or context encoder: ids (b, s) -> (b, d) (or (b, projection_dim))."""

    def __init__(self, cfg: DPRConfig, device="cuda"):
        super().__init__()
        self.config = cfg
        self.bert = Bert(cfg.bert, device)
        if cfg.projection_dim:
            self.proj = lin(cfg.bert.dim, cfg.projection_dim, True, device)

    def forward(self, ids, mask=None, token_type_ids=None):
        out = self.bert.trunk(ids, mask, token_type_ids)[:, 0]
        return dense(out, self.proj) if self.config.projection_dim else out


class DPRReader(LM):
    """ids (b, s) -> (start logits (b, s), end logits (b, s), relevance (b,));
    the reader's trunk takes no token types."""

    def __init__(self, cfg: DPRConfig, device="cuda"):
        super().__init__()
        self.config = cfg
        d = cfg.bert.dim
        self.bert = Bert(cfg.bert, device)
        self.qa_outputs = lin(d, 2, True, device)
        self.qa_classifier = lin(d, 1, True, device)

    def forward(self, ids, mask=None):
        x = self.bert.trunk(ids, mask)
        qa = dense(x, self.qa_outputs)
        return qa[..., 0], qa[..., 1], dense(x[:, 0], self.qa_classifier)[..., 0]


def _strip(sd: Dict, prefix: str) -> Dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _trunk(sd: Dict, prefix: str, cfg: BertConfig) -> Dict[str, torch.Tensor]:
    """The `<prefix>` BertModel without a pooler -> `bert.*`, the pooler zero."""
    trunk = _strip(sd, prefix)
    trunk.setdefault("pooler.dense.weight", torch.zeros(cfg.dim, cfg.dim))
    trunk.setdefault("pooler.dense.bias", torch.zeros(cfg.dim))
    return {f"bert.{k}": v for k, v in bert_from_hf(trunk, cfg).items()}


def dpr_encoder_from_hf(sd: Dict, cfg: DPRConfig,
                        tower: str = "question_encoder") -> Dict[str, torch.Tensor]:
    """HF DPRQuestionEncoder / DPRContextEncoder (`tower` "ctx_encoder") state
    dict -> `DPREncoder.state_dict()` names."""
    out = _trunk(sd, f"{tower}.bert_model.", cfg.bert)
    if cfg.projection_dim:
        out.update(pick(sd, {"proj.weight": f"{tower}.encode_proj.weight",
                             "proj.bias": f"{tower}.encode_proj.bias"}))
    return out


def dpr_reader_from_hf(sd: Dict, cfg: DPRConfig) -> Dict[str, torch.Tensor]:
    """HF DPRReader state dict -> `DPRReader.state_dict()` names."""
    out = _trunk(sd, "span_predictor.encoder.bert_model.", cfg.bert)
    p = "span_predictor."
    out.update(pick(sd, {"qa_outputs.weight": p + "qa_outputs.weight",
                         "qa_outputs.bias": p + "qa_outputs.bias",
                         "qa_classifier.weight": p + "qa_classifier.weight",
                         "qa_classifier.bias": p + "qa_classifier.bias"}))
    return out
