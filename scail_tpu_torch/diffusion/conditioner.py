"""GeneralConditioner (counterpart of scail_tpu/diffusion/conditioner.py).

Routes each embedder's output by rank into {vector (2d), crossattn (3d),
concat (4d/5d)}, applies per-embedder unconditional-guidance dropout, and
builds the (c, uc) pair for CFG sampling.

Correlated ucg: `cor_embs` lists embedder indices whose dropout is drawn
jointly, one categorical draw per batch element over the 2**len(cor_embs)
on/off combinations with probabilities `cor_p`; bit k of the draw drops
embedder cor_embs[k].  The correlated embedders are embedded first, the
rest after them in their order.  The draws come from RandomState(rank), the
process's torch.distributed rank (0 on one process), as the JAX package
seeds it with its process index: data-parallel ranks hold different
examples and draw different dropouts.  Under a seq or model mesh the ranks
of one data group hold the same examples, so the engine reseeds the stream
with the data coordinate (`seed_ucg`, from engine.shard_params).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from scail_tpu_torch.utils.registry import instantiate_from_config, register

OUTPUT_DIM2KEYS = {2: "vector", 3: "crossattn", 4: "concat", 5: "concat"}
KEY2CATDIM = {"vector": 1, "crossattn": 2, "concat": 1}


@register(alias=("sgm.modules.GeneralConditioner",
                 "sgm.modules.encoders.modules.GeneralConditioner"))
class GeneralConditioner:
    def __init__(self, emb_models, cor_embs=(), cor_p=()):
        self.embedders: List = []
        for cfg in emb_models:
            cfg = dict(cfg)
            emb = instantiate_from_config({"target": cfg["target"],
                                           "params": cfg.get("params", {})})
            emb.is_trainable = cfg.get("is_trainable", False)
            emb.ucg_rate = cfg.get("ucg_rate", 0.0)
            emb.input_key = cfg.get("input_key")
            emb.legacy_ucg_val = cfg.get("legacy_ucg_val", None)
            self.embedders.append(emb)
        self.cor_embs = list(cor_embs)
        self.cor_p = list(cor_p)
        if self.cor_embs and len(self.cor_p) != 2 ** len(self.cor_embs):
            raise ValueError(f"cor_p needs one probability per on/off combination: expected "
                             f"{2 ** len(self.cor_embs)}, got {len(self.cor_p)}")
        self.seed_ucg(dist.get_rank() if dist.is_available() and dist.is_initialized() else 0)

    def seed_ucg(self, seed: int) -> None:
        """Restart the ucg dropout stream from RandomState(seed)."""
        self.ucg_prng = np.random.RandomState(seed)

    def _legacy_ucg(self, emb, batch: Dict, cond_or_not) -> Dict:
        """Swap in the legacy ucg value: per element with probability
        ucg_rate, or where an explicit 0/1 vector (correlated mode) says 1."""
        vals = list(batch[emb.input_key])
        for i in range(len(vals)):
            drop = (self.ucg_prng.random() < emb.ucg_rate if cond_or_not is None
                    else bool(cond_or_not[i]))
            if drop:
                vals[i] = emb.legacy_ucg_val
        return dict(batch, **{emb.input_key: vals})

    def _embed_one(self, emb, batch: Dict, output: Dict, cond_or_not, force_zero_embeddings,
                   disable_ucg: bool) -> None:
        apply_ucg = emb.ucg_rate > 0.0 and not disable_ucg
        # the string swap has no rate gate under a correlated draw (the
        # reference's surely_get_ucg_val); the zeroing below keeps it in both
        # modes
        if emb.legacy_ucg_val is not None and not disable_ucg and \
                (cond_or_not is not None or emb.ucg_rate > 0.0):
            batch = self._legacy_ucg(emb, batch, cond_or_not)
        emb_out = emb(batch[emb.input_key])
        if not isinstance(emb_out, (list, tuple)):
            emb_out = [emb_out]
        for e in emb_out:
            out_key = OUTPUT_DIM2KEYS[e.dim()]
            if apply_ucg and emb.legacy_ucg_val is None:
                if cond_or_not is None:
                    keep = [0.0 if self.ucg_prng.random() < emb.ucg_rate else 1.0
                            for _ in range(e.shape[0])]
                else:
                    keep = [1.0 - float(c) for c in cond_or_not]
                e = e * torch.tensor(keep, dtype=e.dtype, device=e.device).reshape(
                    (-1,) + (1,) * (e.dim() - 1))
            if emb.input_key in force_zero_embeddings:
                e = torch.zeros_like(e)
            if out_key in output:
                output[out_key] = torch.cat([output[out_key], e], dim=KEY2CATDIM[out_key])
            else:
                output[out_key] = e

    def __call__(self, batch: Dict, force_zero_embeddings=(), disable_ucg: bool = False):
        output: Dict[str, torch.Tensor] = {}
        cor = self.cor_embs if not disable_ucg else []
        if cor:
            bs = len(batch[self.embedders[cor[0]].input_key])
            draw = self.ucg_prng.choice(len(self.cor_p), size=(bs,), p=self.cor_p)
            for emb_idx in cor:
                self._embed_one(self.embedders[emb_idx], batch, output, draw % 2,
                                force_zero_embeddings, disable_ucg)
                draw = draw // 2
        for i, emb in enumerate(self.embedders):
            if i not in cor:
                self._embed_one(emb, batch, output, None, force_zero_embeddings, disable_ucg)
        return output

    def get_unconditional_conditioning(self, batch: Dict, batch_uc: Optional[Dict] = None,
                                       force_uc_zero_embeddings=()):
        """Embed cond and uncond with ucg disabled."""
        c = self(batch, disable_ucg=True)
        uc = self(batch_uc if batch_uc is not None else batch,
                  force_zero_embeddings=force_uc_zero_embeddings, disable_ucg=True)
        return c, uc
