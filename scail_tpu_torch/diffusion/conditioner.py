"""GeneralConditioner (counterpart of scail_tpu/diffusion/conditioner.py).

Routes each embedder's output by rank into {vector (2d), crossattn (3d),
concat (4d/5d)}, applies per-embedder unconditional-guidance dropout, and
builds the (c, uc) pair for CFG sampling.  Correlated dropout (`cor_embs`)
is not on the sampling path and is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from scail_tpu_torch.utils.registry import instantiate_from_config, register

OUTPUT_DIM2KEYS = {2: "vector", 3: "crossattn", 4: "concat", 5: "concat"}
KEY2CATDIM = {"vector": 1, "crossattn": 2, "concat": 1}


@register(alias=("sgm.modules.GeneralConditioner",
                 "sgm.modules.encoders.modules.GeneralConditioner"))
class GeneralConditioner:
    def __init__(self, emb_models, cor_embs=(), cor_p=()):
        if cor_embs:
            raise NotImplementedError("correlated ucg (cor_embs) is not ported")
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
        # one process (rank 0) until torch.distributed arrives
        self.ucg_prng = np.random.RandomState(0)

    def _embed_one(self, emb, batch: Dict, output: Dict, force_zero_embeddings,
                   disable_ucg: bool) -> None:
        apply_ucg = emb.ucg_rate > 0.0 and not disable_ucg
        if emb.legacy_ucg_val is not None and apply_ucg:
            vals = list(batch[emb.input_key])
            for i in range(len(vals)):
                if self.ucg_prng.random() < emb.ucg_rate:
                    vals[i] = emb.legacy_ucg_val
            batch = dict(batch, **{emb.input_key: vals})
        emb_out = emb(batch[emb.input_key])
        if not isinstance(emb_out, (list, tuple)):
            emb_out = [emb_out]
        for e in emb_out:
            out_key = OUTPUT_DIM2KEYS[e.dim()]
            if apply_ucg and emb.legacy_ucg_val is None:
                keep = [0.0 if self.ucg_prng.random() < emb.ucg_rate else 1.0
                        for _ in range(e.shape[0])]
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
        for emb in self.embedders:
            self._embed_one(emb, batch, output, force_zero_embeddings, disable_ucg)
        return output

    def get_unconditional_conditioning(self, batch: Dict, batch_uc: Optional[Dict] = None,
                                       force_uc_zero_embeddings=()):
        """Embed cond and uncond with ucg disabled."""
        c = self(batch, disable_ucg=True)
        uc = self(batch_uc if batch_uc is not None else batch,
                  force_zero_embeddings=force_uc_zero_embeddings, disable_ucg=True)
        return c, uc
