"""Aesthetic score and the HPSv2 hook (the port's own copy of
scail_tpu/evals/aesthetic.py; reference: eval/eval_aes.py, eval/eval_hps.py).

The LAION aesthetic predictor is a small MLP over normalised CLIP ViT-L/14
image embeddings; it runs in numpy on the host from the public
`sac+logos+ava1-l14-linearMSE.pth`.  HPSv2 needs the external `hpsv2`
package, or a scorer passed in.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

MLP_SIZES = ((768, 1024), (1024, 128), (128, 64), (64, 16), (16, 1))
MLP_LAYERS = (0, 2, 4, 6, 7)


def aesthetic_score_from_clip_embeddings(clip_emb: np.ndarray, mlp_weights: dict) -> np.ndarray:
    """Normalise the CLIP embeddings -> 5-layer MLP -> one rating each.

    mlp_weights: the torch Linear weights layers.{0,2,4,6,7}.{weight,bias}
    of the public head, as numpy arrays."""
    x = clip_emb / np.linalg.norm(clip_emb, axis=-1, keepdims=True)
    for n, i in enumerate(MLP_LAYERS):
        x = x @ mlp_weights[f"layers.{i}.weight"].T + mlp_weights[f"layers.{i}.bias"]
        if n < 4:
            x = np.maximum(x, 0.0)  # ReLU between hidden layers
    return x[:, 0]


def random_aesthetic_head(seed: int = 0) -> dict:
    """Smoke-mode head: N(0, 0.02) weights, zero biases (eval/eval_aes.py's
    stand-in when no weights are given)."""
    rng = np.random.default_rng(seed)
    mlp = {}
    for i, (din, dout) in zip(MLP_LAYERS, MLP_SIZES):
        mlp[f"layers.{i}.weight"] = rng.standard_normal((dout, din)).astype(np.float32) * 0.02
        mlp[f"layers.{i}.bias"] = np.zeros((dout,), np.float32)
    return mlp


def load_aesthetic_head(path: str) -> dict:
    """The head's weights as numpy arrays."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"aesthetic head weights not found: {path}")
    from scail_tpu_torch.convert.torch_ckpt import load_torch_state_dict

    return {k: v.float().numpy() for k, v in load_torch_state_dict(path).items()}


def hps_score(images, prompts, scorer: Callable = None):
    """HPSv2 needs the external `hpsv2` package + weights; delegate when
    available (the reference eval/eval_hps.py does the same)."""
    if scorer is not None:
        return scorer(images, prompts)
    try:
        import hpsv2
    except ImportError as e:
        raise RuntimeError(
            "hpsv2 package not installed; provide `scorer` or install hpsv2") from e
    return hpsv2.score(images, prompts)
