"""CLIP score on PyTorch (counterpart of scail_tpu/evals/clip_score.py;
reference: eval/eval_clip_score.py).

score = 100 * cos(image_emb, text_emb), averaged over pairs; open_clip
ViT-g-14 in the reference.  `ClipScorer` runs both towers of
models/clip_score.py on the card.

Tokenizer: with a `tokenizer_path`, HF transformers' AutoTokenizer, which
must be importable (there is no fallback); without one, a deterministic
hash tokenizer keeps smoke runs self-contained.  The JAX package hashes
words with Python's `hash()`, which changes from process to process under
hash randomisation; this one uses `zlib.crc32`, so the ids are the same in
every process.
"""

from __future__ import annotations

import zlib
from typing import Callable, Sequence

import numpy as np
import torch

from scail_tpu_torch.evals import full_f32
from scail_tpu_torch.models.clip_score import (ClipScoreConfig, ClipScoreModel,
                                               load_clip_score_state_dict)

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# the towers of smoke mode (no weights, no config given)
SMOKE_CONFIG = dict(vision_width=64, vision_layers=2, vision_heads=4, vision_mlp=96,
                    text_width=64, text_layers=2, text_heads=4, text_mlp=96, embed_dim=32)


def clip_score_from_embeddings(img_emb: np.ndarray, txt_emb: np.ndarray) -> float:
    """img_emb / txt_emb: (N, D) unnormalised -> mean 100 * cosine over pairs."""
    a = img_emb / np.linalg.norm(img_emb, axis=-1, keepdims=True)
    b = txt_emb / np.linalg.norm(txt_emb, axis=-1, keepdims=True)
    return float(100.0 * np.mean(np.sum(a * b, axis=-1)))


def hash_token_ids(texts: Sequence[str], cfg: ClipScoreConfig) -> np.ndarray:
    """BOS + one crc32-hashed id per lower-cased word + EOS, zero padded to
    the context length: (len(texts), context_length) int64."""
    length = cfg.context_length
    bos, eos = cfg.eos_token_id - 1, cfg.eos_token_id
    ids = np.zeros((len(texts), length), np.int64)
    for r, t in enumerate(texts):
        words = [zlib.crc32(w.encode("utf-8")) % (bos - 1) + 1 for w in t.lower().split()]
        toks = [bos] + words[:length - 2] + [eos]
        ids[r, :len(toks)] = toks
    return ids


class ClipScorer:
    """Dual-tower CLIP scorer on `device` (default the card).

    weights_path: an HF CLIPModel state dict (.bin / .pt / .safetensors) or
    an open_clip one (HPS_v2*.pt's 'state_dict'); the open_clip layout picks
    ViT-H-14 or ViT-g-14 from its width unless `cfg` is given.  Without
    weights, random init from `seed` at `cfg` (smoke mode; the tiny
    SMOKE_CONFIG towers when no cfg is given).
    tokenizer_path: an HF tokenizer dir / name (needs `transformers`);
    without it the crc32 hash tokenizer.
    """

    def __init__(self, weights_path: str = None, tokenizer_path: str = None, cfg=None,
                 device="cuda", seed: int = 0):
        from scail_tpu_torch.engine import resolve_device

        self.device = resolve_device(device)
        sd = None
        if weights_path is not None:
            if weights_path.endswith(".safetensors"):
                from safetensors.torch import load_file

                sd = load_file(weights_path)
            else:
                from scail_tpu_torch.convert.torch_ckpt import load_torch_state_dict

                sd = load_torch_state_dict(weights_path)
            if cfg is None and "visual.conv1.weight" in sd:
                width = sd["visual.conv1.weight"].shape[0]
                cfg = ClipScoreConfig.vit_h14() if width == 1280 else ClipScoreConfig.vit_g14()
            self.cfg = cfg or ClipScoreConfig()
            self.model = load_clip_score_state_dict(
                ClipScoreModel(self.cfg, device=self.device), sd)
        else:
            self.cfg = cfg or ClipScoreConfig(**SMOKE_CONFIG)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.model = ClipScoreModel(self.cfg, device=self.device).init_random_(gen)
        self._tok = None
        if tokenizer_path:
            try:
                from transformers import AutoTokenizer
            except ImportError as e:
                raise ImportError(
                    f"--tokenizer {tokenizer_path} needs the `transformers` package, which "
                    "is not installed; omit the tokenizer to use the hash tokenizer") from e
            self._tok = AutoTokenizer.from_pretrained(tokenizer_path)

    def preprocess(self, pil_images) -> torch.Tensor:
        """open_clip's eval transform on the device: antialiased bicubic
        resize of the short side, center crop, CLIP mean/std -> (b, 3, S, S)."""
        from scail_tpu_torch.ops.resize import resize_bicubic

        size = self.cfg.image_size
        out = []
        for im in pil_images:
            a = np.asarray(im, np.float32) / 255.0                            # (H, W, 3)
            x = torch.as_tensor(a, device=self.device).permute(2, 0, 1)[None]  # (1, 3, H, W)
            h, w = x.shape[2], x.shape[3]
            s = size / min(h, w)
            nh, nw = max(size, round(h * s)), max(size, round(w * s))
            x = resize_bicubic(x, nh, nw, antialias=True)
            t, l = (nh - size) // 2, (nw - size) // 2
            out.append(x[0, :, t:t + size, l:l + size])
        x = torch.stack(out)
        mean = torch.tensor(CLIP_MEAN, device=self.device).view(1, 3, 1, 1)
        std = torch.tensor(CLIP_STD, device=self.device).view(1, 3, 1, 1)
        return (x - mean) / std

    def tokenize(self, texts: Sequence[str]) -> np.ndarray:
        if self._tok is not None:
            enc = self._tok(list(texts), padding="max_length", truncation=True,
                            max_length=self.cfg.context_length, return_tensors="np")
            return enc["input_ids"].astype(np.int64)
        return hash_token_ids(texts, self.cfg)

    def image_embed(self, pil_images) -> np.ndarray:
        with torch.no_grad(), full_f32():
            return self.model.image_embed(self.preprocess(pil_images)).float().cpu().numpy()

    def text_embed(self, texts: Sequence[str]) -> np.ndarray:
        ids = torch.as_tensor(self.tokenize(texts), device=self.device)
        with torch.no_grad(), full_f32():
            return self.model.text_embed(ids).float().cpu().numpy()


def compute_clip_score(images, prompts: Sequence[str], image_embed_fn: Callable,
                       text_embed_fn: Callable, batch: int = 32) -> float:
    img_embs, txt_embs = [], []
    for i in range(0, len(prompts), batch):
        img_embs.append(np.asarray(image_embed_fn(images[i:i + batch])))
        txt_embs.append(np.asarray(text_embed_fn(list(prompts[i:i + batch]))))
    return clip_score_from_embeddings(np.concatenate(img_embs), np.concatenate(txt_embs))
