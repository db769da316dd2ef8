"""LAION aesthetic score on PyTorch (counterpart of eval/eval_aes.py): CLIP
ViT-L/14 image embeddings on the card, normalised, through the 5-layer MLP
head.

Usage:
  python -m scail_tpu_torch.cli.eval_aes --images <dir> [--clip-weights ViT-L-14 weights] \\
      [--mlp sac+logos+ava1-l14-linearMSE.pth] [--device cuda]

Without --clip-weights small random towers with the 768-d embedding run;
without --mlp a random head (smoke mode).  Prints `Average aesthetic score:
<value> over <n> images` last.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> float:
    ap = argparse.ArgumentParser("eval_aes")
    ap.add_argument("--images", required=True)
    ap.add_argument("--clip-weights", default=None)
    ap.add_argument("--mlp", default=None, help="LAION aesthetic MLP weights (.pth)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is not available")
    args = ap.parse_args(argv)

    from scail_tpu_torch.data.video import load_image_dir
    from scail_tpu_torch.evals.aesthetic import (aesthetic_score_from_clip_embeddings,
                                                 load_aesthetic_head, random_aesthetic_head)
    from scail_tpu_torch.evals.clip_score import SMOKE_CONFIG, ClipScorer
    from scail_tpu_torch.models.clip_score import ClipScoreConfig

    # with weights the ViT-L/14 geometry; smoke: small towers, but the 768-d
    # embedding the head takes
    cfg = ClipScoreConfig.vit_l14() if args.clip_weights else ClipScoreConfig(
        **dict(SMOKE_CONFIG, embed_dim=768), hidden_act="quick_gelu")
    scorer = ClipScorer(args.clip_weights, cfg=cfg, device=args.device)
    images = load_image_dir(args.images)
    emb = scorer.image_embed(images)
    if args.mlp:
        mlp = load_aesthetic_head(args.mlp)
    else:
        mlp = random_aesthetic_head(0)
        print("(random-init smoke mode: scores are not meaningful)")
    scores = aesthetic_score_from_clip_embeddings(emb, mlp)
    mean = float(np.mean(scores))
    print(f"Average aesthetic score: {mean:.4f} over {len(images)} images", flush=True)
    return mean


if __name__ == "__main__":
    main(sys.argv[1:])
