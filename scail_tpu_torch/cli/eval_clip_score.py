"""CLIP score of an image directory against a prompt file, on PyTorch
(counterpart of eval/eval_clip_score.py; the reference scores with
open_clip ViT-g-14).

Usage:
  python -m scail_tpu_torch.cli.eval_clip_score --images <dir> --prompts prompts.txt \\
      [--clip-weights CLIP-ViT-g-14.bin] [--tokenizer <HF tokenizer>] [--device cuda]

One prompt per line, in the images' sorted order.  Without --clip-weights
small random towers run (smoke mode); without --tokenizer the crc32 hash
tokenizer.  Prints `CLIP score: <value> (Average CLIP Score: <value/100>)`.
"""

from __future__ import annotations

import argparse
import sys


def read_prompts(path: str) -> list:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def main(argv=None) -> float:
    ap = argparse.ArgumentParser("eval_clip_score")
    ap.add_argument("--images", required=True)
    ap.add_argument("--prompts", required=True)
    ap.add_argument("--clip-weights", default=None,
                    help="HF CLIPModel state dict (.bin/.safetensors), e.g. "
                         "laion/CLIP-ViT-g-14-laion2B-s12B-b42K, or an open_clip one; smoke "
                         "mode with random init when omitted")
    ap.add_argument("--tokenizer", default=None,
                    help="HF tokenizer dir/name (needs transformers); the hash tokenizer "
                         "without it")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is not available")
    args = ap.parse_args(argv)

    from scail_tpu_torch.data.video import load_image_dir
    from scail_tpu_torch.evals.clip_score import ClipScorer, compute_clip_score

    scorer = ClipScorer(args.clip_weights, args.tokenizer, device=args.device)
    prompts = read_prompts(args.prompts)
    images = load_image_dir(args.images)
    if len(images) != len(prompts):
        raise ValueError(f"{len(images)} images but {len(prompts)} prompts")
    score = compute_clip_score(images, prompts, scorer.image_embed, scorer.text_embed)
    # the reference prints the plain mean cosine (eval_clip_score.py:96-99)
    print(f"CLIP score: {score:.4f} (Average CLIP Score: {score / 100.0:.6f})", flush=True)
    return score


if __name__ == "__main__":
    main(sys.argv[1:])
