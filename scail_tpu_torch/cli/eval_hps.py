"""HPSv2 human-preference score on PyTorch (counterpart of eval/eval_hps.py):
the mean cosine of normalised image and text embeddings under the
HPS_v2-fine-tuned open_clip ViT-H-14.

Usage:
  python -m scail_tpu_torch.cli.eval_hps --images <dir> --prompts prompts.txt \\
      [--hps-weights HPS_v2*.pt] [--tokenizer <HF tokenizer>] [--device cuda]

--hps-weights: an open_clip state dict (read from checkpoint['state_dict'])
or an HF-format CLIP one; without it small random towers run (smoke mode).
Prints `Average HPS: <value>` last.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> float:
    ap = argparse.ArgumentParser("eval_hps")
    ap.add_argument("--images", required=True)
    ap.add_argument("--prompts", required=True)
    ap.add_argument("--hps-weights", default=None,
                    help="HPS_v2*.pt (open_clip ViT-H state dict) or an HF-format CLIP "
                         "state dict")
    ap.add_argument("--tokenizer", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is not available")
    args = ap.parse_args(argv)

    from scail_tpu_torch.cli.eval_clip_score import read_prompts
    from scail_tpu_torch.data.video import load_image_dir
    from scail_tpu_torch.evals.clip_score import ClipScorer, compute_clip_score

    scorer = ClipScorer(args.hps_weights, args.tokenizer, device=args.device)
    prompts = read_prompts(args.prompts)
    images = load_image_dir(args.images)
    if len(images) != len(prompts):
        raise ValueError(f"{len(images)} images but {len(prompts)} prompts")
    score = compute_clip_score(images, prompts, scorer.image_embed, scorer.text_embed)
    # the reference prints the plain mean cosine (eval_hps.py:125-129)
    print(f"Average HPS: {score / 100.0:.6f}", flush=True)
    return score / 100.0


if __name__ == "__main__":
    main(sys.argv[1:])
