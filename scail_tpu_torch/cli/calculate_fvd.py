"""FVD between two directories of videos on PyTorch (counterpart of
eval/calculate_fvd.py).

Usage:
  python -m scail_tpu_torch.cli.calculate_fvd --real <dir> --fake <dir> \\
      [--i3d i3d_pretrained_400.pt | --i3d i3d_torchscript.pt] [--num 64] [--device cuda]

Without --i3d the I3D runs with random weights from a seed (smoke mode: the
whole pipeline runs; scores are only relatively meaningful).  Prints
`FVD: <value>` last.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> float:
    ap = argparse.ArgumentParser("calculate_fvd")
    ap.add_argument("--real", required=True)
    ap.add_argument("--fake", required=True)
    ap.add_argument("--i3d", default=None,
                    help="i3d_pretrained_400.pt (state dict) or *torchscript.pt")
    ap.add_argument("--num", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is not available")
    args = ap.parse_args(argv)

    from scail_tpu_torch.evals.frechet import frechet_from_features
    from scail_tpu_torch.evals.fvd import I3DFeatureExtractor, load_video_dir

    extractor = I3DFeatureExtractor(args.i3d, device=args.device)
    real = np.stack(load_video_dir(args.real, args.num))
    fake = np.stack(load_video_dir(args.fake, args.num))
    fvd = frechet_from_features(extractor(real), extractor(fake))
    print(f"FVD: {fvd:.3f}", flush=True)
    return fvd


if __name__ == "__main__":
    main(sys.argv[1:])
