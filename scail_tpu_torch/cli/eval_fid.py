"""FID on PyTorch (counterpart of eval/eval_fid.py): `ref` writes the
feature statistics of a directory of images to an .npz; `calc` scores a
directory of generated images against them.

Usage:
  python -m scail_tpu_torch.cli.eval_fid ref  --images <dir> --stats ref.npz [--detector ...]
  python -m scail_tpu_torch.cli.eval_fid calc --images <dir> --stats ref.npz [--detector ...]

--detector: a pytorch-fid pt_inception-2015-12-05*.pth or an EDM torchscript;
random-init smoke mode when omitted.  Prints `saved stats -> <path>` or
`FID: <value>` last.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser("eval_fid")
    ap.add_argument("mode", choices=["ref", "calc"])
    ap.add_argument("--images", required=True)
    ap.add_argument("--stats", required=True, help="ref-stats npz path")
    ap.add_argument("--detector", default=None,
                    help="pt_inception-2015-12-05*.pth or an EDM torchscript; random-init "
                         "smoke mode when omitted")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is not available")
    args = ap.parse_args(argv)

    from scail_tpu_torch.data.video import load_image_dir
    from scail_tpu_torch.evals.fid import (InceptionFeatureExtractor, fid_from_stats,
                                           save_ref_stats)

    extractor = InceptionFeatureExtractor(args.detector, device=args.device)
    feats = extractor(np.stack([np.asarray(im) for im in load_image_dir(args.images)]))
    if args.mode == "ref":
        save_ref_stats(feats, args.stats)
        print(f"saved stats -> {args.stats}", flush=True)
        return feats
    fid = fid_from_stats(feats, args.stats)
    print(f"FID: {fid:.4f}", flush=True)
    return fid


if __name__ == "__main__":
    main(sys.argv[1:])
