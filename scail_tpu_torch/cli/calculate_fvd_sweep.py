"""Sharded FVD sweep over two video directories on PyTorch (counterpart of
eval/calculate_fvd_sweep.py; reference: eval/calculate_fvd_multiprocess.py).

One process per card: the video pairs split round-robin across the ranks,
the features are all-gathered and every rank prints the same FVD.

Usage:
  torchrun --nproc-per-node N -m scail_tpu_torch.cli.calculate_fvd_sweep \\
      --real_video_dir <dir> --generated_video_dir <dir> [--num_frames 16] \\
      [--sample_rate 1] [--resolution 224] [--crop_size 224] [--batch 8] \\
      [--i3d weights.pt] [--max_videos N] [--device cuda]

(torchrun sets RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT / LOCAL_RANK;
one plain process runs the whole list.)  Without --i3d the I3D runs with
random weights from a seed (smoke mode).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> float:
    ap = argparse.ArgumentParser("calculate_fvd_sweep")
    ap.add_argument("--real_video_dir", required=True)
    ap.add_argument("--generated_video_dir", required=True)
    ap.add_argument("--num_frames", type=int, default=16)
    ap.add_argument("--sample_rate", type=int, default=1)
    ap.add_argument("--resolution", type=int, default=224)
    ap.add_argument("--crop_size", type=int, default=224)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--i3d", default=None,
                    help="i3d_pretrained_400.pt (state dict) or *torchscript.pt")
    ap.add_argument("--max_videos", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is not available")
    args = ap.parse_args(argv)

    from scail_tpu_torch.evals.sweep import fvd_sweep
    from scail_tpu_torch.parallel.distributed import initialize_distributed

    initialize_distributed(device=args.device)  # from the environment when WORLD_SIZE > 1
    fvd = fvd_sweep(args.real_video_dir, args.generated_video_dir, i3d_path=args.i3d,
                    num_frames=args.num_frames, sample_rate=args.sample_rate,
                    resolution=args.resolution, crop_size=args.crop_size, batch=args.batch,
                    max_videos=args.max_videos, device=args.device)
    print(f"FVD: {fvd:.3f}", flush=True)
    return fvd


if __name__ == "__main__":
    main(sys.argv[1:])
