"""Sharded FVD sweep over two video directories, on PyTorch (counterpart of
scail_tpu/evals/sweep.py; reference: eval/calculate_fvd_multiprocess.py,
one worker per GPU with the video list split across them).

One process per card: the pair list splits round-robin across the
torch.distributed ranks (parallel/distributed.py `initialize_distributed`),
each rank extracts I3D features of its own clips in batches (no batch
padding: a rank owns its whole card), the features are padded to the
largest per-rank count and all-gathered, and every rank solves the Frechet
distance.  With one process the sweep is the plain extractor over the list.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def sample_frames(frames: np.ndarray, num_frames: int, sample_rate: int = 1) -> np.ndarray:
    """Uniform frame subsampling, the reference's _load_video policy
    (calculate_fvd_multiprocess.py:51-74): num_frames spread over the first
    num_frames * sample_rate frames; shorter clips scale down proportionally."""
    total = frames.shape[0]
    want_len = num_frames * sample_rate
    if total >= want_len:
        e, n = want_len, num_frames
    else:
        e = total
        n = max(1, int(total / want_len * num_frames))
    idx = np.linspace(0, e - 1, n, dtype=int)
    return frames[idx]


def center_crop(frames: np.ndarray, crop: int) -> np.ndarray:
    """(T, H, W, C) center crop (CenterCropVideo equivalent)."""
    h, w = frames.shape[1:3]
    top = max(0, (h - crop) // 2)
    left = max(0, (w - crop) // 2)
    return frames[:, top:top + crop, left:left + crop]


def short_side_scale(frames01: np.ndarray, size: int) -> np.ndarray:
    """(T, H, W, 3) in [0, 1]: bilinear resize so that min(H, W) == size
    (pytorchvideo ShortSideScale equivalent), on the host."""
    from scail_tpu_torch.ops.resize import resize_bilinear_host

    t, h, w = frames01.shape[:3]
    if h <= w:
        nh, nw = size, max(1, int(round(w * size / h)))
    else:
        nh, nw = max(1, int(round(h * size / w))), size
    v = resize_bilinear_host(frames01.transpose(0, 3, 1, 2), nh, nw)  # t c h w
    return v.transpose(0, 2, 3, 1)


def paired_video_files(real_dir: str, fake_dir: str) -> Tuple[List[str], List[str]]:
    """Sorted basename pairing, the reference's _combine_without_prefix
    (calculate_fvd_multiprocess.py:76-86)."""

    def walk(d):
        return sorted(
            os.path.join(d, f) for f in os.listdir(d)
            if not f.startswith(".") and os.path.isfile(os.path.join(d, f))
            and f.endswith((".mp4", ".gif", ".npz", ".npy")))

    real, fake = walk(real_dir), walk(fake_dir)
    if len(real) != len(fake):
        raise ValueError(f"video count mismatch: {len(real)} real vs {len(fake)} generated")
    return real, fake


def load_clip(path: str, num_frames: int, sample_rate: int, resolution: int,
              crop_size: Optional[int]) -> np.ndarray:
    """One clip as the sweep feeds it: subsampled, short clips padded by
    repeating the last frame (so every clip stacks to (num_frames, H, W, 3)),
    short side scaled, center cropped."""
    from scail_tpu_torch.data.video import load_video_frames

    frames, _ = load_video_frames(path)
    frames01 = sample_frames(frames.astype(np.float32) / 255.0, num_frames, sample_rate)
    if frames01.shape[0] < num_frames:
        pad = np.repeat(frames01[-1:], num_frames - frames01.shape[0], axis=0)
        frames01 = np.concatenate([frames01, pad])
    frames01 = short_side_scale(frames01, resolution)
    if crop_size:
        frames01 = center_crop(frames01, crop_size)
    return frames01


def _gather(feats: Optional[np.ndarray], counts: List[int], device) -> np.ndarray:
    """Every rank's (count, D) features, in rank order: padded to the largest
    count (all_gather takes equal shapes), gathered, the pads dropped."""
    from scail_tpu_torch.evals.i3d import NUM_CLASSES

    dim = feats.shape[1] if feats is not None else NUM_CLASSES
    buf = torch.zeros(max(counts), dim, dtype=torch.float32, device=device)
    if feats is not None:
        buf[:feats.shape[0]] = torch.from_numpy(feats)
    out = [torch.empty_like(buf) for _ in counts]
    dist.all_gather(out, buf)
    return np.concatenate([o[:c].cpu().numpy() for o, c in zip(out, counts)])


def sweep_features(real_dir: str, fake_dir: str, *, i3d_path: Optional[str] = None,
                   num_frames: int = 16, sample_rate: int = 1, resolution: int = 224,
                   crop_size: Optional[int] = 224, batch: int = 8,
                   max_videos: Optional[int] = None, i3d_size: int = 224,
                   device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """The I3D features of every (real, fake) pair, on every rank: (N, 400)
    each, ordered rank by rank (rank r holds pairs r, r + P, ...)."""
    from scail_tpu_torch.evals.fvd import I3DFeatureExtractor

    real_files, fake_files = paired_video_files(real_dir, fake_dir)
    if max_videos:
        real_files, fake_files = real_files[:max_videos], fake_files[:max_videos]
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    mine = list(range(rank, len(real_files), world))
    extractor = I3DFeatureExtractor(i3d_path, batch=batch, size=i3d_size, device=device)

    def feats(paths):
        if not paths:
            return None  # ranks past the file count contribute nothing
        return extractor(np.stack([load_clip(p, num_frames, sample_rate, resolution, crop_size)
                                   for p in paths]))

    f_real = feats([real_files[i] for i in mine])
    f_fake = feats([fake_files[i] for i in mine])
    if world > 1:
        counts = [len(range(r, len(real_files), world)) for r in range(world)]
        f_real = _gather(f_real, counts, extractor.device)
        f_fake = _gather(f_fake, counts, extractor.device)
    return f_real, f_fake


def fvd_sweep(real_dir: str, fake_dir: str, **kw) -> float:
    """FVD between two directories of videos, sharded over the ranks; the
    same value on every rank.  Keywords as `sweep_features`."""
    from scail_tpu_torch.evals.frechet import frechet_from_features

    return frechet_from_features(*sweep_features(real_dir, fake_dir, **kw))
