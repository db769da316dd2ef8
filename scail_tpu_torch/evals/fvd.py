"""FVD between two sets of videos on PyTorch (counterpart of
scail_tpu/evals/fvd.py; reference: eval/calculate_fvd.py).

I3D features (evals/i3d.py) on the extractor's device, then the Frechet
distance on the host (evals/frechet.py).  The preprocessing (resize to 224,
[0, 1] -> [-1, 1]) runs on the device with the port's torch-compatible
bilinear resize.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from scail_tpu_torch.evals import full_f32
from scail_tpu_torch.evals.frechet import frechet_from_features
from scail_tpu_torch.evals.i3d import InceptionI3d


def preprocess_for_i3d(videos01, size: int = 224, device=None) -> torch.Tensor:
    """(B, T, H, W, 3) in [0, 1] -> (B, 3, T, size, size) in [-1, 1] on `device`."""
    from scail_tpu_torch.ops.resize import resize_bilinear

    v = torch.as_tensor(np.asarray(videos01, np.float32), device=device)
    v = v.permute(0, 1, 4, 2, 3)  # b t c h w
    b, t = v.shape[:2]
    v = resize_bilinear(v.reshape(b * t, *v.shape[2:]), size, size)
    v = v.reshape(b, t, 3, size, size).permute(0, 2, 1, 3, 4)
    return v * 2.0 - 1.0


class I3DFeatureExtractor:
    """I3D 400-d FVD features on `device` (default the card).

    - weights_path to `i3d_pretrained_400.pt` (the videogpt state dict,
      eval/fvd/videogpt/fvd.py:8-19): loaded into InceptionI3d, strict.
    - weights_path to a `*torchscript.pt` (the styleganv flavour): loaded
      onto `device` and called as the reference calls it.
    - weights_path=None: random-init smoke mode from `seed` (the full
      pipeline runs without external downloads; distances are meaningful
      only relatively).
    """

    def __init__(self, weights_path: Optional[str] = None, batch: int = 4, size: int = 224,
                 device="cuda", seed: int = 0):
        from scail_tpu_torch.engine import resolve_device

        self.device = resolve_device(device)
        self.batch = batch
        self.size = size
        self._ts_model = None
        if weights_path is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.model = InceptionI3d(device=self.device).init_random_(gen)
        elif weights_path.endswith("torchscript.pt"):
            self._ts_model = torch.jit.load(weights_path, map_location=self.device).eval()
        else:
            if not os.path.exists(weights_path):
                raise FileNotFoundError(
                    f"I3D weights not found at {weights_path}; download "
                    "i3d_pretrained_400.pt (eval/fvd/videogpt/fvd.py:8-14)")
            from scail_tpu_torch.convert.torch_ckpt import load_torch_state_dict

            self.model = InceptionI3d(device=self.device)
            self.model.load_state_dict(load_torch_state_dict(weights_path), strict=True)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Preprocessed (b, 3, t, size, size) -> (b, 400) on the device."""
        if self._ts_model is not None:
            return self._ts_model(x, rescale=False, resize=False, return_features=True)
        return self.model(x)

    def __call__(self, videos01, batch: Optional[int] = None) -> np.ndarray:
        """(N, T, H, W, 3) in [0, 1] -> (N, 400) float32 features."""
        batch = batch or self.batch
        feats = []
        with torch.no_grad(), full_f32():
            for i in range(0, len(videos01), batch):
                x = preprocess_for_i3d(videos01[i:i + batch], self.size, self.device)
                feats.append(self.features(x).float().cpu().numpy())
        return np.concatenate(feats)


def compute_fvd(real_videos01, fake_videos01, i3d_path: Optional[str] = None,
                features: Optional[tuple] = None, i3d_size: int = 224, device="cuda") -> float:
    """Either raw videos (+ optional I3D weights; random-init smoke mode
    without them), or precomputed (real, fake) feature arrays."""
    if features is not None:
        return frechet_from_features(features[0], features[1])
    extractor = I3DFeatureExtractor(i3d_path, size=i3d_size, device=device)
    return frechet_from_features(extractor(real_videos01), extractor(fake_videos01))


def load_video_dir(path: str, max_videos: Optional[int] = None) -> List[np.ndarray]:
    """Every video file of a directory -> list of (T, H, W, 3) in [0, 1]
    (reference dataset: eval/calculate_fvd.py:24-80)."""
    from scail_tpu_torch.data.video import load_video_frames

    names = sorted(f for f in os.listdir(path) if f.endswith((".mp4", ".gif", ".npz", ".npy")))
    if max_videos:
        names = names[:max_videos]
    out = []
    for n in names:
        frames, _ = load_video_frames(os.path.join(path, n))
        out.append(frames.astype(np.float32) / 255.0)
    return out
