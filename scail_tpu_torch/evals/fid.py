"""FID on PyTorch (counterpart of scail_tpu/evals/fid.py; reference:
eval/eval_fid.py, EDM-style).

`save_ref_stats` writes the (mu, cov) of a directory's features to an .npz;
`fid_from_stats` scores generated images against stored stats.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from scail_tpu_torch.evals import full_f32
from scail_tpu_torch.evals.frechet import feature_stats, frechet_distance
from scail_tpu_torch.evals.inception import FIDInceptionV3


def load_inception_state_dict(model: FIDInceptionV3, path: str) -> FIDInceptionV3:
    """A pytorch-fid `pt_inception-2015-12-05*.pth` into `model`, strict on
    every feature unit; the 1008-class `fc` head the file also holds is not
    part of the features and is dropped."""
    from scail_tpu_torch.convert.torch_ckpt import load_torch_state_dict

    sd = {k: v for k, v in load_torch_state_dict(path).items() if not k.startswith("fc.")}
    model.load_state_dict(sd, strict=True)
    return model


class InceptionFeatureExtractor:
    """2048-d FID features on `device` (default the card).

    - weights_path to a pytorch-fid `pt_inception-2015-12-05*.pth` state
      dict: loaded into FIDInceptionV3 (evals/inception.py).
    - weights_path to an EDM torchscript / pkl: loaded onto `device` and
      called on uint8 NCHW images, as the reference calls it.
    - weights_path=None: random-init smoke mode from `seed`.
    """

    def __init__(self, weights_path: Optional[str] = None, batch: int = 16, device="cuda",
                 seed: int = 0):
        from scail_tpu_torch.engine import resolve_device

        self.device = resolve_device(device)
        self.batch = batch
        self._ts_model = None
        if weights_path is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.model = FIDInceptionV3(device=self.device).init_random_(gen)
        elif weights_path.endswith((".pkl", "torchscript.pt")):
            self._ts_model = torch.jit.load(weights_path, map_location=self.device).eval()
        else:
            if not os.path.exists(weights_path):
                raise FileNotFoundError(
                    f"inception weights not found at {weights_path} "
                    "(pt_inception-2015-12-05*.pth or EDM torchscript)")
            self.model = load_inception_state_dict(FIDInceptionV3(device=self.device),
                                                   weights_path)

    def __call__(self, images_u8: np.ndarray, batch: Optional[int] = None) -> np.ndarray:
        """(N, H, W, 3) uint8 -> (N, 2048) float32 features."""
        batch = batch or self.batch
        feats = []
        with torch.no_grad(), full_f32():
            for i in range(0, images_u8.shape[0], batch):
                x = torch.as_tensor(np.asarray(images_u8[i:i + batch]), device=self.device)
                x = x.permute(0, 3, 1, 2)
                if self._ts_model is not None:
                    f = self._ts_model(x, return_features=True)
                else:
                    f = self.model(x.float() / 255.0)
                feats.append(f.float().cpu().numpy())
        return np.concatenate(feats)


def save_ref_stats(features: np.ndarray, out_path: str):
    mu, cov = feature_stats(features)
    np.savez(out_path, mu=mu, sigma=cov)


def fid_from_stats(features: np.ndarray, ref_stats_path: str) -> float:
    ref = np.load(ref_stats_path)
    mu, cov = feature_stats(features)
    return frechet_distance(mu, cov, ref["mu"], ref["sigma"])
