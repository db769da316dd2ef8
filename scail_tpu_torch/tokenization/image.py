"""Image tokenizer: discrete codes through a VQ first stage (counterpart of
scail_tpu/tokenization/image.py).  Any autoencoding/vqgan.py VQModel or MOVQ
serves as the codec.  The API keeps JAX's channels-last images (b, h, w, 3);
the model is NCHW, so the images are permuted inside: EncodeAsIds flattens
each image's code grid, DecodeIds reshapes (a square grid by default) and
decodes back to (b, h, w, 3).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch


def sqrt_int(x: int) -> int:
    r = int(math.sqrt(x) + 1e-4)
    assert r * r == x, f"{x} is not a perfect square"
    return r


class ImageTokenizer:
    # CogView's channel statistics
    MEAN = np.asarray([0.79093, 0.76271, 0.75340], np.float32)
    STD = np.asarray([0.30379, 0.32279, 0.32800], np.float32)

    def __init__(self, model, params: Optional[Dict[str, torch.Tensor]] = None):
        """model: a VQModel / MOVQ on its device; params: an optional state
        dict to load into it."""
        if params is not None:
            model.load_state_dict(params)
        self.model = model
        self.num_tokens = model.n_embed
        self.image_tokens = model.n_embed

    def __len__(self):
        return self.num_tokens

    @property
    def device(self):
        return next(self.model.parameters()).device

    def normalize(self, img):
        mean, std = (torch.from_numpy(a).to(img.device) for a in (self.MEAN, self.STD))
        return (img - mean) / std

    @torch.no_grad()
    def EncodeAsIds(self, img, add_normalization: bool = False):
        """img (b, h, w, 3) -> (b, h' · w') codes."""
        img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        assert img.ndim == 4
        if add_normalization:
            img = self.normalize(img)
        _, _, idx = self.model.encode(img.permute(0, 3, 1, 2))
        return idx.reshape(img.shape[0], -1)

    @torch.no_grad()
    def DecodeIds(self, code, shape: Optional[tuple] = None):
        """Codes -> (b, h, w, 3) reconstructions; shape None: one square grid."""
        code = torch.as_tensor(code, device=self.device)
        if shape is None:
            s = sqrt_int(code.numel())
            shape = (1, s, s)
        return self.model.decode_code(code.reshape(shape).long()).permute(0, 2, 3, 1)
