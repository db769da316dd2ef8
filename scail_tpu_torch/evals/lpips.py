"""LPIPS perceptual distance on PyTorch (counterpart of
scail_tpu/evals/lpips.py; reference: sgm/modules/autoencoding/lpips/loss/
lpips.py).

VGG16 feature taps relu1_2 / 2_2 / 3_3 / 4_3 / 5_3, each unit-normalised
per position over its channels (+1e-10), squared differences weighted by
the learned 1x1 `lin` convs, averaged over space and summed over the five
taps; inputs shifted and scaled by the reference's constants first.

Names: torchvision's `features.N.{weight,bias}` for the VGG16 convs and the
reference's `linK.model.1.weight` for the lin layers, so `load_lpips`
reads torchvision's vgg16 state dict and the vendored `vgg.pth`.
"""

from __future__ import annotations

import torch
from torch import nn

from scail_tpu_torch.evals import full_f32

# conv layer indices of torchvision vgg16 .features, and the taps' ends
VGG_CONVS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
_SLICE_ENDS = [4, 9, 16, 23, 30]    # feature taps AFTER the relu at end-1
_POOLS = {4, 9, 16, 23}             # maxpool positions
CHNS = [64, 128, 256, 512, 512]
_VGG_CHANS = [3, 64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    """VGG16 taps + lin weights, in eval mode; forward(x, y) -> (b,)."""

    def __init__(self, device=None):
        super().__init__()
        layers = []
        ci = 0
        for idx in range(30):
            if idx in _POOLS:
                layers.append(nn.MaxPool2d(2, 2))
            elif idx in VGG_CONVS:
                layers.append(nn.Conv2d(_VGG_CHANS[ci], _VGG_CHANS[ci + 1], 3, padding=1,
                                        device=device))
                ci += 1
            else:
                layers.append(nn.ReLU())
        self.features = nn.Sequential(*layers)
        for k, c in enumerate(CHNS):
            setattr(self, f"lin{k}", nn.Module())
            getattr(self, f"lin{k}").model = nn.Sequential(
                nn.Dropout(), nn.Conv2d(c, 1, 1, bias=False, device=device))
        self.register_buffer("shift", torch.tensor(_SHIFT, device=device).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE, device=device).view(1, 3, 1, 1),
                             persistent=False)
        self.eval()
        self.requires_grad_(False)

    def init_random_(self, generator: torch.Generator, std: float = 0.05):
        """Random-init smoke mode, as init_lpips_params draws it: conv kernels
        N(0, std), biases 0, lin weights |N(0, 1)| * 0.1."""
        with torch.no_grad():
            for idx in VGG_CONVS:
                self.features[idx].weight.normal_(0.0, std, generator=generator)
                self.features[idx].bias.zero_()
            for k in range(len(CHNS)):
                w = getattr(self, f"lin{k}").model[1].weight
                w.copy_(torch.randn(w.shape, generator=generator, device=w.device).abs() * 0.1)
        return self

    def taps(self, x):
        """(b, 3, H, W) -> the five feature taps."""
        out = []
        for idx, layer in enumerate(self.features):
            x = layer(x)
            if idx + 1 in _SLICE_ENDS:
                out.append(x)
        return out

    def forward(self, x, y):
        """x, y: (b, 3, H, W) in [-1, 1] -> (b,) perceptual distance."""
        with full_f32():
            fx = self.taps((x.float() - self.shift) / self.scale)
            fy = self.taps((y.float() - self.shift) / self.scale)
            total = 0.0
            for k, (a, b) in enumerate(zip(fx, fy)):
                na = a / (torch.sqrt(torch.sum(a * a, 1, keepdim=True)) + 1e-10)
                nb = b / (torch.sqrt(torch.sum(b * b, 1, keepdim=True)) + 1e-10)
                lin = getattr(self, f"lin{k}").model[1].weight.view(1, -1, 1, 1)
                total = total + torch.sum((na - nb) ** 2 * lin, dim=1).mean(dim=(1, 2))
        return total


def load_lpips(vgg_path: str, lin_path: str, device="cuda") -> LPIPS:
    """torchvision's `vgg16().state_dict()` (its `features.*`; the classifier
    is dropped) and the reference's `vgg.pth` (`linK.model.1.weight`) into
    one LPIPS module, strict on both."""
    from scail_tpu_torch.convert.torch_ckpt import load_torch_state_dict
    from scail_tpu_torch.engine import resolve_device

    device = resolve_device(device)
    sd = {k: v for k, v in load_torch_state_dict(vgg_path).items() if k.startswith("features.")}
    sd.update(load_torch_state_dict(lin_path))
    model = LPIPS(device=device)
    model.load_state_dict(sd, strict=True)
    return model
