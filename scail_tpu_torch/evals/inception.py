"""InceptionV3 FID feature extractor (2048-d pool3) on PyTorch (counterpart
of scail_tpu/evals/inception.py).

The FID variant of InceptionV3, with the architecture and parameter names
of pytorch-fid's `pt_inception-2015-12-05` (the torch port of the TF
`inception-2015-12-05` graph the reference's FID uses): BasicConv2d is a
bias-free conv + BatchNorm (eps 1e-3) + relu, named
`<block>[.<unit>].conv.weight` and `.bn.{weight,bias,running_mean,
running_var}`.  The FID-specific pools: every branch average pool counts
only the taps inside the image (count_include_pad=False), and the pool
branch of Mixed_7c is a max pool (stride 1, pad 1) where Mixed_7b's is an
average.  Images are resized bilinearly to 299 and mapped to [-1, 1] first.
Features are the 2048-d global average pool, the FID statistic's input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


# structure table: {block: {unit: (cin, cout, kh, kw)}} (torchvision InceptionV3)
def _a(cin, pool):
    return {"branch1x1": (cin, 64, 1, 1), "branch5x5_1": (cin, 48, 1, 1),
            "branch5x5_2": (48, 64, 5, 5), "branch3x3dbl_1": (cin, 64, 1, 1),
            "branch3x3dbl_2": (64, 96, 3, 3), "branch3x3dbl_3": (96, 96, 3, 3),
            "branch_pool": (cin, pool, 1, 1)}


def _c(c7):
    return {"branch1x1": (768, 192, 1, 1), "branch7x7_1": (768, c7, 1, 1),
            "branch7x7_2": (c7, c7, 1, 7), "branch7x7_3": (c7, 192, 7, 1),
            "branch7x7dbl_1": (768, c7, 1, 1), "branch7x7dbl_2": (c7, c7, 7, 1),
            "branch7x7dbl_3": (c7, c7, 1, 7), "branch7x7dbl_4": (c7, c7, 7, 1),
            "branch7x7dbl_5": (c7, 192, 1, 7), "branch_pool": (768, 192, 1, 1)}


def _e(cin):
    return {"branch1x1": (cin, 320, 1, 1), "branch3x3_1": (cin, 384, 1, 1),
            "branch3x3_2a": (384, 384, 1, 3), "branch3x3_2b": (384, 384, 3, 1),
            "branch3x3dbl_1": (cin, 448, 1, 1), "branch3x3dbl_2": (448, 384, 3, 3),
            "branch3x3dbl_3a": (384, 384, 1, 3), "branch3x3dbl_3b": (384, 384, 3, 1),
            "branch_pool": (cin, 192, 1, 1)}


INCEPTION_STRUCTURE = {
    "Conv2d_1a_3x3": (3, 32, 3, 3), "Conv2d_2a_3x3": (32, 32, 3, 3),
    "Conv2d_2b_3x3": (32, 64, 3, 3), "Conv2d_3b_1x1": (64, 80, 1, 1),
    "Conv2d_4a_3x3": (80, 192, 3, 3),
    "Mixed_5b": _a(192, 32), "Mixed_5c": _a(256, 64), "Mixed_5d": _a(288, 64),
    "Mixed_6a": {"branch3x3": (288, 384, 3, 3), "branch3x3dbl_1": (288, 64, 1, 1),
                 "branch3x3dbl_2": (64, 96, 3, 3), "branch3x3dbl_3": (96, 96, 3, 3)},
    "Mixed_6b": _c(128), "Mixed_6c": _c(160), "Mixed_6d": _c(160),
    "Mixed_6e": _c(192),
    "Mixed_7a": {"branch3x3_1": (768, 192, 1, 1), "branch3x3_2": (192, 320, 3, 3),
                 "branch7x7x3_1": (768, 192, 1, 1), "branch7x7x3_2": (192, 192, 1, 7),
                 "branch7x7x3_3": (192, 192, 7, 1), "branch7x7x3_4": (192, 192, 3, 3)},
    "Mixed_7b": _e(1280), "Mixed_7c": _e(2048),
}


class BasicConv2d(nn.Module):
    """Bias-free conv + eval-mode BatchNorm (eps 1e-3) + relu; the stride and
    the symmetric padding are given per call, as the block's forward needs."""

    def __init__(self, cin, cout, kh, kw, device=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, (kh, kw), bias=False, device=device)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS, device=device)

    def forward(self, x, stride=1, pad=False):
        kh, kw = self.conv.kernel_size
        padding = (kh // 2, kw // 2) if pad else 0
        return F.relu(self.bn(F.conv2d(x, self.conv.weight, None, stride, padding)))


def _maxpool(x, k=3, s=2, pad=0):
    return F.max_pool2d(x, k, s, pad)


def _avgpool_nocount(x):
    """3x3 stride-1 pad-1 average over the taps inside the image."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _block(units: dict, device) -> nn.Module:
    m = nn.Module()
    for unit, (cin, cout, kh, kw) in units.items():
        setattr(m, unit, BasicConv2d(cin, cout, kh, kw, device=device))
    return m


def inception_a(p, x):
    b1 = p.branch1x1(x)
    b5 = p.branch5x5_2(p.branch5x5_1(x), pad=True)
    bd = p.branch3x3dbl_3(p.branch3x3dbl_2(p.branch3x3dbl_1(x), pad=True), pad=True)
    bp = p.branch_pool(_avgpool_nocount(x))
    return torch.cat([b1, b5, bd, bp], dim=1)


def inception_b(p, x):
    b3 = p.branch3x3(x, stride=2)
    bd = p.branch3x3dbl_3(p.branch3x3dbl_2(p.branch3x3dbl_1(x), pad=True), stride=2)
    return torch.cat([b3, bd, _maxpool(x)], dim=1)


def inception_c(p, x):
    b1 = p.branch1x1(x)
    b7 = p.branch7x7_3(p.branch7x7_2(p.branch7x7_1(x), pad=True), pad=True)
    bd = p.branch7x7dbl_1(x)
    for unit in ("branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5"):
        bd = getattr(p, unit)(bd, pad=True)
    bp = p.branch_pool(_avgpool_nocount(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def inception_d(p, x):
    b3 = p.branch3x3_2(p.branch3x3_1(x), stride=2)
    b7 = p.branch7x7x3_3(p.branch7x7x3_2(p.branch7x7x3_1(x), pad=True), pad=True)
    b7 = p.branch7x7x3_4(b7, stride=2)
    return torch.cat([b3, b7, _maxpool(x)], dim=1)


def inception_e(p, x, pool: str):
    b1 = p.branch1x1(x)
    b3 = p.branch3x3_1(x)
    b3 = torch.cat([p.branch3x3_2a(b3, pad=True), p.branch3x3_2b(b3, pad=True)], dim=1)
    bd = p.branch3x3dbl_2(p.branch3x3dbl_1(x), pad=True)
    bd = torch.cat([p.branch3x3dbl_3a(bd, pad=True), p.branch3x3dbl_3b(bd, pad=True)], dim=1)
    # FIDInceptionE_1 averages, FIDInceptionE_2 takes the max (pytorch-fid)
    bp = _avgpool_nocount(x) if pool == "avg" else _maxpool(x, k=3, s=1, pad=1)
    return torch.cat([b1, b3, bd, p.branch_pool(bp)], dim=1)


# the blocks after the stem, in order, with their forward
BLOCKS = (("Mixed_5b", inception_a), ("Mixed_5c", inception_a), ("Mixed_5d", inception_a),
          ("Mixed_6a", inception_b), ("Mixed_6b", inception_c), ("Mixed_6c", inception_c),
          ("Mixed_6d", inception_c), ("Mixed_6e", inception_c), ("Mixed_7a", inception_d),
          ("Mixed_7b", lambda p, x: inception_e(p, x, "avg")),
          ("Mixed_7c", lambda p, x: inception_e(p, x, "max")))


class FIDInceptionV3(nn.Module):
    """The FID InceptionV3 up to its 2048-d pool3 features, in eval mode."""

    def __init__(self, device=None):
        super().__init__()
        for block, spec in INCEPTION_STRUCTURE.items():
            setattr(self, block, BasicConv2d(*spec, device=device) if isinstance(spec, tuple)
                    else _block(spec, device))
        self.eval()
        self.requires_grad_(False)

    def init_random_(self, generator: torch.Generator, std: float = 0.05):
        """Random-init smoke mode, as init_inception_params draws it: every
        conv kernel N(0, std), BatchNorm the identity."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    m.weight.normal_(0.0, std, generator=generator)
                elif isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()
        return self

    def stem(self, x):
        """[-1, 1] images at 299 -> the 192-channel map Mixed_5b takes."""
        x = self.Conv2d_1a_3x3(x, stride=2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(x), pad=True)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_maxpool(x)))
        return _maxpool(x)

    def forward(self, images01):
        """images01: (b, 3, H, W) in [0, 1] -> (b, 2048)."""
        from scail_tpu_torch.ops.resize import resize_bilinear

        x = resize_bilinear(images01.float(), 299, 299) * 2.0 - 1.0
        x = self.stem(x)
        for name, fn in BLOCKS:
            x = fn(getattr(self, name), x)
        return x.mean(dim=(2, 3))
