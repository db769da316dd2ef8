"""Inception-v1 I3D feature extractor on PyTorch (counterpart of
scail_tpu/evals/i3d.py; reference: eval/fvd/videogpt/pytorch_i3d.py).

The FVD backbone: both reference FVD flavours (the videogpt state dict and
the styleganv torchscript) are this network with Kinetics-400 weights, and
both return the 400-d pre-softmax logits as FVD features.

Module names are those of pytorch_i3d.py (`Mixed_3b.b0.conv3d.weight`,
`Mixed_3b.b0.bn.running_mean`, `logits.conv3d.bias`, ...), so the released
`i3d_pretrained_400.pt` loads with `load_state_dict(strict=True)`.

Padding follows the torch module exactly: zero-pad by TF-SAME amounts, then
VALID convolutions and pools.  The max-pools take the max over those zero
pads (MaxPool3dSamePadding), so the pad is F.pad with zeros followed by an
unpadded F.max_pool3d: max_pool3d's own padding pads with -inf, which gives
another answer at the borders.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# (name, kind, spec); mirrors InceptionI3d.__init__ (pytorch_i3d.py:204-273)
I3D_LAYERS = (
    ("Conv3d_1a_7x7", "conv", dict(out=64, k=(7, 7, 7), s=(2, 2, 2))),
    ("MaxPool3d_2a_3x3", "pool", dict(k=(1, 3, 3), s=(1, 2, 2))),
    ("Conv3d_2b_1x1", "conv", dict(out=64, k=(1, 1, 1), s=(1, 1, 1))),
    ("Conv3d_2c_3x3", "conv", dict(out=192, k=(3, 3, 3), s=(1, 1, 1))),
    ("MaxPool3d_3a_3x3", "pool", dict(k=(1, 3, 3), s=(1, 2, 2))),
    ("Mixed_3b", "mix", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", "mix", (128, 128, 192, 32, 96, 64)),
    ("MaxPool3d_4a_3x3", "pool", dict(k=(3, 3, 3), s=(2, 2, 2))),
    ("Mixed_4b", "mix", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", "mix", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", "mix", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", "mix", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", "mix", (256, 160, 320, 32, 128, 128)),
    ("MaxPool3d_5a_2x2", "pool", dict(k=(2, 2, 2), s=(2, 2, 2))),
    ("Mixed_5b", "mix", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", "mix", (384, 192, 384, 48, 128, 128)),
)
NUM_CLASSES = 400
_FINAL_CH = 384 + 384 + 128 + 128  # Mixed_5c output
BN_EPS = 1e-5


def _same_pads(size: int, k: int, s: int):
    """TF-SAME pad amounts (pytorch_i3d.py:9-13)."""
    if size % s == 0:
        pad = max(k - s, 0)
    else:
        pad = max(k - (size % s), 0)
    return pad // 2, pad - pad // 2


def _pad_same(x, k, s):
    """Zero-pad (b, c, t, h, w) by the TF-SAME amounts of kernel k, stride s."""
    pads = []
    for d in (2, 1, 0):  # F.pad takes the last dim first
        pads += _same_pads(x.shape[2 + d], k[d], s[d])
    return F.pad(x, pads)


def _maxpool_same(x, k, s):
    return F.max_pool3d(_pad_same(x, k, s), k, s)


class Unit3D(nn.Module):
    """Same-pad conv3d (+ eval-mode BatchNorm) (+ relu) (pytorch_i3d.py:37-103)."""

    def __init__(self, cin, cout, k, s=(1, 1, 1), bn=True, relu=True, bias=False, device=None):
        super().__init__()
        self.k, self.s, self.relu = k, s, relu
        self.conv3d = nn.Conv3d(cin, cout, k, stride=s, bias=bias, device=device)
        self.bn = nn.BatchNorm3d(cout, eps=BN_EPS, device=device) if bn else None

    def forward(self, x):
        x = self.conv3d(_pad_same(x, self.k, self.s))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class InceptionModule(nn.Module):
    """4-branch inception block (pytorch_i3d.py:107-132)."""

    def __init__(self, cin, o, device=None):
        super().__init__()
        one, three = (1, 1, 1), (3, 3, 3)
        self.b0 = Unit3D(cin, o[0], one, device=device)
        self.b1a = Unit3D(cin, o[1], one, device=device)
        self.b1b = Unit3D(o[1], o[2], three, device=device)
        self.b2a = Unit3D(cin, o[3], one, device=device)
        self.b2b = Unit3D(o[3], o[4], three, device=device)
        self.b3b = Unit3D(cin, o[5], one, device=device)

    def forward(self, x):
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
                          self.b3b(_maxpool_same(x, (3, 3, 3), (1, 1, 1)))], dim=1)


class InceptionI3d(nn.Module):
    """The I3D network up to its 400 logits, in eval mode."""

    def __init__(self, in_channels: int = 3, device=None):
        super().__init__()
        cin = in_channels
        for name, kind, spec in I3D_LAYERS:
            if kind == "conv":
                setattr(self, name, Unit3D(cin, spec["out"], spec["k"], spec["s"],
                                           device=device))
                cin = spec["out"]
            elif kind == "mix":
                setattr(self, name, InceptionModule(cin, spec, device=device))
                cin = spec[0] + spec[2] + spec[4] + spec[5]
        self.logits = Unit3D(_FINAL_CH, NUM_CLASSES, (1, 1, 1), bn=False, relu=False,
                             bias=True, device=device)
        self.eval()
        self.requires_grad_(False)

    def init_random_(self, generator: torch.Generator, std: float = 0.05):
        """Random-init smoke mode, as init_i3d_params draws it: every conv
        kernel N(0, std), the logits bias 0, BatchNorm the identity."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv3d):
                    m.weight.normal_(0.0, std, generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.BatchNorm3d):
                    m.reset_parameters()
        return self

    def forward(self, videos):
        """videos: (b, 3, t, h, w) in [-1, 1].  Returns the (b, 400) FVD
        features: the spatial 2x7x7 average pool, the 1x1x1 logits conv and
        the time mean (pytorch_i3d.py:305-315)."""
        x = videos
        for name, kind, spec in I3D_LAYERS:
            if kind == "pool":
                x = _maxpool_same(x, spec["k"], spec["s"])
            else:
                x = getattr(self, name)(x)
        # AvgPool3d (2, 7, 7), stride 1, VALID (pytorch_i3d.py:276); the window
        # is clamped to the feature map, as the JAX function does, so small
        # inputs stay defined (exact at the 224 px / 16-frame geometry)
        win = (min(2, x.shape[2]), min(7, x.shape[3]), min(7, x.shape[4]))
        x = F.avg_pool3d(x, win, stride=1)
        x = self.logits(x)
        return x.mean(dim=(3, 4)).mean(dim=2)
