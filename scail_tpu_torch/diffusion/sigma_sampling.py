"""Training sigma samplers (counterpart of scail_tpu/diffusion/sigma_sampling.py).

Draws from an explicit torch.Generator; the JAX package draws from a PRNG key,
so the two give different numbers from one seed (the parity tests inject
the same draws into both).
"""

from __future__ import annotations

import numpy as np
import torch

from scail_tpu_torch.diffusion.discretization import RFDiscretization
from scail_tpu_torch.utils.registry import instantiate_from_config, register


@register(alias="sgm.modules.diffusionmodules.sigma_sampling.RFSampling")
class RFSampling:
    """LogisticNormal(p_mean, p_std): sigma = sigmoid(N(p_mean, p_std))."""

    def __init__(self, p_mean: float = 0.0, p_std: float = 1.0):
        self.p_mean, self.p_std = p_mean, p_std

    def __call__(self, generator: torch.Generator, shape) -> torch.Tensor:
        """f32 sigmas of `shape` (an int batch size or a tuple) on the
        generator's device."""
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        z = torch.randn(shape, generator=generator, device=generator.device)
        return torch.sigmoid(self.p_mean + self.p_std * z)


@register(alias="sgm.modules.diffusionmodules.sigma_sampling.EDMSampling")
class EDMSampling:
    """sigma = exp(N(p_mean, p_std))."""

    def __init__(self, p_mean: float = -1.2, p_std: float = 1.2):
        self.p_mean, self.p_std = p_mean, p_std

    def __call__(self, generator: torch.Generator, n_samples: int) -> torch.Tensor:
        z = torch.randn((n_samples,), generator=generator, device=generator.device)
        return torch.exp(self.p_mean + self.p_std * z)


@register(alias="sgm.modules.diffusionmodules.sigma_sampling.DiscreteSampling")
class DiscreteSampling:
    """Uniform over the rungs of a discretized ladder.

    With `uniform_sampling` and `group_num` g, the batch splits into g
    contiguous chunks (element i of n is in group (i * g) // n), and group k
    draws only from the index interval [k * num_idx / g, (k + 1) * num_idx /
    g): the reference's data-parallel rank groups, laid out as the batch
    slices those ranks hold."""

    def __init__(self, discretization_config=None, num_idx: int = 1000,
                 do_append_zero: bool = False, flip: bool = True,
                 uniform_sampling: bool = False, group_num: int = 0):
        disc = (instantiate_from_config(discretization_config)
                if discretization_config is not None else RFDiscretization(num_idx))
        self.sigmas_np = np.asarray(disc(num_idx, do_append_zero=do_append_zero, flip=flip),
                                    np.float32)
        self.num_idx = num_idx
        if uniform_sampling:
            if group_num <= 0 or num_idx % group_num:
                raise ValueError(f"uniform_sampling needs 0 < group_num dividing num_idx, got "
                                 f"group_num {group_num}, num_idx {num_idx}")
        self.uniform_sampling = uniform_sampling
        self.group_num = group_num

    def idx_to_sigma(self, idx: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(self.sigmas_np).to(idx.device)[idx]

    def __call__(self, generator: torch.Generator, shape, rand=None, return_idx: bool = False):
        """Sigmas of `shape` (an int batch or a tuple: (b, t) for the TASD
        losses); `rand` gives the indices instead of drawing them."""
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        if rand is not None:
            idx = rand
        elif self.uniform_sampling:
            interval = self.num_idx // self.group_num
            dev = generator.device
            group = (torch.arange(shape[0], device=dev) * self.group_num) // shape[0]
            lo = (group * interval).reshape((-1,) + (1,) * (len(shape) - 1))
            idx = lo + torch.randint(0, interval, shape, generator=generator, device=dev)
        else:
            idx = torch.randint(0, self.num_idx, shape, generator=generator,
                                device=generator.device)
        sigma = self.idx_to_sigma(idx)
        return (sigma, idx) if return_idx else sigma
