"""Training losses (counterpart of scail_tpu/diffusion/loss.py: the standard
loss, RFLoss (the SCAIL objective), the progressive-distillation loss and the
temporal-autoregressive self-distillation losses TASD and TASD-RF).

RFLoss: sigma ~ LogisticNormal, optionally shifted by resolution; only the
non-history frames are noised, x_sigma = (1 - sigma) x + sigma noise; the
target is the rectified-flow velocity noise - x, and the L2 error is masked to
the generated frames.  Sigma and noise come from an explicit torch.Generator,
in that order, or are passed in (`sigma=`, `noise=`) by a caller that must
reproduce given draws; so are the draws of the other losses.

PDDiffusionLoss: the student learns to match two teacher DDIM steps on the
sqrt(alphas_cumprod) ladder in one, at a random guidance scale.  TASDLoss /
TASDLossRF: per-frame noise levels, the clean frames prepended along time as
in-context history, the loss on the noised half.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from scail_tpu_torch.utils.misc import append_dims
from scail_tpu_torch.utils.registry import instantiate_from_config, register


@register(alias="sgm.modules.diffusionmodules.loss.StandardDiffusionLoss")
class StandardDiffusionLoss:
    def __init__(self, sigma_sampler_config=None, type: str = "l2",
                 offset_noise_level: float = 0.0, batch2model_keys=None, **kw):
        self.sigma_sampler = (instantiate_from_config(sigma_sampler_config)
                              if sigma_sampler_config is not None else None)
        if type not in ("l2", "l1"):
            raise ValueError(f"unknown loss type {type!r}")
        self.type = type
        self.offset_noise_level = offset_noise_level

    def get_loss(self, model_output, target, w):
        """Per-sample mean of w * err^2 (or w * |err|): shape (b,)."""
        b = target.shape[0]
        err = model_output - target
        per = w * (err.square() if self.type == "l2" else err.abs())
        return per.reshape(b, -1).mean(dim=1)

    def _draw(self, generator, input, sigma, noise):
        """Sigma (b,) then noise like input, from the generator unless given."""
        if sigma is None:
            sigma = self.sigma_sampler(generator, input.shape[0])
        if noise is None:
            noise = torch.randn(input.shape, generator=generator, device=input.device)
        return sigma, noise

    def __call__(self, generator, network_fn, denoiser, cond: Dict, input, *, sigma=None,
                 noise=None, offset=None, **model_kwargs):
        """x_sigma = x + sigma * noise; the denoiser's x0 against x, weighted by
        denoiser.w(sigma).  With offset_noise_level > 0 the noise gains
        offset_noise_level * N(0, 1) per sample (`offset`, (b,), drawn after
        the noise unless given)."""
        sigma, noise = self._draw(generator, input, sigma, noise)
        if self.offset_noise_level > 0.0:
            if offset is None:
                offset = torch.randn((input.shape[0],), generator=generator,
                                     device=input.device)
            noise = noise + self.offset_noise_level * append_dims(offset, input.dim())
        inp = input.float()
        out = denoiser(network_fn, inp + noise * append_dims(sigma, input.dim()), sigma, cond,
                       **model_kwargs)
        return self.get_loss(out, inp, append_dims(denoiser.w(sigma), input.dim()))


def get_3d_position_ids(frame_len: int, h: int, w: int, device=None):
    """(frame_len, h, w, 3) integer (t, h, w) grid."""
    grids = torch.meshgrid(*(torch.arange(n, device=device) for n in (frame_len, h, w)),
                           indexing="ij")
    return torch.stack(grids, dim=-1)


def _tasd_position_ids(b: int, t: int, H: int, W: int, patch_size, device=None):
    """rope_position_ids (b, 2 * tokens, 3) of the [clean | noised] sequence."""
    pos = get_3d_position_ids(t // patch_size[0], H // patch_size[1], W // patch_size[2],
                              device).reshape(-1, 3)
    return pos.repeat(2, 1)[None].expand(b, -1, -1)


def guidance_scale_embedding(w, embedding_dim: int = 512):
    """Sinusoidal embedding of the guidance scale w * 1000, [sin | cos]."""
    w = torch.as_tensor(w, dtype=torch.float32) * 1000.0
    half = embedding_dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=w.device)
                      * (-math.log(10000.0) / (half - 1)))
    emb = w[:, None] * freqs[None]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def time_shift(mu: float, t):
    """Resolution shift of sigma ('normal' mode): e^mu / (e^mu + 1/t - 1)."""
    return math.exp(mu) / (math.exp(mu) + 1.0 / t - 1.0)


def resolution_shift_mu(image_seq_len: int) -> float:
    """The shift's mu, linear in the per-frame token count: 0.5 at 256 tokens,
    1.15 at 4096."""
    m = (1.15 - 0.5) / (4096 - 256)
    return float(m * image_seq_len + 0.5 - m * 256)


@register(alias="sgm.modules.diffusionmodules.loss.RFLoss")
class RFLoss(StandardDiffusionLoss):
    def __init__(self, schedule_shift: bool = False, **kw):
        super().__init__(**kw)
        self.schedule_shift = schedule_shift

    def __call__(self, generator, network_fn, denoiser, cond: Dict, input, *,
                 history_mask: Optional[torch.Tensor] = None, patch_size=(1, 2, 2),
                 sigma=None, noise=None, **model_kwargs):
        """input (b, T, C, H, W) latent; history_mask (b, T, 4, H, W) marks
        clean history frames.  Returns the per-sample loss (b,)."""
        sigma, noise = self._draw(generator, input, sigma, noise)
        if self.schedule_shift:
            tokens = input.shape[-1] * input.shape[-2] // patch_size[-1] // patch_size[-2]
            sigma = time_shift(resolution_shift_mu(tokens), sigma)
        if history_mask is None:
            hist = torch.zeros_like(input[:, :, :1], dtype=torch.float32)
        else:
            hist = history_mask[:, :, :1].float()
        hist = hist.expand(input.shape)
        inp = input.float()
        sig_b = append_dims(sigma, input.dim())
        noised = inp * (1.0 - sig_b) + noise * (1.0 - hist) * sig_b  # history stays clean
        out = denoiser(network_fn, noised, sigma, cond, history_mask=history_mask,
                       **model_kwargs)
        return self.get_loss(out, noise - inp, 1.0 - hist)


@register(alias="sgm.modules.diffusionmodules.loss.PDDiffusionLoss")
class PDDiffusionLoss(StandardDiffusionLoss):
    """Over the sqrt(alphas_cumprod) parametrization (VideoScaling and
    ZeroSNRDDPMDiscretization); `teacher_fn` is the frozen teacher network."""

    def __init__(self, type: str = "l2", discretization_config=None, num_idx: int = 1000,
                 add_dsm_loss: bool = False, **kw):
        super().__init__(type=type, **kw)
        disc = instantiate_from_config(discretization_config)
        ac, timesteps = disc(num_idx, do_append_zero=False, flip=True, return_idx=True)
        # the clean endpoint first
        self.ac_all = np.concatenate([[1.0], np.asarray(ac, np.float32)]).astype(np.float32)
        self.timesteps = np.concatenate([[-1], np.asarray(timesteps)]).astype(np.int64)
        self.num_idx = num_idx
        self.add_dsm_loss = add_dsm_loss

    def __call__(self, generator, network_fn, denoiser, cond: Dict, input, *, teacher_fn,
                 uncond: Optional[Dict] = None, rand=None, scale=None, noise=None,
                 **model_kwargs):
        """Draws, in this order unless given: `rand` (b,) an even rung in [2,
        num_idx], `scale` (b,) in [1.5, 9), `noise` like input."""
        b, dev = input.shape[0], input.device
        if rand is None:
            rand = torch.randint(1, self.num_idx // 2 + 1, (b,), generator=generator,
                                 device=dev) * 2
        if scale is None:
            scale = 1.5 + torch.rand((b,), generator=generator, device=dev) * 7.5
        if noise is None:
            noise = torch.randn(input.shape, generator=generator, device=dev)
        ac_all = torch.from_numpy(self.ac_all).to(dev)
        timesteps = torch.from_numpy(self.timesteps).to(dev)
        ac, ac_next, ac_nn = ac_all[rand], ac_all[rand - 1], ac_all[rand - 2]
        nd = input.dim()
        inp = input.float()
        noised = inp * append_dims(ac, nd) + noise * append_dims((1 - ac ** 2) ** 0.5, nd)
        # the student at guidance scale `scale`
        out = denoiser(network_fn, noised, ac, cond, idx=timesteps[rand], cfg_scale=scale,
                       **model_kwargs)

        def ddim_step(x, a, a_next, idx):  # the teacher without CFG
            den = denoiser(teacher_fn, x, a, cond, idx=idx, **model_kwargs)
            a_t = append_dims(((1 - a_next ** 2) / (1 - a ** 2)) ** 0.5, nd)
            return a_t * x + (append_dims(a_next, nd) - append_dims(a, nd) * a_t) * den

        with torch.no_grad():
            x_next = ddim_step(noised, ac, ac_next, timesteps[rand])
            x_nn = ddim_step(x_next, ac_next, ac_nn, timesteps[rand - 1])
        a_t = (1 - ac_nn ** 2) ** 0.5 / (1 - ac ** 2) ** 0.5
        target = (x_nn - append_dims(a_t, nd) * noised) / append_dims(ac_nn - a_t * ac, nd)
        w = append_dims(1.0 / (1 - ac ** 2), nd)  # v-prediction weighting
        loss = self.get_loss(out, target, w)
        if self.add_dsm_loss:
            loss = loss + 0.001 * self.get_loss(out, inp, w)
        return loss


@register(alias="sgm.modules.diffusionmodules.loss.TASDLoss")
class TASDLoss(StandardDiffusionLoss):
    """DDPM parametrization: per-frame alphas_cumprod_sqrt from the sigma
    sampler (DiscreteSampling), weight 1 / (1 - ac^2), clamped to
    min_snr_value element by element when set.  Use with
    DiscreteDenoiser_TASD and a network that takes per-frame timesteps and
    rope_position_ids."""

    def __init__(self, min_snr_value=None, **kw):
        super().__init__(**kw)
        self.min_snr_value = min_snr_value

    def __call__(self, generator, network_fn, denoiser, cond: Dict, input, *,
                 patch_size=(1, 2, 2), noise=None, alphas_idx=None, **model_kwargs):
        """input (b, t, c, H, W); draws `alphas_idx` (b, t) then `noise`."""
        b, t = input.shape[:2]
        if alphas_idx is not None:
            idx = alphas_idx
            ac = self.sigma_sampler.idx_to_sigma(idx)
        else:
            ac, idx = self.sigma_sampler(generator, (b, t), return_idx=True)
        if noise is None:
            noise = torch.randn(input.shape, generator=generator, device=input.device)
        nd = input.dim()
        inp = input.float()
        noised = inp * append_dims(ac, nd) + noise * append_dims((1.0 - ac ** 2) ** 0.5, nd)
        noised = torch.cat([inp, noised], dim=1)  # clean history first
        ac_full = torch.cat([torch.ones_like(ac), ac], dim=1)
        idx_full = torch.cat([torch.zeros_like(idx), idx], dim=1)
        pos = _tasd_position_ids(b, t, input.shape[3], input.shape[4], patch_size, input.device)
        out = denoiser(network_fn, noised, ac_full, cond, idx=idx_full, rope_position_ids=pos,
                       **model_kwargs)[:, t:]
        w = append_dims(1.0 / (1.0 - ac_full[:, t:] ** 2), nd)
        if self.min_snr_value is not None:
            w = w.clamp(max=self.min_snr_value)
        return self.get_loss(out, inp, w)


@register(alias="sgm.modules.diffusionmodules.loss.TASDLoss_RF")
class TASDLossRF(StandardDiffusionLoss):
    """Rectified flow: per-frame t from the sigma sampler (optionally shifted
    by resolution), clean (or lightly noised) history prepended, target noise
    - input on the noised half, without its first frame when remove_first."""

    def __init__(self, schedule_shift: bool = False, noise_augmentation: bool = False,
                 aug: bool = False, aug_max=None, remove_first: bool = True, **kw):
        super().__init__(**kw)
        self.schedule_shift = schedule_shift
        self.noise_augmentation = noise_augmentation
        self.aug = aug
        self.aug_max = aug_max
        self.remove_first = remove_first

    def __call__(self, generator, network_fn, denoiser, cond: Dict, input, *,
                 patch_size=(1, 2, 2), noise=None, t_indices=None, **model_kwargs):
        """Draws `t_indices` (b, t), `noise`, then those of the history's
        noise augmentation and of `aug`."""
        b, t = input.shape[:2]
        dev = input.device

        def randn(shape):
            return torch.randn(shape, generator=generator, device=dev)

        if t_indices is None:
            t_indices = self.sigma_sampler(generator, (b, t))
        if noise is None:
            noise = randn(input.shape)
        if self.schedule_shift:
            tokens = input.shape[-1] * input.shape[-2] // patch_size[-1] // patch_size[-2]
            t_indices = time_shift(resolution_shift_mu(tokens), t_indices)
        nd = input.dim()
        inp = input.float()
        noised = inp * append_dims(1.0 - t_indices, nd) + noise * append_dims(t_indices, nd)
        if self.noise_augmentation:  # the history gets light noise
            sig = torch.exp(-3.0 + 0.5 * randn(inp.shape))
            inp = inp + sig * randn(inp.shape)
        if not self.aug:
            history, t_hist = inp, torch.zeros_like(t_indices)
        else:  # partially noised history
            aug_noise = randn(inp.shape)
            t_hist = torch.rand((b, t), generator=generator, device=dev) * self.aug_max
            history = inp * append_dims(1.0 - t_hist, nd) + aug_noise * append_dims(t_hist, nd)
        pos = _tasd_position_ids(b, t, input.shape[3], input.shape[4], patch_size, dev)
        out = denoiser(network_fn, torch.cat([history, noised], dim=1),
                       torch.cat([t_hist, t_indices], dim=1), cond, rope_position_ids=pos,
                       **model_kwargs)[:, t:]
        label = noise - inp  # the history's input after augmentation
        if self.remove_first:
            out, label = out[:, 1:], label[:, 1:]
        return self.get_loss(out, label, 1.0)
