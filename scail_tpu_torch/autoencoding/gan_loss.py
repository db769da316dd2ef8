"""GAN losses for autoencoder training (counterpart of
scail_tpu/autoencoding/gan_loss.py).

- `LPIPSWithDiscriminator` (:79-213; reference GeneralLPIPSWithDiscriminator,
  sgm/modules/autoencoding/losses/discriminator_loss.py:17-314): L1 + LPIPS
  + logvar NLL + the adversarial term with the adaptive generator weight,
  hinge or vanilla discriminator loss, the disc_start gate and the
  regularization weights.
- `VideoAutoencoderLoss` (:215-304; reference video_loss.py:550-759): MSE +
  LPIPS on one random frame + the 3D-GAN terms + the quantizer aux.

Layouts are the port's: images (b, c, h, w), videos (b, c, t, h, w).  The
discriminator is a module called on the reconstruction; its parameters get
no gradient from a generator loss (the JAX functions stop-gradient them).

The adaptive weight is the ratio of the norms of d nll / d w and d g / d w
over the decoder's last layer w (_head_grad_norms, :64-76): the head
re-applied to its detached input features, and two torch.autograd.grad
calls on the head's parameters, so neither gradient reaches the generator's.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# d-loss zoo (gan_loss.py:35-55)
# ---------------------------------------------------------------------------
def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real)) + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.softplus(-logits_real)) + torch.mean(F.softplus(logits_fake)))


def hinge_discr_loss(logits_fake, logits_real):
    """video_loss.py:37-38: not halved, unlike hinge_d_loss."""
    return torch.mean(F.relu(1.0 + logits_fake) + F.relu(1.0 - logits_real))


def hinge_gen_loss(logits_fake):
    return -torch.mean(logits_fake)


def pick_video_frame(video, frame_indices):
    """video (b, c, t, ...) and a frame index per item (b,) -> (b, c, ...)
    (gan_loss.py:57-62 on the port's time axis)."""
    return video[torch.arange(video.shape[0], device=video.device), :, frame_indices]


def _flat_frames(t):
    """(b, c, t, h, w) -> (b t, c, h, w), frames of an item together."""
    b, c, n = t.shape[:3]
    return t.transpose(1, 2).reshape(b * n, c, *t.shape[3:])


@contextlib.contextmanager
def no_param_grads(module):
    """The module's parameters take no gradient inside the block (the JAX
    losses stop-gradient the discriminator's parameters)."""
    params = [p for p in module.parameters() if p.requires_grad] if module is not None else []
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def head_grad_norms(adaptive_ctx, nll_of_recon: Callable, g_of_recon: Callable):
    """(|d nll / d w|, |d g / d w|) over the head's parameters w, the head
    applied to its detached input features (gan_loss.py:64-76); both graphs
    are separate from the caller's."""
    head, feats = adaptive_ctx
    params = [p for p in head.parameters() if p.requires_grad]
    with torch.enable_grad():
        recon = head(feats.detach())
        norms = []
        for fn in (nll_of_recon, g_of_recon):
            grads = torch.autograd.grad(fn(recon), params, retain_graph=True, allow_unused=True)
            norms.append(torch.sqrt(sum(g.float().square().sum() for g in grads
                                        if g is not None)))
    return norms[0], norms[1]


@dataclasses.dataclass
class LPIPSWithDiscriminator:
    """generator_loss == forward(optimizer_idx=0) (discriminator_loss.py:
    246-282); discriminator_loss == forward(optimizer_idx=1) (:283-298).
    `lpips` is a module (x, y) -> (b,) (evals/lpips.LPIPS), or None: no
    perceptual term."""

    disc_start: int
    disc_factor: float = 1.0
    disc_weight: float = 1.0
    perceptual_weight: float = 1.0
    disc_loss: str = "hinge"
    learn_logvar: bool = False
    regularization_weights: Optional[Dict[str, float]] = None
    dims: int = 2
    lpips: Optional[Callable] = None

    def __post_init__(self):
        assert self.disc_loss in ("hinge", "vanilla")
        self._d_loss = hinge_d_loss if self.disc_loss == "hinge" else vanilla_d_loss

    def _perceptual(self):
        return self.perceptual_weight > 0 and self.lpips is not None

    def _nll(self, inputs, recons, logvar, generator, weights=None, frame_indices=None):
        """(nll_fn, nll_loss, weighted_nll, rec, p_loss): nll_fn(recon) is the
        unweighted nll as a function of the reconstruction, LPIPS included
        (the adaptive weight differentiates through it)."""
        if self._perceptual() and inputs.dim() == 5 and frame_indices is None:
            frame_indices = torch.randint(0, inputs.shape[2], (inputs.shape[0],),
                                          generator=generator, device=generator.device
                                          ).to(inputs.device)

        def parts(recon):
            rec = torch.abs(inputs.float() - recon.float())
            p = rec.new_zeros(())
            if self._perceptual():
                if inputs.dim() == 5:  # LPIPS on one frame of each clip
                    pi = pick_video_frame(inputs, frame_indices)
                    pr = pick_video_frame(recon, frame_indices)
                else:
                    pi, pr = inputs, recon
                p = torch.mean(self.lpips(pi, pr))
                rec = rec + self.perceptual_weight * p
            return rec / torch.exp(logvar) + logvar, rec, p

        nll, rec, p_loss = parts(recons)
        weighted = nll if weights is None else weights * nll
        nll_loss = torch.sum(nll) / nll.shape[0]
        weighted_nll = torch.sum(weighted) / weighted.shape[0]

        def nll_fn(recon):
            n = parts(recon)[0]
            return torch.sum(n) / n.shape[0]

        return nll_fn, nll_loss, weighted_nll, rec, p_loss

    def _flat(self, t):
        return _flat_frames(t) if self.dims > 2 and t.dim() == 5 else t

    def generator_loss(self, discriminator, logvar, inputs, recons, regularization_log: Dict,
                       global_step: int, *, generator=None, adaptive_ctx=None,
                       training: bool = True, weights=None, frame_indices=None):
        """(loss, log); recons carries the autoencoder's graph; adaptive_ctx
        is (decoder head module, its detached input features)."""
        nll_fn, nll_loss, weighted_nll, rec, p_loss = self._nll(
            inputs, recons, logvar, generator, weights, frame_indices)
        zero = weighted_nll.new_zeros(())
        with no_param_grads(discriminator):
            if global_step >= self.disc_start or not training:
                g_loss = hinge_gen_loss(discriminator(self._flat(recons)))
                if training:
                    assert adaptive_ctx is not None, (
                        "a training generator step needs adaptive_ctx (head, feats)")

                    def g_of(recon):
                        return hinge_gen_loss(discriminator(self._flat(recon)))

                    nll_n, g_n = head_grad_norms(adaptive_ctx, nll_fn, g_of)
                    d_weight = torch.clamp(nll_n / (g_n + 1e-4), 0.0, 1e4).detach()
                    d_weight = d_weight * self.disc_weight
                else:
                    d_weight = zero + 1.0
            else:
                d_weight, g_loss = zero, zero
        loss = weighted_nll + d_weight * self.disc_factor * g_loss
        log = {"loss/nll": nll_loss, "loss/rec": torch.mean(rec), "loss/percep": p_loss,
               "loss/g": g_loss, "scalars/logvar": logvar, "scalars/d_weight": d_weight}
        for k, v in (regularization_log or {}).items():
            if self.regularization_weights and k in self.regularization_weights:
                loss = loss + self.regularization_weights[k] * v
            log[k] = v.float().mean() if torch.is_tensor(v) and v.dim() else v
        log["loss/total"] = loss
        return loss, log

    def discriminator_loss(self, discriminator, inputs, recons, global_step: int, *,
                           training: bool = True):
        """Real and fake logits on detached inputs, the gated d loss
        (discriminator_loss.py:283-298)."""
        inputs, recons = self._flat(inputs), self._flat(recons)
        logits_real = discriminator(inputs.detach())
        logits_fake = discriminator(recons.detach())
        if global_step >= self.disc_start or not training:
            d_loss = self.disc_factor * self._d_loss(logits_real, logits_fake)
        else:
            d_loss = logits_real.new_zeros(())
        return d_loss, {"loss/disc": d_loss, "logits/real": torch.mean(logits_real),
                        "logits/fake": torch.mean(logits_fake)}


@dataclasses.dataclass
class VideoAutoencoderLoss:
    """MSE recon + LPIPS on one random frame + hinge GAN + quantizer aux,
    following the JAX package (gan_loss.py:215-304), not upstream
    video_loss.py where they part:
      * the adversarial term is on once global_step >= disc_start (upstream
        gates it the other way round, video_loss.py:636-639; the JAX
        package chose the documented intent, gan_loss.py:240-247);
      * the adaptive weight is computed and logged but not multiplied into
        the total (as upstream, video_loss.py:686-691)."""

    disc_start: int
    perceptual_weight: float = 1.0
    adversarial_loss_weight: float = 0.0
    grad_penalty_loss_weight: float = 0.0
    quantizer_aux_loss_weight: float = 0.0
    lpips: Optional[Callable] = None

    def generator_loss(self, discriminator, inputs, recons, global_step: int, *,
                       generator=None, aux_losses=None, adaptive_ctx=None,
                       training: bool = True, frame_indices=None):
        recon_loss = torch.mean((inputs.float() - recons.float()) ** 2)
        zero = recon_loss.new_zeros(())
        p_loss = zero
        percep = self.perceptual_weight > 0 and self.lpips is not None
        if percep:
            if frame_indices is None:
                frame_indices = torch.randint(0, inputs.shape[2], (inputs.shape[0],),
                                              generator=generator, device=generator.device
                                              ).to(inputs.device)
            p_loss = torch.mean(self.lpips(pick_video_frame(inputs, frame_indices),
                                           pick_video_frame(recons, frame_indices)))
        gen_loss, adaptive_weight = zero, zero
        if training and self.adversarial_loss_weight > 0:
            with no_param_grads(discriminator):
                gen_loss = hinge_gen_loss(discriminator(recons))
                gen_loss = gen_loss * float(global_step >= self.disc_start)
                if adaptive_ctx is not None and percep:
                    def percep_of(recon):
                        return torch.mean(self.lpips(pick_video_frame(inputs, frame_indices),
                                                     pick_video_frame(recon, frame_indices)))

                    def g_of(recon):
                        return hinge_gen_loss(discriminator(recon))

                    pn, gn = head_grad_norms(adaptive_ctx, percep_of, g_of)
                    adaptive_weight = torch.clamp(pn / torch.clamp(gn, min=1e-3), max=1e3)
                    adaptive_weight = torch.nan_to_num(adaptive_weight, nan=1.0).detach()
        aux = zero if aux_losses is None else aux_losses
        total = (recon_loss + aux * self.quantizer_aux_loss_weight
                 + p_loss * self.perceptual_weight + gen_loss * self.adversarial_loss_weight)
        return total, {"total_loss": total, "recon_loss": recon_loss, "perceptual_loss": p_loss,
                       "gen_loss": gen_loss, "aux_losses": aux,
                       "adaptive_weight": adaptive_weight}

    def discriminator_loss(self, discriminator, inputs, recons, global_step: int):
        """The hinge discriminator loss and the optional gradient penalty on
        the real inputs (video_loss.py:706-759)."""
        recons = recons.detach()
        real = inputs.detach().requires_grad_(self.grad_penalty_loss_weight > 0)
        logits_real = discriminator(real)
        logits_fake = discriminator(recons)
        d_loss = hinge_discr_loss(logits_fake, logits_real)
        gp = d_loss.new_zeros(())
        if self.grad_penalty_loss_weight > 0:
            (grads,) = torch.autograd.grad(logits_real.sum(), real, create_graph=True)
            gnorm = torch.sqrt(grads.float().square().flatten(1).sum(1) + 1e-12)
            gp = torch.mean((gnorm - 1.0) ** 2)
        total = d_loss + self.grad_penalty_loss_weight * gp
        return total, {"total_disc_loss": total, "discr_loss": d_loss, "grad_penalty_loss": gp,
                       "logits_real": torch.mean(logits_real),
                       "logits_fake": torch.mean(logits_fake)}
