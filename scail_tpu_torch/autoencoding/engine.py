"""Adversarial autoencoder training with alternating generator and
discriminator optimizers (counterpart of scail_tpu/autoencoding/engine.py:
27-132; reference Lightning engine sgm/models/autoencoder.py:109-304).

`train_step` picks the optimizer by batch_idx % 2 and forces the generator
before disc_start (:289-304).  The generator is one module: encoder,
regularizer (whose trainable parameters, such as a VQ codebook, train with
it), decoder body, decoder head and `logvar`, under one
torch.optim.Adam(ae_lr * lr_g_factor); the discriminator has its own
Adam(disc_lr).  torch.optim.Adam's update is optax.adam's (eps outside the
square root, bias correction of both moments).  The decoder is split at its
last layer, the head, which gives the GAN loss its adaptive weight.  The
discriminator step reconstructs under no_grad and differentiates only the
discriminator.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from scail_tpu_torch.autoencoding.gan_loss import VideoAutoencoderLoss


class AutoencoderTrainer:
    """encoder(x) -> latent; regularizer(z, generator) -> (z, log);
    decoder_body(z) -> features; decoder_head(features) -> reconstruction
    (modules, e.g. VQModel.trainer_parts()); loss: LPIPSWithDiscriminator or
    VideoAutoencoderLoss; discriminator: a module."""

    def __init__(self, encoder: nn.Module, regularizer: nn.Module, decoder_body: nn.Module,
                 decoder_head: nn.Module, loss: Any, discriminator: nn.Module,
                 disc_start: int = 0, ae_lr: float = 1e-4, disc_lr: float = 1e-4,
                 lr_g_factor: float = 1.0, logvar: Optional[float] = 0.0):
        self.loss, self.discriminator, self.disc_start = loss, discriminator, disc_start
        m = nn.Module()
        m.encoder, m.regularizer = encoder, regularizer
        m.decoder_body, m.decoder_head = decoder_body, decoder_head
        device = next(decoder_head.parameters()).device
        m.logvar = nn.Parameter(torch.tensor(float(logvar), device=device))
        self.model = m
        self.opt_gen = torch.optim.Adam(m.parameters(), lr=ae_lr * lr_g_factor)
        self.opt_disc = torch.optim.Adam(discriminator.parameters(), lr=disc_lr)
        self.step = 0

    def reconstruct(self, x, generator=None):
        """(reconstruction, head features, latent, regularizer log)
        (autoencoder.py:222-227)."""
        m = self.model
        z, reg_log = m.regularizer(m.encoder(x), generator)
        feats = m.decoder_body(z)
        return m.decoder_head(feats), feats, z, reg_log

    def generator_step(self, batch, generator=None, global_step: int = 0):
        """One generator update; returns (loss, log)."""
        m = self.model
        self.opt_gen.zero_grad(set_to_none=True)
        recon, feats, _, reg_log = self.reconstruct(batch, generator)
        ctx = (m.decoder_head, feats)
        if isinstance(self.loss, VideoAutoencoderLoss):
            loss, log = self.loss.generator_loss(
                self.discriminator, batch, recon, global_step, generator=generator,
                aux_losses=reg_log.get("aux_loss"), adaptive_ctx=ctx)
        else:
            loss, log = self.loss.generator_loss(
                self.discriminator, m.logvar, batch, recon, reg_log, global_step,
                generator=generator, adaptive_ctx=ctx)
        loss.backward()
        if not getattr(self.loss, "learn_logvar", False):
            m.logvar.grad = torch.zeros_like(m.logvar)
        self.opt_gen.step()
        self.step += 1
        return loss.detach(), log

    def discriminator_step(self, batch, generator=None, global_step: int = 0):
        """One discriminator update on a reconstruction made without a graph."""
        with torch.no_grad():
            recon = self.reconstruct(batch, generator)[0]
        self.opt_disc.zero_grad(set_to_none=True)
        loss, log = self.loss.discriminator_loss(self.discriminator, batch, recon, global_step)
        if loss.requires_grad:
            loss.backward()
        else:  # gated off before disc_start: a zero gradient, as jax.grad gives
            for p in self.discriminator.parameters():
                p.grad = torch.zeros_like(p)
        self.opt_disc.step()
        self.step += 1
        return loss.detach(), log

    def train_step(self, batch, generator, batch_idx: int, global_step: int):
        """Even batches (or any before disc_start) train the generator, odd
        ones the discriminator."""
        optimizer_idx = batch_idx % 2
        if global_step < self.disc_start:
            optimizer_idx = 0
        if optimizer_idx == 0:
            return self.generator_step(batch, generator, global_step)
        return self.discriminator_step(batch, generator, global_step)
