"""Latent regularizers (counterpart of scail_tpu/autoencoding/regularizers.py):
the diagonal-Gaussian (KL) one, vector quantization with a trained or an EMA
codebook, and lookup-free quantization (LFQ).  Channels on dim 1 (NCHW /
NCTHW) at the modules' edges; the JAX functions take channels last.

LFQ's entropy terms need softmax over every code for every token: at the
video tokenizer's 2^18 codes and 36,864 tokens that is 38.6 GB of f32, so
past LFQ_CHUNK_ELEMENTS they run in chunks of tokens (_ChunkedLFQEntropy),
the same function with the clip(prob, 1e-5) inside the log.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def diagonal_gaussian_regularizer(z, generator: Optional[torch.Generator] = None, *,
                                  sample: bool = True, noise=None
                                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """z (b, 2c, ...): mean and logvar on dim 1.  Returns (latent (b, c, ...),
    {'kl_loss': scalar}): the mean, or with `sample` mean + std * noise
    (`noise` given, else drawn from `generator`).  logvar is clamped to
    [-30, 20]; the KL is summed over the non-batch dims and averaged over the
    batch."""
    mean, logvar = z.chunk(2, dim=1)
    logvar = logvar.clamp(-30.0, 20.0)
    if sample:
        if noise is None:
            if generator is None:
                raise ValueError("a sampling regularizer needs a generator or the noise")
            noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                                dtype=mean.dtype)
        out = mean + torch.exp(0.5 * logvar) * noise
    else:
        out = mean
    kl = 0.5 * (mean.float() ** 2 + torch.exp(logvar).float() - 1.0 - logvar.float())
    return out, {"kl_loss": kl.sum() / z.shape[0]}


def measure_perplexity(indices, num_centroids: int):
    """Codebook usage perplexity and the number of codes used
    (regularizers.py:58; reference regularizers/base.py:29-40)."""
    onehot = F.one_hot(indices.reshape(-1).long(), num_centroids).float()
    avg = onehot.mean(dim=0)
    perplexity = torch.exp(-torch.sum(avg * torch.log(avg + 1e-10)))
    return perplexity, torch.sum(avg > 0)


def _channels_last(z):
    return z.movedim(1, -1)


def _nearest_code(zf, emb):
    """(N, d) x (n, d) -> argmin_j ||z - e_j||^2 in the expanded form
    (quantize.py:250-259)."""
    d = (zf.square().sum(1, keepdim=True) + emb.square().sum(1)[None, :]
         - 2.0 * zf @ emb.t())
    return d.argmin(dim=1)


class VectorQuantizer(nn.Module):
    """Nearest-code VQ with the straight-through estimator and the beta
    commitment (regularizers.py:71-111; reference quantize.py:172-320).
    Channels on dim 1; the codebook is `embedding.weight` (n_e, e_dim), as
    the reference's `quantize.embedding.weight`, trained by the optimizer."""

    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25, log_perplexity=False,
                 device=None):
        super().__init__()
        self.n_e, self.e_dim, self.beta, self.log_perplexity = n_e, e_dim, beta, log_perplexity
        self.embedding = nn.Embedding(n_e, e_dim, device=device)

    def init_random_(self, generator: torch.Generator):
        """U(-1/n_e, 1/n_e) (quantize.py:204)."""
        with torch.no_grad():
            self.embedding.weight.uniform_(-1.0 / self.n_e, 1.0 / self.n_e, generator=generator)
        return self

    def forward(self, z, generator=None):
        """z (b, e_dim, ...) -> (z_q, {'loss/vq', 'min_encoding_indices' (b, ...)}):
        loss = beta * mean((sg[z_q] - z)^2) + mean((z_q - sg[z])^2)."""
        emb = self.embedding.weight
        zl = _channels_last(z)
        zf = zl.reshape(-1, self.e_dim).float()
        idx = _nearest_code(zf, emb.float())
        z_q = emb[idx].reshape(zl.shape).to(z.dtype)
        loss = (self.beta * torch.mean((z_q.detach() - zl) ** 2)
                + torch.mean((z_q - zl.detach()) ** 2))
        log = {"loss/vq": loss, "min_encoding_indices": idx.reshape(zl.shape[:-1])}
        if self.log_perplexity:
            p, c = measure_perplexity(idx, self.n_e)
            log.update({"perplexity": p, "cluster_usage": c})
        z_q = zl + (z_q - zl).detach()
        return z_q.movedim(-1, 1), log

    def get_codebook_entry(self, indices):
        """(b, ...) indices -> (b, e_dim, ...) codes."""
        return self.embedding.weight[indices].movedim(-1, 1)


class EmbeddingEMA(nn.Module):
    """The EMA codebook (quantize.py:323-352): `weight`, `cluster_size` and
    `embed_avg` are buffers updated in place, never by an optimizer."""

    def __init__(self, n_embed: int, embedding_dim: int, device=None):
        super().__init__()
        self.register_buffer("weight", torch.zeros(n_embed, embedding_dim, device=device))
        self.register_buffer("cluster_size", torch.zeros(n_embed, device=device))
        self.register_buffer("embed_avg", torch.zeros(n_embed, embedding_dim, device=device))


class EMAVectorQuantizer(nn.Module):
    """VQ with an EMA codebook (regularizers.py:113-155; reference
    quantize.py:323-445): in training mode each forward moves the cluster
    sizes and sums by `decay` and renormalises the codebook with Laplace
    smoothing, under no_grad; loss = beta * mse(sg[z_q], z)."""

    def __init__(self, n_embed: int, embedding_dim: int, beta: float, decay: float = 0.99,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.n_embed, self.embedding_dim = n_embed, embedding_dim
        self.beta, self.decay, self.eps = beta, decay, eps
        self.embedding = EmbeddingEMA(n_embed, embedding_dim, device=device)

    def init_random_(self, generator: torch.Generator):
        """weight N(0, 1), cluster sizes 0, embed_avg a copy of the weight."""
        e = self.embedding
        with torch.no_grad():
            e.weight.normal_(generator=generator)
            e.cluster_size.zero_()
            e.embed_avg.copy_(e.weight)
        return self

    def forward(self, z, generator=None):
        """z (b, d, ...) -> (z_q, {'loss/vq', 'encoding_indices' (N,),
        'perplexity'}); the codebook moves in training mode only."""
        e = self.embedding
        n, d = e.weight.shape
        zl = _channels_last(z)
        zf = zl.reshape(-1, d).float()
        w = e.weight
        idx = _nearest_code(zf, w)
        z_q = w[idx].reshape(zl.shape).to(z.dtype)
        onehot = F.one_hot(idx, n).float()
        avg_probs = onehot.mean(dim=0)
        perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
        if self.training:
            with torch.no_grad():
                e.cluster_size.mul_(self.decay).add_(onehot.sum(0), alpha=1 - self.decay)
                e.embed_avg.mul_(self.decay).add_(onehot.t() @ zf.detach(),
                                                  alpha=1 - self.decay)
                tot = e.cluster_size.sum()
                smoothed = (e.cluster_size + self.eps) / (tot + n * self.eps) * tot
                e.weight.copy_(e.embed_avg / smoothed[:, None])
        loss = self.beta * torch.mean((z_q.detach() - zl) ** 2)
        z_q = zl + (z_q - zl).detach()
        return z_q.movedim(-1, 1), {"loss/vq": loss, "encoding_indices": idx,
                                    "perplexity": perplexity}


# ---------------------------------------------------------------------------
# Lookup-free quantization (regularizers.py:157-251; reference
# lookup_free_quantization.py:53-302, MagViT-2)
# ---------------------------------------------------------------------------
# above this many (token, codebook, code) probabilities the entropy terms run
# in chunks of tokens (512 MB of f32 a chunk)
LFQ_CHUNK_ELEMENTS = 1 << 27


def lfq_codebook(codebook_size: int, codebook_scale: float = 1.0, device=None):
    """The 2^d sign patterns (codebook_size, d), most significant bit first."""
    d = int(math.log2(codebook_size))
    mask = 2 ** torch.arange(d - 1, -1, -1, device=device)
    bits = (torch.arange(codebook_size, device=device)[:, None] & mask) != 0
    return bits.float() * codebook_scale * 2 - codebook_scale


def _entropy(prob):
    return torch.sum(-prob * torch.log(prob.clamp(min=1e-5)), dim=-1)


def _entropy_grad(prob):
    """d/dp of sum(-p log(clip(p, 1e-5))): the clip passes no gradient below
    its floor."""
    return -torch.log(prob.clamp(min=1e-5)) - (prob > 1e-5).to(prob.dtype)


def lfq_entropy_terms(x, codebook, inv_temperature: float, chunk_tokens: Optional[int] = None):
    """(per-sample entropy, codebook entropy) of softmax(2 inv_temperature x . c)
    over the codebook, x (N, K, d) f32: the per-token entropies' mean, and the
    mean over codebooks of the entropy of the batch-mean probability.  With
    chunk_tokens None the (N, K, C) probabilities are one tensor; else the
    same function in chunks of tokens (_ChunkedLFQEntropy)."""
    if chunk_tokens is None:
        prob = torch.softmax(2.0 * inv_temperature * torch.einsum("nkd,cd->nkc", x, codebook),
                             dim=-1)
        return _entropy(prob).mean(), _entropy(prob.mean(dim=0)).mean()
    return _ChunkedLFQEntropy.apply(x, codebook, float(inv_temperature), int(chunk_tokens))


class _ChunkedLFQEntropy(torch.autograd.Function):
    """lfq_entropy_terms without the (N, K, C) tensor: the forward pass walks
    chunks of tokens, summing each chunk's per-token entropies and
    probabilities (no graph); the backward walks them again, recomputing
    each chunk's softmax.  The codebook entropy's gradient with respect to a
    token's probabilities is the same for every token (its entropy's
    gradient at the batch mean, over N), so one pass gives both terms'
    gradients."""

    @staticmethod
    def forward(ctx, x, codebook, inv_temperature, chunk):
        n, k, _ = x.shape
        c = codebook.shape[0]
        s = 2.0 * inv_temperature
        prob_sum = x.new_zeros(k, c)
        ent_sum = x.new_zeros(())
        for lo in range(0, n, chunk):
            prob = torch.softmax(s * torch.einsum("nkd,cd->nkc", x[lo:lo + chunk], codebook),
                                 dim=-1)
            ent_sum += _entropy(prob).sum()
            prob_sum += prob.sum(dim=0)
            del prob
        avg = prob_sum / n
        ctx.save_for_backward(x, codebook, avg)
        ctx.s, ctx.chunk = s, chunk
        return ent_sum / (n * k), _entropy(avg).mean()

    @staticmethod
    def backward(ctx, g_sample, g_codebook):
        x, codebook, avg = ctx.saved_tensors
        n, k, _ = x.shape
        s, chunk = ctx.s, ctx.chunk
        # d codebook_entropy / d p[n, k, c], the same for every token n
        g_avg = g_codebook * _entropy_grad(avg) / (k * n)
        dx = torch.empty_like(x)
        for lo in range(0, n, chunk):
            prob = torch.softmax(s * torch.einsum("nkd,cd->nkc", x[lo:lo + chunk], codebook),
                                 dim=-1)
            g = g_sample / (n * k) * _entropy_grad(prob) + g_avg
            dz = prob * (g - (prob * g).sum(dim=-1, keepdim=True))
            del prob, g
            dx[lo:lo + chunk] = s * torch.einsum("nkc,cd->nkd", dz, codebook)
        return dx, None, None, None


def lfq_auto_chunk(n_tokens: int, num_codebooks: int, codebook_size: int) -> Optional[int]:
    """Tokens per chunk when the probabilities pass LFQ_CHUNK_ELEMENTS, else None."""
    per_token = num_codebooks * codebook_size
    if n_tokens * per_token <= LFQ_CHUNK_ELEMENTS:
        return None
    return max(1, LFQ_CHUNK_ELEMENTS // per_token)


class LFQ(nn.Module):
    """Lookup-free quantization: each latent dim to {-scale, +scale}, the
    entropy aux loss (confident per token, uniform over the batch) and the
    commitment; `project_in` / `project_out` (reference names
    `quantizers.project_*`) when dim != log2(codebook_size) * num_codebooks
    (init_lfq, regularizers.py:157-180)."""

    def __init__(self, *, dim: Optional[int] = None, codebook_size: Optional[int] = None,
                 num_codebooks: int = 1, codebook_scale: float = 1.0,
                 inv_temperature: float = 100.0, diversity_gamma: float = 1.0,
                 entropy_loss_weight: float = 0.1, commitment_loss_weight: float = 0.25,
                 device=None):
        super().__init__()
        assert dim is not None or codebook_size is not None
        codebook_size = codebook_size if codebook_size is not None else 2 ** dim
        self.codebook_dim = int(math.log2(codebook_size))
        assert 2 ** self.codebook_dim == codebook_size, "codebook size must be 2^k"
        codebook_dims = self.codebook_dim * num_codebooks
        self.dim = dim if dim is not None else codebook_dims
        self.codebook_size, self.num_codebooks = codebook_size, num_codebooks
        self.codebook_scale, self.inv_temperature = codebook_scale, inv_temperature
        self.diversity_gamma = diversity_gamma
        self.entropy_loss_weight = entropy_loss_weight
        self.commitment_loss_weight = commitment_loss_weight
        if self.dim != codebook_dims:
            self.project_in = nn.Linear(self.dim, codebook_dims, device=device)
            self.project_out = nn.Linear(codebook_dims, self.dim, device=device)

    def init_random_(self, generator: torch.Generator):
        """Projections U(+-1/sqrt(fan_in)), biases zero (init_lfq)."""
        with torch.no_grad():
            for lin in (getattr(self, "project_in", None), getattr(self, "project_out", None)):
                if lin is not None:
                    b = 1.0 / math.sqrt(lin.in_features)
                    lin.weight.uniform_(-b, b, generator=generator)
                    lin.bias.zero_()
        return self

    def quantize(self, x, training: bool = True):
        """x (..., dim) channels last -> (quantized (..., dim), indices (...)
        or (..., num_codebooks), aux_loss, {'per_sample_entropy',
        'batch_entropy', 'commitment'}) (lfq_quantize, regularizers.py:186-251)."""
        in_shape = x.shape
        x = x.float()
        if hasattr(self, "project_in"):
            x = F.linear(x, self.project_in.weight, self.project_in.bias)
        x = x.reshape(*x.shape[:-1], self.num_codebooks, self.codebook_dim)
        original = x
        scale = self.codebook_scale
        quantized = torch.where(x > 0, torch.full_like(x, scale), torch.full_like(x, -scale))
        x = x + (quantized - x).detach() if training else quantized
        mask = 2 ** torch.arange(self.codebook_dim - 1, -1, -1, device=x.device)
        indices = ((x > 0).long() * mask).sum(dim=-1)
        zero = x.new_zeros(())
        if training:
            codebook = lfq_codebook(self.codebook_size, scale, device=x.device)
            flat = original.reshape(-1, self.num_codebooks, self.codebook_dim)
            chunk = lfq_auto_chunk(flat.shape[0], self.num_codebooks, self.codebook_size)
            per_sample, batch_entropy = lfq_entropy_terms(flat, codebook, self.inv_temperature,
                                                          chunk)
            entropy_aux = per_sample - self.diversity_gamma * batch_entropy
            commit = torch.mean((original - quantized.detach()) ** 2)
        else:
            entropy_aux = per_sample = batch_entropy = commit = zero
        x = x.reshape(*x.shape[:-2], self.num_codebooks * self.codebook_dim)
        if hasattr(self, "project_out"):
            x = F.linear(x, self.project_out.weight, self.project_out.bias)
        x = x.reshape(in_shape)
        if self.num_codebooks == 1:
            indices = indices[..., 0]
        aux = entropy_aux * self.entropy_loss_weight + commit * self.commitment_loss_weight
        return x, indices, aux, {"per_sample_entropy": per_sample,
                                 "batch_entropy": batch_entropy, "commitment": commit}

    def forward(self, z, generator=None):
        """z (b, dim, ...) -> (quantized (b, dim, ...), {'aux_loss', 'indices',
        the breakdown}): the AutoencoderTrainer's regularizer contract."""
        q, indices, aux, breakdown = self.quantize(_channels_last(z), training=self.training)
        return q.movedim(-1, 1), {"aux_loss": aux, "indices": indices, **breakdown}

    def indices_to_codes(self, indices):
        """(...) or (..., num_codebooks) int -> (..., dim) codes (channels last)."""
        if self.num_codebooks > 1 and indices.shape[-1] != self.num_codebooks:
            raise ValueError("multi-codebook indices need a trailing num_codebooks dim")
        idx = indices if self.num_codebooks > 1 else indices[..., None]
        mask = 2 ** torch.arange(self.codebook_dim - 1, -1, -1, device=indices.device)
        bits = (idx[..., None] & mask) != 0
        codes = torch.where(bits, 1.0, -1.0).float()
        codes = codes.reshape(*codes.shape[:-2], -1)
        if hasattr(self, "project_out"):
            codes = F.linear(codes, self.project_out.weight, self.project_out.bias)
        return codes
