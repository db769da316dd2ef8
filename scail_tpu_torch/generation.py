"""Autoregressive sampling (counterpart of scail_tpu/generation.py):
`filling_sequence` fills the -1 positions of a token buffer left to right
from any `logits_fn`, under the top-k / top-p / temperature `BaseStrategy`;
`BeamSearchStrategy` searches deterministically.

Where JAX runs a `lax.scan` over positions, this is a Python loop over the
same fixed-size buffer.  Draws come from the `torch.Generator` the caller
passes, so they are reproducible but are not `jax.random`'s.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch


@dataclasses.dataclass
class BaseStrategy:
    """top-k / top-p / temperature sampling."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0
    end_tokens: Sequence[int] = ()

    def mask(self, logits):
        """The logits in f32 over the temperature, -inf outside the top k
        and outside the smallest head of the sorted distribution whose mass
        reaches top_p (ties at a cut kept, as in JAX)."""
        logits = logits.float() / max(self.temperature, 1e-6)
        if self.top_k > 0:
            kth = torch.sort(logits, dim=-1).values[..., -self.top_k, None]
            logits = logits.masked_fill(logits < kth, float("-inf"))
        if self.top_p > 0.0:
            sorted_logits = torch.sort(logits, dim=-1, descending=True).values
            cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
            cutoff_idx = (cum < self.top_p).sum(-1, keepdim=True)
            cutoff = sorted_logits.gather(-1, cutoff_idx)
            logits = logits.masked_fill(logits < cutoff, float("-inf"))
        return logits

    def forward(self, logits, generator: Optional[torch.Generator] = None):
        """One token a row, drawn from softmax(mask(logits))."""
        probs = torch.softmax(self.mask(logits), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[..., 0]

    def is_done(self, tokens):
        done = torch.zeros(tokens.shape[0], dtype=torch.bool, device=tokens.device)
        for e in self.end_tokens:
            done |= (tokens == e).any(-1)
        return done


def filling_sequence(logits_fn: Callable, seq, strategy: Optional[BaseStrategy] = None,
                     generator: Optional[torch.Generator] = None):
    """Fill every -1 of seq (b, L) left to right.  logits_fn(tokens,
    position) -> (b, vocab) logits of the token after tokens[:, :position +
    1]; known positions keep their value."""
    strategy = strategy or BaseStrategy()
    tokens = seq.clone()
    to_fill = (seq < 0).any(0).nonzero()
    if to_fill.numel() == 0:
        return tokens
    for pos in range(int(to_fill[0]), seq.shape[1]):
        sampled = strategy.forward(logits_fn(tokens, pos - 1), generator)
        fill = tokens[:, pos] < 0
        tokens[:, pos] = torch.where(fill, sampled.to(tokens.dtype), tokens[:, pos])
    return tokens


@dataclasses.dataclass
class BeamSearchStrategy:
    """Deterministic beam search."""

    num_beams: int = 4
    length_penalty: float = 1.0
    end_token: Optional[int] = None

    def search(self, logits_fn: Callable, prompt, max_new: int):
        """prompt (L0,) -> the best (L0 + max_new,) sequence.  Among equal
        scores the lower flat index wins (lax.top_k's order)."""
        L0, nb = prompt.shape[0], self.num_beams
        seqs = torch.cat([prompt[None].expand(nb, L0),
                          prompt.new_zeros(nb, max_new)], dim=1).clone()
        scores = torch.full((nb,), float("-inf"), device=prompt.device)
        scores[0] = 0.0
        for i in range(max_new):
            pos = L0 + i
            logp = torch.log_softmax(logits_fn(seqs, pos - 1).float(), dim=-1)
            vocab = logp.shape[-1]
            flat = (scores[:, None] + logp).reshape(-1)
            top = torch.sort(flat, descending=True, stable=True)
            scores, top_idx = top.values[:nb], top.indices[:nb]
            seqs = seqs[top_idx // vocab]
            seqs[:, pos] = top_idx % vocab
        norm = scores / (float(max_new) ** self.length_penalty)
        return seqs[torch.argmax(norm)]
