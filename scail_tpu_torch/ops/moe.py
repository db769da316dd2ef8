"""Mixture-of-experts MLP with top-k routing (counterpart of
scail_tpu/ops/moe.py).

The router takes the softmax of x @ gate in f32, keeps the top k experts
of every token and renormalises their weights to sum to one.  Each selected
expert's whole MLP output, bias included, is scaled by its weight and the k
outputs are summed.

Dispatch: the JAX function evaluates every expert on every token and folds
the routing in through a dense (b, s, E) combine tensor, so that XLA sees
static shapes.  Here each token goes to its k experts only: the (token,
slot) pairs are sorted by expert, each expert's rows are gathered, run
through its MLP and scattered back with `index_add`.  That does k / E of
the dense work (a quarter at 8 experts and top 2) and costs one host
synchronisation a call (the per-expert row counts).  The sum is the dense
one up to f32 order.  This is work XLA carries in JAX (einsums, no Pallas
kernel), so cuBLAS carries it here.

Expert parallelism: a rank that holds experts [offset, offset + E_local)
passes its slices and `expert_offset`; the router still scores all E
experts (the gate is replicated), and the caller sums the ranks' outputs.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from scail_tpu_torch.models.common import gelu_tanh


def moe_router(x, gate_weight, top_k: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., d), gate_weight (E, d) -> (weights (..., k) f32, indices
    (..., k) int64): softmax in f32, top k, renormalised."""
    logits = F.linear(x, gate_weight.to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    weights, idx = torch.topk(probs, top_k, dim=-1)
    return weights / weights.sum(-1, keepdim=True), idx


def _expert_linear(h, weight, bias, e):
    y = h @ weight[e].to(h.dtype).t()
    return y if bias is None else y + bias[e].to(h.dtype)


def moe_mlp(x, gate_weight, w_in, w_out, *, b_in=None, b_out=None, top_k: int = 2,
            act: Callable = gelu_tanh, router: Optional[Tuple] = None, w_gate=None,
            expert_offset: int = 0):
    """x (..., d) -> (..., d).

    gate_weight (E, d); w_in (E_local, f, d), b_in (E_local, f); w_out
    (E_local, d, f), b_out (E_local, d); w_gate (E_local, f, d) for gated
    experts: h = act(x @ w_gate) * (x @ w_in).  `router` overrides the
    (weights, indices) of `moe_router`.  With `expert_offset`, only experts
    [offset, offset + E_local) are evaluated (this rank's share)."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    weights, idx = moe_router(xf, gate_weight, top_k) if router is None else (
        router[0].reshape(-1, router[0].shape[-1]), router[1].reshape(-1, router[1].shape[-1]))
    k = idx.shape[-1]
    n_local = w_in.shape[0]
    flat = idx.reshape(-1) - expert_offset
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat.clamp(-1, n_local).add(1), minlength=n_local + 2)
    counts = counts.tolist()
    out = torch.zeros_like(xf)
    start = counts[0]  # slots routed below this rank's experts
    for e in range(n_local):
        rows = order[start:start + counts[e + 1]]
        start += counts[e + 1]
        if rows.numel() == 0:
            continue
        tok = rows // k
        h_in = xf[tok]
        h = _expert_linear(h_in, w_in, b_in, e)
        if w_gate is not None:
            h = act(_expert_linear(h_in, w_gate, None, e)) * h
        else:
            h = act(h)
        y = _expert_linear(h, w_out, b_out, e)
        w = weights.reshape(-1)[rows].to(x.dtype)
        out = out.index_add(0, tok, y * w[:, None])
    return out.reshape(shape)
