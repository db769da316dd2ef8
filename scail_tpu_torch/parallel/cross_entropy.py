"""Vocab-parallel cross entropy (counterpart of
scail_tpu/parallel/cross_entropy.py; the reference's sat/mpu/cross_entropy.py).

The logits stay sharded over the vocabulary on one mesh axis: the stable
log-sum-exp takes the per-rank max through an all-reduce(MAX) (no gradient
flows through the shift) and the sum of exponentials through an
all-reduce(SUM); the target logit comes from the rank that owns it, summed
over the axis.  The gradient, softmax - onehot on each rank's columns, is
the autograd Function's backward; the full (..., V) logits are never built.
"""

from __future__ import annotations

import torch

from scail_tpu_torch.parallel import comm
from scail_tpu_torch.parallel.mesh import MODEL_AXIS


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, mesh, axis):
        v_local = logits.shape[-1]
        lo = mesh.rank(axis) * v_local
        x = logits.float()
        m = comm.all_reduce_(x.amax(dim=-1), mesh, axis, op="max")
        e = torch.exp(x - m[..., None])
        z = comm.all_reduce_(e.sum(dim=-1), mesh, axis)
        in_shard = (targets >= lo) & (targets < lo + v_local)
        idx = (targets - lo).clamp(0, v_local - 1)
        tl = torch.where(in_shard, x.gather(-1, idx[..., None])[..., 0], torch.zeros_like(m))
        tl = comm.all_reduce_(tl, mesh, axis)
        ctx.save_for_backward(e / z[..., None], idx, in_shard)
        ctx.dtype = logits.dtype
        return m + torch.log(z) - tl

    @staticmethod
    def backward(ctx, g):
        softmax, idx, in_shard = ctx.saved_tensors
        grad = softmax.clone()
        onehot = torch.zeros_like(grad).scatter_(-1, idx[..., None], 1.0)
        grad -= onehot * in_shard[..., None].to(grad.dtype)
        return (grad * g[..., None]).to(ctx.dtype), None, None, None


def vocab_parallel_cross_entropy(logits, targets, mesh, axis: str = MODEL_AXIS):
    """logits: this rank's (..., V / P) columns of the vocabulary, rank r
    holding [r V/P, (r + 1) V/P); targets: (...) global vocabulary ids.
    Returns the per-token negative log-likelihood (...) in f32."""
    return _VocabParallelCE.apply(logits, targets, mesh, axis)
