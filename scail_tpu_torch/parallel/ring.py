"""Ring attention over the 'seq' ranks (counterpart of
scail_tpu/parallel/ring.py, rebuilt on the flash kernels).

Each seq rank keeps its S/P query rows and passes its k/v chunk around the
ring.  The JAX ring builds the full f32 logits of (local q, visiting chunk)
at every step; here every step is one flash forward with its LSE (K2) on
(local q, visiting chunk), and the partial outputs are merged in f32 by
their LSEs:

  lse = logaddexp(lse_a, lse_b)
  o   = o_a exp(lse_a - lse) + o_b exp(lse_b - lse)

which is softmax(q kᵀ) v over the whole sequence for any chunk order.  The
hop of k and v to the next rank (one batch of isend / irecv) is posted
before the step's kernel and waited on after it, so the transfer overlaps
the kernel; P chunks take P - 1 hops.

The backward is the ring-flash one: with the merged LSE and
delta = rowsum(dO O) of the final output, each chunk's K5 passes (dq and
dk/dv) give that chunk's exact share.  dq accumulates locally in f32; the
f32 dk/dv sums travel with their chunk and arrive home after P hops.
"""

from __future__ import annotations

import math

import torch

from scail_tpu_torch.parallel import comm
from scail_tpu_torch.parallel.mesh import SEQ_AXIS


def _fwd(q, k, v, scale, use_kernel):
    from scail_tpu_torch.ops import attention as A

    fn = A.flash_attention if use_kernel else A.flash_attention_plain
    return fn(q, k, v, scale=scale)


def _bwd_chunk(q, kc, vc, out, lse, do, ops, scale, use_kernel):
    """(dq, dk, dv) of one chunk, f32; `ops` are _bwd_operands' (q2, lse2,
    delta), computed once for the kernels."""
    from scail_tpu_torch.ops import attention as A

    if use_kernel and q.device.type == "cuda":
        q2, lse2, delta = ops
        dq = A.flash_attention_bwd_dq(q2, kc, vc, do, lse2, delta, scale=scale)
        dk, dv = A.flash_attention_bwd_dkv(q2, kc, vc, do, lse2, delta)
    else:
        dq, dk, dv = A.flash_attention_bwd_plain(q, kc, vc, out, lse, do, scale=scale)
    return dq.float(), dk.float(), dv.float()


def _neighbours(mesh):
    p, r = mesh.size(SEQ_AXIS), mesh.rank(SEQ_AXIS)
    return (r + 1) % p, (r - 1) % p


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, scale, use_kernel):
        p = mesh.size(SEQ_AXIS)
        nxt, prv = _neighbours(mesh)
        kc, vc = k.contiguous(), v.contiguous()
        o = lse = None
        for step in range(p):
            reqs = ()
            if step < p - 1:
                k_in, v_in = torch.empty_like(kc), torch.empty_like(vc)
                reqs = comm.exchange([(kc, nxt), (vc, nxt)], [(k_in, prv), (v_in, prv)],
                                     mesh, SEQ_AXIS)
            o_s, lse_s = _fwd(q, kc, vc, scale, use_kernel)
            if o is None:
                o, lse = o_s.float(), lse_s
            else:
                new = torch.logaddexp(lse, lse_s)
                w_old = torch.exp(lse - new).transpose(1, 2)[..., None]
                w_new = torch.exp(lse_s - new).transpose(1, 2)[..., None]
                o, lse = o * w_old + o_s.float() * w_new, new
            for req in reqs:
                req.wait()
            if step < p - 1:
                kc, vc = k_in, v_in
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mesh, ctx.scale, ctx.use_kernel = mesh, scale, use_kernel
        return out

    @staticmethod
    def backward(ctx, do):
        from scail_tpu_torch.ops.attention import _bwd_operands

        q, k, v, out, lse = ctx.saved_tensors
        mesh, scale, use_kernel = ctx.mesh, ctx.scale, ctx.use_kernel
        do = do.contiguous()
        p = mesh.size(SEQ_AXIS)
        nxt, prv = _neighbours(mesh)
        ops = None
        if use_kernel and q.device.type == "cuda":
            q2, lse2, delta = _bwd_operands(q, out, lse, do, scale)
            ops = (q2, lse2.contiguous(), delta.contiguous())
        kc, vc = k.contiguous(), v.contiguous()
        dq = dk = dv = None
        for step in range(p):
            dq_s, dk_s, dv_s = _bwd_chunk(q, kc, vc, out, lse, do, ops, scale, use_kernel)
            dq = dq_s if dq is None else dq + dq_s
            dk = dk_s if dk is None else dk + dk_s
            dv = dv_s if dv is None else dv + dv_s
            # the chunk's dk/dv sums move on with it; after P hops they are home
            dk_in, dv_in = torch.empty_like(dk), torch.empty_like(dv)
            sends, recvs = [(dk, nxt), (dv, nxt)], [(dk_in, prv), (dv_in, prv)]
            if step < p - 1:
                k_in, v_in = torch.empty_like(kc), torch.empty_like(vc)
                sends += [(kc, nxt), (vc, nxt)]
                recvs += [(k_in, prv), (v_in, prv)]
            for req in comm.exchange(sends, recvs, mesh, SEQ_AXIS):
                req.wait()
            dk, dv = dk_in, dv_in
            if step < p - 1:
                kc, vc = k_in, v_in
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def check_ring_rows(seq_len: int, mesh, shapes) -> None:
    """The ring shards the sequence evenly over the seq ranks."""
    p = mesh.size(SEQ_AXIS)
    if seq_len % p:
        raise ValueError(f"attn_impl='ring': the sequence of {seq_len} tokens does not divide "
                         f"over {p} seq ranks (shapes {shapes})")


def ring_attention(q, k, v, mesh, *, scale: float = None, impl: str = "auto"):
    """q/k/v: this rank's (b, S/P, n, d) rows (heads as held); returns the
    attention of its q rows over the whole sequence, in q's layout.  With one
    seq rank, the flash wrapper itself.  impl 'auto' takes the kernels (their
    plain versions on CPU tensors), 'xla' the plain versions."""
    from scail_tpu_torch.ops.attention import _check_impl, attention

    use_kernel = _check_impl(impl)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if mesh.size(SEQ_AXIS) == 1:
        return attention(q, k, v, scale=scale, impl=impl)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attn_impl='ring' takes equal q, k, v shards, got "
                         f"{[tuple(t.shape) for t in (q, k, v)]}")
    return _RingAttention.apply(q, k, v, mesh, scale, use_kernel)
