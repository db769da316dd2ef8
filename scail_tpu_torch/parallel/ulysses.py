"""Ulysses sequence-parallel attention (counterpart of
scail_tpu/parallel/ulysses.py; the reference's sat/mpu/ulysses_attn_layer.py
and sat/mpu/all_to_all.py).

Each seq rank holds S/P rows of q, k and v for its heads (the heads it holds
under tensor parallel):

  (b, S/P, n, d) --all_to_all(split heads, gather rows)--> (b, S, n/P, d)
    --attention over the whole sequence for n/P heads (K2, K5 backward)-->
  (b, S, n/P, d) --all_to_all(split rows, gather heads)--> (b, S/P, n, d)

The backward of each exchange is the inverse exchange.  `attn_fn` replaces
the local attention (the sliding-tile attention of the DiT's STA path, which
then sees the whole tile-major sequence for its heads).
"""

from __future__ import annotations

from scail_tpu_torch.parallel import comm
from scail_tpu_torch.parallel.mesh import MODEL_AXIS, SEQ_AXIS


def ulysses_attention(q, k, v, mesh, *, attn_fn=None, scale: float = None,
                      impl: str = "auto"):
    """q/k/v: this rank's (b, S/P, n_local, d) rows and heads; returns the
    same layout.  With one seq rank, attn_fn(q, k, v) itself."""
    if attn_fn is None:
        from scail_tpu_torch.ops.attention import attention

        def attn_fn(a, b, c):
            return attention(a, b, c, scale=scale, impl=impl)

    seq = mesh.size(SEQ_AXIS)
    if seq == 1:
        return attn_fn(q, k, v)
    n = q.shape[2] * mesh.size(MODEL_AXIS)
    if n % (seq * mesh.size(MODEL_AXIS)):
        raise ValueError(f"heads {n} not divisible by seq*model shards "
                         f"({seq}*{mesh.size(MODEL_AXIS)})")
    ql, kl, vl = (comm.all_to_all(t, mesh, SEQ_AXIS, 2, 1) for t in (q, k, v))
    return comm.all_to_all(attn_fn(ql, kl, vl).contiguous(), mesh, SEQ_AXIS, 1, 2)
