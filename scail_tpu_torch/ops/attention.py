"""Attention ops: hand-written CUDA kernels with their plain PyTorch versions
(counterpart of scail_tpu/ops/attention.py).

Layout at the public functions is (batch, seq, heads, head_dim), as in the
JAX package.  Four kernel wrappers:

  * `flash_attention` -- flash self-attention (csrc/flash_attention.cu), with
    the rotary optionally applied to q inside the kernel (k arrives roped);
  * `flash_attention_bwd` -- its gradient, a dq pass and a dk/dv pass
    (csrc/flash_attention_bwd.cu);
  * `dual_cross_attention_fused` -- the DiT's text + CLIP cross-attention,
    two softmaxes summed (csrc/dual_cross_attention.cu);
  * `flash_attention_int8` -- flash self-attention with q and k quantized
    per (row, head) to int8 in torch and QK^T in int32 on the tensor cores
    (csrc/flash_attention_int8.cu).
The rotary of k before the flash kernel, and of q in its backward, is the
interleaved-rotary kernel of ops/fused_norms.py (K10) where the layout is
interleaved.

Each wrapper runs its plain version when given CPU tensors and launches its
kernel (or raises) for CUDA tensors; there is no fallback from a CUDA tensor
to the plain version.  Each counts its launches in `LAUNCHES`.  `attention`,
`dual_cross_attention` and `attention_int8` are differentiable: their
torch.autograd.Functions are the counterparts of the JAX custom VJPs.
`FlashStash` keeps the flash forward's (out, lse) of a checkpointed layer for
its recompute, the JAX names `flash_out` / `flash_lse` that the remat
policies save_attn, save_attn_frac and offload_attn keep.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import ctypes
import math

import torch

from scail_tpu_torch.ops import cuda_build, fused_norms
from scail_tpu_torch.ops.rotary import apply_rotary, rotate_half

_LOG2E = math.log2(math.e)
_LN2 = math.log(2.0)

# kernel launches by wrapper (plain ints; reset with reset_launch_counts); the
# sliding-tile wrappers of ops/sta.py and the AdaLN and rotary wrappers of
# ops/fused_norms.py count here too
LAUNCHES = {"flash_attention": 0, "flash_attention_rope": 0, "dual_cross_attention": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "sta_attention_fwd": 0, "sta_attention_fwd_lse": 0,
            "sta_attention_bwd_dq": 0, "sta_attention_bwd_dkv": 0,
            "flash_attention_int8": 0, "adaln_layer_norm": 0, "rotary": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --------------------------------------------------------------------------
# Plain versions: the kernels' functions in PyTorch, chunked over q rows so
# they can check the kernels at 48,832 tokens (full logits would not fit).
# --------------------------------------------------------------------------
def _prescale_rope_q(q, scale, rope, interleaved):
    """scale*log2e folded into q (rounded to q.dtype), then the rotary in f32
    (rounded to q.dtype again), as the kernel does."""
    qs = (q.float() * (scale * _LOG2E)).to(q.dtype)
    if rope is None:
        return qs
    cos, sin = rope
    xf = qs.float()
    return (xf * cos.float()[:, None, :]
            + rotate_half(xf, interleaved) * sin.float()[:, None, :]).to(q.dtype)


def _softmax_stream(qb, k, v):
    """One exp2-domain softmax of f32 q rows over a whole KV; P is rounded to
    v.dtype before P V, as in the kernels.  Returns (o (b,q,n,d), m, l)."""
    s = torch.einsum("bqnd,bknd->bnqk", qb, k.float())
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype).float(), v.float())
    return o / l.permute(0, 2, 1, 3), m[..., 0], l[..., 0]


def flash_attention_plain(q, k, v, *, scale=None, rope=None, rope_interleaved=True,
                          block_q: int = 256):
    """Plain version of `flash_attention`: returns (out (b,sq,n,d) in q.dtype,
    lse (b,n,sq) f32, natural log).  k must already carry its rotary."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qs = _prescale_rope_q(q, scale, rope, rope_interleaved)
    outs, lses = [], []
    for i in range(0, q.shape[1], block_q):
        o, m, l = _softmax_stream(qs[:, i:i + block_q].float(), k, v)
        outs.append(o.to(q.dtype))
        lses.append(_LN2 * m + torch.log(l.clamp_min(1e-30)))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def dual_cross_attention_plain(q, k1, v1, k2, v2, *, scale=None, block_q: int = 1024):
    """Plain version of `dual_cross_attention_fused`:
    softmax(q k1^T) v1 + softmax(q k2^T) v2, in q.dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qs = _prescale_rope_q(q, scale, None, True)
    outs = []
    for i in range(0, q.shape[1], block_q):
        qb = qs[:, i:i + block_q].float()
        outs.append((_softmax_stream(qb, k1, v1)[0]
                     + _softmax_stream(qb, k2, v2)[0]).to(q.dtype))
    return torch.cat(outs, dim=1)


def quantize_rows(x):
    """Per-row int8 quantization over the last dim (JAX _quantize_rows):
    (..., d) -> (int8 codes (..., d), f32 scales (...)), scale =
    max(absmax, 1e-6) / 127, codes round(x / scale) clipped to +-127."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-6) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _int8_operands(q, k, scale):
    """q and k quantized per (row, head), the q scales times scale*log2e (a
    Python float, as JAX _flash_int8_fwd folds it): (qi, qs, ki, ks), scales
    (b, s, n) f32."""
    qi, qs = quantize_rows(q)
    ki, ks = quantize_rows(k)
    return qi, qs * (scale * _LOG2E), ki, ks


def _int8_kernel_operands(q, k, scale):
    """`_int8_operands` laid out for the kernel: (qi, qs, ki, ks) with the k
    scales re-laid as (b*n, skv rounded up to 64) f32, zero past skv (JAX
    _flash_int8_fwd's (b*n, skv + pad) row of k scales, padded with 0 to the
    kernel's 64-row tiles), so a tile's scales are one contiguous copy."""
    qi, qs, ki, ks = _int8_operands(q, k, scale)
    b, skv, n = ks.shape
    ks_rows = ks.new_zeros((b * n, -(-skv // 64) * 64))
    ks_rows[:, :skv] = ks.permute(0, 2, 1).reshape(b * n, skv)
    return qi, qs, ki, ks_rows


def flash_attention_int8_plain(q, k, v, *, scale=None, block_q: int = 256):
    """Plain version of `flash_attention_int8`: (out (b,sq,n,d) in v.dtype,
    lse (b,n,sq) f32, natural log).  With d = 128 every sum of code products
    is an integer below 2^24, so the f32 product of the codes is the kernel's
    int32 one exactly; then s = that * (q_scale * k_scale), exp2 softmax, P
    rounded to v.dtype before P V."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qi, qs, ki, ks = _int8_operands(q, k, scale)
    kf, vf = ki.float(), v.float()
    ks_t = ks.transpose(1, 2)[:, :, None, :]  # (b, n, 1, skv)
    outs, lses = [], []
    for i in range(0, q.shape[1], block_q):
        sl = slice(i, i + block_q)
        s = torch.einsum("bqnd,bknd->bnqk", qi[:, sl].float(), kf)
        s = s * (qs[:, sl].transpose(1, 2)[..., None] * ks_t)
        m = s.amax(-1, keepdim=True)
        p = torch.exp2(s - m)
        l = p.sum(-1, keepdim=True)
        o = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype).float(), vf)
        outs.append((o / l.permute(0, 2, 1, 3)).to(v.dtype))
        lses.append(_LN2 * m[..., 0] + torch.log(l[..., 0].clamp_min(1e-30)))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def _bwd_operands(q, out, lse, do, scale):
    """What _flash_bwd computes in XLA before its kernels: q prescaled by
    scale*log2e (rounded to q.dtype), the LSE in the log2 domain and
    delta = rowsum(dO * O) in f32, both (b, n, sq)."""
    q2 = (q.float() * (scale * _LOG2E)).to(q.dtype)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    return q2, lse.float() * _LOG2E, delta


def flash_attention_bwd_plain(q, k, v, out, lse, do, *, scale=None, block_q: int = 256,
                              grads: str = "all"):
    """Plain version of `flash_attention_bwd`: the gradient of flash attention
    (q already roped, lse natural-log from the forward), in f32 at the rounding
    points of the Pallas kernels (dS and P rounded to the input dtype before
    their products).  dk/dv rows depend only on their own kv rows, dq rows only
    on their own q rows, so both can be checked on a slice.  Returns
    (dq, dk, dv) in the input dtypes; grads='dq' or 'dkv' computes only the
    plain version of that kernel and returns None for the others."""
    if grads not in ("all", "dq", "dkv"):
        raise ValueError(f"grads must be 'all', 'dq' or 'dkv', got {grads!r}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    q2, lse2, delta = _bwd_operands(q, out, lse, do, scale)
    kf, vf = k.float(), v.float()
    want_dq, want_dkv = grads in ("all", "dq"), grads in ("all", "dkv")
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device) if want_dkv else None
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device) if want_dkv else None
    dqs = []
    for i in range(0, q.shape[1], block_q):
        sl = slice(i, i + block_q)
        qb, dob = q2[:, sl].float(), do[:, sl].float()
        s = torch.einsum("bqnd,bknd->bnqk", qb, kf)
        p = torch.exp2((s - lse2[:, :, sl, None]).clamp_max(0.0))
        dp = torch.einsum("bqnd,bknd->bnqk", dob, vf)
        ds = (p * (dp - delta[:, :, sl, None])).to(k.dtype).float()
        if want_dq:
            dqs.append((torch.einsum("bnqk,bknd->bqnd", ds, kf) * scale).to(q.dtype))
        if want_dkv:
            dv += torch.einsum("bnqk,bqnd->bknd", p.to(do.dtype).float(), dob)
            dk += torch.einsum("bnqk,bqnd->bknd", ds, qb)
    return (torch.cat(dqs, dim=1) if want_dq else None,
            (dk * _LN2).to(k.dtype) if want_dkv else None,
            dv.to(v.dtype) if want_dkv else None)


def dual_cross_attention_bwd_plain(q, k1, v1, k2, v2, g, *, scale=None, block_q: int = 4096):
    """Exact gradient of softmax(q k1^T s) v1 + softmax(q k2^T s) v2 in f32,
    chunked over q rows (the JAX package's _dual_cross_vjp_bwd differentiates
    the same composed reference in XLA; it has no kernel).  Returns
    (dq, dk1, dv1, dk2, dv2) in the input dtypes."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    streams = [(k.float(), v.float()) for k, v in ((k1, v1), (k2, v2))]
    dkv = [[torch.zeros(k.shape, dtype=torch.float32, device=k.device) for _ in range(2)]
           for k, _ in streams]
    dqs = []
    for i in range(0, q.shape[1], block_q):
        qb, gb = q[:, i:i + block_q].float(), g[:, i:i + block_q].float()
        dq = torch.zeros_like(qb)
        for (kf, vf), (dk, dv) in zip(streams, dkv):
            p = torch.softmax(torch.einsum("bqnd,bknd->bnqk", qb, kf) * scale, dim=-1)
            o = torch.einsum("bnqk,bknd->bqnd", p, vf)
            dv += torch.einsum("bnqk,bqnd->bknd", p, gb)
            dp = torch.einsum("bqnd,bknd->bnqk", gb, vf)
            ds = p * (dp - (gb * o).sum(-1).transpose(1, 2)[..., None])
            dq += torch.einsum("bnqk,bknd->bqnd", ds, kf) * scale
            dk += torch.einsum("bnqk,bqnd->bknd", ds, qb) * scale
        dqs.append(dq.to(q.dtype))
    (dk1, dv1), (dk2, dv2) = dkv
    return (torch.cat(dqs, dim=1), dk1.to(k1.dtype), dv1.to(v1.dtype), dk2.to(k2.dtype),
            dv2.to(v2.dtype))


# How far a kernel's bf16 result may sit from its plain version computed in
# f32.  The kernels round q (after the scale and the rotary), P before P V and
# the output to bf16.  Limits are scaled to the reference, since the output of
# random attention over n keys shrinks like 1/sqrt(n):
#   * max-abs error of the output <= OUT_MAX_PER_STD * std(plain output);
#   * relative L2 error of every (batch, head) slice <= OUT_REL_L2;
#   * natural-log LSE within LSE_ATOL.
# Sound kernels sit under half of each limit.  The plain version with one
# 64-key KV tile dropped or counted twice, at 48,832 keys, sits 0.34 std and
# 3.8% relative L2 away from the full one.
OUT_MAX_PER_STD = 0.1
OUT_REL_L2 = 1e-2
LSE_ATOL = 1e-2


def error_vs_plain(got, want, *, lse=False) -> dict:
    """Error of a kernel result against its plain version, with `ok` set by the
    limits above.  got/want: outputs (b, s, n, d), or LSEs (b, n, s) when lse."""
    d = got.float() - want.float()
    max_abs = d.abs().max().item()
    res = {"max_abs_err": max_abs, "mean_abs_err": d.abs().mean().item()}
    if lse:
        res["ok"] = max_abs <= LSE_ATOL
        return res
    w = want.float()
    per_std = max_abs / w.std().item()
    rel_l2 = (d.square().sum((1, 3)).sqrt() / w.square().sum((1, 3)).sqrt()).max().item()
    res.update(err_per_std=per_std, rel_l2=rel_l2,
               ok=per_std <= OUT_MAX_PER_STD and rel_l2 <= OUT_REL_L2)
    return res


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------
def _check_operand(name, t, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
    if t.dim() != 4 or t.shape[-1] != 128:
        raise ValueError(f"{name}: the kernel takes (b, s, n, 128), got {tuple(t.shape)}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs a contiguous head dim and 16-byte "
                         f"aligned rows, got strides {t.stride()}")


def _strides(t):
    return [ctypes.c_longlong(s) for s in t.stride()[:3]]


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def flash_attention(q, k, v, *, scale=None, rope=None, rope_interleaved=True):
    """Flash self-attention (b, sq, n, d) x (b, skv, n, d) -> (out, lse).

    rope=(cos, sin) with (sq, d) tables rotates q inside the kernel (the
    caller passes k already rotated).  CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, rope=rope,
                                     rope_interleaved=rope_interleaved)
    if q.device.type != "cuda":
        raise NotImplementedError(f"flash_attention: no kernel for device {q.device}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.device)
    b, sq, n, d = q.shape
    skv = k.shape[1]
    if k.shape != (b, skv, n, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if b * n > 65535 or skv == 0:
        raise ValueError(f"unsupported batch*heads {b * n} / kv length {skv}")
    mode = 0
    cos = sin = None
    if rope is not None:
        # contiguous f32 rows on 16-byte boundaries: the kernel reads them as float4
        cos, sin = (t.to(device=q.device, dtype=torch.float32).contiguous() for t in rope)
        cos, sin = (t.clone() if t.data_ptr() % 16 else t for t in (cos, sin))
        if cos.shape != (sq, d) or sin.shape != (sq, d):
            raise ValueError(f"rope tables {tuple(cos.shape)} do not fit q {tuple(q.shape)}")
        mode = 1 if rope_interleaved else 2
    out = torch.empty((b, sq, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    lib = cuda_build.lib()
    rc = lib.scail_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        cos.data_ptr() if cos is not None else None,
        sin.data_ptr() if sin is not None else None,
        out.data_ptr(), lse.data_ptr(), b, n, sq, skv,
        *_strides(q), *_strides(k), *_strides(v), *_strides(out),
        ctypes.c_float(scale * _LOG2E), mode, _stream(q.device))
    cuda_build.check(rc, "flash_attention")
    LAUNCHES["flash_attention_rope" if mode else "flash_attention"] += 1
    return out, lse


def dual_cross_attention_fused(q, k1, v1, k2, v2, *, scale=None):
    """attention(q, k1, v1) + attention(q, k2, v2) in one kernel.  CPU
    tensors take the plain version."""
    if q.device.type == "cpu":
        return dual_cross_attention_plain(q, k1, v1, k2, v2, scale=scale)
    if q.device.type != "cuda":
        raise NotImplementedError(f"dual_cross_attention: no kernel for device {q.device}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    for name, t in (("q", q), ("k1", k1), ("v1", v1), ("k2", k2), ("v2", v2)):
        _check_operand(name, t, q.device)
    b, sq, n, d = q.shape
    s1, s2 = k1.shape[1], k2.shape[1]
    if (k1.shape != (b, s1, n, d) or v1.shape != k1.shape or k2.shape != (b, s2, n, d)
            or v2.shape != k2.shape or sq == 0 or s1 == 0 or s2 == 0):
        raise ValueError("dual_cross_attention: unsupported shapes "
                         f"{[tuple(t.shape) for t in (q, k1, v1, k2, v2)]}")
    out = torch.empty((b, sq, n, d), dtype=q.dtype, device=q.device)
    lib = cuda_build.lib()
    rc = lib.scail_dual_cross_attention_fwd(
        q.data_ptr(), k1.data_ptr(), v1.data_ptr(), k2.data_ptr(), v2.data_ptr(),
        out.data_ptr(), b, n, sq, s1, s2,
        *_strides(q), *_strides(k1), *_strides(v1), *_strides(k2), *_strides(v2),
        *_strides(out), ctypes.c_float(scale * _LOG2E), _stream(q.device))
    cuda_build.check(rc, "dual_cross_attention")
    LAUNCHES["dual_cross_attention"] += 1
    return out


def flash_attention_int8(q, k, v, *, scale=None):
    """int8-QK flash self-attention (b, sq, n, d) x (b, skv, n, d) -> (out,
    lse): q and k (already roped) are quantized per (row, head) in torch,
    the kernel runs QK^T in int32 and P V in bf16.  CPU tensors take the
    plain version."""
    if q.device.type == "cpu":
        return flash_attention_int8_plain(q, k, v, scale=scale)
    if q.device.type != "cuda":
        raise NotImplementedError(f"flash_attention_int8: no kernel for device {q.device}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.device)
    b, sq, n, d = q.shape
    skv = k.shape[1]
    if k.shape != (b, skv, n, d) or v.shape != k.shape or b * n > 65535 or skv == 0:
        raise ValueError(f"flash_attention_int8: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    qi, qs, ki, ks = _int8_kernel_operands(q, k, scale)
    out = torch.empty((b, sq, n, d), dtype=v.dtype, device=q.device)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    rc = cuda_build.lib().scail_flash_attention_int8_fwd(
        qi.data_ptr(), ki.data_ptr(), v.data_ptr(), qs.data_ptr(), ks.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, n, sq, skv,
        *_strides(qi), *_strides(ki), *_strides(v), *_strides(out), _stream(q.device))
    cuda_build.check(rc, "flash_attention_int8")
    LAUNCHES["flash_attention_int8"] += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, do, *, scale=None):
    """Gradient of `flash_attention` (no rotary: q and k already roped), from
    its output and natural-log LSE: (dq, dk, dv), two kernel launches.  CPU
    tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, scale=scale)
    if q.device.type != "cuda":
        raise NotImplementedError(f"flash_attention_bwd: no kernel for device {q.device}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    b, sq, n, d = q.shape
    if (k.shape[0] != b or k.shape[2:] != q.shape[2:] or v.shape != k.shape
            or out.shape != q.shape or do.shape != q.shape or lse.shape != (b, n, sq)):
        raise ValueError("flash_attention_bwd: unsupported shapes "
                         f"{[tuple(t.shape) for t in (q, k, v, out, lse, do)]}")
    q2, lse2, delta = _bwd_operands(q, out, lse, do, scale)
    ops = (q2, k, v, do, lse2.contiguous(), delta.contiguous())
    return (flash_attention_bwd_dq(*ops, scale=scale), *flash_attention_bwd_dkv(*ops))


def _check_bwd_operands(q2, k, v, do, lse2, delta):
    for name, t in (("q", q2), ("k", k), ("v", v), ("do", do)):
        _check_operand(name, t, q2.device)
    b, sq, n, _ = q2.shape
    if b * n > 65535 or k.shape[1] == 0:
        raise ValueError(f"unsupported batch*heads {b * n} / kv length {k.shape[1]}")
    for name, t in (("lse2", lse2), ("delta", delta)):
        if t.shape != (b, n, sq) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: the kernels take contiguous f32 (b, n, sq)")


def flash_attention_bwd_dq(q2, k, v, do, lse2, delta, *, scale):
    """The dq kernel on _bwd_operands' inputs (q prescaled, log2 LSE, delta)."""
    _check_bwd_operands(q2, k, v, do, lse2, delta)
    b, sq, n, _ = q2.shape
    dq = torch.empty(q2.shape, dtype=q2.dtype, device=q2.device)
    rc = cuda_build.lib().scail_flash_attention_bwd_dq(
        q2.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse2.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, n, sq, k.shape[1], *_strides(q2), *_strides(k),
        *_strides(v), *_strides(do), *_strides(dq), ctypes.c_float(scale), _stream(q2.device))
    cuda_build.check(rc, "flash_attention_bwd_dq")
    LAUNCHES["flash_attention_bwd_dq"] += 1
    return dq


def flash_attention_bwd_dkv(q2, k, v, do, lse2, delta):
    """The dk/dv kernel on _bwd_operands' inputs: (dk, dv)."""
    _check_bwd_operands(q2, k, v, do, lse2, delta)
    b, sq, n, _ = q2.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    rc = cuda_build.lib().scail_flash_attention_bwd_dkv(
        q2.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse2.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, sq, k.shape[1], *_strides(q2),
        *_strides(k), *_strides(v), *_strides(do), *_strides(dk), *_strides(dv),
        _stream(q2.device))
    cuda_build.check(rc, "flash_attention_bwd_dkv")
    LAUNCHES["flash_attention_bwd_dkv"] += 1
    return dk, dv


# --------------------------------------------------------------------------
# Gradients (counterparts of the JAX custom VJPs)
# --------------------------------------------------------------------------
def rope_transpose(g, cos, sin, interleaved: bool = True):
    """Pull a gradient back through `apply_rotary` (JAX _rope_t_bnsd).  The
    rotary is J = C + R S with R the antisymmetric rotate_half, so
    J^T = C - R S: multiply by sin first, then rotate (C - S R differs in the
    halves layout, whose swap straddles the per-axis table blocks)."""
    cos, sin = cos.to(g.dtype), sin.to(g.dtype)
    return g * cos - rotate_half(g * sin, interleaved)


class FlashStash:
    """The (out, lse) of the flash forwards of one checkpointed DiT layer,
    kept across its recompute (the JAX names `flash_out` and `flash_lse`,
    which the remat policies save_attn, save_attn_frac and offload_attn
    save or offload).

    `contexts()` gives torch.utils.checkpoint's context_fn pair: under the
    first, each flash forward (K1, K2, K7 with the LSE) launches and its
    result is kept; under the second, the recompute, each takes its kept
    result back in call order and launches nothing.  The q-side inputs are
    still recomputed.  With `offload`, CUDA results are copied to pinned host
    memory on a side stream and brought back on it when the recompute
    starts; `policy` names the remat policy in errors."""

    def __init__(self, policy: str, offload: bool = False):
        self.policy, self.offload = policy, offload
        self._kept = collections.deque()
        self._stream = None

    def contexts(self):
        return _stash_mode(self.record), _stash_mode(self.replay, self._fetch)

    def record(self, launch):
        out, lse = launch()
        self._kept.append(tuple(self._to_host(t) if self.offload else t.detach()
                                for t in (out, lse)))
        return out, lse

    def replay(self, launch):
        if not self._kept:
            raise RuntimeError(f"remat_policy={self.policy!r}: the recompute asked for more "
                               "flash outputs than its forward kept")
        kept = self._kept.popleft()
        if self._stream is not None:
            torch.cuda.current_stream(kept[0].device).wait_stream(self._stream)
        return kept

    def _side_stream(self, device):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def _to_host(self, t):
        """A pinned host copy of a CUDA tensor, made on the side stream (CPU
        tensors are host memory already)."""
        if t.device.type != "cuda":
            return t.detach()
        try:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        except RuntimeError as err:
            raise RuntimeError(f"remat_policy={self.policy!r}: could not allocate "
                               f"{t.numel() * t.element_size()} bytes of pinned host memory "
                               "for a flash output") from err
        side = self._side_stream(t.device)
        side.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(side):
            host.copy_(t, non_blocking=True)
        t.record_stream(side)
        return host

    def _fetch(self):
        """Start copying the offloaded outputs back to the device on the side
        stream, as the recompute begins; `replay` waits for them."""
        if not (self.offload and self._kept and self._stream is not None):
            return
        side = self._stream
        device = side.device
        with torch.cuda.stream(side):
            fetched = [tuple(t.to(device, non_blocking=True) for t in kept)
                       for kept in self._kept]
        for kept in fetched:
            for t in kept:
                t.record_stream(torch.cuda.current_stream(device))
        self._kept = collections.deque(fetched)


# the flash forwards' hook under a checkpointed layer: FlashStash.record or
# .replay while one of its contexts is active, else None
_STASH = contextvars.ContextVar("flash_stash", default=None)


@contextlib.contextmanager
def _stash_mode(fn, on_enter=None):
    if on_enter is not None:
        on_enter()
    token = _STASH.set(fn)
    try:
        yield
    finally:
        _STASH.reset(token)


def stashed_flash(launch):
    """(out, lse) of `launch()`, through the active FlashStash if any."""
    fn = _STASH.get()
    return launch() if fn is None else fn(launch)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with an optional rotary on q and k (JAX
    _flash_attention_rope_bnsd / _flash_attention_bnsd): the forward ropes k
    (K10) and q inside the flash kernel; the backward ropes q (K10), runs
    the dq and dk/dv kernels and pulls dq and dk back through the transposed
    rotary.  The tables get no gradient.  Under a remat policy that keeps
    the flash outputs, the recompute takes (out, lse) from the FlashStash."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, scale, interleaved):
        rope = None
        if cos is not None:
            rope = (cos, sin)
            k = fused_norms.apply_rotary_fused(k, cos, sin, interleaved=interleaved)
        out, lse = stashed_flash(lambda: flash_attention(q, k, v, scale=scale, rope=rope,
                                                         rope_interleaved=interleaved))
        ctx.save_for_backward(q, k, v, out, lse, cos, sin)
        ctx.scale, ctx.interleaved = scale, interleaved
        return out

    @staticmethod
    def backward(ctx, do):
        q, k_roped, v, out, lse, cos, sin = ctx.saved_tensors
        il = ctx.interleaved
        if cos is not None:
            q = fused_norms.apply_rotary_fused(q, cos, sin, interleaved=il)
        dq, dk, dv = flash_attention_bwd(q, k_roped, v, out, lse, do.contiguous(),
                                         scale=ctx.scale)
        if cos is not None:
            dq = rope_transpose(dq, cos[:, None, :], sin[:, None, :], il)
            dk = rope_transpose(dk, cos[:, None, :], sin[:, None, :], il)
        return dq, dk, dv, None, None, None, None


class _DualCrossAttention(torch.autograd.Function):
    """The dual cross-attention kernel forward with the exact plain backward
    (JAX _dual_cross_tpu)."""

    @staticmethod
    def forward(ctx, q, k1, v1, k2, v2, scale):
        ctx.save_for_backward(q, k1, v1, k2, v2)
        ctx.scale = scale
        return dual_cross_attention_fused(q, k1, v1, k2, v2, scale=scale)

    @staticmethod
    def backward(ctx, g):
        return (*dual_cross_attention_bwd_plain(*ctx.saved_tensors, g, scale=ctx.scale), None)


class _FlashAttentionInt8(torch.autograd.Function):
    """int8-QK flash attention forward; the backward is the exact bf16 one
    (K5) on the original q and k with the int8 forward's output and LSE (JAX
    _flash_int8_vjp_bwd, the straight-through treatment).  q and k arrive
    roped.  use_kernel False takes the plain versions both ways."""

    @staticmethod
    def forward(ctx, q, k, v, scale, use_kernel):
        fwd = flash_attention_int8 if use_kernel else flash_attention_int8_plain
        out, lse = fwd(q, k, v, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.use_kernel = scale, use_kernel
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd if ctx.use_kernel else flash_attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, out, lse, do.contiguous(), scale=ctx.scale)
        return dq, dk, dv, None, None


# --------------------------------------------------------------------------
# Public ops
# --------------------------------------------------------------------------
IMPLS = ("auto", "xla")  # kernel wrapper, plain version


def _check_impl(impl):
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}, expected one of {IMPLS}")
    return impl == "auto"


def attention(q, k, v, *, scale: float = None, impl: str = "auto", rope=None,
              rope_interleaved: bool = True):
    """Full bidirectional attention, q (b, sq, n, d), k/v (b, skv, n, d).

    rope: optional (cos, sin) (s, d) tables applied to q and k; k is rotated
    here in plain torch and q inside the kernel (or its plain version).
    impl: 'auto' takes the kernel wrappers, forward and backward (plain
    versions on CPU tensors); 'xla' takes the plain forward on any device and
    lets autograd differentiate it."""
    use_kernel = _check_impl(impl)
    cos = sin = None
    if rope is not None:
        if q.shape[1] != k.shape[1]:
            raise ValueError("rope needs q and k of the same length")
        cos, sin = rope
    if use_kernel:
        scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
        return _FlashAttention.apply(q, k, v, cos, sin, scale, rope_interleaved)
    if rope is not None:
        k = apply_rotary(k, cos[:, None, :], sin[:, None, :], rope_interleaved)
    return flash_attention_plain(q, k, v, scale=scale, rope=rope,
                                 rope_interleaved=rope_interleaved)[0]


def dual_cross_attention(q, k1, v1, k2, v2, *, scale: float = None, impl: str = "auto"):
    """attention(q, k1, v1) + attention(q, k2, v2): the DiT's summed text and
    CLIP cross-attention."""
    if _check_impl(impl):
        scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
        return _DualCrossAttention.apply(q, k1, v1, k2, v2, scale)
    return dual_cross_attention_plain(q, k1, v1, k2, v2, scale=scale)


def attention_int8(q, k, v, *, scale: float = None, impl: str = "auto"):
    """Self-attention with int8-quantized q and k (JAX attention(impl=
    'pallas_int8')); q and k carry their rotary already.  impl 'auto' takes
    the kernel wrappers (plain versions on CPU tensors), 'xla' the plain
    versions on any device; both differentiate through the exact backward."""
    use_kernel = _check_impl(impl)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttentionInt8.apply(q, k, v, scale, use_kernel)
