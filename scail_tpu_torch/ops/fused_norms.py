"""Fused AdaLN LayerNorm and interleaved rotary (counterpart of
scail_tpu/ops/fused_norms.py).

Two kernel wrappers over csrc/fused_norms.cu:

  * `adaln_layer_norm` -- y = LN(x) * (1 + scale) + shift (K9), the DiT's
    AdaLN entry to self-attention and to the MLP, and its final layer; with
    one rounding as the Pallas kernel, or with round_ln at dit_forward's
    roundings, which the DiT takes;
  * `apply_rotary_fused` -- x * cos + rotate_half(x) * sin over interleaved
    pairs (K10), the rotary of k before the flash kernel, of q in its
    backward, and of q and k under sliding-tile and int8-QK attention.

Each has a plain PyTorch version (`*_plain`), runs it for CPU tensors and
launches its kernel (or raises) for CUDA tensors, and counts its launches in
`ops.attention.LAUNCHES` ('adaln_layer_norm', 'rotary').  `impl` as in
ops/attention.py: 'auto' the kernel wrapper, 'xla' the plain version on any
device.  The JAX package has no backward kernel for either, so neither has
one here: where a gradient is needed the wrapper runs inside a
torch.autograd.Function whose backward differentiates the plain version (K9)
or applies the transposed rotary (K10).
"""

from __future__ import annotations

import ctypes

import torch

from scail_tpu_torch.ops import attention, cuda_build
from scail_tpu_torch.ops.rotary import apply_rotary

# K9 holds a row in one warp's registers: at most 32 vectors of 8 per lane
NORM_MAX_DIM = 8192


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------
def adaln_layer_norm_plain(x, shift, scale, *, eps: float = 1e-6, round_ln: bool = False):
    """LN(x) * (1 + scale) + shift; x (b, s, d), shift/scale (b, 1, d).  The
    statistics as the Pallas kernel computes them: f32 mean,
    var = mean((x - mean)^2), (x - mean) * rsqrt(var + eps).  Then either
      * round_ln=False (the Pallas kernel): * (1 + scale) + shift with shift
        and scale in f32, one rounding to x.dtype; or
      * round_ln=True (dit_forward's modulate(layer_norm(x), shift, scale)):
        the LayerNorm rounded to x.dtype, then x * (1 + scale) + shift in the
        types that promotion gives (bf16 shift/scale: each op rounded to bf16;
        f32 shift/scale: an f32 result).
    In f32 the two modes are the same ops."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = xc.square().mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    if round_ln:
        return y.to(x.dtype) * (1 + scale) + shift
    return (y * (1 + scale.float()) + shift.float()).to(x.dtype)


def apply_rotary_fused_plain(x, cos, sin):
    """x (b, s, n, d) in the interleaved pair layout, cos/sin (s, d): the
    tables cast to x.dtype, each product and the sum rounded to x.dtype
    (ops/rotary.py apply_rotary, the Pallas body's rounding order)."""
    return apply_rotary(x, cos[:, None, :], sin[:, None, :], interleaved=True)


# How far K9's bf16 output may sit from its plain version on the same inputs:
# both round once from f32 and differ only in the order of the row sums, so an
# element may round the other way, by one bf16 ulp (<= 2^-7 of the largest
# magnitude); and the relative L2 distance over the whole output.  K10 rounds
# where its plain version rounds and is held bit-exact.
ADALN_MAX_ABS_PER_MAX = 2.0 ** -7
ADALN_REL_L2 = 4e-3


def adaln_error_vs_plain(got, want) -> dict:
    """K9's error against its plain version, with `ok` set by the limits
    above: max_abs_err, its bound, rel_l2, err_per_std."""
    d = got.float() - want.float()
    w = want.float()
    max_abs = d.abs().max().item()
    limit = ADALN_MAX_ABS_PER_MAX * w.abs().max().item()
    rel_l2 = (d.norm() / w.norm()).item()
    return {"max_abs_err": max_abs, "max_abs_limit": limit, "rel_l2": rel_l2,
            "err_per_std": max_abs / w.std().item(),
            "ok": max_abs <= limit and rel_l2 <= ADALN_REL_L2}


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------
def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def adaln_layer_norm_kernel(x, shift, scale, *, eps: float = 1e-6, round_ln: bool = False):
    """K9 on x (b, s, d) bf16, strided over (b, s) with 16-byte aligned rows,
    and shift/scale (b or 1, 1, d), both bf16 or both f32 (bf16 only with
    round_ln, whose result would otherwise be f32); returns a contiguous
    (b, s, d) bf16.  CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return adaln_layer_norm_plain(x, shift, scale, eps=eps, round_ln=round_ln)
    if x.device.type != "cuda":
        raise NotImplementedError(f"adaln_layer_norm: no kernel for device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"adaln_layer_norm: the kernel takes bfloat16 x, got {x.dtype}")
    if x.dim() != 3 or x.shape[-1] % 8 or not 0 < x.shape[-1] <= NORM_MAX_DIM:
        raise ValueError(f"adaln_layer_norm: the kernel takes (b, s, d) with d a multiple of 8 "
                         f"up to {NORM_MAX_DIM}, got {tuple(x.shape)}")
    b, s, d = x.shape
    shift, scale = shift.expand(b, 1, d), scale.expand(b, 1, d)
    if shift.dtype != scale.dtype or shift.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"adaln_layer_norm: shift/scale must both be bfloat16 or float32, got "
                        f"{shift.dtype} / {scale.dtype}")
    if round_ln and shift.dtype != torch.bfloat16:
        raise TypeError("adaln_layer_norm: round_ln takes bfloat16 shift/scale (with f32 ones "
                        "the modulation's result is f32, which the kernel does not write)")
    if shift.stride(0) != scale.stride(0):  # the kernel takes one batch stride for both
        shift, scale = shift.contiguous(), scale.contiguous()
    for name, t, rows in (("x", x, 2), ("shift", shift, 1), ("scale", scale, 1)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:rows]) or t.data_ptr() % 16:
            raise ValueError(f"adaln_layer_norm: {name} needs a contiguous last dim and "
                             f"16-byte aligned rows, got strides {t.stride()}")
    out = torch.empty((b, s, d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    rc = cuda_build.lib().scail_adaln_layer_norm(
        x.data_ptr(), shift.data_ptr(), scale.data_ptr(), out.data_ptr(), b, s, d,
        ctypes.c_longlong(x.stride(0)), ctypes.c_longlong(x.stride(1)),
        ctypes.c_longlong(shift.stride(0)), int(shift.dtype == torch.float32), int(round_ln),
        ctypes.c_float(eps), _stream(x.device))
    cuda_build.check(rc, "adaln_layer_norm")
    attention.LAUNCHES["adaln_layer_norm"] += 1
    return out


def rotary_kernel(x, cos, sin):
    """K10 on x (b, s, n, d) bf16 with a contiguous last dim (other strides
    free, e.g. a column slice of the qkv projection), d even, and (s, d)
    tables; returns a contiguous (b, s, n, d) bf16.  CPU tensors take the
    plain version."""
    if x.device.type == "cpu":
        return apply_rotary_fused_plain(x, cos, sin)
    if x.device.type != "cuda":
        raise NotImplementedError(f"rotary: no kernel for device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"rotary: the kernel takes bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[-1] % 2:
        raise ValueError(f"rotary: the kernel takes (b, s, n, d) with d even, got "
                         f"{tuple(x.shape)}")
    if x.stride(-1) != 1 or any(st % 2 for st in x.stride()[:3]) or x.data_ptr() % 4:
        raise ValueError(f"rotary: x needs a contiguous last dim and 4-byte aligned pairs, "
                         f"got strides {x.stride()}")
    b, s, n, d = x.shape
    cos, sin = (t.to(device=x.device, dtype=torch.float32).contiguous() for t in (cos, sin))
    if cos.shape != (s, d) or sin.shape != (s, d):
        raise ValueError(f"rotary tables {tuple(cos.shape)} do not fit x {tuple(x.shape)}")
    out = torch.empty((b, s, n, d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    rc = cuda_build.lib().scail_rotary_interleaved(
        x.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(), b, s, n, d,
        *(ctypes.c_longlong(st) for st in x.stride()[:3]), _stream(x.device))
    cuda_build.check(rc, "rotary")
    attention.LAUNCHES["rotary"] += 1
    return out


# --------------------------------------------------------------------------
# Gradients
# --------------------------------------------------------------------------
class _AdaLayerNorm(torch.autograd.Function):
    """K9 forward; the backward differentiates the plain version, recomputed
    from the saved inputs, for the exact gradients of x, shift and scale."""

    @staticmethod
    def forward(ctx, x, shift, scale, eps, round_ln):
        ctx.save_for_backward(x, shift, scale)
        ctx.eps, ctx.round_ln = eps, round_ln
        return adaln_layer_norm_kernel(x, shift, scale, eps=eps, round_ln=round_ln)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = adaln_layer_norm_plain(*inputs, eps=ctx.eps, round_ln=ctx.round_ln)
        grads = torch.autograd.grad(y, inputs, g)
        return (*(gr if need else None for gr, need in zip(grads, ctx.needs_input_grad)),
                None, None)


class _Rotary(torch.autograd.Function):
    """K10 forward; the backward is the transposed rotary (the tables get no
    gradient)."""

    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        return rotary_kernel(x, cos, sin)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        return attention.rope_transpose(g, cos[:, None, :], sin[:, None, :], True), None, None


# --------------------------------------------------------------------------
# Public ops
# --------------------------------------------------------------------------
def adaln_layer_norm(x, shift, scale, *, eps: float = 1e-6, round_ln: bool = False,
                     impl: str = "auto"):
    """LN(x) * (1 + scale) + shift; x (b, s, d), shift/scale (b, 1, d);
    round_ln as in adaln_layer_norm_plain (True: dit_forward's roundings).
    impl 'auto' the kernel wrapper (the plain version on CPU tensors), 'xla'
    the plain version on any device."""
    if not attention._check_impl(impl):
        return adaln_layer_norm_plain(x, shift, scale, eps=eps, round_ln=round_ln)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, shift, scale)):
        return _AdaLayerNorm.apply(x, shift, scale, eps, round_ln)
    return adaln_layer_norm_kernel(x, shift, scale, eps=eps, round_ln=round_ln)


def apply_rotary_fused(x, cos, sin, *, interleaved: bool = True, impl: str = "auto"):
    """The rotary of x (b, s, n, d) with (s, d) tables.  impl 'auto' the
    kernel wrapper (the plain version on CPU tensors), 'xla' the plain
    version on any device.  Only the interleaved layout has a kernel, as in
    the JAX package: the halves layout is ops/rotary.py's apply_rotary."""
    if not interleaved:
        return apply_rotary(x, cos[:, None, :], sin[:, None, :], interleaved=False)
    if not attention._check_impl(impl):
        return apply_rotary_fused_plain(x, cos, sin)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Rotary.apply(x, cos, sin)
    return rotary_kernel(x, cos, sin)
