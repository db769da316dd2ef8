"""Weight quantization: W8A16 and W4A16 linears with a hand-written CUDA
kernel and its plain PyTorch version (counterpart of scail_tpu/ops/quant.py).

Layout: the port keeps nn.Linear's (out, in) = (N, K) for the codes, so a
code row is K-contiguous, the K-major B operand of the kernel's wgmma once
converted to bf16: `qweight` (N, K) int8, or `qweight4` (N, K/2) uint8 with the even
input index in the low nibble and the odd one in the high nibble; `scale`
(N,) per output channel.  The JAX package stores the transposes, (K, N) and
(K/2, N); convert/from_jax.py moves between the two.

Quantization follows the JAX package to the bit: absmax over the input dim,
max(scale, 1e-8), a true division by the scale, round half to even, clip to
+-127 or +-7.  `matmul_w8a16` / `matmul_w4a16` launch the kernel
(csrc/w8a16_matmul.cu) for CUDA tensors and run the plain version for CPU
tensors, or with impl='xla' on any device; each launch counts in LAUNCHES.
"""

from __future__ import annotations

import ctypes
from typing import Iterable

import torch
from torch import nn

from scail_tpu_torch.ops import cuda_build

LAUNCHES = {"w8a16_matmul": 0, "w4a16_matmul": 0}
IMPLS = ("auto", "xla")  # kernel wrapper, plain version


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Quantize / pack
# ---------------------------------------------------------------------------
def _absmax_scale(w, qmax: float):
    return (w.abs().amax(dim=-1) / qmax).clamp_min(1e-8)


def quantize_int8(w):
    """w (..., N, K) float -> (int8 codes (..., N, K), f32 scale (..., N)):
    symmetric per output channel, scale = absmax / 127.  Leading dims
    (stacked layers) quantize independently."""
    w = w.float()
    scale = _absmax_scale(w, 127.0)
    q = torch.round(w / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_int4(w):
    """w (..., N, K), K even -> (packed uint8 (..., N, K/2), f32 scale (..., N)):
    codes in [-7, 7], two per byte along the input dim (even k low nibble)."""
    w = w.float()
    if w.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even input dim, got {w.shape[-1]}")
    scale = _absmax_scale(w, 7.0)
    q = torch.round(w / scale[..., None]).clamp(-7, 7).to(torch.int8)
    lo = (q[..., 0::2] & 0xF).to(torch.uint8)
    hi = (q[..., 1::2] & 0xF).to(torch.uint8)
    return lo | (hi << 4), scale


def unpack_int4(packed):
    """Inverse of quantize_int4's packing: (..., N, K/2) uint8 -> int8 codes
    (..., N, K), each nibble sign-extended (so a byte's 0x8 nibble is -8)."""
    nib = torch.stack([packed & 0xF, packed >> 4], dim=-1).to(torch.int16)
    nib = torch.where(nib >= 8, nib - 16, nib).to(torch.int8)
    return nib.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


# ---------------------------------------------------------------------------
# Plain version: the kernel's function, chunked over rows
# ---------------------------------------------------------------------------
def matmul_quant_plain(x, codes, scale, bias=None, *, block_m: int = 8192):
    """(x @ codes^T) with f32 accumulation, times f32(scale) per output
    channel, rounded to x.dtype; then + bias in x.dtype (two roundings, as
    the JAX package's dense_quantized).  codes (N, K) int8 (unpacked)."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    w = codes.float()
    s = scale.float()
    out = torch.empty((x2.shape[0], w.shape[0]), dtype=x.dtype, device=x.device)
    for i in range(0, x2.shape[0], block_m):
        out[i:i + block_m] = ((x2[i:i + block_m].float() @ w.T) * s).to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out.reshape(*lead, w.shape[0])


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------
def _launch(x, codes, scale, bias, bits):
    name = f"w{bits}a16_matmul"
    if x.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for device {x.device}")
    k = x.shape[-1]
    n = codes.shape[0]
    want = (torch.int8, k) if bits == 8 else (torch.uint8, k // 2)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16 activations, got {x.dtype}")
    if codes.dim() != 2 or (codes.dtype, codes.shape[1]) != want or not codes.is_contiguous():
        raise ValueError(f"{name}: codes must be contiguous {want[0]} (N, {want[1]}), got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    if codes.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs 16-byte aligned codes")
    if k % 16 or k == 0 or n == 0:
        raise ValueError(f"{name}: the kernel needs K a positive multiple of 16, got K={k}, N={n}")
    if scale.shape != (n,):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} does not fit N={n}")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} does not fit N={n}")
    for nm, t in (("codes", codes), ("scale", scale)) + ((("bias", bias),) if bias is not None
                                                         else ()):
        if t.device != x.device:
            raise ValueError(f"{name}: {nm} is on {t.device}, x on {x.device}")
    x2 = x.reshape(-1, k)
    if x2.stride(1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16:
        x2 = x2.contiguous()  # a layout copy: TMA reads 16-byte aligned rows
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m:
        s32 = scale.float().contiguous()
        b16 = bias.to(torch.bfloat16).contiguous() if bias is not None else None
        fn = cuda_build.lib().scail_w8a16_matmul if bits == 8 else cuda_build.lib().scail_w4a16_matmul
        rc = fn(x2.data_ptr(), codes.data_ptr(), s32.data_ptr(),
                b16.data_ptr() if b16 is not None else None, out.data_ptr(), m, n, k,
                ctypes.c_longlong(x2.stride(0)),
                ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
        cuda_build.check(rc, name)
        LAUNCHES[name] += 1
    return out.reshape(*x.shape[:-1], n)


def _check_impl(impl):
    if impl not in IMPLS:
        raise ValueError(f"unknown quantized matmul impl {impl!r}, expected one of {IMPLS}")
    return impl == "auto"


def matmul_w8a16(x, qw, scale, bias=None, impl: str = "auto"):
    """x (..., K) @ dequant(qw)^T (+ bias): the W8A16 linear.  qw (N, K) int8,
    scale (N,).  'auto': the kernel for CUDA tensors, the plain version for
    CPU tensors; 'xla': the plain version on any device."""
    if not _check_impl(impl) or x.device.type == "cpu":
        return matmul_quant_plain(x, qw, scale, bias)
    return _launch(x, qw, scale, bias, 8)


def matmul_w4a16(x, packed, scale, bias=None, impl: str = "auto"):
    """The int4 variant: packed (N, K/2) uint8.  The kernel unpacks the
    nibbles in registers; the plain version unpacks first."""
    if not _check_impl(impl) or x.device.type == "cpu":
        return matmul_quant_plain(x, unpack_int4(packed), scale, bias)
    return _launch(x, packed, scale, bias, 4)


# ---------------------------------------------------------------------------
# Quantized layers
# ---------------------------------------------------------------------------
class QuantizedLinear(nn.Module):
    """A linear layer with int8 (`qweight` (N, K)) or packed int4 (`qweight4`
    (N, K/2)) codes, a per-output-channel `scale` and an optional `bias`, all
    buffers: Module.to(dtype) casts the scale and bias and leaves the codes."""

    def __init__(self, codes, scale, bias=None, bits: int = 8):
        super().__init__()
        if bits not in (8, 4):
            raise ValueError(f"bits must be 8 or 4, got {bits}")
        self.bits = bits
        self.out_features = codes.shape[0]
        self.in_features = codes.shape[1] * (2 if bits == 4 else 1)
        self.register_buffer("qweight" if bits == 8 else "qweight4", codes)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)

    @property
    def codes(self):
        return self.qweight if self.bits == 8 else self.qweight4

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, bits={self.bits}"


def quantize_dense_params(layer: nn.Linear, bits: int = 8) -> QuantizedLinear:
    """An nn.Linear -> its QuantizedLinear (codes and scales from the f32
    weight; the bias and any LoRA factors kept as they are)."""
    quantize = {8: quantize_int8, 4: quantize_int4}.get(bits)
    if quantize is None:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    codes, scale = quantize(layer.weight.detach())
    bias = layer.bias.detach().clone() if layer.bias is not None else None
    qlayer = QuantizedLinear(codes, scale.to(layer.weight.dtype), bias, bits)
    # LoRA factors stay as they are: the delta runs beside the quantized base
    for name, p in layer.named_parameters(recurse=False):
        if name.startswith("lora_"):
            qlayer.register_parameter(name, p)
    for name, b in layer.named_buffers(recurse=False):
        if name.startswith("lora_"):
            qlayer.register_buffer(name, b)
    return qlayer


def dense_quantized(layer: QuantizedLinear, x, impl: str = "auto"):
    """x @ W^T + b for a QuantizedLinear in x.dtype.  The scale is rounded to
    x.dtype first, as the JAX DiT casts every floating leaf to its compute
    dtype before the kernel reads the scale back in f32."""
    scale = layer.scale.to(x.dtype)
    fn = matmul_w8a16 if layer.bits == 8 else matmul_w4a16
    return fn(x, layer.codes, scale, layer.bias, impl=impl)


def quantize_model_params(model: nn.Module, targets: Iterable[str] = ("layers.",),
                          bits: int = 8) -> nn.Module:
    """Replace, in place, every nn.Linear whose qualified name contains a
    target substring with its QuantizedLinear (the JAX quantize_model_params
    over the stacked tree: `layers.3.qkv.qweight` <-> layers/qkv/qweight[3]).
    Returns the model."""
    targets = tuple(targets)
    for name, mod in list(model.named_modules()):
        if isinstance(mod, nn.Linear) and any(t in name + "." for t in targets):
            parent, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(parent) if parent else model, leaf,
                    quantize_dense_params(mod, bits))
    return model


def random_quantized_linear(d_in: int, d_out: int, bits: int, *, device, generator,
                            dtype=torch.bfloat16) -> QuantizedLinear:
    """Random codes made on `device` without a float weight: int8 uniform in
    [-127, 127] with scale 0.02/127, or packed int4 bytes uniform in
    [0, 255] (so every nibble, -8 included) with scale 0.02/7; zero bias."""
    if bits == 8:
        codes = torch.randint(-127, 128, (d_out, d_in), dtype=torch.int8, device=device,
                              generator=generator)
        s = 0.02 / 127.0
    elif bits == 4:
        codes = torch.randint(0, 256, (d_out, d_in // 2), dtype=torch.uint8, device=device,
                              generator=generator)
        s = 0.02 / 7.0
    else:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    return QuantizedLinear(codes, torch.full((d_out,), s, dtype=dtype, device=device),
                           torch.zeros(d_out, dtype=dtype, device=device), bits)
