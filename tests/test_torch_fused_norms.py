"""Parity of the port's fused AdaLN LayerNorm (K9) and interleaved rotary (K10)
with the JAX package's Pallas kernels, run in interpret mode on the CPU as
tests/test_fused_norms.py runs them.

The same numpy inputs go to `scail_tpu.ops.fused_norms` (impl='pallas') and
to `scail_tpu_torch.ops.fused_norms`, through the plain path (impl='xla') and
through the kernel wrapper (impl='auto', which takes the plain version for CPU
tensors).  Limits: f32 at 2e-5 (the JAX test's own); bf16 within one bf16
ulp for K9, whose f32 sums may round the other way, and bit-equal for K10,
which rounds after each product and the sum in both packages.  The autograd
Functions' gradients are held against torch.autograd of the plain versions at
1e-6 (f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scail_tpu.ops import fused_norms as jfn
from scail_tpu.ops.rotary import build_scail_rope as jax_build_scail_rope
from scail_tpu_torch.ops import attention as tattn
from scail_tpu_torch.ops import fused_norms as tfn
from scail_tpu_torch.ops.norms import layer_norm, modulate

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(dtype)


def _within_one_bf16_ulp(got, want):
    """|got - want| <= one bf16 ulp of |want| (8 significant bits)."""
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
    assert ((got - want).abs() <= ulp).all(), (got - want).abs().max().item()


@pytest.mark.parametrize("impl", ["xla", "auto"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [64, 256])
def test_adaln_layer_norm_matches_pallas(impl, dtype, d):
    _, jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(d)
    b, s = 2, 300  # s no multiple of the 128-row block
    x, shift, scale = (jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jdt)
                       for shape in ((b, s, d), (b, 1, d), (b, 1, d)))
    with pltpu.force_tpu_interpret_mode():
        want = jfn.adaln_layer_norm(x, shift, scale, eps=1e-6, impl="pallas", block_s=128)
    want = _to_torch(want, tdt)
    tattn.reset_launch_counts()
    got = tfn.adaln_layer_norm(*(_to_torch(t, tdt) for t in (x, shift, scale)), eps=1e-6,
                               impl=impl)
    assert got.dtype == tdt and got.shape == (b, s, d)
    assert all(n == 0 for n in tattn.LAUNCHES.values())  # CPU tensors: no kernel
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    else:
        _within_one_bf16_ulp(got, want)


def _rotary_case(dtype, n=3, b=2):
    """x (b, S, n, 32) in the port's layout with SCAIL tables of a (2, 4, 6)
    latent grid (S = 24 ref + 48 video + 12 pose = 84, no multiple of the
    32-row block), and the same x in the JAX kernel's (b*n, S, d) layout."""
    _, jdt, tdt = DTYPES[dtype]
    tables = jax_build_scail_rope(32, 2, 4, 6)
    S = tables.cos.shape[0]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, S, n, 32)).astype(np.float32)
    xj = jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * n, S, 32)).astype(jdt)
    cos, sin = (np.asarray(t, np.float32) for t in (tables.cos, tables.sin))
    return xj, _to_torch(xj, tdt).reshape(b, n, S, 32).transpose(1, 2), cos, sin


@pytest.mark.parametrize("impl", ["xla", "auto"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rotary_matches_pallas(impl, dtype):
    _, _, tdt = DTYPES[dtype]
    xj, xt, cos, sin = _rotary_case(dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jfn.apply_rotary_pallas(xj, jnp.asarray(cos), jnp.asarray(sin), impl="pallas",
                                       block_s=32)
    b, S, n, d = xt.shape
    want = _to_torch(want, tdt).reshape(b, n, S, d).transpose(1, 2)
    tattn.reset_launch_counts()
    got = tfn.apply_rotary_fused(xt, torch.from_numpy(cos), torch.from_numpy(sin), impl=impl)
    assert got.dtype == tdt and got.shape == xt.shape
    assert all(c == 0 for c in tattn.LAUNCHES.values())
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    else:
        assert torch.equal(got, want)


def test_rotary_takes_a_strided_qkv_view():
    """q and k reach the rotary as column slices of the qkv projection (row
    stride 3 * hidden): the result equals the rotary of contiguous copies."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((2, 84, 3 * 3 * 32)).astype(np.float32))
    q, k, _ = (t.unflatten(-1, (3, 32)) for t in qkv.chunk(3, dim=-1))
    _, _, cos, sin = _rotary_case("float32")
    cos, sin = torch.from_numpy(cos), torch.from_numpy(sin)
    for t in (q, k):
        assert not t.is_contiguous()
        assert torch.equal(tfn.apply_rotary_fused(t, cos, sin),
                           tfn.apply_rotary_fused_plain(t.contiguous(), cos, sin))


def test_adaln_plain_is_layer_norm_then_modulate_in_f32_and_rounds_once_in_bf16():
    """In f32 the plain K9 is modulate(layer_norm(x)) to the bit (so the f32
    DiT parity tests see no change); in bf16 it rounds once, and lands at
    least as close to the f32 result as the two-rounding chain does."""
    rng = np.random.default_rng(5)
    x, shift, scale = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                       for s in ((2, 77, 96), (2, 1, 96), (2, 1, 96)))
    chain = modulate(layer_norm(x, eps=1e-6), shift, scale)
    assert torch.equal(tfn.adaln_layer_norm_plain(x, shift, scale, eps=1e-6), chain)
    xb, sb, cb = (t.bfloat16() for t in (x, shift, scale))
    exact = tfn.adaln_layer_norm_plain(xb.float(), sb.float(), cb.float(), eps=1e-6)
    one = tfn.adaln_layer_norm_plain(xb, sb, cb, eps=1e-6)
    two = modulate(layer_norm(xb, eps=1e-6), sb, cb)
    assert one.dtype == two.dtype == torch.bfloat16
    assert torch.equal(one, exact.bfloat16())
    assert (one.float() - exact).abs().mean() <= (two.float() - exact).abs().mean()


@pytest.mark.parametrize("mod_dtype", [torch.float32, torch.bfloat16])
def test_adaln_function_gradients_match_autograd_of_the_plain_version(mod_dtype):
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 37, 64)).astype(np.float32))
    mod = torch.from_numpy(rng.standard_normal((2, 6, 64)).astype(np.float32)).to(mod_dtype)
    g = torch.from_numpy(rng.standard_normal((2, 37, 64)).astype(np.float32))
    grads = []
    for fn in (tfn.adaln_layer_norm, tfn.adaln_layer_norm_plain):
        xi, mi = x.clone().requires_grad_(), mod.clone().requires_grad_()
        # shift and scale as the DiT passes them: strided rows of one table
        shift, scale = mi.unsqueeze(2).unbind(1)[:2]
        y = fn(xi, shift, scale, eps=1e-6)
        assert (type(y.grad_fn).__name__ == "_AdaLayerNormBackward") == (fn is tfn.adaln_layer_norm)
        y.backward(g)
        grads.append((xi.grad, mi.grad))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_rotary_function_gradient_matches_autograd_of_the_plain_version():
    _, xt, cos, sin = _rotary_case("float32")
    cos, sin = torch.from_numpy(cos), torch.from_numpy(sin)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(xt.shape).astype(np.float32))
    grads = []
    for fn in (tfn.apply_rotary_fused, tfn.apply_rotary_fused_plain):
        xi = xt.detach().clone().requires_grad_()
        y = fn(xi, cos, sin)
        assert (type(y.grad_fn).__name__ == "_RotaryBackward") == (fn is tfn.apply_rotary_fused)
        y.backward(g)
        grads.append(xi.grad)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=1e-6, atol=1e-6)


def test_unknown_impl_raises():
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tfn.adaln_layer_norm(x, x[:, :1], x[:, :1], impl="pallas")
    with pytest.raises(ValueError, match="unknown attention impl"):
        tfn.apply_rotary_fused(x[:, :, None], x[0], x[0], impl="pallas")
