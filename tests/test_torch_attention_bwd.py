"""Parity of the port's attention gradients with the JAX package's custom VJPs.

The JAX side runs its Pallas backward kernels (_flash_dq_kernel and
_flash_dkv_kernel) in interpret mode on the CPU; the port's wrappers take their
plain versions on CPU tensors.  Same numpy inputs, f32.  Tolerance 2e-4: the
JAX package's own interpret-mode VJP tests (tests/test_ops.py) use the same.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scail_tpu_torch.ops import attention as tattn
from scail_tpu_torch.ops import rotary as trot

jattn = importlib.import_module("scail_tpu.ops.attention")

TOL = dict(rtol=2e-4, atol=2e-4)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _rope_tables(rng, s, d, interleaved):
    ang = rng.standard_normal((s, d // 2)).astype(np.float32)
    ang = np.repeat(ang, 2, axis=-1) if interleaved else np.concatenate([ang, ang], axis=-1)
    return np.cos(ang), np.sin(ang)


def _bnsd(a):
    b, s, n, d = a.shape
    return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * n, s, d))


def _from_bnsd(a, b, n):
    a = np.asarray(a)
    return a.reshape(b, n, a.shape[1], a.shape[2]).transpose(0, 2, 1, 3)


def test_plain_flash_bwd_matches_jax_pallas_kernels(rng):
    """flash_attention_bwd_plain == _flash_bwd (dq and dk/dv Pallas kernels),
    ragged q (150) and KV (176) with padding in the JAX blocks."""
    b, sq, skv, n, d = 1, 150, 176, 2, 128
    q, do = _rand(rng, b, sq, n, d), _rand(rng, b, sq, n, d)
    k, v = _rand(rng, b, skv, n, d), _rand(rng, b, skv, n, d)
    scale = 1.0 / np.sqrt(d)
    with pltpu.force_tpu_interpret_mode():
        out, lse = jattn._flash_fwd(_bnsd(q), _bnsd(k), _bnsd(v), scale, 128, 128)
        want = jattn._flash_bwd(_bnsd(q), _bnsd(k), _bnsd(v), out, lse, _bnsd(do), scale,
                                128, 128)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = tattn.flash_attention_bwd_plain(
        t(q), t(k), t(v), t(_from_bnsd(out, b, n)),
        t(np.asarray(lse).reshape(b, n, sq)), t(do), scale=scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _from_bnsd(w, b, n), **TOL)


@pytest.mark.parametrize("interleaved", [True, False])
def test_attention_rope_grads_match_jax_fused_kernel(rng, interleaved):
    """Gradients of attention(rope=...) (the autograd Function over the kernel
    wrappers) == those of _attention_pallas_rope's custom VJP."""
    b, s, n, d = 1, 150, 2, 128
    q, k, v, w = (_rand(rng, b, s, n, d) for _ in range(4))
    cos, sin = _rope_tables(rng, s, d, interleaved)

    def loss_jax(q, k, v):
        return jnp.sum(jnp.asarray(w) * jattn._attention_pallas_rope(
            q, k, v, jnp.asarray(cos), jnp.asarray(sin), 1.0 / np.sqrt(d), interleaved,
            block_q=128, block_k=128))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss_jax, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tattn.reset_launch_counts()
    out = tattn.attention(tq, tk, tv, rope=(torch.from_numpy(cos), torch.from_numpy(sin)),
                          rope_interleaved=interleaved)
    (out * torch.from_numpy(w)).sum().backward()
    for g, wg in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **TOL)
    assert all(c == 0 for c in tattn.LAUNCHES.values())


def test_attention_grads_without_rope_match_jax(rng):
    """The no-rope Function (K2 forward, K5 backward) against
    attention(impl='pallas') in JAX, q and KV of different lengths."""
    b, sq, skv, n, d = 2, 150, 176, 2, 128
    q, w = _rand(rng, b, sq, n, d), _rand(rng, b, sq, n, d)
    k, v = _rand(rng, b, skv, n, d), _rand(rng, b, skv, n, d)

    def loss_jax(q, k, v):
        return jnp.sum(jnp.asarray(w) * jattn.attention(q, k, v, impl="pallas"))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss_jax, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (tattn.attention(tq, tk, tv) * torch.from_numpy(w)).sum().backward()
    for g, wg in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **TOL)


def test_dual_cross_attention_grads_match_jax(rng):
    b, s, n, d = 1, 200, 2, 128
    arrays = [_rand(rng, b, s, n, d)] + [_rand(rng, b, m, n, d) for m in (37, 37, 21, 21)]
    w = _rand(rng, b, s, n, d)

    def loss_jax(*a):
        return jnp.sum(jnp.asarray(w) * jattn.dual_cross_attention(*a, impl="pallas"))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss_jax, argnums=tuple(range(5)))(*(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (tattn.dual_cross_attention(*ts) * torch.from_numpy(w)).sum().backward()
    for t, wg in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg), **TOL)


@pytest.mark.parametrize("interleaved", [True, False])
def test_rope_transpose_is_the_adjoint_of_the_rotary(interleaved):
    """<apply_rotary(x), g> == <x, rope_transpose(g)> on SCAIL's own tables,
    whose halves layout does not commute sin with rotate_half."""
    tabs = trot.build_scail_rope(128, 2, 4, 6, interleaved=interleaved)
    g = torch.Generator().manual_seed(0)
    x, gr = (torch.randn(1, tabs.cos.shape[0], 2, 128, generator=g, dtype=torch.float64)
             for _ in range(2))
    cos, sin = tabs.cos.double()[:, None], tabs.sin.double()[:, None]
    lhs = (trot.apply_rotary(x, cos, sin, interleaved) * gr).sum()
    rhs = (x * tattn.rope_transpose(gr, cos, sin, interleaved)).sum()
    assert abs(lhs.item() - rhs.item()) < 1e-9 * abs(lhs.item())


def test_bwd_wrapper_takes_plain_version_on_cpu_and_raises_elsewhere(rng):
    q, k, v, do = (torch.from_numpy(_rand(rng, 1, 20, 2, 128)) for _ in range(4))
    out, lse = tattn.flash_attention_plain(q, k, v)
    tattn.reset_launch_counts()
    got = tattn.flash_attention_bwd(q, k, v, out, lse, do)
    want = tattn.flash_attention_bwd_plain(q, k, v, out, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(c == 0 for c in tattn.LAUNCHES.values())
    m = torch.empty(1, 64, 2, 128, device="meta", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        tattn.flash_attention_bwd(m, m, m, m, torch.empty(1, 2, 64, device="meta"), m)
