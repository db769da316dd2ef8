"""Parity of the port's int8-QK attention (ops/attention.py attention_int8)
with the JAX package's `_attention_pallas_int8`, on the CPU.

The JAX side runs its Pallas kernels (the int8 forward and, for the
gradients, the flash backward) in interpret mode, as tests/test_ops.py runs
them; the port's wrappers take their plain versions on CPU tensors.  The row
quantization must match to the bit; outputs, LSEs and gradients within 2e-4
(f32 summation order), the tolerance of the other interpret-mode parity
tests.  Numpy inputs from a seed, f32.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scail_tpu.models.dit import DiTConfig as JaxDiTConfig
from scail_tpu.models.dit import dit_forward, init_dit_params
from scail_tpu_torch.convert.from_jax import dit_state_dict_from_jax
from scail_tpu_torch.models.dit import DiT, DiTConfig
from scail_tpu_torch.ops import attention as tattn

jattn = importlib.import_module("scail_tpu.ops.attention")

TOL = dict(rtol=2e-4, atol=2e-4)
TINY = dict(hidden_size=32, num_layers=2, num_heads=4, inner_hidden_size=48,
            time_embed_dim=32, text_dim=16, clip_dim=8, share_adaln=True,
            use_i2v_clip=True, dtype="float32", interleaved_rope=True)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_quantize_rows_bit_exact_with_jax(rng):
    x = _rand(rng, 2, 50, 3, 64) * 3.0
    x[0, 7, 1] = 0.0  # a zero row takes the 1e-6 floor
    jq, js = jattn._quantize_rows(jnp.asarray(x))
    q, s = tattn.quantize_rows(*_t(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert torch.equal(q, *_t(jq)) and torch.equal(s, *_t(js))


@pytest.mark.parametrize("sq, skv", [(100, 150), (64, 64), (1, 65)])
def test_kernel_operands_bit_exact_with_jax_int8_fwd(rng, sq, skv):
    """What the K6 wrapper hands the kernel: the codes and scales of JAX
    _flash_int8_fwd on the (b*n, s, d) layout, the q scales folded with
    scale*log2e, the k scales re-laid as (b*n, skv) rows padded with zeros to
    the kernel's 64-row tiles (JAX pads them to its block_k)."""
    b, n = 2, 3
    q, k = _rand(rng, b, sq, n, 128) * 2.0, _rand(rng, b, skv, n, 128)
    scale = 1.0 / np.sqrt(128)
    qi, qs, ki, ks = tattn._int8_kernel_operands(*_t(q, k), scale)
    bnsd = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * n, -1, 128))  # noqa: E731
    jqi, jqs = jattn._quantize_rows(bnsd(q))
    jqs = jqs * (scale * jattn._LOG2E)
    jki, jks = jattn._quantize_rows(bnsd(k))
    jks = jnp.pad(jks, ((0, 0), (0, (-skv) % 64)))
    to_bnsd = lambda t: t.permute(0, 2, 1, 3).reshape(b * n, -1, 128)  # noqa: E731
    assert torch.equal(to_bnsd(qi), *_t(jqi)) and torch.equal(to_bnsd(ki), *_t(jki))
    assert torch.equal(qs.permute(0, 2, 1).reshape(b * n, sq), *_t(jqs))
    assert ks.shape == (b * n, -(-skv // 64) * 64) and ks.dtype == torch.float32
    assert torch.equal(ks, *_t(jks))


def _qkv(rng, s=384):
    """(1, 384, 2, 128): 384 kv rows are one and a half 256-row JAX blocks,
    so the JAX kernel pads and masks a KV tail."""
    return [_rand(rng, 1, s, 2, 128) for _ in range(3)]


def test_attention_int8_matches_jax_pallas_interpret(rng):
    q, k, v = _qkv(rng)
    scale = 1.0 / np.sqrt(128)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jattn._attention_pallas_int8(
            *(jnp.asarray(a) for a in (q, k, v)), scale, block_q=128, block_k=256))
        bnsd = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3).reshape(2, -1, 128))  # noqa: E731
        _, want_lse = jattn._flash_int8_fwd(bnsd(q), bnsd(k), bnsd(v), scale, 128, 256)
    tq, tk, tv = _t(q, k, v)
    np.testing.assert_allclose(tattn.attention_int8(tq, tk, tv).detach().numpy(), want, **TOL)
    out, lse = tattn.flash_attention_int8(tq, tk, tv)
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    np.testing.assert_allclose(lse.numpy().reshape(2, -1), np.asarray(want_lse), **TOL)
    # the exact attention is a different function: the int8 one is not it
    exact = tattn.flash_attention_plain(tq, tk, tv)[0].numpy()
    assert np.abs(exact - want).max() > 1e-3


def test_attention_int8_gradients_match_jax_vjp(rng):
    """q, k, v gradients: the exact backward (K5) on the original q and k with
    the int8 forward's output and LSE, as the JAX custom VJP."""
    q, k, v = _qkv(rng)
    w = _rand(rng, *q.shape)

    def loss(q, k, v):
        out = jattn._attention_pallas_int8(q, k, v, 1.0 / np.sqrt(128), block_q=128,
                                           block_k=256)
        return jnp.sum(out * jnp.asarray(w))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for impl in ("auto", "xla"):
        tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
        (tattn.attention_int8(tq, tk, tv, impl=impl) * torch.from_numpy(w)).sum().backward()
        for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_int8_wrapper_counts_nothing_on_cpu_and_raises_without_a_kernel(rng):
    tattn.reset_launch_counts()
    q, k, v = _t(*_qkv(rng, 70))
    out, lse = tattn.flash_attention_int8(q, k, v)
    want, want_lse = tattn.flash_attention_int8_plain(q, k, v)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert all(n == 0 for n in tattn.LAUNCHES.values())
    m = torch.empty(1, 64, 2, 128, device="meta", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        tattn.flash_attention_int8(m, m, m)


@pytest.mark.parametrize("quant_impl", ["auto", "xla"])
def test_dit_with_int8_attention_matches_jax(quant_impl):
    params = init_dit_params(jax.random.PRNGKey(2), JaxDiTConfig(**TINY))
    rng = np.random.default_rng(11)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inp = dict(x=f(1, 2, 16, 8, 8), t=np.full((1,), 500.0, np.float32), ctx=f(1, 8, 16),
               ref=f(1, 1, 16, 8, 8), smpl=f(1, 2, 16, 4, 4), clip=f(1, 5, 8))
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(dit_forward(
            params, JaxDiTConfig(**TINY, attn_impl="pallas_int8"), j["x"], j["t"], j["ctx"],
            ref_concat=j["ref"], concat_smpl_render=j["smpl"], image_clip_features=j["clip"]))
    model = DiT(DiTConfig(**TINY, attn_impl="pallas_int8", quant_impl=quant_impl))
    model.load_state_dict(dit_state_dict_from_jax(params))
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    with torch.no_grad():
        got = model(t["x"], t["t"], t["ctx"], ref_concat=t["ref"], concat_smpl_render=t["smpl"],
                    image_clip_features=t["clip"]).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the exact attention sits ~20x farther from the JAX int8 DiT than the port
    model.config = DiTConfig(**TINY)
    with torch.no_grad():
        exact = model(t["x"], t["t"], t["ctx"], ref_concat=t["ref"],
                      concat_smpl_render=t["smpl"], image_clip_features=t["clip"]).numpy()
    assert np.abs(got - want).max() < 0.1 * np.abs(exact - want).max()
