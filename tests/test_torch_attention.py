"""Parity of the PyTorch port's attention ops with the JAX package's Pallas
kernels, run in interpret mode on the CPU, plus the wrappers' CPU contract.

On CPU tensors the port's kernel wrappers take their plain PyTorch versions;
the same numpy inputs go through both packages in f32.  Tolerance 2e-4: the
JAX package's own interpret-mode attention tests use the same.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scail_tpu_torch.ops import attention as tattn
from scail_tpu_torch.ops import rotary as trot

# scail_tpu.ops re-exports functions under its module names: import the modules
jattn = importlib.import_module("scail_tpu.ops.attention")
jrot = importlib.import_module("scail_tpu.ops.rotary")

TOL = dict(rtol=2e-4, atol=2e-4)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _rope_tables(rng, s, d, interleaved):
    ang = rng.standard_normal((s, d // 2)).astype(np.float32)
    ang = np.repeat(ang, 2, axis=-1) if interleaved else np.concatenate([ang, ang], axis=-1)
    return np.cos(ang), np.sin(ang)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("interleaved", [True, False])
def test_attention_rope_matches_jax_fused_kernel(rng, interleaved):
    """attention(rope=...) == the JAX fused-rope flash kernel (q rotated in
    the kernel, k pre-rotated), ragged S with q and KV padding in the blocks."""
    b, s, n, d = 1, 150, 2, 128
    q, k, v = (_rand(rng, b, s, n, d) for _ in range(3))
    cos, sin = _rope_tables(rng, s, d, interleaved)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jattn._attention_pallas_rope(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cos), jnp.asarray(sin),
            1.0 / np.sqrt(d), interleaved, block_q=128, block_k=128))
    tq, tk, tv, tc, ts = _t(q, k, v, cos, sin)
    got = tattn.attention(tq, tk, tv, rope=(tc, ts), rope_interleaved=interleaved).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_attention_matches_jax_pallas_with_lse(rng):
    """No-rope flash (the K2 instantiation): output via attention(impl='pallas')
    and the natural-log LSE via the JAX forward driver, ragged q and KV."""
    b, sq, skv, n, d = 2, 150, 176, 2, 128
    q, k, v = _rand(rng, b, sq, n, d), _rand(rng, b, skv, n, d), _rand(rng, b, skv, n, d)
    scale = 1.0 / np.sqrt(d)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          impl="pallas"))
        bnsd = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * n, -1, d))  # noqa: E731
        _, lse = jattn._flash_fwd(bnsd(q), bnsd(k), bnsd(v), scale, 128, 128)
    out, got_lse = tattn.flash_attention(*_t(q, k, v))
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    np.testing.assert_allclose(got_lse.numpy().reshape(b * n, sq), np.asarray(lse), **TOL)


@pytest.mark.parametrize("rope", [None, True, False], ids=["none", "interleaved", "halves"])
def test_flash_rounding_points_match_jax_in_bf16(rng, rope):
    """The rounding points the flash kernel keeps (q prescaled to bf16, q
    rotated in f32 and rounded again, P rounded to bf16 before P V, f32 m / l
    / acc), held in bf16 against JAX's _flash_rope_fwd / _flash_fwd in
    interpret mode, ragged q and KV.  Reading: 0.016 std, relative L2
    1.3e-3 to 1.5e-3, LSE 4.8e-7, 87-89% of the outputs bit-equal.  The
    error_vs_plain limits alone pass a plain version with these roundings
    dropped (0.032 std, 3.5e-3), so the share of bit-equal outputs is held
    too: it falls to 46% without them."""
    b, sq, skv, n, d = 1, 150, 176, 2, 128
    q, k, v = (torch.from_numpy(_rand(rng, b, s, n, d)).to(torch.bfloat16)
               for s in (sq, skv, skv))
    scale = 1.0 / np.sqrt(d)

    def bnsd(t):
        return jnp.asarray(t.float().numpy().transpose(0, 2, 1, 3).reshape(b * n, -1, d),
                           dtype=jnp.bfloat16)

    tables = None
    if rope is not None:
        cos, sin = _rope_tables(rng, skv, d, rope)
        k = trot.apply_rotary(k, *(torch.from_numpy(t)[:, None] for t in (cos, sin)), rope)
        tables = [t[:sq] for t in (cos, sin)]
    with pltpu.force_tpu_interpret_mode():
        if rope is None:
            out, lse = jattn._flash_fwd(bnsd(q), bnsd(k), bnsd(v), scale, 128, 128)
        else:
            out, lse = jattn._flash_rope_fwd(bnsd(q), bnsd(k), bnsd(v),
                                             *(jnp.asarray(t) for t in tables), scale, rope,
                                             128, 128)
    want = torch.from_numpy(np.asarray(out.astype(jnp.float32))).reshape(b, n, sq, d)
    want = want.permute(0, 2, 1, 3)
    want_lse = torch.from_numpy(np.asarray(lse)).reshape(b, n, sq)
    got, got_lse = tattn.flash_attention_plain(
        q, k, v, rope=None if tables is None else _t(*tables), rope_interleaved=bool(rope))
    assert got.dtype == torch.bfloat16
    assert tattn.error_vs_plain(got, want)["ok"]
    assert tattn.error_vs_plain(got_lse, want_lse, lse=True)["ok"]
    assert (got.float() == want).float().mean().item() >= 0.8


def _chunk_views(proj, n):
    """k, v as the DiT hands them over: the two halves of one (b, s, 2 n 128)
    projection, split with chunk into (b, s, n, 128) views of row stride
    2 n 128."""
    return torch.from_numpy(proj).unflatten(-1, (2 * n, 128)).chunk(2, dim=2)


@pytest.mark.parametrize("b, sq, n, s1, s2, chunked", [
    (1, 200, 2, 37, 21, False),
    (2, 130, 2, 512, 257, False),   # the DiT's text and CLIP lengths, a ragged q tail
    (2, 130, 2, 512, 257, True),
], ids=["ragged", "dit_lengths", "dit_chunk_views"])
def test_dual_cross_attention_matches_jax_pallas(rng, b, sq, n, s1, s2, chunked):
    """The port's dual cross-attention against JAX's Pallas K3 (interpret
    mode) on the same inputs; `chunked` passes k/v to the port as chunk views
    of one projection per stream, as dit.py does, and JAX their copies."""
    d = 128
    q = _rand(rng, b, sq, n, d)
    kv1, kv2 = _rand(rng, b, s1, 2 * n * d), _rand(rng, b, s2, 2 * n * d)
    k1, v1 = (a.reshape(b, s1, n, d) for a in np.split(kv1, 2, axis=-1))
    k2, v2 = (a.reshape(b, s2, n, d) for a in np.split(kv2, 2, axis=-1))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jattn.dual_cross_attention(
            *(jnp.asarray(a) for a in (q, k1, v1, k2, v2)), impl="pallas"))
    if chunked:
        tk1, tv1 = _chunk_views(kv1, n)
        tk2, tv2 = _chunk_views(kv2, n)
        assert tk1.stride(1) == 2 * n * d and not tk1.is_contiguous()
        got = tattn.dual_cross_attention(torch.from_numpy(q), tk1, tv1, tk2, tv2).numpy()
    else:
        got = tattn.dual_cross_attention(*_t(q, k1, v1, k2, v2)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_attention_impls_agree_with_jax_xla(rng, impl):
    """Both accepted impls compute plain softmax attention (JAX 'xla' path)."""
    q, k, v = _rand(rng, 2, 40, 2, 16), _rand(rng, 2, 33, 2, 16), _rand(rng, 2, 33, 2, 16)
    want = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      impl="xla"))
    got = tattn.attention(*_t(q, k, v), impl=impl).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("impl", ["sta", "pallas", "chunked"])
def test_unknown_attention_impl_raises(impl):
    """Only 'auto' (kernel) and 'xla' (plain) are accepted; the JAX package's
    other names are not aliases in the port."""
    q = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attention(q, q, q, impl=impl)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.dual_cross_attention(q, q, q, q, q, impl=impl)


def test_wrappers_take_plain_version_on_cpu_and_count_nothing(rng):
    tattn.reset_launch_counts()
    q, k, v = _t(_rand(rng, 1, 20, 2, 128), _rand(rng, 1, 20, 2, 128), _rand(rng, 1, 20, 2, 128))
    cos, sin = _t(*_rope_tables(rng, 20, 128, True))
    out, lse = tattn.flash_attention(q, k, v, rope=(cos, sin))
    want, want_lse = tattn.flash_attention_plain(q, k, v, rope=(cos, sin))
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    dual = tattn.dual_cross_attention_fused(q, k, v, k[:, :7], v[:, :7])
    assert torch.equal(dual, tattn.dual_cross_attention_plain(q, k, v, k[:, :7], v[:, :7]))
    assert tattn.LAUNCHES == {"flash_attention": 0, "flash_attention_rope": 0,
                              "dual_cross_attention": 0, "flash_attention_bwd_dq": 0,
                              "flash_attention_bwd_dkv": 0, "sta_attention_fwd": 0,
                              "sta_attention_fwd_lse": 0, "sta_attention_bwd_dq": 0,
                              "sta_attention_bwd_dkv": 0, "flash_attention_int8": 0,
                              "adaln_layer_norm": 0, "rotary": 0}


def test_error_limits_accept_bf16_rounding_and_reject_a_wrong_kv_walk():
    """The kernel-vs-plain limits (used on the card) pass the plain version run
    with the kernels' bf16 rounding points, and fail it with one 64-key KV tile
    dropped or counted twice, or with q's scale off by 1%."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, s, 2, 128, generator=g).to(torch.bfloat16)
               for s in (150, 176, 176))
    want, want_lse = tattn.flash_attention_plain(q.float(), k.float(), v.float())
    out, lse = tattn.flash_attention_plain(q, k, v)
    assert tattn.error_vs_plain(out, want)["ok"]
    assert tattn.error_vs_plain(lse, want_lse, lse=True)["ok"]
    keep = torch.ones(176, dtype=torch.bool)
    keep[64:128] = False
    twice = torch.cat([torch.arange(176), torch.arange(64, 128)])
    for kk, vv, qq in ((k[:, keep], v[:, keep], q), (k[:, twice], v[:, twice], q),
                       (k, v, q.float() * 1.01)):
        bad, bad_lse = tattn.flash_attention_plain(qq.float(), kk.float(), vv.float())
        assert not tattn.error_vs_plain(bad.to(torch.bfloat16), want)["ok"]
    assert not tattn.error_vs_plain(bad_lse, want_lse + 0.02, lse=True)["ok"]
    nan = out.clone()
    nan[0, 0, 0, 0] = float("nan")
    assert not tattn.error_vs_plain(nan, want)["ok"]


def test_wrappers_raise_on_devices_without_a_kernel():
    q = torch.empty(1, 64, 2, 128, device="meta", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        tattn.flash_attention(q, q, q)
    with pytest.raises(NotImplementedError):
        tattn.dual_cross_attention_fused(q, q, q, q, q)


@pytest.mark.parametrize("interleaved", [True, False])
def test_scail_rope_tables_match_jax(interleaved):
    want = jrot.build_scail_rope(128, 3, 8, 12, interleaved=interleaved)
    got = trot.build_scail_rope(128, 3, 8, 12, interleaved=interleaved)
    assert (got.ref_len, got.video_len, got.pose_len) == (want.ref_len, want.video_len,
                                                          want.pose_len)
    np.testing.assert_allclose(got.cos.numpy(), np.asarray(want.cos), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.sin.numpy(), np.asarray(want.sin), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("interleaved", [True, False])
def test_apply_rotary_matches_jax(rng, interleaved):
    x = _rand(rng, 2, 10, 3, 16)
    cos, sin = _rope_tables(rng, 10, 16, interleaved)
    want = np.asarray(jrot.apply_rotary(jnp.asarray(x), jnp.asarray(cos)[:, None],
                                        jnp.asarray(sin)[:, None], interleaved))
    got = trot.apply_rotary(*_t(x), torch.from_numpy(cos)[:, None],
                            torch.from_numpy(sin)[:, None], interleaved).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
