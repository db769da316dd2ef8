"""Parity of the port's weight quantization (ops/quant.py) with the JAX
package's (scail_tpu/ops/quant.py), on the CPU.

Codes and scales must match to the bit; the W8A16/W4A16 matmuls (the port's
plain version, which CPU tensors take) are held to rtol 2e-4 against the JAX
XLA path and its Pallas kernel run in interpret mode, as the JAX package's
own tests/test_quant.py runs it; the quantized tiny DiT to 2e-4 against the
JAX dit_forward of the quantized tree.  Numpy inputs from a seed, f32.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch import nn

from scail_tpu.models.dit import DiTConfig as JaxDiTConfig
from scail_tpu.models.dit import dit_forward, init_dit_params
from scail_tpu_torch.cli.bench_14b_quant import build_random_quant_params, model_bytes
from scail_tpu_torch.convert.from_jax import dit_state_dict_from_jax
from scail_tpu_torch.models.dit import DiT, DiTConfig
from scail_tpu_torch.ops import quant as tq

jq = importlib.import_module("scail_tpu.ops.quant")

TOL = dict(rtol=2e-4, atol=2e-4)
TINY = dict(hidden_size=32, num_layers=2, num_heads=4, inner_hidden_size=48,
            time_embed_dim=32, text_dim=16, clip_dim=8, share_adaln=True,
            use_i2v_clip=True, dtype="float32", interleaved_rope=True)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_t(a):
    """A JAX (..., in, out) array as the port's (..., out, in) tensor."""
    return _t(np.swapaxes(np.asarray(a), -1, -2))


def test_quantize_int8_bit_exact_with_jax_stacked(rng):
    w = _rand(rng, 3, 40, 24)  # stacked (L, in, out)
    w[1, :, 5] = 0.0           # an all-zero channel takes the 1e-8 floor
    jq8, js = jq.quantize_int8(jnp.asarray(w))
    q, s = tq.quantize_int8(_port_t(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert torch.equal(q, _port_t(jq8)) and torch.equal(s, _t(js))


def test_quantize_int4_and_unpack_bit_exact_with_jax(rng):
    w = _rand(rng, 3, 40, 24)
    packed, s = tq.quantize_int4(_port_t(w))
    assert packed.shape == (3, 24, 20) and packed.dtype == torch.uint8
    for i in range(3):  # the JAX quantize_int4 takes one (in, out) weight
        jp, js = jq.quantize_int4(jnp.asarray(w[i]))
        assert torch.equal(packed[i], _port_t(jp)) and torch.equal(s[i], _t(js))
        assert torch.equal(tq.unpack_int4(packed[i]), _port_t(jq.unpack_int4(jp)))
    # every byte, so every nibble: -8 (0x8) occurs in random packed weights
    every = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got = tq.unpack_int4(_port_t(every))
    assert torch.equal(got, _port_t(jq.unpack_int4(jnp.asarray(every))))
    assert got.min().item() == -8 and got.max().item() == 7


@pytest.mark.parametrize("bits", [8, 4])
def test_matmul_plain_matches_jax_xla_and_pallas_interpret(rng, bits):
    """The ragged (1, 300, 130) x (130, 70) case of the JAX package's test."""
    x, w = _rand(rng, 1, 300, 130), _rand(rng, 130, 70)
    quant = jq.quantize_int8 if bits == 8 else jq.quantize_int4
    jmm = jq.matmul_w8a16 if bits == 8 else jq.matmul_w4a16
    tmm = tq.matmul_w8a16 if bits == 8 else tq.matmul_w4a16
    qw, s = quant(jnp.asarray(w))
    want_xla = np.asarray(jmm(jnp.asarray(x), qw, s, impl="xla"))
    with pltpu.force_tpu_interpret_mode():
        want_pallas = np.asarray(jmm(jnp.asarray(x), qw, s, impl="pallas"))
    for impl in ("auto", "xla"):
        got = tmm(_t(x), _port_t(qw), _t(s), impl=impl).numpy()
        np.testing.assert_allclose(got, want_xla, **TOL)
        np.testing.assert_allclose(got, want_pallas, **TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_dense_quantized_with_bias_matches_jax(rng, bits):
    p = {"kernel": _rand(rng, 32, 16), "bias": _rand(rng, 16)}
    x = _rand(rng, 4, 32)
    want = np.asarray(jq.dense_quantized(jq.quantize_dense_params(
        {k: jnp.asarray(v) for k, v in p.items()}, bits=bits), jnp.asarray(x), impl="xla"))
    layer = nn.Linear(32, 16)
    with torch.no_grad():
        layer.weight.copy_(_port_t(p["kernel"]))
        layer.bias.copy_(_t(p["bias"]))
    got = tq.dense_quantized(tq.quantize_dense_params(layer, bits), _t(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _jax_params(seed=0):
    return init_dit_params(jax.random.PRNGKey(seed), JaxDiTConfig(**TINY))


@pytest.mark.parametrize("bits", [8, 4])
def test_bridge_keeps_codes_dtypes_and_layout(bits):
    qparams = jq.quantize_model_params(_jax_params(), bits=bits)
    sd = dit_state_dict_from_jax(qparams)
    key = "qweight" if bits == 8 else "qweight4"
    codes = np.asarray(qparams["layers"]["mlp_out"][key])  # (L, in[/2], out)
    for i in range(TINY["num_layers"]):
        got = sd[f"layers.{i}.mlp_out.{key}"]
        assert got.dtype == (torch.int8 if bits == 8 else torch.uint8)
        assert torch.equal(got, _port_t(codes[i]))
        assert torch.equal(sd[f"layers.{i}.mlp_out.scale"],
                           _t(qparams["layers"]["mlp_out"]["scale"][i]))
    assert sd["patch_embed.proj.weight"].dtype == torch.float32
    assert not any(k.endswith(".weight") and k.startswith("layers.") for k in sd)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_model_params_matches_jax_exactly(bits):
    """The port quantizing the bridged f32 DiT gives the bridged codes and
    scales of the JAX quantize_model_params, and load_state_dict of the
    bridged quantized tree leaves them as they are."""
    params = _jax_params()
    model = DiT(DiTConfig(**TINY))
    model.load_state_dict(dit_state_dict_from_jax(params))
    tq.quantize_model_params(model, bits=bits)
    n_quant = sum(isinstance(m, tq.QuantizedLinear) for m in model.modules())
    assert n_quant == 8 * TINY["num_layers"]
    assert not any(isinstance(m, tq.QuantizedLinear) for m in model.patch_embed.modules())
    want = dit_state_dict_from_jax(jq.quantize_model_params(params, bits=bits))
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    model.load_state_dict(want)
    assert all(torch.equal(model.state_dict()[k], want[k]) for k in want)


def _inputs(seed=11):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=f(1, 2, 16, 8, 8), t=np.full((1,), 500.0, np.float32), ctx=f(1, 8, 16),
                ref=f(1, 1, 16, 8, 8), smpl=f(1, 2, 16, 4, 4), clip=f(1, 5, 8))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_dit_forward_matches_jax(bits):
    params = _jax_params(1)
    qparams = jq.quantize_model_params(params, bits=bits)
    inp = _inputs()
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    want = np.asarray(dit_forward(qparams, JaxDiTConfig(**TINY, attn_impl="xla"), j["x"], j["t"],
                                  j["ctx"], ref_concat=j["ref"], concat_smpl_render=j["smpl"],
                                  image_clip_features=j["clip"]))
    model = DiT(DiTConfig(**TINY))
    model.load_state_dict(dit_state_dict_from_jax(params))
    tq.quantize_model_params(model, bits=bits)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    tq.reset_launch_counts()
    with torch.no_grad():
        got = model(t["x"], t["t"], t["ctx"], ref_concat=t["ref"], concat_smpl_render=t["smpl"],
                    image_clip_features=t["clip"]).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert all(v == 0 for v in tq.LAUNCHES.values())  # CPU tensors: plain versions


@pytest.mark.parametrize("bits", [8, 4])
def test_build_random_quant_params_at_a_tiny_config(bits):
    cfg = DiTConfig(**dict(TINY, dtype="bfloat16"))
    gen = torch.Generator().manual_seed(0)
    dit = build_random_quant_params(cfg, bits, torch.device("cpu"), gen)
    key = "qweight" if bits == 8 else "qweight4"
    for name, t in dit.layers.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        assert leaf != "weight", name  # no float weight in the layers
        if leaf == key:
            assert t.dtype == (torch.int8 if bits == 8 else torch.uint8)
        elif leaf in ("scale", "bias", "adaln"):
            assert t.dtype == torch.bfloat16, name
    qkv = dit.layers[1].qkv
    h = TINY["hidden_size"]
    assert qkv.codes.shape == ((3 * h, h) if bits == 8 else (3 * h, h // 2))
    assert torch.all(qkv.scale == torch.tensor(0.02 / (127 if bits == 8 else 7)).bfloat16())
    assert not qkv.bias.any()
    if bits == 4:  # random bytes: -8 nibbles occur
        assert tq.unpack_int4(qkv.qweight4).min().item() == -8
    assert all(p.dtype == torch.bfloat16 for p in dit.parameters())
    n_codes = 8 * TINY["num_layers"]
    assert sum(isinstance(m, tq.QuantizedLinear) for m in dit.modules()) == n_codes
    assert model_bytes(dit) == sum(t.numel() * t.element_size()
                                   for t in dit.state_dict().values())
    inp = _inputs()
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    with torch.no_grad():
        out = dit(t["x"], t["t"], t["ctx"], ref_concat=t["ref"], concat_smpl_render=t["smpl"],
                  image_clip_features=t["clip"])
    assert out.shape == (1, 2, 16, 8, 8) and out.dtype == torch.bfloat16
    assert torch.isfinite(out).all()


def test_wrappers_raise_on_a_device_without_a_kernel():
    x = torch.empty(4, 32, device="meta", dtype=torch.bfloat16)
    codes = torch.empty(16, 32, device="meta", dtype=torch.int8)
    scale = torch.empty(16, device="meta")
    with pytest.raises(NotImplementedError):
        tq.matmul_w8a16(x, codes, scale)
    with pytest.raises(NotImplementedError):
        tq.matmul_w4a16(x, codes[:, :16].to(torch.uint8), scale)
    with pytest.raises(ValueError, match="unknown quantized matmul impl"):
        tq.matmul_w8a16(x, codes, scale, impl="pallas")


def test_serving_dit_is_built_one_parameter_at_a_time_with_the_same_values():
    """The engine's meta build, cast per parameter, gives the values of an f32
    build cast afterwards."""
    cfg = DiTConfig(**dict(TINY, dtype="bfloat16"))
    ref = DiT(cfg)
    ref.init_weights_(torch.Generator().manual_seed(3))
    ref = ref.to(torch.bfloat16)
    meta = DiT(cfg, device="meta")
    meta.init_weights_(torch.Generator().manual_seed(3), device=torch.device("cpu"),
                       dtype=torch.bfloat16)
    want, got = ref.state_dict(), meta.state_dict()
    assert set(got) == set(want)
    assert all(got[k].dtype == torch.bfloat16 and torch.equal(got[k], want[k]) for k in want)
