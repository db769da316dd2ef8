"""The port's SD-family image path against the JAX package, on the CPU.

Each JAX module takes the port's random weights through its own converter
(`unet_params_from_torch`, `autoencoder_kl_params_from_torch`,
`text_params_from_hf` / `_open_clip`): the port's modules carry the
reference's names.  The bridges back (`convert/from_jax.py`) are held in
the loader test.

* The UNet at SD 2.1 and SDXL topology (linear and conv projections, the
  sequential adm vector, class labels, both AttentionBlock QKV orders,
  NoTimeUNetModel) (rtol 2e-4, atol 1e-4).
* The KL autoencoder: moments, encode (mode, and sampled on JAX's noise),
  decode and the KL term.
* The text towers (FrozenCLIPEmbedder's layers, FrozenOpenCLIPEmbedder2 and
  v1) on the port's token ids, ConcatTimestepEmbedderND, and the
  conditioner's `vector` and `crossattn` for an SDXL-shaped tiny config; the
  widths of SDXL base's adm vector and context from its YAML.
* The tiny pipeline of tests/test_inference_api.py through text_to_image
  (DPMPP2M), image_to_image (EulerEDM, strength 0.5) and refiner
  (EulerAncestral), JAX's start and sampler noise fed to the port: relative
  L2 <= 1e-4.
* The loaders: a tiny reference-layout checkpoint written from seeds loads
  into the port's engine bit-equal to what the JAX converters give through
  the bridges.
* The watermark bit-exact against JAX; every configs/inference target
  resolves in the port's registry; the hash tokenizer gives the same ids in
  two processes; a tokenizer directory that does not load raises; a CUDA
  pipeline without CUDA raises.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import scail_tpu.diffusion.embedders as jemb_mod
import scail_tpu_torch.diffusion.embedders as pemb_mod
from scail_tpu.utils.registry import instantiate_from_config as jax_instantiate
from scail_tpu_torch.convert.from_jax import (autoencoder_kl_state_dict_from_jax,
                                              clip_text_state_dict_from_jax,
                                              unet_state_dict_from_jax)
from scail_tpu_torch.utils.registry import instantiate_from_config

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.dirname(__file__))
M = "sgm.modules.encoders.modules."
TINY_OPEN_CLIP = (32, 3, 2, 64, 24)  # width, layers, heads, mlp, embed_dim


def _t(a):
    return torch.from_numpy(np.array(a))


def _nchw(a):
    return _t(np.asarray(a).transpose(0, 3, 1, 2))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _open_clip_layout(sd, layers):
    """The port's text tower (HF names) in the open_clip layout."""
    out = {"token_embedding.weight": sd["text_model.embeddings.token_embedding.weight"],
           "positional_embedding": sd["text_model.embeddings.position_embedding.weight"],
           "ln_final.weight": sd["text_model.final_layer_norm.weight"],
           "ln_final.bias": sd["text_model.final_layer_norm.bias"],
           "text_projection": sd["text_projection.weight"].t().contiguous()}
    for i in range(layers):
        s, d = f"text_model.encoder.layers.{i}.", f"transformer.resblocks.{i}."
        for leaf in ("weight", "bias"):
            out[d + f"attn.in_proj_{leaf}"] = torch.cat(
                [sd[s + f"self_attn.{p}_proj.{leaf}"] for p in "qkv"])
            for a, b in (("attn.out_proj", "self_attn.out_proj"), ("ln_1", "layer_norm1"),
                         ("ln_2", "layer_norm2"), ("mlp.c_fc", "mlp.fc1"),
                         ("mlp.c_proj", "mlp.fc2")):
                out[d + f"{a}.{leaf}"] = sd[s + f"{b}.{leaf}"]
    return out


def _reference_state_dict(tower):
    """A port text embedder's tower in its reference layout: HF names, or
    open_clip's for a tower with a projection."""
    sd = tower.model.state_dict()
    return _open_clip_layout(sd, tower.cfg.text_layers) if tower.with_projection else sd


def _share_tower(jemb, pemb):
    """The port embedder's weights and tokenizer into the JAX one."""
    jemb.load_state_dict(_reference_state_dict(pemb))
    jemb.tokenizer = lambda texts: pemb.tokenizer(texts).astype(np.int32)


def _write_reference_checkpoint(engine, path):
    """The engine's weights as a reference checkpoint: model.diffusion_model.*,
    first_stage_model.*, the HF towers under conditioner.embedders.N.transformer.*
    and the open_clip ones under conditioner.embedders.N.model.*."""
    sd = {**{f"model.diffusion_model.{k}": v for k, v in engine.network.state_dict().items()},
          **{f"first_stage_model.{k}": v
             for k, v in engine.first_stage_model.state_dict().items()}}
    for i, emb in enumerate(engine.conditioner.embedders):
        if hasattr(emb, "model"):
            head = "model" if emb.with_projection else "transformer"
            sd.update({f"conditioner.embedders.{i}.{head}.{k}": v
                       for k, v in _reference_state_dict(emb).items()})
    torch.save({"state_dict": sd}, path)
    return sd


@pytest.fixture
def tiny_open_clip(monkeypatch):
    """A tiny open_clip arch in both packages' tables."""
    monkeypatch.setitem(jemb_mod._OPEN_CLIP_ARCHS, "tiny", TINY_OPEN_CLIP)
    monkeypatch.setitem(pemb_mod._OPEN_CLIP_ARCHS, "tiny", TINY_OPEN_CLIP)


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------
UNETS = {
    "sd21_linear": dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
                        attention_resolutions=[4, 2, 1], channel_mult=[1, 2, 2],
                        num_head_channels=16, use_spatial_transformer=True,
                        use_linear_in_transformer=True, transformer_depth=1, context_dim=24,
                        legacy=False),
    "sdxl_adm": dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=2,
                     attention_resolutions=[4, 2], channel_mult=[1, 2, 2], num_head_channels=16,
                     use_spatial_transformer=True, use_linear_in_transformer=True,
                     transformer_depth=[1, 1, 2], context_dim=24, legacy=False,
                     adm_in_channels=20, num_classes="sequential"),
    "conv_proj_classes": dict(in_channels=4, model_channels=32, out_channels=4,
                              num_res_blocks=1, attention_resolutions=[2], channel_mult=[1, 2],
                              num_heads=2, use_spatial_transformer=True, transformer_depth=2,
                              context_dim=24, legacy=True, num_classes=7,
                              use_scale_shift_norm=True),
    "legacy_qkv": dict(in_channels=3, model_channels=32, out_channels=3, num_res_blocks=1,
                       attention_resolutions=[2], channel_mult=(1, 2), num_heads=2,
                       use_scale_shift_norm=True, resblock_updown=True, num_classes=7),
    "new_qkv": dict(in_channels=3, model_channels=32, out_channels=3, num_res_blocks=1,
                    attention_resolutions=[2], channel_mult=(1, 2), num_heads=2,
                    use_new_attention_order=True, num_classes="timestep"),
}


@pytest.mark.parametrize("name", sorted(UNETS))
def test_unet_matches_jax(name):
    from scail_tpu.models.unet import UNetModel as JaxUNet
    from scail_tpu.models.unet import unet_params_from_torch
    from scail_tpu_torch.models.unet import NoTimeUNetModel, UNetModel

    cfg = UNETS[name]
    model = UNetModel(**cfg).init_random_(_gen(0), zero_modules=False)
    jm = JaxUNet(**cfg)
    params = unet_params_from_torch(model.state_dict(), jm)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, cfg["in_channels"])).astype(np.float32)
    t = np.array([3.0, 777.0], np.float32)
    ctx = (rng.standard_normal((2, 5, 24)).astype(np.float32)
           if cfg.get("context_dim") else None)
    y = {None: None, 7: np.array([1, 5]), "timestep": np.array([20.0, 900.0], np.float32),
         "sequential": rng.standard_normal((2, 20)).astype(np.float32)}[cfg.get("num_classes")]
    jarg = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    parg = lambda a: None if a is None else _t(a)  # noqa: E731
    want = jm(params, jnp.asarray(x), jnp.asarray(t), jarg(ctx), jarg(y))
    with torch.no_grad():
        got = model(_nchw(x), _t(t), parg(ctx), parg(y))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=2e-4, atol=1e-4)
    if name == "sd21_linear":  # NoTimeUNetModel: the forward at t = 0
        zero = jm(params, jnp.asarray(x), jnp.zeros_like(jnp.asarray(t)), jarg(ctx))
        nt = NoTimeUNetModel(**cfg)
        nt.load_state_dict(model.state_dict())
        with torch.no_grad():
            np.testing.assert_allclose(_nhwc(nt(_nchw(x), _t(t), parg(ctx))), np.asarray(zero),
                                       rtol=2e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# KL autoencoder
# ---------------------------------------------------------------------------
DDCONFIG = dict(double_z=True, z_channels=4, resolution=32, in_channels=3, out_ch=3, ch=32,
                ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[16], dropout=0.0)


def test_autoencoder_kl_matches_jax():
    from scail_tpu.autoencoding.autoencoder_kl import AutoencoderKL as JaxKL
    from scail_tpu.autoencoding.autoencoder_kl import autoencoder_kl_params_from_torch
    from scail_tpu_torch.autoencoding.autoencoder_kl import AutoencoderKL

    model = AutoencoderKL(DDCONFIG, embed_dim=4).init_random_(_gen(0))
    jm = JaxKL(DDCONFIG, embed_dim=4)
    params = autoencoder_kl_params_from_torch(model.state_dict(), DDCONFIG)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(model.moments(_nchw(x))),
                                   np.asarray(jm.moments(params, jnp.asarray(x))),
                                   rtol=2e-4, atol=1e-4)
        mode = model.encode(_nchw(x), sample=False)
        np.testing.assert_allclose(_nhwc(mode), np.asarray(jm.encode(params, jnp.asarray(x),
                                                                     sample=False)),
                                   rtol=2e-4, atol=1e-4)
        # the sampled latent on JAX's draw, and the KL term
        want_z, want_log = jm.encode_with_reg(params, jnp.asarray(x), key=key)
        noise = jax.random.normal(key, want_z.shape, want_z.dtype)
        got_z, got_log = model.encode_with_reg(_nchw(x), noise=_nchw(noise))
        np.testing.assert_allclose(_nhwc(got_z), np.asarray(want_z), rtol=2e-4, atol=1e-4)
        np.testing.assert_allclose(float(got_log["kl_loss"]), float(want_log["kl_loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(_nhwc(model.decode(mode)),
                                   np.asarray(jm.decode(params, jnp.asarray(_nhwc(mode)))),
                                   rtol=2e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# text towers, size embedder, conditioner
# ---------------------------------------------------------------------------
TEXTS = ["a photo of a cat on a sofa", "", "an oil painting of two boats at dusk"]
CLIP_KW = dict(width=32, layers=2, heads=2, mlp=64)


def _bridged(config, seed):
    """(JAX embedder, port embedder) from one config, with the port's random
    weights and tokenizer in both."""
    jemb, pemb = jax_instantiate(config), instantiate_from_config(config)
    pemb.init(_gen(seed))
    _share_tower(jemb, pemb)
    return jemb, pemb


def _assert_same_outputs(want, got):
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("params", [
    dict(layer="last"), dict(layer="pooled"), dict(layer="hidden", layer_idx=1),
    dict(layer="hidden", layer_idx=-1, always_return_pooled=True),
    dict(layer="hidden", layer_idx=0)], ids=["last", "pooled", "hidden1", "hidden-1", "hidden0"])
def test_clip_text_embedder_matches_jax(params):
    jemb, pemb = _bridged({"target": M + "FrozenCLIPEmbedder", "params": {**CLIP_KW, **params}},
                          seed=1)
    _assert_same_outputs(jemb(TEXTS), pemb(TEXTS))


@pytest.mark.parametrize("target,params", [
    ("FrozenOpenCLIPEmbedder2", dict(layer="penultimate", always_return_pooled=True,
                                     legacy=False)),
    ("FrozenOpenCLIPEmbedder2", dict(layer="last")),
    ("FrozenOpenCLIPEmbedder", dict(layer="penultimate"))], ids=["v2_sdxl", "v2_legacy", "v1"])
def test_open_clip_text_embedder_matches_jax(target, params, tiny_open_clip):
    jemb, pemb = _bridged({"target": M + target, "params": dict(arch="tiny", **params)}, seed=2)
    _assert_same_outputs(jemb(TEXTS), pemb(TEXTS))


def test_concat_timestep_embedder_matches_jax():
    cfg = {"target": M + "ConcatTimestepEmbedderND", "params": {"outdim": 16}}
    jemb, pemb = jax_instantiate(cfg), instantiate_from_config(cfg)
    x = np.array([[1024.0, 768.0], [512.0, 0.0]], np.float32)
    np.testing.assert_allclose(pemb(_t(x)).numpy(), np.asarray(jemb(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pemb(_t(x[:, 0])).numpy(),
                               np.asarray(jemb(jnp.asarray(x[:, 0]))), rtol=1e-5, atol=1e-6)


def test_sdxl_shaped_conditioner_matches_jax(tiny_open_clip):
    """CLIP hidden 1 + open_clip penultimate with its pooled output + three
    size embedders: crossattn (b, 77, 32 + 32), vector (b, 24 + 3 * 2 * 8)."""
    from scail_tpu_torch.inference.helpers import get_batch

    emb_models = [
        {"input_key": "txt", "target": M + "FrozenCLIPEmbedder",
         "params": dict(CLIP_KW, layer="hidden", layer_idx=1)},
        {"input_key": "txt", "target": M + "FrozenOpenCLIPEmbedder2",
         "params": dict(arch="tiny", layer="penultimate", always_return_pooled=True,
                        legacy=False)}] + [
        {"input_key": k, "target": M + "ConcatTimestepEmbedderND", "params": {"outdim": 8}}
        for k in ("original_size_as_tuple", "crop_coords_top_left", "target_size_as_tuple")]
    cfg = {"target": "sgm.modules.GeneralConditioner", "params": {"emb_models": emb_models}}
    jc, pc = jax_instantiate(cfg), instantiate_from_config(cfg)
    for i, (je, pe) in enumerate(zip(jc.embedders, pc.embedders)):
        if hasattr(pe, "model"):
            pe.init(_gen(i))
            _share_tower(je, pe)
    values = dict(prompt="a red fox", negative_prompt="", orig_height=1024, orig_width=768,
                  crop_coords_top=0, crop_coords_left=16, target_height=1024, target_width=1024)
    keys = [e.input_key for e in pc.embedders]
    pb, pbu = get_batch(keys, values, [2])
    jb = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
          for k, v in pb.items()}
    jbu = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
           for k, v in pbu.items()}
    want = jc.get_unconditional_conditioning(jb, jbu, force_uc_zero_embeddings=["txt"])
    got = pc.get_unconditional_conditioning(pb, pbu, force_uc_zero_embeddings=["txt"])
    for w, g in zip(want, got):
        assert set(g) == {"vector", "crossattn"} == set(w)
        assert tuple(g["vector"].shape) == (2, 24 + 48) and tuple(g["crossattn"].shape) == \
            (2, 77, 64)
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), rtol=1e-4, atol=1e-5)


def test_sdxl_yaml_widths_add_up():
    """SDXL base: the open_clip pooled width plus three size embedders is the
    UNet's 2,816-wide adm input; the two towers' widths make its context."""
    with open(os.path.join(ROOT, "configs", "inference", "sd_xl_base.yaml")) as f:
        model = yaml.safe_load(f)["model"]["params"]
    pc = instantiate_from_config(model["conditioner_config"])
    towers = [e for e in pc.embedders if hasattr(e, "model")]
    sizes = [e for e in pc.embedders if not hasattr(e, "model")]
    vector = towers[1].cfg.embed_dim + sum(
        e(torch.zeros((1, 2))).shape[1] for e in sizes)
    unet = model["network_config"]["params"]
    assert vector == unet["adm_in_channels"] == 2816
    assert sum(e.cfg.text_width for e in towers) == unet["context_dim"] == 2048


# ---------------------------------------------------------------------------
# the tiny pipeline
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """The JAX and the port's tiny SamplingPipeline on one YAML, both loading
    one reference checkpoint (random weights from a seed, at the spec's file
    name) through their own loaders, the port's tokenizer in both."""
    from test_inference_api import TINY_SD

    import scail_tpu.inference.api as jax_api
    from scail_tpu.inference.api import ModelArchitecture as JArch
    from scail_tpu.inference.api import SamplingPipeline as JaxPipeline
    from scail_tpu_torch.inference.api import ModelArchitecture, SamplingPipeline, model_specs
    from scail_tpu_torch.inference.engine import ImageDiffusionEngine

    d = tmp_path_factory.mktemp("sdcfg")
    (d / "sd_2_1.yaml").write_text(TINY_SD)
    src = ImageDiffusionEngine(**yaml.safe_load(TINY_SD)["model"]["params"], device="cpu")
    gen = _gen(3)
    src.init_params(gen)
    src.network.init_random_(gen, zero_modules=False)
    _write_reference_checkpoint(src, str(d / "tiny.ckpt"))
    # the spec names a .safetensors file; both loaders read torch pickles
    with pytest.MonkeyPatch.context() as mp:
        for specs, arch in ((jax_api.model_specs, JArch.SD_2_1),
                            (model_specs, ModelArchitecture.SD_2_1)):
            mp.setitem(specs, arch, dataclasses.replace(specs[arch], ckpt="tiny.ckpt"))
        jp = JaxPipeline(JArch.SD_2_1, model_path=str(d), config_path=str(d), smoke=False)
        pp = SamplingPipeline(ModelArchitecture.SD_2_1, model_path=str(d), config_path=str(d),
                              device="cpu")
    for je, pe in zip(jp.model.conditioner.embedders, pp.model.conditioner.embedders):
        if hasattr(pe, "model"):
            assert pe.loaded
            je.tokenizer = (lambda p: lambda texts: p.tokenizer(texts).astype(np.int32))(pe)
    return jp, pp


def _step_noise(seed, n, shape):
    """A stochastic JAX sampler's per-step draws (NHWC), as NCHW tensors."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(_nchw(jax.random.normal(sub, shape, jnp.float32)))
    return out


def test_tiny_pipeline_matches_jax(pipelines):
    """text_to_image (DPMPP2M), image_to_image (EulerEDM at strength 0.5) and
    refiner (EulerAncestral) on the same weights and noise."""
    from scail_tpu.inference.api import Sampler as JSampler
    from scail_tpu.inference.api import SamplingParams as JParams
    from scail_tpu_torch.inference.api import Sampler, SamplingParams

    jp, pp = pipelines
    kw = dict(width=32, height=32, scale=3.0)
    seed = 11
    # text to image, with the latent
    jout, jlat = jp.text_to_image(JParams(steps=3, sampler=JSampler.DPMPP2M, **kw), "a cat",
                                  negative_prompt="blurry", samples=2, return_latents=True,
                                  seed=seed)
    start = jax.random.normal(jax.random.PRNGKey(seed), (2, 4, 4, 4), jnp.float32)
    pout, plat = pp.text_to_image(SamplingParams(steps=3, sampler=Sampler.DPMPP2M, **kw),
                                  "a cat", negative_prompt="blurry", samples=2,
                                  return_latents=True, seed=seed, noise=_nchw(start))
    assert tuple(pout.shape) == (2, 32, 32, 3) and tuple(plat.shape) == (2, 4, 4, 4)
    assert float(pout.min()) >= 0.0 and float(pout.max()) <= 1.0
    assert _rel(plat, jlat) <= 1e-4 and _rel(pout, jout) <= 1e-4

    # image to image on the first image
    img = np.asarray(jout)[:1] * 2.0 - 1.0
    i2i = dict(steps=4, img2img_strength=0.5, **kw)
    jout = jp.image_to_image(JParams(sampler=JSampler.EULER_EDM, **i2i), jnp.asarray(img),
                             "a cat", seed=seed)
    _, k_noise, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    noise = jax.random.normal(k_noise, (1, 4, 4, 4), jnp.float32)
    pout = pp.image_to_image(SamplingParams(sampler=Sampler.EULER_EDM, **i2i), _t(img), "a cat",
                             seed=seed, noise=_nchw(noise))
    assert tuple(pout.shape) == (1, 32, 32, 3) and _rel(pout, jout) <= 1e-4

    # the refiner on the first latent
    lat = np.asarray(jlat)[:1]
    jout = jp.refiner(JParams(steps=3, sampler=JSampler.EULER_ANCESTRAL, **kw), jnp.asarray(lat),
                      "a cat", seed=seed)
    pout = pp.refiner(SamplingParams(steps=3, sampler=Sampler.EULER_ANCESTRAL, **kw), _t(lat),
                      "a cat", seed=seed, noise=_nchw(noise),
                      sampler_noise=_step_noise(0, 3, (1, 4, 4, 4)))
    assert tuple(pout.shape) == (1, 32, 32, 3) and _rel(pout, jout) <= 1e-4


def test_pipeline_helpers_and_device(pipelines, tmp_path):
    """The PIL helpers; a CUDA pipeline without CUDA raises."""
    from PIL import Image

    from scail_tpu.inference.helpers import get_input_image_array as jax_input
    from scail_tpu_torch.inference.api import ModelArchitecture, SamplingPipeline
    from scail_tpu_torch.inference.helpers import get_input_image_array, perform_save_locally

    rng = np.random.default_rng(3)
    im = Image.fromarray(rng.integers(0, 256, (70, 130, 3)).astype(np.uint8))
    got = get_input_image_array(im)
    assert tuple(got.shape) == (1, 64, 128, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_input(im)), rtol=1e-6)
    perform_save_locally(str(tmp_path / "out"), (got[0:1] + 1) / 2)
    assert os.listdir(tmp_path / "out") == ["000000000.png"]
    if not torch.cuda.is_available():
        d = tmp_path / "cfg"
        d.mkdir()
        from test_inference_api import TINY_SD

        (d / "sd_2_1.yaml").write_text(TINY_SD)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SamplingPipeline(ModelArchitecture.SD_2_1, model_path=str(d), config_path=str(d))


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------
def test_checkpoint_loads_bit_equal_to_the_jax_converters(tmp_path, tiny_open_clip):
    """A reference-layout checkpoint from seeds (model.diffusion_model.*,
    first_stage_model.*, conditioner.embedders.0.transformer.* in HF names,
    conditioner.embedders.1.model.* in open_clip's): the port's engine loads
    every tensor bit-equal to the file, and to what the JAX engine's
    converters read, through the bridges."""
    from test_inference_api import TINY_SD

    from scail_tpu.inference.engine import ImageDiffusionEngine as JaxEngine
    from scail_tpu_torch.inference.engine import ImageDiffusionEngine

    cfg = yaml.safe_load(TINY_SD)["model"]["params"]
    cfg["conditioner_config"]["params"]["emb_models"].insert(1, {
        "input_key": "txt", "target": M + "FrozenOpenCLIPEmbedder2",
        "params": dict(arch="tiny", layer="penultimate", always_return_pooled=True,
                       legacy=False)})
    cfg["network_config"]["params"].update(context_dim=64, adm_in_channels=96 + 24)
    src = ImageDiffusionEngine(**cfg, device="cpu")
    gen = _gen(4)
    src.init_params(gen)
    src.network.init_random_(gen, zero_modules=False)
    towers = src.text_embedders()
    path = str(tmp_path / "tiny.ckpt")
    sd = _write_reference_checkpoint(src, path)

    eng = ImageDiffusionEngine(**cfg, device="cpu")
    eng.load_checkpoint(path)
    jeng = JaxEngine(**cfg)
    jp = jeng.load_checkpoint(path)
    jtowers = [e for e in jeng.conditioner.embedders if hasattr(e, "params")]
    pairs = [(eng.network, src.network, unet_state_dict_from_jax(jp["unet"], "sequential")),
             (eng.first_stage_model, src.first_stage_model,
              autoencoder_kl_state_dict_from_jax(jp["first_stage"]))] + [
        (pt.model, st.model, clip_text_state_dict_from_jax(jt.params))
        for pt, st, jt in zip(eng.text_embedders(), towers, jtowers)]
    for loaded, source, bridged in pairs:
        got = loaded.state_dict()
        assert set(got) == set(bridged) == set(source.state_dict())
        for k, v in got.items():
            assert torch.equal(v, source.state_dict()[k]), k
            assert torch.equal(v, bridged[k]), k
    # a file without the UNet's tensors raises and names it
    torch.save({"state_dict": {k: v for k, v in sd.items() if "diffusion_model" not in k}},
               str(tmp_path / "bad.ckpt"))
    with pytest.raises(KeyError, match="UNet"):
        ImageDiffusionEngine(**cfg, device="cpu").load_checkpoint(str(tmp_path / "bad.ckpt"))


# ---------------------------------------------------------------------------
# watermark, registry, tokenizers
# ---------------------------------------------------------------------------
def test_watermark_round_trip_is_bit_exact_against_jax():
    from scail_tpu.inference.watermark import decode_watermark as jax_decode
    from scail_tpu.inference.watermark import embed_watermark as jax_embed
    from scail_tpu_torch.inference.watermark import (WATERMARK_BITS, decode_watermark,
                                                     embed_watermark)

    img = np.random.default_rng(5).uniform(0, 1, (2, 96, 128, 3)).astype(np.float32)
    marked = embed_watermark(img)
    np.testing.assert_array_equal(marked, jax_embed(img))
    for im in marked:
        assert decode_watermark(im) == jax_decode(im) == WATERMARK_BITS


def test_every_inference_yaml_target_resolves_in_the_port():
    from scail_tpu_torch.utils.registry import get_obj_from_str

    def targets(node):
        if isinstance(node, dict):
            if "target" in node:
                yield node["target"]
            for v in node.values():
                yield from targets(v)
        elif isinstance(node, list):
            for v in node:
                yield from targets(v)

    d = os.path.join(ROOT, "configs", "inference")
    names = sorted(n for n in os.listdir(d) if n.endswith(".yaml"))
    assert len(names) == 4
    found = set()
    for n in names:
        with open(os.path.join(d, n)) as f:
            found |= set(targets(yaml.safe_load(f)))
    assert len(found) >= 14
    for target in found:
        assert get_obj_from_str(target).__module__.startswith("scail_tpu_torch."), target


def test_hash_token_ids_are_the_same_in_two_processes():
    code = ("from scail_tpu_torch.diffusion.embedders import FrozenCLIPEmbedder, "
            "FrozenOpenCLIPEmbedder2\n"
            "print(FrozenCLIPEmbedder(width=32, layers=2, heads=2, mlp=64).tokenizer("
            "['a red fox jumps']).tolist(), "
            "FrozenOpenCLIPEmbedder2(arch='ViT-L-14').tokenizer(['a red fox']).tolist())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=dict(os.environ, PYTHONHASHSEED=s)) for s in ("1", "2")]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs[0][1][-2000:]
    assert outs[0][0] == outs[1][0] and "49406" in outs[0][0]


def test_tokenizer_directory_that_does_not_load_raises(tmp_path):
    broken = tmp_path / "tok"
    broken.mkdir()
    (broken / "tokenizer_config.json").write_text("{ not json")
    with pytest.raises(RuntimeError, match="does not load"):
        pemb_mod.FrozenCLIPEmbedder(tokenizer_path=str(broken), **CLIP_KW)
