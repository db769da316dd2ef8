"""Parity of the PyTorch port's Wan VAE, umt5 and CLIP towers (and the host
resize and timestep embedding they use) with the JAX package, in f32 on the
CPU, with JAX-initialised weights bridged by scail_tpu_torch.convert.from_jax.
Tolerance 1e-4: only the f32 summation order differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scail_tpu.models import clip_vit as jclip
from scail_tpu.models import umt5 as jt5
from scail_tpu.models import wan_vae as jvae
from scail_tpu.models.common import timestep_embedding as j_timestep_embedding
from scail_tpu.ops.resize import resize_bicubic as j_bicubic
from scail_tpu.ops.resize import resize_bilinear as j_bilinear
from scail_tpu_torch.convert import from_jax
from scail_tpu_torch.models import clip_vit as tclip
from scail_tpu_torch.models import umt5 as tt5
from scail_tpu_torch.models import wan_vae as tvae
from scail_tpu_torch.models.common import timestep_embedding
from scail_tpu_torch.ops.resize import resize_bicubic, resize_bilinear

TOL = dict(rtol=1e-4, atol=1e-4)

VAE_KW = dict(dim=8, z_dim=4, dim_mult=(1, 1, 2, 2), num_res_blocks=1,
              temporal_downsample=(False, True, True), dtype="float32")


def _vae_params(seed=0):
    """Random weights in the JAX init's tree (shapes from jax.eval_shape, which
    skips the slow eager init): N(0, 1/fan_in) kernels, small random biases
    and gammas near one, so every parameter's layout is exercised."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jvae.init_wan_vae_params(k, jvae.WanVAEConfig(**VAE_KW)),
                            jax.random.PRNGKey(0))

    def leaf(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x * np.float32(np.prod(s.shape[:-1]) ** -0.5)
        return x * np.float32(0.1) + np.float32(name == "gamma")

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def vae_pair():
    params = _vae_params()
    cfg = tvae.WanVAEConfig(**VAE_KW)
    model = tvae.WanVAEModel(cfg)
    model.load_state_dict(from_jax.wan_vae_state_dict_from_jax(params))
    return params, model, cfg


@pytest.mark.parametrize("streamed", [False, True])
def test_wan_vae_encode_matches_jax(vae_pair, rng, streamed):
    params, model, cfg = vae_pair
    video = rng.standard_normal((1, 9, 3, 16, 16)).astype(np.float32) * 0.5
    want = np.asarray(jvae.vae_encode(params, jvae.WanVAEConfig(**VAE_KW), jnp.asarray(video),
                                      streamed=streamed))
    with torch.no_grad():
        got = tvae.vae_encode(model, cfg, torch.from_numpy(video), streamed=streamed).numpy()
    assert got.shape == want.shape == (1, 3, 4, 2, 2)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("streamed", [False, True])
def test_wan_vae_decode_matches_jax(vae_pair, rng, streamed):
    params, model, cfg = vae_pair
    z = rng.standard_normal((1, 3, 4, 2, 2)).astype(np.float32)
    want = np.asarray(jvae.vae_decode(params, jvae.WanVAEConfig(**VAE_KW), jnp.asarray(z),
                                      streamed=streamed))
    with torch.no_grad():
        got = tvae.vae_decode(model, cfg, torch.from_numpy(z), streamed=streamed).numpy()
    assert got.shape == want.shape == (1, 9, 3, 16, 16)
    np.testing.assert_allclose(got, want, **TOL)


def test_wan_vae_single_frame_encode_matches_jax(vae_pair, rng):
    """The reference-image encode (T = 1, full-sequence) of the CLI."""
    params, model, cfg = vae_pair
    image = rng.standard_normal((2, 1, 3, 16, 16)).astype(np.float32) * 0.5
    want = np.asarray(jvae.vae_encode(params, jvae.WanVAEConfig(**VAE_KW), jnp.asarray(image)))
    with torch.no_grad():
        got = tvae.vae_encode(model, cfg, torch.from_numpy(image)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_umt5_matches_jax(rng):
    kw = dict(vocab_size=100, dim=32, dim_attn=32, dim_ffn=48, num_heads=4, num_layers=2,
              num_buckets=8, dtype="float32")
    jcfg = jt5.UMT5Config(**kw)
    params = jt5.init_umt5_params(jax.random.PRNGKey(1), jcfg)
    model = tt5.UMT5Encoder(tt5.UMT5Config(**kw))
    model.load_state_dict(from_jax.umt5_state_dict_from_jax(params))
    ids = rng.integers(2, 100, (2, 11)).astype(np.int32)
    mask = np.ones((2, 11), np.int32)
    mask[0, 8:] = 0
    want = np.asarray(jt5.umt5_encode(params, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = tt5.umt5_encode(model, torch.from_numpy(ids).long(),
                              torch.from_numpy(mask).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_relative_buckets_match_jax():
    for lq, nb, md in ((20, 32, 128), (512, 32, 128), (11, 8, 128)):
        np.testing.assert_array_equal(tt5.relative_position_buckets(lq, lq, nb, md),
                                      jt5.relative_position_buckets(lq, lq, nb, md))


def test_fallback_tokenizer_is_stable_across_processes():
    """Same prompt -> same ids in two interpreter processes with different
    hash seeds (the JAX fallback uses Python's per-process hash())."""
    import os
    import subprocess
    import sys

    code = ("from scail_tpu_torch.models.umt5 import StableHashTokenizer as T; "
            "print(T(8)(['a character dancing'])[0].tolist())")
    outs = [subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           env=dict(os.environ, PYTHONHASHSEED=seed), check=True).stdout
            for seed in ("1", "2")]
    assert outs[0] == outs[1] and outs[0].strip()


def test_tokenizer_load_error_raises(tmp_path):
    """A tokenizer path that exists but does not load raises (no silent
    fallback tokenizer)."""
    (tmp_path / "tok").mkdir()
    with pytest.raises(Exception):
        tt5.T5EncoderModel(max_length=8, tokenizer_path=str(tmp_path / "tok"))


def test_clip_visual_matches_jax(rng):
    kw = dict(image_size=32, patch_size=8, dim=32, num_heads=4, num_layers=3, dtype="float32")
    jcfg = jclip.ClipVisionConfig(**kw)
    params = jclip.init_clip_vision_params(jax.random.PRNGKey(2), jcfg)
    model = tclip.ClipVisionTower(tclip.ClipVisionConfig(**kw))
    model.load_state_dict(from_jax.clip_vision_state_dict_from_jax(params))
    imgs = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    want = np.asarray(jclip.clip_visual_tokens(params, jcfg, jnp.asarray(imgs)))
    with torch.no_grad():
        got = tclip.clip_visual_tokens(model, torch.from_numpy(imgs)).numpy()
    assert got.shape == want.shape == (2, 17, 32)
    np.testing.assert_allclose(got, want, **TOL)


def test_clip_preprocess_matches_jax(rng):
    frames = rng.uniform(-1, 1, (2, 3, 50, 70)).astype(np.float32)
    want = np.asarray(jclip.clip_preprocess(jnp.asarray(frames)))
    got = tclip.clip_preprocess(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("antialias", [False, True])
def test_resize_matches_jax(rng, antialias):
    x = rng.uniform(-1, 1, (2, 3, 40, 70)).astype(np.float32)
    np.testing.assert_allclose(
        resize_bicubic(torch.from_numpy(x), 24, 36, antialias=antialias).numpy(),
        np.asarray(j_bicubic(jnp.asarray(x), 24, 36, antialias=antialias)), **TOL)
    np.testing.assert_allclose(
        resize_bilinear(torch.from_numpy(x), 20, 35, antialias=antialias).numpy(),
        np.asarray(j_bilinear(jnp.asarray(x), 20, 35, antialias=antialias)), **TOL)


def test_timestep_embedding_matches_jax():
    t = np.asarray([0.0, 12.5, 999.0], np.float32)
    for dim in (16, 256, 17):
        np.testing.assert_allclose(timestep_embedding(torch.from_numpy(t), dim).numpy(),
                                   np.asarray(j_timestep_embedding(jnp.asarray(t), dim)), **TOL)


def test_gif_reader_matches_shared_loader():
    """The port reads GIFs with Pillow (no video backend needed); frames and
    fps equal the shared loader's on the committed fixture."""
    import os

    from scail_tpu.data.video import load_video_frames as shared_load
    from scail_tpu_torch.data.video import load_video_frames

    path = os.path.join(os.path.dirname(__file__), "..", "examples_synth", "001", "rendered.gif")
    got, fps = load_video_frames(path)
    want, want_fps = shared_load(path)
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] == 9 and abs(fps - want_fps) < 1e-6
