"""The port's quality evals (scail_tpu_torch/evals, models/clip_score.py)
against the JAX package's on the CPU, in f32.

Each port module takes the JAX parameters through the weight bridge
(convert/from_jax.py), or a file written from a random port module goes
through the JAX converter, and both compute on the same numpy inputs.
Tolerance: bit-equal where both sides are numpy (Frechet, the aesthetic
head, the CLIP score's mean cosine), else 2e-4 relative L2, the port's
module tolerance.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scail_tpu_torch.convert import from_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 2e-4


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _random_bn(tree, rng):
    """Randomised BatchNorm statistics and affines, so the eval-mode BN is
    exercised (the random init leaves them the identity)."""
    if isinstance(tree, dict):
        if set(tree) >= {"scale", "bias", "mean", "var"}:
            c = np.asarray(tree["scale"]).shape[0]
            return dict(tree, scale=rng.uniform(0.5, 1.5, c).astype(np.float32),
                        bias=rng.normal(0, 0.1, c).astype(np.float32),
                        mean=rng.normal(0, 0.1, c).astype(np.float32),
                        var=rng.uniform(0.5, 2.0, c).astype(np.float32))
        return {k: _random_bn(v, rng) for k, v in tree.items()}
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# numpy: Frechet, the aesthetic head, the CLIP score's mean cosine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 3, 64])
def test_frechet_is_bit_equal_to_jax(rng, n):
    """n = 1: the zero covariance; n = 3 < D: a singular covariance (sqrtm
    warns); n = 64: the plain case."""
    from scail_tpu.evals import frechet as jf

    from scail_tpu_torch.evals import frechet as tf

    a = rng.standard_normal((n, 16)).astype(np.float32)
    b = rng.standard_normal((n, 16)).astype(np.float32) + 0.5
    for got, want in zip(tf.feature_stats(a), jf.feature_stats(a)):
        np.testing.assert_array_equal(got, want)
    assert tf.frechet_from_features(a, b) == jf.frechet_from_features(a, b)
    assert tf.frechet_from_features(a, a) == jf.frechet_from_features(a, a)
    mu, cov = tf.feature_stats(a)
    assert tf.frechet_distance(mu, cov, mu + 1, 2 * cov, eps=1e-3) == \
        jf.frechet_distance(mu, cov, mu + 1, 2 * cov, eps=1e-3)


def test_aesthetic_head_is_bit_equal_to_jax(rng, tmp_path):
    from scail_tpu.evals.aesthetic import aesthetic_score_from_clip_embeddings as jax_aes

    from scail_tpu_torch.evals.aesthetic import (aesthetic_score_from_clip_embeddings,
                                                 load_aesthetic_head, random_aesthetic_head)

    emb = rng.standard_normal((5, 768)).astype(np.float32)
    head = {k: v * 50 for k, v in random_aesthetic_head(0).items()}  # non-trivial ratings
    np.testing.assert_array_equal(aesthetic_score_from_clip_embeddings(emb, head),
                                  jax_aes(emb, head))
    # the smoke head is eval/eval_aes.py's: default_rng(0) draws in layer order
    jrng = np.random.default_rng(0)
    for i, (din, dout) in zip([0, 2, 4, 6, 7], [(768, 1024), (1024, 128), (128, 64),
                                                 (64, 16), (16, 1)]):
        want = jrng.standard_normal((dout, din)).astype(np.float32) * 0.02
        np.testing.assert_array_equal(random_aesthetic_head(0)[f"layers.{i}.weight"], want)
    # the loader hands numpy arrays to the numpy head
    path = str(tmp_path / "head.pth")
    torch.save({k: torch.from_numpy(v) for k, v in head.items()}, path)
    loaded = load_aesthetic_head(path)
    np.testing.assert_array_equal(aesthetic_score_from_clip_embeddings(emb, loaded),
                                  jax_aes(emb, head))
    with pytest.raises(FileNotFoundError):
        load_aesthetic_head(str(tmp_path / "missing.pth"))


def test_clip_score_mean_cosine_is_bit_equal_to_jax(rng):
    from scail_tpu.evals.clip_score import clip_score_from_embeddings as jax_score

    from scail_tpu_torch.evals.clip_score import clip_score_from_embeddings, compute_clip_score

    a, b = rng.standard_normal((7, 12)), rng.standard_normal((7, 12))
    assert clip_score_from_embeddings(a, b) == jax_score(a, b)
    # batched as compute_clip_score batches it
    got = compute_clip_score(list(range(7)), ["p"] * 7, lambda i: a[i[0]:i[-1] + 1],
                             lambda t: b[:len(t)] if len(t) == 3 else b[6:7], batch=3)
    want = jax_score(a, np.concatenate([b[:3], b[:3], b[6:7]]))
    assert got == want


def test_hps_needs_hpsv2_or_a_scorer(monkeypatch):
    from scail_tpu_torch.evals.aesthetic import hps_score

    assert hps_score(["im"], ["p"], scorer=lambda i, p: [0.25]) == [0.25]
    monkeypatch.setitem(sys.modules, "hpsv2", None)
    with pytest.raises(RuntimeError, match="hpsv2"):
        hps_score(["im"], ["p"])


def test_quick_gelu_matches_jax(rng):
    from scail_tpu.models.common import quick_gelu as jax_quick_gelu

    from scail_tpu_torch.models.common import quick_gelu

    x = rng.standard_normal((4, 33)).astype(np.float32) * 3
    np.testing.assert_allclose(quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_quick_gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_full_f32_turns_tf32_off_and_restores_it():
    from scail_tpu_torch.evals import full_f32

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = True, True
        with pytest.raises(ValueError):
            with full_f32():
                assert not torch.backends.cuda.matmul.allow_tf32
                assert not torch.backends.cudnn.allow_tf32
                raise ValueError
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# I3D / FVD
# ---------------------------------------------------------------------------
def test_preprocess_for_i3d_matches_jax(rng):
    from scail_tpu.evals.fvd import preprocess_for_i3d as jax_pre

    from scail_tpu_torch.evals.fvd import preprocess_for_i3d

    v = rng.uniform(0, 1, (2, 3, 20, 36, 3)).astype(np.float32)
    for size in (32, 16):
        got = preprocess_for_i3d(v, size=size, device="cpu")
        assert got.shape == (2, 3, 3, size, size) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), jax_pre(v, size=size), rtol=1e-5, atol=1e-6)


def _random_i3d(seed):
    """A port I3D from a seed, with randomised BatchNorm statistics and
    affines (the random init leaves them the identity)."""
    from scail_tpu_torch.evals.i3d import InceptionI3d

    model = InceptionI3d().init_random_(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.normal_(0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0, 0.1, generator=gen)
    return model


def _numpy_sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def test_i3d_matches_jax(rng):
    """(2, 3, 8, 32, 32) with randomised BN statistics: every padding, pool
    and the clamped final average pool at a small size; the JAX parameters
    come through the bridge."""
    from scail_tpu.evals.i3d import i3d_logits, i3d_params_from_state_dict

    from scail_tpu_torch.evals.i3d import InceptionI3d

    params = i3d_params_from_state_dict(_numpy_sd(_random_i3d(1)))
    x = rng.uniform(-1, 1, (2, 3, 8, 32, 32)).astype(np.float32)
    want = np.asarray(jax.jit(i3d_logits)(params, jnp.asarray(x)))
    model = InceptionI3d()
    model.load_state_dict(from_jax.i3d_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 400) and rel_l2(got, want) < TOL


def test_i3d_max_pool_takes_the_zero_pads():
    """The TF-SAME max-pool pads with zeros (MaxPool3dSamePadding): on an
    all-negative input the border outputs are 0, where max_pool3d's own
    (-inf) padding would give the input's values."""
    from scail_tpu.evals.i3d import _maxpool_same as jax_pool

    from scail_tpu_torch.evals.i3d import _maxpool_same

    x = -1.0 - np.arange(2 * 3 * 4 * 5 * 6, dtype=np.float32).reshape(2, 3, 4, 5, 6) / 100
    got = _maxpool_same(torch.from_numpy(x), (3, 3, 3), (1, 1, 1)).numpy()
    want = np.asarray(jax_pool(jnp.asarray(x.transpose(0, 2, 3, 4, 1)), (3, 3, 3), (1, 1, 1)))
    np.testing.assert_array_equal(got, want.transpose(0, 4, 1, 2, 3))
    assert got[:, :, 0, 0, 0].max() == 0.0


def test_i3d_file_loads_strict_and_matches_the_jax_converter(rng, tmp_path):
    """A state dict written from a random port I3D (pytorch_i3d names)
    through `i3d_params_from_state_dict`: JAX on the converted params equals
    the port's extractor on the file."""
    from scail_tpu.evals.fvd import I3DFeatureExtractor as JaxI3D
    from scail_tpu.evals.fvd import compute_fvd as jax_compute_fvd

    from scail_tpu_torch.evals.fvd import I3DFeatureExtractor, compute_fvd

    model = _random_i3d(3)
    path = str(tmp_path / "i3d_pretrained_400.pt")
    torch.save(model.state_dict(), path)
    v = rng.uniform(0, 1, (3, 8, 40, 48, 3)).astype(np.float32)
    got = I3DFeatureExtractor(path, batch=2, size=32, device="cpu")(v)
    want = JaxI3D(path, batch=2, size=32)(v)
    assert got.shape == (3, 400) and rel_l2(got, want) < TOL
    assert rel_l2(compute_fvd(v[:2], v[1:], path, i3d_size=32, device="cpu"),
                  jax_compute_fvd(v[:2], v[1:], path, i3d_size=32)) < TOL
    with pytest.raises(FileNotFoundError, match="i3d_pretrained_400"):
        I3DFeatureExtractor(str(tmp_path / "none.pt"), device="cpu")
    sd = model.state_dict()
    sd.pop("Mixed_4c.b1b.bn.running_var")
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="Mixed_4c.b1b.bn.running_var"):
        I3DFeatureExtractor(path, device="cpu")


class _TinyVideoNet(torch.nn.Module):
    """A stand-in with the styleganv torchscript's call signature."""

    def forward(self, x, rescale: bool = True, resize: bool = True,
                return_features: bool = False):
        assert not rescale and not resize and return_features
        return x.mean(dim=(2, 3, 4))[:, :2] * 3.0


class _TinyImageNet(torch.nn.Module):
    """A stand-in with the EDM detector's call signature (uint8 NCHW)."""

    def forward(self, x, return_features: bool = False):
        assert return_features
        return x.float().mean(dim=(2, 3))


def test_torchscript_flavours_run_on_the_extractors_device(rng, tmp_path):
    """A `*torchscript.pt` I3D and an EDM torchscript detector are loaded
    onto the extractor's device and called as the reference calls them."""
    from scail_tpu_torch.evals.fid import InceptionFeatureExtractor
    from scail_tpu_torch.evals.fvd import I3DFeatureExtractor, preprocess_for_i3d

    vpath = str(tmp_path / "i3d_torchscript.pt")
    torch.jit.script(_TinyVideoNet()).save(vpath)
    v = rng.uniform(0, 1, (3, 4, 20, 24, 3)).astype(np.float32)
    ext = I3DFeatureExtractor(vpath, batch=2, size=16, device="cpu")
    want = preprocess_for_i3d(v, 16).mean(dim=(2, 3, 4))[:, :2] * 3.0
    np.testing.assert_allclose(ext(v), want.numpy(), rtol=1e-6)

    ipath = str(tmp_path / "detector_torchscript.pt")
    torch.jit.script(_TinyImageNet()).save(ipath)
    imgs = rng.integers(0, 255, (5, 9, 11, 3), dtype=np.uint8)
    got = InceptionFeatureExtractor(ipath, batch=2, device="cpu")(imgs)
    np.testing.assert_allclose(got, imgs.astype(np.float32).mean(axis=(1, 2)), rtol=1e-6)


# ---------------------------------------------------------------------------
# InceptionV3 / FID
# ---------------------------------------------------------------------------
def _inception_pair(rng, seed=0):
    """JAX parameters from a random port InceptionV3 with randomised BN
    (through the JAX converter), and a fresh port module that takes them
    through the bridge."""
    from scail_tpu.evals.inception import inception_params_from_state_dict

    from scail_tpu_torch.evals.inception import FIDInceptionV3

    src = FIDInceptionV3().init_random_(torch.Generator().manual_seed(seed))
    params = _random_bn(inception_params_from_state_dict(_numpy_sd(src)), rng)
    model = FIDInceptionV3()
    model.load_state_dict(from_jax.inception_state_dict_from_jax(params), strict=True)
    return params, model


@pytest.mark.parametrize("block, jax_fn, cin, hw", [
    ("Mixed_5b", "_inception_a", 192, 9), ("Mixed_6a", "_inception_b", 288, 9),
    ("Mixed_6b", "_inception_c", 768, 8), ("Mixed_7a", "_inception_d", 768, 9),
    ("Mixed_7b", "avg", 1280, 5), ("Mixed_7c", "max", 2048, 5)])
def test_inception_block_matches_jax(rng, block, jax_fn, cin, hw):
    """Each block type at a small spatial size: the count_include_pad=False
    average pools, Mixed_7b's average and Mixed_7c's max pool branch."""
    import scail_tpu.evals.inception as ji

    from scail_tpu_torch.evals import inception as ti

    params, model = _inception_pair(rng)
    x = rng.uniform(0, 2, (2, cin, hw, hw + 2)).astype(np.float32)
    if jax_fn in ("avg", "max"):
        want = ji._inception_e(params[block], jnp.asarray(x.transpose(0, 2, 3, 1)), jax_fn)
    else:
        want = getattr(ji, jax_fn)(params[block], jnp.asarray(x.transpose(0, 2, 3, 1)))
    fn = dict(ti.BLOCKS)[block]
    with torch.no_grad():
        got = fn(getattr(model, block), torch.from_numpy(x)).numpy()
    assert rel_l2(got, np.asarray(want).transpose(0, 3, 1, 2)) < TOL


def test_inception_pools_count_only_the_image():
    """The branch average pool divides by the taps inside the image (corner:
    4 of 9), unlike avg_pool2d's default."""
    from scail_tpu_torch.evals.inception import _avgpool_nocount

    x = torch.ones(1, 1, 4, 4)
    assert torch.equal(_avgpool_nocount(x), x)


def test_inception_file_loads_strict_and_matches_the_jax_converter(rng, tmp_path):
    """The whole InceptionV3 at batch 1: a pytorch-fid style file (with its
    1008-class fc head) written from a random port module, read by the
    port's extractor and by the strict `inception_params_from_state_dict`."""
    from scail_tpu.evals.fid import InceptionFeatureExtractor as JaxInception

    from scail_tpu_torch.evals.fid import InceptionFeatureExtractor

    _, model = _inception_pair(rng, seed=4)
    sd = dict(model.state_dict(), **{"fc.weight": torch.zeros(1008, 2048),
                                     "fc.bias": torch.zeros(1008)})
    path = str(tmp_path / "pt_inception-2015-12-05.pth")
    torch.save(sd, path)
    imgs = rng.integers(0, 255, (1, 40, 56, 3), dtype=np.uint8)
    got = InceptionFeatureExtractor(path, device="cpu")(imgs)
    want = JaxInception(path)(imgs)
    assert got.shape == (1, 2048) and rel_l2(got, want) < TOL
    sd.pop("Mixed_6e.branch7x7dbl_4.bn.running_mean")
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="Mixed_6e.branch7x7dbl_4.bn.running_mean"):
        InceptionFeatureExtractor(path, device="cpu")


def test_fid_stats_round_trip_matches_jax(rng, tmp_path):
    from scail_tpu.evals.fid import fid_from_stats as jax_fid

    from scail_tpu_torch.evals.fid import fid_from_stats, save_ref_stats

    ref, gen = rng.standard_normal((20, 8)), rng.standard_normal((20, 8)) + 0.3
    save_ref_stats(ref, str(tmp_path / "ref.npz"))
    assert fid_from_stats(gen, str(tmp_path / "ref.npz")) == \
        jax_fid(gen, str(tmp_path / "ref.npz"))
    assert abs(fid_from_stats(ref, str(tmp_path / "ref.npz"))) < 1e-6


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------
def test_lpips_matches_jax(rng):
    from scail_tpu.evals.lpips import lpips, lpips_params_from_torch

    from scail_tpu_torch.evals.lpips import LPIPS

    sd = _numpy_sd(LPIPS().init_random_(torch.Generator().manual_seed(2)))
    params = lpips_params_from_torch(sd, sd)
    x = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.3, x.shape), -1, 1).astype(np.float32)
    want = np.asarray(lpips(params, jnp.asarray(x), jnp.asarray(y)))
    model = LPIPS()
    model.load_state_dict(from_jax.lpips_state_dict_from_jax(params), strict=True)
    got = model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == (2,) and rel_l2(got, want) < TOL
    assert np.all(model(torch.from_numpy(x), torch.from_numpy(x)).numpy() == 0)


def test_lpips_files_load_and_match_the_jax_converter(rng, tmp_path):
    """torchvision's vgg16 state dict (with its classifier) and the lin file,
    written from a random port module, through `lpips_params_from_torch`."""
    from scail_tpu.evals.lpips import lpips, lpips_params_from_torch

    from scail_tpu_torch.evals.lpips import LPIPS, load_lpips

    model = LPIPS().init_random_(torch.Generator().manual_seed(5))
    sd = model.state_dict()
    vgg = {k: v for k, v in sd.items() if k.startswith("features.")}
    vgg["classifier.0.weight"] = torch.zeros(4, 4)
    lins = {k: v for k, v in sd.items() if k.startswith("lin")}
    torch.save(vgg, str(tmp_path / "vgg16.pth"))
    torch.save(lins, str(tmp_path / "vgg.pth"))
    x = rng.uniform(-1, 1, (2, 3, 48, 40)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 3, 48, 40)).astype(np.float32)
    got = load_lpips(str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg.pth"), device="cpu")(
        torch.from_numpy(x), torch.from_numpy(y)).numpy()
    params = lpips_params_from_torch({k: v.numpy() for k, v in vgg.items()},
                                     {k: v.numpy() for k, v in lins.items()})
    want = np.asarray(lpips(params, jnp.asarray(x), jnp.asarray(y)))
    assert rel_l2(got, want) < TOL


# ---------------------------------------------------------------------------
# CLIP towers and the scorer
# ---------------------------------------------------------------------------
def _tiny_cfgs(act="gelu"):
    """The tiny config of tests/test_clip_score_model.py, in both packages."""
    from scail_tpu.models.clip_score import ClipScoreConfig as JaxCfg

    from scail_tpu_torch.models.clip_score import ClipScoreConfig

    kw = dict(vision_width=32, vision_layers=2, vision_heads=4, vision_mlp=48, image_size=32,
              patch_size=16, text_width=24, text_layers=2, text_heads=4, text_mlp=40,
              vocab_size=64, context_length=16, embed_dim=20, hidden_act=act,
              eos_token_id=63, dtype="float32")
    return JaxCfg(**kw), ClipScoreConfig(**kw)


def _clip_inputs(rng, cfg):
    images = rng.standard_normal((3, 3, 32, 32)).astype(np.float32)
    ids = rng.integers(1, 60, (3, cfg.context_length))
    ids[0, 5], ids[1, 15], ids[2, 3] = 63, 63, 63   # EOS at 5, at the end, and twice
    ids[2, 9] = 63
    return images, ids


def _embeds_both(jparams, jcfg, model, images, ids):
    from scail_tpu.models.clip_score import clip_image_embed, clip_text_embed

    want_i = np.asarray(clip_image_embed(jparams, jcfg, jnp.asarray(images)))
    want_t = np.asarray(clip_text_embed(jparams, jcfg, jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        got_i = model.image_embed(torch.from_numpy(images)).numpy()
        got_t = model.text_embed(torch.from_numpy(ids)).numpy()
    return (got_i, want_i), (got_t, want_t)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_towers_match_jax_through_the_bridge(rng, act):
    from scail_tpu.models.clip_score import clip_params_from_hf_state_dict

    from scail_tpu_torch.models.clip_score import ClipScoreModel

    jcfg, cfg = _tiny_cfgs(act)
    src = ClipScoreModel(cfg).init_random_(torch.Generator().manual_seed(0))
    jparams = clip_params_from_hf_state_dict(_numpy_sd(src), jcfg)
    model = ClipScoreModel(cfg)
    model.load_state_dict(from_jax.clip_score_state_dict_from_jax(jparams), strict=True)
    for got, want in _embeds_both(jparams, jcfg, model, *_clip_inputs(rng, cfg)):
        assert got.shape == (3, 20) and rel_l2(got, want) < TOL


def test_clip_hf_layout_matches_the_jax_converter(rng):
    """The port module's state dict is HF CLIPModel's (plus HF's extra
    tensors): `clip_params_from_hf_state_dict` reads it, the port loads it."""
    from scail_tpu.models.clip_score import clip_params_from_hf_state_dict

    from scail_tpu_torch.models.clip_score import ClipScoreModel, load_clip_score_state_dict

    jcfg, cfg = _tiny_cfgs()
    src = ClipScoreModel(cfg).init_random_(torch.Generator().manual_seed(6))
    sd = dict(src.state_dict(), logit_scale=torch.tensor(4.6),
              **{"text_model.embeddings.position_ids": torch.arange(16)[None]})
    jparams = clip_params_from_hf_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg)
    model = load_clip_score_state_dict(ClipScoreModel(cfg), sd)
    for got, want in _embeds_both(jparams, jcfg, model, *_clip_inputs(rng, cfg)):
        assert rel_l2(got, want) < TOL
    sd.pop("vision_model.encoder.layers.1.mlp.fc2.bias")
    with pytest.raises(KeyError, match="layers.1.mlp.fc2.bias"):
        load_clip_score_state_dict(ClipScoreModel(cfg), sd)


def _open_clip_sd(rng, cfg):
    """A random state dict in open_clip's layout (fused qkv, resblocks)."""
    def n(*shape, s=0.1):
        return torch.from_numpy(rng.normal(0, s, shape).astype(np.float32))

    sd = {}
    for prefix, d, mlp, layers in (("visual.", cfg.vision_width, cfg.vision_mlp,
                                    cfg.vision_layers),
                                   ("", cfg.text_width, cfg.text_mlp, cfg.text_layers)):
        for i in range(layers):
            b = f"{prefix}transformer.resblocks.{i}."
            sd.update({b + "attn.in_proj_weight": n(3 * d, d), b + "attn.in_proj_bias": n(3 * d),
                       b + "attn.out_proj.weight": n(d, d), b + "attn.out_proj.bias": n(d),
                       b + "ln_1.weight": 1 + n(d), b + "ln_1.bias": n(d),
                       b + "ln_2.weight": 1 + n(d), b + "ln_2.bias": n(d),
                       b + "mlp.c_fc.weight": n(mlp, d), b + "mlp.c_fc.bias": n(mlp),
                       b + "mlp.c_proj.weight": n(d, mlp), b + "mlp.c_proj.bias": n(d)})
    vd, td, p = cfg.vision_width, cfg.text_width, cfg.patch_size
    for name, d in (("visual.ln_pre", vd), ("visual.ln_post", vd), ("ln_final", td)):
        sd[name + ".weight"], sd[name + ".bias"] = 1 + n(d), n(d)
    sd.update({"visual.class_embedding": n(vd), "visual.conv1.weight": n(vd, 3, p, p),
               "visual.positional_embedding": n((cfg.image_size // p) ** 2 + 1, vd),
               "visual.proj": n(vd, cfg.embed_dim), "token_embedding.weight": n(cfg.vocab_size, td),
               "positional_embedding": n(cfg.context_length, td),
               "text_projection": n(td, cfg.embed_dim), "logit_scale": torch.tensor(4.6)})
    return sd


def test_clip_open_clip_layout_matches_the_jax_converter(rng):
    from scail_tpu.models.clip_score import clip_params_from_open_clip

    from scail_tpu_torch.models.clip_score import ClipScoreModel, load_clip_score_state_dict

    jcfg, cfg = _tiny_cfgs()
    sd = _open_clip_sd(rng, cfg)
    jparams = clip_params_from_open_clip({k: v.numpy() for k, v in sd.items()}, jcfg)
    model = load_clip_score_state_dict(ClipScoreModel(cfg), sd)
    for got, want in _embeds_both(jparams, jcfg, model, *_clip_inputs(rng, cfg)):
        assert rel_l2(got, want) < TOL


def test_clip_scorer_matches_the_jax_scorer(rng, tmp_path):
    """ClipScorer from an open_clip file against JaxClipScorer on the same
    file: the open_clip eval transform on PIL images of odd sizes, and the
    text tower on the same ids."""
    from PIL import Image
    from scail_tpu.evals.clip_score import JaxClipScorer

    from scail_tpu_torch.evals.clip_score import ClipScorer

    jcfg, cfg = _tiny_cfgs()
    path = str(tmp_path / "open_clip.pt")
    torch.save({"state_dict": _open_clip_sd(rng, cfg)}, path)
    port, ref = ClipScorer(path, cfg=cfg, device="cpu"), JaxClipScorer(path, cfg=jcfg)
    images = [Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
              for h, w in ((40, 70), (90, 33), (32, 32))]
    np.testing.assert_allclose(port.preprocess(images).numpy(), ref.preprocess(images),
                               rtol=1e-5, atol=1e-5)
    assert rel_l2(port.image_embed(images), ref.image_embed(images)) < TOL
    ids = _clip_inputs(rng, cfg)[1]
    with torch.no_grad():
        got = port.model.text_embed(torch.from_numpy(ids)).numpy()
    want = np.asarray(ref._txt_fn(ref.params, jnp.asarray(ids, jnp.int32)))
    assert rel_l2(got, want) < TOL


def test_hash_tokenizer_is_the_same_in_every_process():
    """The JAX fallback tokenizer hashes with hash(), which PYTHONHASHSEED
    changes; the port's crc32 ids are equal across processes."""
    code = ("from scail_tpu_torch.evals.clip_score import hash_token_ids; "
            "from scail_tpu_torch.models.clip_score import ClipScoreConfig; "
            "print(hash_token_ids(['A dancer turns', 'x'], ClipScoreConfig()).tolist())")
    outs = []
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=seed)
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout)
    assert outs[0] == outs[1]
    ids = eval(outs[0])  # noqa: S307 -- our own subprocess's list of ints
    assert ids[0][:5] == [49406, ids[0][1], ids[0][2], ids[0][3], 49407] and ids[1][2] == 49407
    assert all(0 < t < 49406 for t in ids[0][1:4]) and ids[0][5:] == [0] * 72


def test_tokenizer_path_without_transformers_raises(monkeypatch):
    from scail_tpu_torch.evals.clip_score import ClipScorer

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        ClipScorer(tokenizer_path="some/tokenizer", device="cpu")


@pytest.mark.parametrize("make", ["i3d", "inception", "clip", "lpips"])
def test_extractors_on_cuda_without_cuda_raise(make, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from scail_tpu_torch.evals.clip_score import ClipScorer
    from scail_tpu_torch.evals.fid import InceptionFeatureExtractor
    from scail_tpu_torch.evals.fvd import I3DFeatureExtractor
    from scail_tpu_torch.evals.lpips import load_lpips

    with pytest.raises(RuntimeError, match="CUDA"):
        {"i3d": lambda: I3DFeatureExtractor(),
         "inception": lambda: InceptionFeatureExtractor(),
         "clip": lambda: ClipScorer(),
         "lpips": lambda: load_lpips(str(tmp_path / "a"), str(tmp_path / "b"))}[make]()
