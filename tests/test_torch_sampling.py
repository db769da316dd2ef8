"""The PyTorch port's sampling slice as a whole, plus its guards.

* The port's RFSampler + Denoiser + VanillaCFG + DiT, with JAX-initialised
  weights bridged by convert/from_jax.py and the same inputs, reproduce the
  committed CPU `dense` fingerprint (goldens/fingerprints_cpu.json) at rtol
  1e-4, compared with scripts/fingerprints.py's own `compare`; the port's
  RFSamplerLong reproduces the `long_tile` fingerprint the same way, its
  `long_step` matches the JAX one at 1e-4 and `make_tile_indices` the JAX
  function.
* The port's CLI answers a request on examples_synth/001 with --device cpu at
  a tiny model built here, and writes its clip, with RFSampler and with the
  tiled RFSamplerLong.
* Guards: the port never imports jax or the JAX package (its modules, its
  sources, and its train CLI run in a fresh interpreter); the reference
  YAML builds the port's classes through the port's registry and the JAX
  classes through the JAX registry in one process; a CUDA device without
  CUDA raises.
"""

import hashlib
import inspect
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from scail_tpu.diffusion.samplers import RFSamplerLong as JaxRFSamplerLong
from scail_tpu.diffusion.samplers import make_tile_indices as jax_make_tile_indices
from scail_tpu.models.dit import DiTConfig as JaxDiTConfig
from scail_tpu.models.dit import dit_forward, init_dit_params
from scail_tpu_torch.convert.from_jax import dit_state_dict_from_jax
from scail_tpu_torch.data.video import load_video_frames, save_multi_video_grid_and_mp4
from scail_tpu_torch.diffusion.samplers import make_tile_indices
from scail_tpu_torch.models.dit import DiT, DiTConfig
from scail_tpu_torch.utils.registry import instantiate_from_config

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.dirname(__file__))

SAMPLER = dict(
    hunyuan_schedule=True, shift_scale=5, num_steps=50, mode="normal",
    discretization_config={
        "target": "sgm.modules.diffusionmodules.discretizer.RFDiscretization"},
    guider_config={"target": "sgm.modules.diffusionmodules.guiders.VanillaCFG",
                   "params": {"scale": 4}})
DENOISER = dict(
    weighting_config={
        "target": "sgm.modules.diffusionmodules.denoiser_weighting.EpsWeighting"},
    scaling_config={"target": "sgm.modules.diffusionmodules.denoiser_scaling.RFScaling"})


# the tiny DiT of scripts/fingerprints.py, and its long-tile geometry: tiles
# of 3 latent frames overlapping by 1
FP_DIT = dict(hidden_size=64, num_layers=2, num_heads=2, inner_hidden_size=128,
              time_embed_dim=64, text_dim=32, clip_dim=16, share_adaln=True,
              use_i2v_clip=True, dtype="float32")
TINY_TILE, TINY_OVERLAP = 3, 1


def _fingerprint_inputs(kind="step", **cfg_kw):
    """The tiny geometry of scripts/fingerprints.py for a path of `kind`
    ('step': 9 frames, 'long': 25 frames in tiles), built with the same JAX
    keys: weights, conditioning and the starting latent, as numpy, and the
    port's DiTConfig (cfg_kw: the path's attention options)."""
    T, H, W = (7 if kind == "long" else 3), 8, 8
    key = jax.random.PRNGKey(0)
    params = init_dit_params(key, JaxDiTConfig(**FP_DIT, attn_impl="xla"))
    ks = jax.random.split(key, 8)
    cond = {
        "crossattn": jax.random.normal(ks[1], (1, 16, 32), jnp.float32),
        "ref_concat": jax.random.normal(ks[2], (1, 1, 16, H, W), jnp.float32),
        "image_clip_features": jax.random.normal(ks[3], (1, 9, 16), jnp.float32),
    }
    if kind == "long":
        n = len(jax_make_tile_indices(T, TINY_TILE, TINY_OVERLAP))
        cond["smpl_tiled"] = jax.random.normal(
            ks[4], (1, n, TINY_TILE, 16, H // 2, W // 2), jnp.float32)
    else:
        cond["concat_smpl_render"] = jax.random.normal(ks[4], (1, T, 16, H // 2, W // 2),
                                                       jnp.float32)
    x0 = jax.random.normal(jax.random.PRNGKey(7), (1, T, 16, H, W), jnp.float32)
    to_np = lambda t: np.array(t)  # noqa: E731  (writable copies for torch)
    return (jax.tree.map(to_np, params), DiTConfig(**FP_DIT, **cfg_kw),
            {k: to_np(v) for k, v in cond.items()}, to_np(x0))


def _port_denoise_fn(params, cfg):
    """The port's Denoiser over its DiT with the bridged weights."""
    model = DiT(cfg)
    model.load_state_dict(dit_state_dict_from_jax(params, cfg))
    denoiser = instantiate_from_config(
        {"target": "sgm.modules.diffusionmodules.denoiser.Denoiser", "params": DENOISER})

    def net(x, c_noise, c, **kw):
        return model(x, c_noise, c["crossattn"], ref_concat=c["ref_concat"],
                     concat_smpl_render=c["concat_smpl_render"],
                     image_clip_features=c["image_clip_features"])

    def denoise_fn(x, sigma, c, cfg_scale=None, **kw):
        return denoiser(net, x, sigma, c)

    return denoise_fn


def port_fingerprint(name, **cfg_kw):
    """Run the port's sampler + Denoiser + VanillaCFG + DiT for the steps of
    the CPU fingerprint `name` (RFSampler steps, or RFSamplerLong's tiled
    steps for a 'long' path) and hold it against the committed golden at rtol
    1e-4 (scripts/fingerprints.py's own `compare`)."""
    import fingerprints as fp

    geom = fp.TINY_GEOMS[name]
    params, cfg, cond_np, x0 = _fingerprint_inputs(geom["kind"], **cfg_kw)
    denoise_fn = _port_denoise_fn(params, cfg)
    target = "RFSamplerLong" if geom["kind"] == "long" else "RFSampler"
    sampler = instantiate_from_config(
        {"target": f"sgm.modules.diffusionmodules.sampling.{target}", "params": SAMPLER})
    cond = {k: torch.from_numpy(v) for k, v in cond_np.items()}
    uc = dict(cond, crossattn=torch.zeros_like(cond["crossattn"]))
    if geom["kind"] == "long":
        tiles = make_tile_indices(x0.shape[1], TINY_TILE, TINY_OVERLAP)

        def step(x, sigma, next_sigma):
            return sampler.long_step(denoise_fn, x, (sigma, next_sigma), tiles, cond, uc)
    else:
        merged = sampler.guider.prepare_cond(cond, uc)

        def step(x, sigma, next_sigma):
            return sampler.step(denoise_fn, x, sigma, next_sigma, merged, sampler.guider.scale)

    sigmas = sampler.sigma_schedule(x0.shape)
    x = torch.from_numpy(x0)
    prev = x0
    norms, deltas = [], []
    with torch.no_grad():
        for i in range(geom["steps"]):
            x = step(x, float(sigmas[i]), float(sigmas[i + 1]))
            xa = x.numpy().astype(np.float32)
            norms.append(round(float(np.linalg.norm(xa)), 4))
            deltas.append(round(float(np.linalg.norm(xa - prev)), 5))
            prev = xa
    got = {name: {"step_norms": norms, "delta_norms": deltas,
                  "final_mean": round(float(xa.mean()), 6),
                  "final_std": round(float(xa.std()), 6),
                  "final_hash": hashlib.sha256(xa.tobytes()).hexdigest()[:16]}}
    with open(os.path.join(fp.GOLDENS_DIR, "fingerprints_cpu.json")) as f:
        want = {name: json.load(f)["fingerprints"][name]}
    hard, msgs = fp.compare(got, want, rtol=1e-4)
    assert not hard, "\n".join(msgs)


def test_port_reproduces_dense_cpu_fingerprint():
    port_fingerprint("dense")


def test_port_reproduces_long_tile_cpu_fingerprint():
    port_fingerprint("long_tile")


@pytest.mark.parametrize("tile, overlap", [(3, 1), (21, 8), (5, 4), (8, 3)])
def test_make_tile_indices_matches_jax(tile, overlap):
    for frames in (1, 3, 7, 13, 20, 21, 22, 25, 41, 60, 61, 100):
        assert make_tile_indices(frames, tile, overlap) == \
            jax_make_tile_indices(frames, tile, overlap), frames
    # the long-clip request: 161 frames -> 41 latent frames in three tiles
    assert [(t[0], t[-1]) for t in make_tile_indices(41, 21, 8)] == [(0, 20), (13, 33), (20, 40)]
    with pytest.raises(ValueError):
        make_tile_indices(41, tile, tile)


def test_long_step_matches_jax():
    """One tiled step (three tiles, pairs (0, 1) and (1, 2): the middle tile
    denoised twice) of the port's RFSamplerLong on the tiny DiT with bridged
    weights against the JAX long_step on the same inputs, at 1e-4."""
    from scail_tpu.diffusion.denoiser import Denoiser as JaxDenoiser
    from scail_tpu_torch.diffusion.samplers import RFSamplerLong

    params, cfg, cond_np, x0 = _fingerprint_inputs("long")
    tiles = make_tile_indices(x0.shape[1], TINY_TILE, TINY_OVERLAP)
    assert len(tiles) == 3
    jcfg = JaxDiTConfig(**FP_DIT, attn_impl="xla")
    jparams = jax.tree.map(jnp.asarray, params)
    jden = JaxDenoiser(**DENOISER)

    def jnet(x, c_noise, c, **kw):
        return dit_forward(jparams, jcfg, x, c_noise, c["crossattn"], ref_concat=c["ref_concat"],
                           concat_smpl_render=c["concat_smpl_render"],
                           image_clip_features=c["image_clip_features"])

    jcond = {k: jnp.asarray(v) for k, v in cond_np.items()}
    juc = dict(jcond, crossattn=jnp.zeros_like(jcond["crossattn"]))
    jsampler = JaxRFSamplerLong(**SAMPLER)
    pair = np.asarray(jsampler.sigma_schedule(x0.shape)[10:12], np.float32)
    want = jax.jit(lambda x: jsampler.long_step(
        lambda x, s, c, cfg_scale=None, **kw: jden(jnet, x, s, c), x, jnp.asarray(pair),
        tuple(tuple(t) for t in tiles), jcond, juc))(jnp.asarray(x0))

    cond = {k: torch.from_numpy(v) for k, v in cond_np.items()}
    uc = dict(cond, crossattn=torch.zeros_like(cond["crossattn"]))
    sampler = RFSamplerLong(**SAMPLER)
    with torch.no_grad():
        got = sampler.long_step(_port_denoise_fn(params, cfg), torch.from_numpy(x0),
                                (float(pair[0]), float(pair[1])), tiles, cond, uc)
    assert got.dtype == torch.float32 and got.shape == x0.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="two tiles"):
        sampler.long_step(None, torch.from_numpy(x0), (1.0, 0.9), tiles[:1], cond, uc)


def _tiny_cli_yaml(tmp_path, long=False):
    """The tiny model config as a CLI YAML; `long` swaps in RFSamplerLong
    with tiles of 2 latent frames overlapping by 1 (YAML args)."""
    from scail_tpu.testing import tiny_model_config

    mc = tiny_model_config()
    mc["network_config"]["params"].update(text_dim=16, clip_dim=32)
    mc["conditioner_config"] = {"target": "sgm.modules.GeneralConditioner", "params": {
        "emb_models": [{"is_trainable": False, "input_key": "txt", "ucg_rate": 0.1,
                        "legacy_ucg_val": "",
                        "target": "sgm.modules.encoders.umt5.T5EncoderModel",
                        "params": {"max_length": 12}}]}}
    mc["i2v_clip_config"] = {"target": "sgm.modules.encoders.clip.CLIPModel", "params": {}}
    args = {"bf16": False, "output_dir": str(tmp_path / "out")}
    if long:
        mc["sampler_config"]["target"] = "sgm.modules.diffusionmodules.sampling.RFSamplerLong"
        args.update(long_tile=2, long_overlap=1)
    path = tmp_path / ("tiny_long.yaml" if long else "tiny.yaml")
    path.write_text(yaml.safe_dump({"model": mc, "args": args}))
    return str(path)


def _answer_tiny_request(tmp_path, monkeypatch, long=False):
    """The port's sampling CLI on examples_synth/001 (9 frames, 3 latent
    frames) at 32x64, 2 steps, --device cpu, with the YAML's text/CLIP/VAE
    wrappers at toy widths.  Returns (records, the DiT forwards' (batch,
    latent frames))."""
    import scail_tpu_torch.cli.sample_video as sv
    from scail_tpu_torch.models.clip_vit import ClipVisionConfig
    from scail_tpu_torch.models.umt5 import UMT5Config
    from scail_tpu_torch.models.wan_vae import WanVAEConfig
    from scail_tpu_torch.ops import attention as port_attention

    real_engine = sv.VideoDiffusionEngine

    def tiny_engine(model_config, args=None, device="cuda"):
        # the YAML's text/CLIP/VAE wrappers at toy widths; init_params then
        # initialises only the DiT
        eng = real_engine(model_config, args, device=device)
        g = torch.Generator().manual_seed(0)
        eng.conditioner.embedders[0].init(g, UMT5Config(
            vocab_size=300, dim=16, dim_attn=16, dim_ffn=24, num_heads=2, num_layers=1,
            num_buckets=8, dtype="float32"))
        eng.i2v_clip.init(g, ClipVisionConfig(image_size=28, patch_size=14, dim=32,
                                              num_heads=2, num_layers=2, dtype="float32"))
        eng.first_stage_model.init(g, WanVAEConfig(dim=8, z_dim=16, dim_mult=(1, 1, 2, 2),
                                                   num_res_blocks=1, dtype="float32"))
        return eng

    forwards = []
    real_forward = DiT.forward

    def forward(self, x, *a, **kw):
        forwards.append((x.shape[0], x.shape[1]))
        return real_forward(self, x, *a, **kw)

    monkeypatch.setattr(sv, "VideoDiffusionEngine", tiny_engine)
    monkeypatch.setattr(DiT, "forward", forward)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text(f"a character dancing@@{os.path.join(ROOT, 'examples_synth', '001')}\n")
    port_attention.reset_launch_counts()
    records = sv.main(["--base", _tiny_cli_yaml(tmp_path, long), "--input-type", "txt",
                       "--input-file", str(prompts), "--sampling-steps", "2",
                       "--image-size", "32", "64", "--device", "cpu"])
    assert len(records) == 1
    rec = records[0]
    assert rec["finite"] and rec["frames"] == 9
    assert set(rec["phases"]) == {"prepare", "sample", "decode", "save"}
    out = rec["outputs"][0]
    assert os.path.basename(out) == "001_output_000000.mp4"
    assert load_video_frames(out)[0].shape == (9, 32, 64, 3)
    assert all(v == 0 for v in port_attention.LAUNCHES.values())
    return records, forwards


def test_cli_answers_a_request_on_cpu(tmp_path, monkeypatch):
    _, forwards = _answer_tiny_request(tmp_path, monkeypatch)
    assert forwards == [(2, 3)] * 2  # one CFG-batch forward of the whole latent per step


def test_cli_answers_a_long_clip_request_on_cpu(tmp_path, monkeypatch):
    """RFSamplerLong through the CLI (the counterpart of tests/test_cli.py's
    long-clip run): 3 latent frames in tiles [0, 1] and [1, 2], so each of
    the 2 steps denoises both tiles of the one pair at CFG batch 2."""
    _, forwards = _answer_tiny_request(tmp_path, monkeypatch, long=True)
    assert forwards == [(2, 2)] * 4


def test_clip_writer_round_trips_frames(tmp_path):
    """One MPEG-4 clip per batch element, streams side by side; decoded frames
    keep count, size and (within codec loss) content."""
    rng = np.random.default_rng(0)
    smooth = np.linspace(0.0, 1.0, 64, dtype=np.float32)[None, None, None, None, :]
    a = np.broadcast_to(smooth, (2, 5, 3, 32, 64)).copy()
    b = rng.uniform(0.4, 0.6, (2, 5, 3, 32, 64)).astype(np.float32)
    paths = save_multi_video_grid_and_mp4([a, b], str(tmp_path), fps=16.0, key="clip")
    assert [os.path.basename(p) for p in paths] == ["clip_000000.mp4", "clip_000001.mp4"]
    for p in paths:
        frames, fps = load_video_frames(p)
        assert frames.shape == (5, 32, 128, 3) and abs(fps - 16.0) < 1e-6
        # the left panel is a horizontal ramp 0..255
        ramp = frames[:, 8:24, 4:60].astype(np.float32).mean(axis=(0, 1, 3))
        assert np.all(np.diff(ramp) > -4.0) and ramp[-1] - ramp[0] > 180


def test_cli_device_cuda_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from scail_tpu_torch.cli.sample_video import main

    prompts = tmp_path / "p.txt"
    prompts.write_text("x@@examples_synth/001\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--base", _tiny_cli_yaml(tmp_path), "--input-type", "txt",
              "--input-file", str(prompts), "--device", "cuda"])


def test_engine_device_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from scail_tpu.testing import tiny_model_config
    from scail_tpu_torch.engine import VideoDiffusionEngine

    with pytest.raises(RuntimeError, match="CUDA"):
        VideoDiffusionEngine(tiny_model_config(), device="cuda")


def test_profiler_groups_kernels_and_needs_cuda(tmp_path):
    from scail_tpu_torch.cli import profile

    names = {"void scail::flash_fwd_kernel<1>(__nv_bfloat16 const*": "flash_attention",
             "void scail::flash_fwd_kernel<0>(__nv_bfloat16 const*": "flash_attention_norope",
             "void scail::flash_bwd_dkv_kernel(__nv_bfloat16 const": "flash_attention_bwd",
             "void scail::sta_fwd_kernel<true>(__nv_bfloat16 const": "sta_attention",
             "void scail::sta_bwd_dq_kernel(__nv_bfloat16 const*,": "sta_attention_bwd",
             "scail::dual_cross_kernel(__nv_bfloat16 const*, __nv_": "dual_cross_attention",
             "void scail::adaln_ln_kernel<6, __nv_bfloat16>(__nv_b": "adaln_layer_norm",
             "scail::rotary_kernel(__nv_bfloat16 const*, float con": "rotary",
             "sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_n": "conv",
             "nvjet_tst_192x192_64x4_1x2_h_bz_coopB_bias_TNN": "gemm",
             "void cudnn::engines_precompiled::nchwToNhwcKernel<__": "copy",
             "void at::native::vectorized_elementwise_kernel<4, at": "other"}
    assert {n: profile._group(n) for n in names} == names
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profile.main(["--out", str(tmp_path)])


_SIG = "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, float const*, "


@pytest.mark.parametrize("name, group", [
    ("void scail::flash_fwd_kernel<1>" + _SIG, "flash_attention"),
    ("void scail::flash_fwd_kernel<2>" + _SIG, "flash_attention"),
    ("void scail::flash_fwd_kernel<0>" + _SIG, "flash_attention_norope"),
    ("void scail::flash_int8_kernel(CUtensorMap_st, CUtensorMap_st", "flash_attention_int8"),
    ("void scail::flash_bwd_dq_kernel<2>(CUtensorMap_st, CUtensorMap_st", "flash_attention_bwd"),
])
def test_profiler_groups_the_wgmma_flash_forward(name, group):
    """K1 (flash_fwd_kernel<1> and <2>) and K2 (<0>) under the names the
    profiler reads for the wgmma kernel, which takes tensor maps: each in its
    own group, and no other kernel in theirs."""
    from scail_tpu_torch.cli import profile

    assert profile._group(name) == group


def test_profiler_reads_clock_and_power_samples():
    """The SM clock and board power beside a profiled call: nvidia-smi's
    `clocks.sm, power.draw` lines, unreadable ones skipped."""
    from scail_tpu_torch.cli import profile

    stats = profile._clock_stats(["1980, 310.52", "1755, 699.10", "[N/A], [N/A]", "",
                                  "1830, 650.00"])
    assert stats == {"samples": 3, "sm_clock_mhz_mean": 1855.0, "sm_clock_mhz_min": 1755.0,
                     "power_w_mean": (310.52 + 699.10 + 650.00) / 3, "power_w_max": 699.10}
    assert profile._clock_stats(["[N/A], [N/A]"]) is None


# modules of JAX, of ml_dtypes (JAX's bf16 for numpy) or of the JAX package
# (but not of scail_tpu_torch)
_FOREIGN = ("m == 'jax' or m.startswith('jax.') or m == 'scail_tpu' "
            "or m.startswith('scail_tpu.') or m == 'ml_dtypes'")


def test_port_never_imports_jax():
    """Every module of scail_tpu_torch imports in a fresh interpreter without
    pulling in jax or any module of the JAX package scail_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import scail_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(scail_tpu_torch.__path__, "
        "'scail_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'scail_tpu_torch.cli.sample_video' in names, names\n"
        "assert 'scail_tpu_torch.cli.train' in names, names\n"
        "for m in ('ops.quant', 'ops.fused_norms', 'cli.bench_14b_quant', "
        "'cli.bench_14b_e2e', 'convert.torch_ckpt', 'convert.wan_vae_ckpt', "
        "'training.lora', 'parallel.mesh', 'parallel.comm', 'parallel.distributed', "
        "'parallel.sharding', 'parallel.ulysses', 'parallel.ring', "
        "'parallel.cross_entropy', 'diffusion.embedders', 'models.unet', "
        "'autoencoding.vqgan', 'autoencoding.regularizers', 'autoencoding.autoencoder_kl', "
        "'inference.api', 'inference.engine', 'inference.helpers', 'inference.watermark', "
        "'utils.logging', 'utils.timers', 'utils.metrics_writers', 'utils.profiling', "
        "'training.sync', 'autoencoding.discriminator', 'autoencoding.gan_loss', "
        "'autoencoding.video_tokenizer', 'autoencoding.engine', "
        "'models.video_unet', 'ops.moe', 'ops.local_attn_2d', 'generation', "
        "'training.prefix_tuning', 'models.zoo.common', 'models.zoo.llama', "
        "'models.zoo.mixtral', 'models.zoo.gpt', 'models.zoo.gptneo', 'models.zoo.glm', "
        "'models.zoo.chatglm', 'models.zoo.chatglm23', 'models.zoo.glm130b', "
        "'models.zoo.glmblock', 'models.zoo.cuda2d', 'models.zoo.bert', 'models.zoo.dpr', "
        "'models.zoo.t5', 'models.zoo.vit', 'models.zoo.cait', 'models.zoo.eva2', "
        "'models.zoo.evaclip', 'models.zoo.glm4v', 'models.zoo.mae', 'models.zoo.yolos', "
        "'training.adapters', 'training.distill', 'tokenization', 'tokenization.core', "
        "'tokenization.text', 'tokenization.glm', 'tokenization.image'):\n"
        "    assert 'scail_tpu_torch.' + m in names, names\n"
        f"bad = [m for m in sys.modules if {_FOREIGN}]\n"
        "assert not bad, bad[:5]\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_port_sources_never_import_jax_or_the_jax_package():
    """No source of scail_tpu_torch/, nor chip_smoke.py, imports jax,
    ml_dtypes or scail_tpu, by statement or by importlib."""
    pattern = re.compile(r"^\s*(?:from|import)\s+(?:jax|ml_dtypes|scail_tpu)(?:[.\s,]|$)"
                         r"|import_module\(\s*[\"'](?:jax|ml_dtypes|scail_tpu)[\"'.]", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "scail_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) >= 30
    for new in ("ops/quant.py", "ops/fused_norms.py", "cli/bench_14b_quant.py",
                "cli/bench_14b_e2e.py", "convert/torch_ckpt.py", "convert/wan_vae_ckpt.py",
                "training/lora.py", "parallel/mesh.py", "parallel/comm.py",
                "parallel/distributed.py", "parallel/sharding.py", "parallel/ulysses.py",
                "parallel/ring.py", "parallel/cross_entropy.py", "diffusion/embedders.py",
                "models/unet.py", "autoencoding/vqgan.py", "autoencoding/regularizers.py",
                "autoencoding/autoencoder_kl.py", "inference/api.py", "inference/engine.py",
                "inference/helpers.py", "inference/watermark.py", "utils/logging.py",
                "utils/timers.py", "utils/metrics_writers.py", "utils/profiling.py",
                "training/sync.py", "autoencoding/discriminator.py", "autoencoding/gan_loss.py",
                "autoencoding/video_tokenizer.py", "autoencoding/engine.py",
                "models/video_unet.py", "ops/moe.py", "ops/local_attn_2d.py", "generation.py",
                "training/prefix_tuning.py", "models/zoo/common.py", "models/zoo/llama.py",
                "models/zoo/mixtral.py", "models/zoo/gpt.py", "models/zoo/gptneo.py",
                "models/zoo/glm.py", "models/zoo/chatglm.py", "models/zoo/chatglm23.py",
                "models/zoo/glm130b.py", "models/zoo/glmblock.py", "models/zoo/cuda2d.py",
                "models/zoo/bert.py", "models/zoo/dpr.py", "models/zoo/t5.py", "models/zoo/vit.py",
                "models/zoo/cait.py", "models/zoo/eva2.py", "models/zoo/evaclip.py",
                "models/zoo/glm4v.py", "models/zoo/mae.py", "models/zoo/yolos.py",
                "training/adapters.py", "training/distill.py", "tokenization/__init__.py",
                "tokenization/core.py", "tokenization/text.py", "tokenization/glm.py",
                "tokenization/image.py"):
        assert os.path.join(ROOT, "scail_tpu_torch", new) in files, new
    bad = {os.path.relpath(f, ROOT): m.group(0).strip() for f in files
           for m in [pattern.search(open(f).read())] if m}
    assert not bad, bad
    assert pattern.search("from scail_tpu.data import video") and \
        pattern.search("import jax.numpy as jnp") and pattern.search("import ml_dtypes") and \
        not pattern.search("from scail_tpu_torch.ops import attention")


def test_train_cli_runs_without_jax_or_the_jax_package(tmp_path):
    """The CPU train CLI at toy size, in a fresh interpreter: it trains an
    iteration and leaves no module of jax or scail_tpu in sys.modules."""
    from test_torch_training import _make_data_root, _toy_engine, _toy_train_yaml

    root = _make_data_root(str(tmp_path / "data"))
    code = (
        "import sys\n"
        "import torch\n"
        + inspect.getsource(_toy_engine) +
        "import scail_tpu_torch.engine as e\n"
        "from scail_tpu_torch.cli import train\n"
        "e.VideoDiffusionEngine = _toy_engine(e.VideoDiffusionEngine)\n"
        f"t = train.main(['--base', {_toy_train_yaml(tmp_path)!r}, '--data-root', {root!r}, "
        "'--train-iters', '1', '--image-size', '32', '32', '--num-frames', '5', "
        "'--device', 'cpu'])\n"
        "assert t.step == 1 and t.history[0]['ok'], t.history\n"
        f"bad = [m for m in sys.modules if {_FOREIGN}]\n"
        "assert not bad, bad[:5]\n"
        "print('trained', t.step)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "trained 1" in out.stdout


def test_reference_yaml_builds_each_package_through_its_own_registry():
    from scail_tpu.utils.registry import instantiate_from_config as jax_instantiate

    with open(os.path.join(ROOT, "configs", "video_model", "scail_1p3b.yaml")) as f:
        model = yaml.safe_load(f)["model"]
    keys = ("network_config", "denoiser_config", "sampler_config", "conditioner_config",
            "i2v_clip_config", "first_stage_config")
    for key in keys:
        port = instantiate_from_config(model[key])
        ref = jax_instantiate(model[key])
        assert type(port).__module__.startswith("scail_tpu_torch."), (key, type(port))
        assert type(ref).__module__.startswith("scail_tpu."), (key, type(ref))
        assert type(port).__name__ == type(ref).__name__
    # and again in the other order: neither registry shadows the other
    port = instantiate_from_config(model["network_config"])
    assert type(port).__module__ == "scail_tpu_torch.models.dit"
    assert port.config.hidden_size == 1536 and port.config.num_layers == 30
