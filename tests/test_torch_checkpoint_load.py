"""The port's loaders of the released checkpoints against the JAX package's
converters, on the same files, on the CPU.

* The SAT DiT (tests/oracles.py OracleDiT, the tests/test_dit.py geometry),
  written as <dir>/1/mp_rank_00_model_states.pt with `latest`, in f32 and
  bf16: the JAX chain (resolve_latest_checkpoint, load_torch_state_dict,
  dit_params_from_state_dict, then the weight bridge) and the port's loader
  give equal tensors; the loaded DiT matches the oracle at 2e-4.
* The Wan VAE (tests/oracle_vae.py), umt5 and CLIP (the oracles of
  tests/test_encoders.py, their keys renamed to the reference names as
  there): equal tensors, then the loaded models against the oracles (VAE
  encode at 2e-4, umt5 and CLIP at 3e-4).
* A missing key and a mis-shaped tensor raise and name the key.
* `sample_video --load` and `train --load` on the CPU with a tiny YAML whose
  four paths name such files.
"""

import functools
import os

import numpy as np
import pytest
import torch
import yaml

from oracle_vae import OracleWanVAE
from oracles import OracleDiT
from test_dit import TINY as ORACLE_TINY
from test_dit import make_inputs, tiny_cfg
from test_encoders import _ClipViT, _T5Enc

from scail_tpu.convert import torch_ckpt as jckpt
from scail_tpu.convert.wan_vae_ckpt import load_wan_vae_params
from scail_tpu.models import clip_vit as jclip
from scail_tpu.models import umt5 as jt5
from scail_tpu_torch.convert import from_jax, torch_ckpt
from scail_tpu_torch.convert.wan_vae_ckpt import wan_vae_source, wan_vae_state_dict_from_torch
from scail_tpu_torch.models import clip_vit as tclip
from scail_tpu_torch.models import umt5 as tt5
from scail_tpu_torch.models import wan_vae as tvae
from scail_tpu_torch.models.dit import DiT, DiTConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TINY = DiTConfig(hidden_size=32, num_layers=2, num_heads=2, inner_hidden_size=48,
                      in_channels=20, out_channels=16, text_dim=12, time_freq_dim=16,
                      time_embed_dim=32, clip_dim=10, share_adaln=True, use_i2v_clip=True,
                      qk_ln=True, interleaved_rope=True, dtype="float32")
VAE_KW = dict(dim=8, z_dim=4, dim_mult=(1, 1, 2, 2), num_res_blocks=1,
              temporal_downsample=(False, True, True), dtype="float32")
T5_KW = dict(vocab_size=100, dim=32, dim_attn=32, dim_ffn=48, num_heads=4, num_layers=2,
             num_buckets=8, dtype="float32")
CLIP_KW = dict(image_size=32, patch_size=8, dim=32, num_heads=4, num_layers=3, dtype="float32")


def _write_sat(load_dir, sd, dtype=torch.float32, **save_kw):
    """`sd` under the SAT prefix as <load_dir>/1/mp_rank_00_model_states.pt
    with {'module': ...}, plus the `latest` tracker."""
    os.makedirs(os.path.join(load_dir, "1"), exist_ok=True)
    module = {torch_ckpt.SAT_PREFIX + k: v.detach().to(dtype) for k, v in sd.items()}
    torch.save({"module": module, "iteration": 1},
               os.path.join(load_dir, "1", "mp_rank_00_model_states.pt"), **save_kw)
    with open(os.path.join(load_dir, "latest"), "w") as f:
        f.write("1")
    return str(load_dir)


def _oracle_dit(**over):
    torch.manual_seed(0)
    return OracleDiT(**dict(ORACLE_TINY, **over))


def _jax_dit_state(load_dir, cfg):
    """The JAX package's chain from the directory, bridged to DiT names (f32)."""
    sd = jckpt.load_torch_state_dict(jckpt.resolve_latest_checkpoint(load_dir))
    return from_jax.dit_state_dict_from_jax(jckpt.dit_params_from_state_dict(sd, cfg))


def _port_dit_state(load_dir):
    sd = torch_ckpt.load_torch_state_dict(torch_ckpt.resolve_latest_checkpoint(load_dir))
    return torch_ckpt.dit_state_dict_from_sat(sd, PORT_TINY)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dit_loader_matches_the_jax_converter(tmp_path, dtype):
    load_dir = _write_sat(tmp_path, _oracle_dit().state_dict(), dtype)
    want = _jax_dit_state(load_dir, tiny_cfg())
    got = _port_dit_state(load_dir)
    assert set(got) == set(want) == set(DiT(PORT_TINY, device="meta").state_dict())
    for k in want:
        assert got[k].dtype == dtype, k  # the stored dtype is kept
        assert torch.equal(got[k].float(), want[k]), k


def test_dit_loader_reads_a_legacy_file(tmp_path):
    """A file in torch's pre-zipfile format takes the plain load."""
    oracle = _oracle_dit()
    legacy = _write_sat(tmp_path / "legacy", oracle.state_dict(),
                        _use_new_zipfile_serialization=False)
    got = _port_dit_state(legacy)
    want = _port_dit_state(_write_sat(tmp_path / "zip", oracle.state_dict()))
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_loaded_dit_matches_the_oracle(tmp_path, rng):
    """load_dit_ fills a DiT built on the meta device; its forward holds
    against OracleDiT as tests/test_dit.py holds the JAX DiT."""
    oracle = _oracle_dit()
    load_dir = _write_sat(tmp_path, oracle.state_dict())
    dit = DiT(PORT_TINY, device="meta")
    sd = torch_ckpt.load_torch_state_dict(torch_ckpt.resolve_latest_checkpoint(load_dir))
    torch_ckpt.load_dit_(dit, sd, device=torch.device("cpu"), dtype=torch.float32)
    assert all(p.device.type == "cpu" and p.dtype == torch.float32 for p in dit.parameters())
    inp = {k: torch.from_numpy(v) for k, v in make_inputs(rng).items()}
    with torch.no_grad():
        want = oracle(inp["x"], inp["timesteps"], inp["context"], inp["ref_concat"],
                      inp["pose"], inp["clip"]).numpy()
        got = dit(inp["x"], inp["timesteps"], inp["context"], ref_concat=inp["ref_concat"],
                  concat_smpl_render=inp["pose"], image_clip_features=inp["clip"]).numpy()
    assert got.shape == want.shape == (1, 2, 16, 8, 8)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_dit_checkpoint_missing_a_key_raises_and_names_it(tmp_path):
    sd = _oracle_dit().state_dict()
    del sd["transformer.layers.1.cross_attention.key_value.bias"]
    load_dir = _write_sat(tmp_path, sd)
    dit = DiT(PORT_TINY, device="meta")
    sat = torch_ckpt.load_torch_state_dict(torch_ckpt.resolve_latest_checkpoint(load_dir))
    with pytest.raises(KeyError, match=r"layers\.1\.cross_kv\.bias.*"
                                        r"model\.diffusion_model\.transformer\.layers\.1\."
                                        r"cross_attention\.key_value\.bias"):
        torch_ckpt.load_dit_(dit, sat, device="cpu", dtype=torch.float32)


def test_dit_checkpoint_with_a_wrong_shape_raises_and_names_it(tmp_path):
    sd = _oracle_dit().state_dict()
    sd["mixins.adaln_layer.query_layernorm_list.0.weight"] = torch.ones(31)
    load_dir = _write_sat(tmp_path, sd)
    dit = DiT(PORT_TINY, device="meta")
    sat = torch_ckpt.load_torch_state_dict(torch_ckpt.resolve_latest_checkpoint(load_dir))
    with pytest.raises(ValueError, match=r"query_layernorm_list\.0\.weight' has shape \(31,\), "
                                         r"parameter 'layers\.0\.q_norm\.scale' needs \(32,\)"):
        torch_ckpt.load_dit_(dit, sat, device="cpu", dtype=torch.float32)


def test_wan_vae_loader_matches_the_jax_converter(tmp_path, rng):
    torch.manual_seed(0)
    oracle = OracleWanVAE(dim=8, z_dim=4, dim_mult=(1, 1, 2, 2), num_res_blocks=1,
                          temporal_down=(False, True, True))
    path = str(tmp_path / "Wan2.1_VAE.pth")
    torch.save(oracle.state_dict(), path)
    cfg = tvae.WanVAEConfig(**VAE_KW)
    want = from_jax.wan_vae_state_dict_from_jax(load_wan_vae_params(path))
    got = wan_vae_state_dict_from_torch(torch_ckpt.load_torch_state_dict(path), cfg)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)

    model = tvae.WanVAEModel(cfg, device="meta")
    torch_ckpt.load_mapped_(model, torch_ckpt.load_torch_state_dict(path), wan_vae_source,
                            what="Wan VAE")
    video = rng.standard_normal((1, 9, 3, 16, 16)).astype(np.float32) * 0.5
    mu_ref = oracle.encode_streamed(torch.tensor(video).permute(0, 2, 1, 3, 4))
    with torch.no_grad():
        got = tvae.vae_encode(model, cfg, torch.from_numpy(video), streamed=True)
    assert got.shape == (1, 3, 4, 2, 2)
    np.testing.assert_allclose(got.numpy(), mu_ref.permute(0, 2, 1, 3, 4).numpy(),
                               rtol=2e-4, atol=2e-4)


def _umt5_oracle_file(path, vocab, d, dff, nh, layers, buckets):
    """A _T5Enc's weights under the reference names, as test_encoders renames them."""
    torch.manual_seed(0)
    oracle = _T5Enc(vocab, d, dff, nh, layers, buckets)
    sd = {k.replace(".gate0.", ".gate.0.").replace(".pos.embedding.", ".pos_embedding.embedding."):
          v for k, v in oracle.state_dict().items()}
    torch.save(sd, path)
    return oracle


def _clip_oracle_file(path, prefix="", **kw):
    """A _ClipViT's weights under the reference names, as test_encoders renames them."""
    torch.manual_seed(1)
    oracle = _ClipViT(**kw)
    sd = {}
    for k, v in oracle.state_dict().items():
        k = (k.replace("blocks.", "transformer.").replace(".attn_qkv.", ".attn.to_qkv.")
             .replace(".attn_proj.", ".attn.proj.").replace(".mlp0.", ".mlp.0.")
             .replace(".mlp2.", ".mlp.2."))
        sd[prefix + k] = v
    torch.save(sd, path)
    return oracle


def test_umt5_loader_matches_the_jax_converter(tmp_path, rng, monkeypatch):
    path = str(tmp_path / "umt5.pth")
    oracle = _umt5_oracle_file(path, 100, 32, 48, 4, 2, 8)
    want = from_jax.umt5_state_dict_from_jax(jt5.umt5_params_from_state_dict(
        jckpt.load_torch_state_dict(path), jt5.UMT5Config(**T5_KW)))
    got = tt5.umt5_state_dict_from_torch(torch_ckpt.load_torch_state_dict(path),
                                         tt5.UMT5Config(**T5_KW))
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)

    # through the conditioner's wrapper, at this geometry
    monkeypatch.setattr(tt5, "UMT5Config", functools.partial(tt5.UMT5Config, **T5_KW))
    wrapper = tt5.T5EncoderModel(max_length=11, checkpoint_path=path, dtype="float32")
    assert wrapper.checkpoint_path == path and wrapper.tokenizer.vocab_size == 100
    ids = rng.integers(2, 100, (2, 11))
    mask = np.ones((2, 11), np.int64)
    mask[0, 8:] = 0
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        np.testing.assert_allclose(wrapper.model(ids, mask).numpy(), oracle(ids, mask).numpy(),
                                   rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("prefix", ["visual.", ""])
def test_clip_loader_matches_the_jax_converter(tmp_path, rng, monkeypatch, prefix):
    path = str(tmp_path / "clip.pth")
    oracle = _clip_oracle_file(path, prefix, d=32, nh=4, L=3, patch=8, img=32)
    want = from_jax.clip_vision_state_dict_from_jax(jclip.clip_vision_params_from_state_dict(
        jckpt.load_torch_state_dict(path), jclip.ClipVisionConfig(**CLIP_KW)))
    got = tclip.clip_vision_state_dict_from_torch(torch_ckpt.load_torch_state_dict(path),
                                                  tclip.ClipVisionConfig(**CLIP_KW))
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)

    monkeypatch.setattr(tclip, "ClipVisionConfig",
                        functools.partial(tclip.ClipVisionConfig, **CLIP_KW))
    wrapper = tclip.CLIPModel(dtype="float32", checkpoint_path=path)
    imgs = torch.from_numpy(rng.standard_normal((2, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        got = wrapper.model(imgs).numpy()
        want = oracle(imgs).numpy()
    assert got.shape == want.shape == (2, 17, 32)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


# ---------------------------------------------------------------------------
# the CLIs at the toy geometry of tests/test_torch_sampling.py
# ---------------------------------------------------------------------------
TOY_T5 = dict(vocab_size=300, dim=16, dim_attn=16, dim_ffn=24, num_heads=2, num_layers=1,
              num_buckets=8)
TOY_CLIP = dict(image_size=28, patch_size=14, dim=32, num_heads=2, num_layers=2)
TOY_VAE = dict(dim=8, dim_mult=(1, 1, 2, 2), num_res_blocks=1)


def _toy_files(root):
    """The four files of the toy geometry under `root`, and the JAX chain's
    reading of each, bridged to the port's names (f32)."""
    from scail_tpu.models.dit import DiTConfig as JaxDiTConfig
    from scail_tpu.testing import tiny_model_config

    os.makedirs(root, exist_ok=True)
    p = dict(tiny_model_config()["network_config"]["params"], text_dim=16, clip_dim=32)
    ckpt = _write_sat(os.path.join(root, "ckpt"), _oracle_dit(
        hidden=p["hidden_size"], heads=p["num_attention_heads"], layers=p["num_layers"],
        inner=p["inner_hidden_size"], text_dim=16, time_freq=p["time_freq_dim"],
        clip_dim=32).state_dict())
    jcfg = JaxDiTConfig.from_network_config(dict(p, use_i2v_clip=True, dtype="fp32"))
    vae = os.path.join(root, "Wan2.1_VAE.pth")
    torch.manual_seed(2)
    torch.save(OracleWanVAE(z_dim=16, **TOY_VAE).state_dict(), vae)
    t5 = os.path.join(root, "umt5.pth")
    _umt5_oracle_file(t5, 300, 16, 24, 2, 1, 8)
    clip = os.path.join(root, "clip.pth")
    _clip_oracle_file(clip, "visual.", d=32, nh=2, L=2, patch=14, img=28)
    want = {
        "dit": _jax_dit_state(ckpt, jcfg),
        "vae": from_jax.wan_vae_state_dict_from_jax(load_wan_vae_params(vae)),
        "umt5": from_jax.umt5_state_dict_from_jax(jt5.umt5_params_from_state_dict(
            jckpt.load_torch_state_dict(t5), jt5.UMT5Config(**TOY_T5))),
        "clip": from_jax.clip_vision_state_dict_from_jax(jclip.clip_vision_params_from_state_dict(
            jckpt.load_torch_state_dict(clip), jclip.ClipVisionConfig(**TOY_CLIP))),
    }
    return dict(ckpt=ckpt, vae=vae, umt5=t5, clip=clip), want


def _toy_yaml(tmp_path, files, args):
    """The toy model config with the four paths (f32 everywhere)."""
    from scail_tpu.testing import tiny_model_config

    mc = tiny_model_config()
    mc["network_config"]["params"].update(text_dim=16, clip_dim=32)
    mc["first_stage_config"]["params"].update(vae_pth=files["vae"], dtype="torch.float32")
    mc["conditioner_config"] = {"target": "sgm.modules.GeneralConditioner", "params": {
        "emb_models": [{"is_trainable": False, "input_key": "txt", "ucg_rate": 0.1,
                        "legacy_ucg_val": "",
                        "target": "sgm.modules.encoders.umt5.T5EncoderModel",
                        "params": {"max_length": 12, "dtype": "float32",
                                   "checkpoint_path": files["umt5"],
                                   "tokenizer_path": str(tmp_path / "no_tokenizer")}}]}}
    mc["i2v_clip_config"] = {"target": "sgm.modules.encoders.clip.CLIPModel",
                             "params": {"dtype": "float32", "checkpoint_path": files["clip"]}}
    path = tmp_path / "toy_load.yaml"
    path.write_text(yaml.safe_dump({"model": mc, "args": args}))
    return str(path)


@pytest.fixture
def toy_geometry(monkeypatch):
    """The wrappers' configs at the toy geometry, as the files have it."""
    monkeypatch.setattr(tt5, "UMT5Config", functools.partial(tt5.UMT5Config, **TOY_T5))
    monkeypatch.setattr(tclip, "ClipVisionConfig",
                        functools.partial(tclip.ClipVisionConfig, **TOY_CLIP))
    monkeypatch.setattr(tvae, "WanVAEConfig", functools.partial(tvae.WanVAEConfig, **TOY_VAE))


def _capture_engines(monkeypatch, module):
    engines = []
    real = module.VideoDiffusionEngine

    def make(*a, **kw):
        engines.append(real(*a, **kw))
        return engines[-1]

    monkeypatch.setattr(module, "VideoDiffusionEngine", make)
    return engines


def _assert_holds(module, want):
    got = module.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert got[k].device.type == "cpu" and torch.equal(got[k], want[k]), k


def test_sample_cli_load_answers_a_request_on_cpu(tmp_path, monkeypatch, toy_geometry):
    import scail_tpu_torch.cli.sample_video as sv

    files, want = _toy_files(str(tmp_path / "files"))
    engines = _capture_engines(monkeypatch, sv)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text(f"a character dancing@@{os.path.join(ROOT, 'examples_synth', '001')}\n")
    base = _toy_yaml(tmp_path, files, {"bf16": False, "output_dir": str(tmp_path / "out")})
    argv = ["--base", base, "--input-type", "txt", "--input-file", str(prompts),
            "--sampling-steps", "2", "--image-size", "32", "64", "--device", "cpu"]
    records = sv.main(argv + ["--load", files["ckpt"]])
    assert len(records) == 1 and records[0]["finite"] and records[0]["frames"] == 9
    eng = engines[0]
    _assert_holds(eng.dit, want["dit"])
    _assert_holds(eng.first_stage_model.model, want["vae"])
    _assert_holds(eng.conditioner.embedders[0].model, want["umt5"])
    _assert_holds(eng.i2v_clip.model, want["clip"])
    assert [r["what"] for r in eng.weight_loads] == ["Wan VAE", "CLIP", "text encoder", "DiT"]
    eng.init_params(torch.Generator().manual_seed(5))  # random-inits only what has no weights
    _assert_holds(eng.dit, want["dit"])
    _assert_holds(eng.conditioner.embedders[0].model, want["umt5"])

    # a directory that exists but holds no checkpoint raises: no random fallback
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="mp_rank_00_model_states.pt"):
        sv.main(argv + ["--load", str(tmp_path / "empty")])


def test_load_checkpoint_needs_every_sub_model_file(tmp_path):
    """An engine whose YAML paths hold no files refuses a DiT checkpoint
    rather than serve it beside random encoders."""
    from scail_tpu.testing import tiny_model_config
    from scail_tpu_torch.engine import VideoDiffusionEngine

    eng = VideoDiffusionEngine(tiny_model_config(), {"bf16": False}, device="cpu")
    with pytest.raises(FileNotFoundError, match="Wan VAE"):
        eng.load_checkpoint(_write_sat(tmp_path, _oracle_dit().state_dict()))


def test_train_cli_load_starts_from_the_file_on_cpu(tmp_path, monkeypatch, toy_geometry):
    """`train --load` fills the trainable DiT in f32 from the file; its first
    loss equals that of the same run whose DiT got the JAX chain's reading of
    the file in memory."""
    import scail_tpu_torch.cli.train as train
    import scail_tpu_torch.engine as engine_mod
    from scail_tpu_torch.training.engine import Trainer
    from test_torch_training import _make_data_root

    files, want = _toy_files(str(tmp_path / "files"))
    engines = _capture_engines(monkeypatch, engine_mod)
    root = _make_data_root(str(tmp_path / "data"))
    argv = ["--base", _toy_yaml(tmp_path, files, {"bf16": False}), "--data-root", root,
            "--train-iters", "1", "--image-size", "32", "32", "--num-frames", "5",
            "--warmup-iters", "1", "--device", "cpu"]
    seen = []
    real_fit = Trainer.fit

    def fit(self, *a, **kw):  # the parameters the first step starts from
        seen.append({n: p.detach().clone() for n, p in self.params.items()})
        return real_fit(self, *a, **kw)

    monkeypatch.setattr(Trainer, "fit", fit)
    loaded = train.main(argv + ["--load", files["ckpt"]])
    assert all(p.dtype == torch.float32 and p.requires_grad for p in engines[0].dit.parameters())
    assert set(seen[0]) == set(want["dit"])
    assert all(torch.equal(seen[0][k], want["dit"][k]) for k in want["dit"])

    cls = type(engines[0])
    real_init = cls.init_params

    def init_params(self, generator, trainable=False):  # the file's tensors, in memory
        out = real_init(self, generator, trainable)
        self.dit.load_state_dict(want["dit"])
        return out

    monkeypatch.setattr(cls, "init_params", init_params)
    in_memory = train.main(argv)
    assert np.isfinite(loaded.history[0]["loss"])
    assert loaded.history[0]["loss"] == in_memory.history[0]["loss"]
