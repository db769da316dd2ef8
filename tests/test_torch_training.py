"""The PyTorch port's training slice against the JAX package, on the CPU.

* RFLoss and the resolution time shift, on the same injected sigma and noise
  (1e-5).
* The tiny DiT's loss and parameter gradients through RFLoss, with remat on
  and off, against jax.grad on weights carried across (2e-4: f32 summation
  order).
* annealing_lr, and three steps of clipping + EMA-Adam against the optax chain
  of the JAX Trainer, the optimizer state carried across by
  ema_adam_state_from_jax (1e-6 relative).
* The weight bridge joins the save_attn_frac split layout (params and
  EMA-Adam state) into the stacked one.
* Trainer: NaN skip, gradient accumulation, exact save/resume, checkpoint GC.
* The train CLI on the CPU at toy size: 2 iterations, a checkpoint, a resume.
* The host helpers the port copied from the JAX package agree with it.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from scail_tpu.models.dit import DiTConfig as JaxDiTConfig
from scail_tpu.models.dit import dit_forward, init_dit_params, split_layer_params
from scail_tpu.training.ema_adam import EmaAdamState as JaxEmaAdamState
from scail_tpu.training.ema_adam import fused_ema_adam
from scail_tpu.training.ema_adam import swap_in_ema as jax_swap_in_ema
from scail_tpu.training.lr_schedules import annealing_lr as jax_annealing_lr
from scail_tpu.utils.registry import instantiate_from_config as jax_instantiate
from scail_tpu_torch.convert.from_jax import dit_state_dict_from_jax, ema_adam_state_from_jax
from scail_tpu_torch.diffusion.loss import RFLoss, time_shift
from scail_tpu_torch.diffusion.sigma_sampling import RFSampling
from scail_tpu_torch.models.dit import DiT, DiTConfig
from scail_tpu_torch.training.checkpoint import CheckpointManager, read_latest
from scail_tpu_torch.training.ema_adam import FusedEmaAdam, clip_by_global_norm_, swap_in_ema
from scail_tpu_torch.training.engine import TrainConfig, Trainer
from scail_tpu_torch.training.lr_schedules import annealing_lr
from scail_tpu_torch.utils.registry import instantiate_from_config

jloss_mod = importlib.import_module("scail_tpu.diffusion.loss")

DENOISER = {"target": "sgm.modules.diffusionmodules.denoiser.Denoiser", "params": dict(
    weighting_config={"target": "sgm.modules.diffusionmodules.denoiser_weighting.EpsWeighting"},
    scaling_config={"target": "sgm.modules.diffusionmodules.denoiser_scaling.RFScaling"})}
TINY = dict(hidden_size=32, num_layers=2, num_heads=2, inner_hidden_size=48, time_embed_dim=32,
            text_dim=16, clip_dim=8, share_adaln=True, use_i2v_clip=True, dtype="float32",
            interleaved_rope=True)


def _case(seed=0, b=2, T=3, H=8, W=8):
    """Latents, conditioning, history mask, sigma and noise as numpy; the noise
    is JAX's own draw for `key`, so RFLoss in JAX sees the same numbers."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    key = jax.random.PRNGKey(seed)
    _, k_noise = jax.random.split(key)
    hist = np.zeros((b, T, 4, H, W), np.float32)
    hist[:, 0] = 1.0  # the first frame is clean history
    return dict(
        key=key, latents=f(b, T, 16, H, W),
        cond=dict(crossattn=f(b, 6, TINY["text_dim"]), ref_concat=f(b, 1, 16, H, W),
                  concat_smpl_render=f(b, T, 16, H // 2, W // 2),
                  image_clip_features=f(b, 5, TINY["clip_dim"])),
        hist=hist, sigma=np.array([0.3, 0.85], np.float32)[:b],
        noise=np.array(jax.random.normal(k_noise, (b, T, 16, H, W), jnp.float32)))


def _jax_rf_loss(case, net):
    loss = jloss_mod.RFLoss(schedule_shift=True)
    loss.sigma_sampler = lambda key, n: jnp.asarray(case["sigma"])
    cond = {k: jnp.asarray(v) for k, v in case["cond"].items()}
    return loss(case["key"], net, jax_instantiate(DENOISER), cond, jnp.asarray(case["latents"]),
                history_mask=jnp.asarray(case["hist"]), patch_size=(1, 2, 2))


def _port_rf_loss(case, net):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return RFLoss(schedule_shift=True)(
        None, net, instantiate_from_config(DENOISER), {k: t(v) for k, v in case["cond"].items()},
        t(case["latents"]), history_mask=t(case["hist"]), patch_size=(1, 2, 2),
        sigma=t(case["sigma"]), noise=t(case["noise"]))


def test_rf_loss_and_time_shift_match_jax():
    case = _case()
    w = np.random.default_rng(1).standard_normal((16,)).astype(np.float32)

    def jnet(x, c_noise, cond, **kw):  # a cheap stand-in network, same in both
        return x * jnp.asarray(w)[:, None, None] + c_noise[:, None, None, None, None] * 1e-3

    def tnet(x, c_noise, cond, **kw):
        return x * torch.from_numpy(w)[:, None, None] + c_noise[:, None, None, None, None] * 1e-3

    want = np.asarray(_jax_rf_loss(case, jnet))
    got = _port_rf_loss(case, tnet).numpy()
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    t = np.linspace(0.01, 0.99, 25, dtype=np.float32)
    for mu in (0.5, 0.8, 1.15):
        np.testing.assert_allclose(time_shift(mu, torch.from_numpy(t)).numpy(),
                                   np.asarray(jloss_mod._time_shift_traced(mu, jnp.asarray(t))),
                                   rtol=1e-5, atol=1e-6)


def test_rf_sampling_draws_a_logistic_normal_from_the_generator():
    s = RFSampling(p_mean=0.3, p_std=0.8)
    a = s(torch.Generator().manual_seed(0), 20000)
    assert a.shape == (20000,) and a.dtype == torch.float32 and ((a > 0) & (a < 1)).all()
    z = torch.logit(a.double())
    assert abs(z.mean().item() - 0.3) < 0.03 and abs(z.std().item() - 0.8) < 0.03
    assert torch.equal(s(torch.Generator().manual_seed(0), (4, 3)),
                       s(torch.Generator().manual_seed(0), (4, 3)))


@pytest.mark.parametrize("remat", [False, True])
def test_tiny_dit_loss_and_grads_match_jax(remat):
    """Without remat the JAX side differentiates through its Pallas kernels'
    custom VJPs; JAX cannot partially evaluate the interpret-mode kernels
    under jax.checkpoint, so with remat it uses its XLA attention."""
    case = _case(seed=3)
    params = init_dit_params(jax.random.PRNGKey(0), JaxDiTConfig(**TINY))
    jcfg = JaxDiTConfig(**TINY, attn_impl="xla" if remat else "pallas", remat=remat)

    def jax_loss(p):
        def net(x, c_noise, cond, **kw):
            return dit_forward(p, jcfg, x, c_noise, cond["crossattn"],
                               ref_concat=cond["ref_concat"],
                               concat_smpl_render=cond["concat_smpl_render"],
                               image_clip_features=cond["image_clip_features"],
                               history_mask=kw.get("history_mask"))
        return jnp.mean(_jax_rf_loss(case, net))

    with pltpu.force_tpu_interpret_mode():
        want_loss, want_grads = jax.value_and_grad(jax_loss)(params)
    model = DiT(DiTConfig(**TINY, remat=remat))
    model.load_state_dict(dit_state_dict_from_jax(params))
    model.requires_grad_(True)

    def net(x, c_noise, cond, **kw):
        return model(x, c_noise, cond["crossattn"], ref_concat=cond["ref_concat"],
                     concat_smpl_render=cond["concat_smpl_render"],
                     image_clip_features=cond["image_clip_features"],
                     history_mask=kw.get("history_mask"))

    loss = _port_rf_loss(case, net).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-4)
    want = dit_state_dict_from_jax(want_grads)
    grads = dict(model.named_parameters())
    assert set(grads) == set(want)
    for n, g in want.items():
        np.testing.assert_allclose(grads[n].grad.numpy(), g.numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=n)


@pytest.mark.parametrize("style", ["linear", "cosine", "exponential", "constant"])
def test_annealing_lr_matches_jax(style):
    want, got = jax_annealing_lr(3e-4, 3, 10, style, 0.1), annealing_lr(3e-4, 3, 10, style, 0.1)
    for step in range(13):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


def test_clip_and_ema_adam_match_the_optax_chain():
    """Three steps of clip_by_global_norm + fused EMA-Adam, from a JAX state
    carried across after one JAX step; clipping triggers on some steps."""
    params = init_dit_params(jax.random.PRNGKey(0), JaxDiTConfig(**TINY))
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     fused_ema_adam(jax_annealing_lr(1e-3, 2, 10, "cosine", 0.1),
                                    weight_decay=0.01, ema_decay=0.99))
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * s), params)
        for s in (0.01, 1.0, 0.001, 0.05)]
    state = tx.init(params)
    updates, state = tx.update(grads[0], state, params)
    params = optax.apply_updates(params, updates)

    opt = FusedEmaAdam(weight_decay=0.01, ema_decay=0.99)
    sched = annealing_lr(1e-3, 2, 10, "cosine", 0.1)
    pstate = ema_adam_state_from_jax(state[1])
    pparams = dit_state_dict_from_jax(params)
    assert pstate.count == 1
    for g in grads[1:]:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        pg = dit_state_dict_from_jax(g)
        clip_by_global_norm_(pg, 1.0)
        opt.step(pparams, pg, pstate, sched(pstate.count + 1))
    want = ema_adam_state_from_jax(state[1])
    assert pstate.count == want.count == 4
    ema = dit_state_dict_from_jax(jax_swap_in_ema(params, state[1])[0])
    got_ema = swap_in_ema(pparams, pstate)[0]
    assert all(torch.equal(got_ema[n], pstate.shadow[n]) for n in got_ema)
    assert all(torch.equal(ema[n], want.shadow[n]) for n in ema)
    for got_d, want_d in ((pparams, dit_state_dict_from_jax(params)),
                          (pstate.exp_avg, want.exp_avg), (pstate.exp_avg_sq, want.exp_avg_sq),
                          (pstate.shadow, want.shadow)):
        for n in want_d:  # relative, elementwise and to the tensor's largest value
            w = want_d[n].numpy()
            np.testing.assert_allclose(got_d[n].numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(), err_msg=n)


def _split_case():
    """A 3-layer DiT's params and a random EMA-Adam state, stacked and in the
    save_attn_frac split layout (2 head layers, 1 tail layer)."""
    cfg = JaxDiTConfig(**dict(TINY, num_layers=3), remat=True, remat_policy="save_attn_frac",
                       remat_save_frac=0.7)
    params = init_dit_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    trees = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
             for _ in range(3)]
    state = JaxEmaAdamState(count=jnp.asarray(3), exp_avg=trees[0], exp_avg_sq=trees[1],
                            shadow=trees[2])
    split = JaxEmaAdamState(count=state.count,
                            **{f: split_layer_params(getattr(state, f), cfg)
                               for f in ("exp_avg", "exp_avg_sq", "shadow")})
    split_params = split_layer_params(params, cfg)
    assert jax.tree.leaves(split_params["layers"]["tail_layers"])[0].shape[0] == 1
    return params, split_params, state, split


def _assert_equal_state_dicts(got, want):
    assert set(got) == set(want) == set(DiT(DiTConfig(**dict(TINY, num_layers=3)),
                                            device="meta").state_dict())
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_bridge_joins_the_split_layer_layout():
    """A DiT tree in the save_attn_frac layout (layers/head_layers +
    layers/tail_layers, as the JAX trainer stores it) bridges to the same
    state dict as the stacked tree."""
    params, split, _, _ = _split_case()
    _assert_equal_state_dicts(dit_state_dict_from_jax(split), dit_state_dict_from_jax(params))


def test_bridge_joins_the_split_layer_layout_of_the_optimizer_state():
    _, _, state, split = _split_case()
    got, want = ema_adam_state_from_jax(split), ema_adam_state_from_jax(state)
    assert got.count == want.count == 3
    for f in ("exp_avg", "exp_avg_sq", "shadow"):
        _assert_equal_state_dicts(getattr(got, f), getattr(want, f))


class _Toy(torch.nn.Module):
    def __init__(self, seed=0):
        super().__init__()
        torch.manual_seed(seed)
        self.lin = torch.nn.Linear(4, 3)


def _toy_trainer(tmp_path=None, seed=0, noise=True, **kw):
    model = _Toy(seed)

    def loss_fn(gen, batch):
        err = model.lin(batch["x"]) - batch["y"]
        if noise:
            err = err - 0.1 * torch.randn(err.shape, generator=gen)
        return err.square().mean()

    cfg = TrainConfig(lr=1e-2, warmup_iters=1, save_dir=str(tmp_path) if tmp_path else None,
                      log_interval=1, **kw)
    return Trainer(model, loss_fn, cfg), model


def _batches(n, b=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [{"x": torch.randn(b, 4, generator=g), "y": torch.randn(b, 3, generator=g)}
            for _ in range(n)]


def test_trainer_skips_a_step_whose_loss_is_not_finite():
    trainer, model = _toy_trainer(train_iters=3)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    bad = _batches(1)[0]
    bad["y"][0, 0] = float("nan")
    m = trainer.train_step(bad)
    assert not m["ok"] and trainer.skipped == 1 and trainer.step == 1
    assert trainer.opt_state.count == 0
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    assert trainer.train_step(_batches(1)[0])["ok"] and trainer.opt_state.count == 1
    assert not torch.equal(model.lin.weight, before["lin.weight"])


def test_grad_accumulation_of_two_batches_of_one_equals_one_batch_of_two():
    batch = _batches(1)[0]
    one, m1 = _toy_trainer(noise=False, train_iters=2)
    one.train_step(batch)
    acc, m2 = _toy_trainer(noise=False, train_iters=2, grad_accum=2)
    acc.train_step({k: v.reshape(2, 1, *v.shape[1:]) for k, v in batch.items()})
    for a, b in zip(m1.parameters(), m2.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_save_then_resume_restores_state_and_continues_exactly(tmp_path):
    data = _batches(5)
    full, m_full = _toy_trainer(train_iters=5)
    full.fit(iter(data))
    part, _ = _toy_trainer(tmp_path, train_iters=5)
    for batch in data[:3]:
        part.train_step(batch)
    part.save(3)
    assert read_latest(str(tmp_path)) == "3" and (tmp_path / "3" / "state").is_dir()
    resumed, m_res = _toy_trainer(tmp_path, seed=7, train_iters=5)
    assert resumed.resume() == 3 and resumed.step == 3
    assert all(torch.equal(resumed.params[n], part.params[n]) for n in part.params)
    assert resumed.opt_state.count == 3
    assert torch.equal(resumed.generator.get_state(), part.generator.get_state())
    resumed.fit(iter(data[3:]))
    assert resumed.step == 5 and read_latest(str(tmp_path)) == "5"
    assert (tmp_path / "metrics.jsonl").read_text().count("\n") == 2  # iters 4 and 5
    for a, b in zip(m_full.parameters(), m_res.parameters()):
        assert torch.equal(a, b)


def test_checkpoint_gc_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for it in range(1, 6):
        mgr.save(it, {"w": torch.full((2,), float(it))}, model_config={"a": 1})
    kept = sorted(int(n) for n in os.listdir(tmp_path) if n.isdigit())
    assert kept == [4, 5] and read_latest(str(tmp_path)) == "5"
    assert (tmp_path / "model_config.json").is_file()
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path / "5"))


def test_first_frame_noise_draws_log_normal_sigmas_from_the_generator():
    from scail_tpu_torch.engine import VideoDiffusionEngine

    image = torch.zeros(3000, 1, 3, 4, 4)
    a = VideoDiffusionEngine.add_noise_to_first_frame(None, torch.Generator().manual_seed(0),
                                                      image)
    b = VideoDiffusionEngine.add_noise_to_first_frame(None, torch.Generator().manual_seed(0),
                                                      image)
    assert a.shape == image.shape and a.dtype == image.dtype and torch.equal(a, b)
    log_sigma = a.flatten(1).std(dim=1).log()  # sigma = exp(N(-2.5, 0.5)) per sample
    assert abs(log_sigma.mean().item() + 2.5) < 0.05
    assert abs(log_sigma.std().item() - 0.5) < 0.05


def test_trainer_refuses_tensorboard_and_wandb():
    for flag in ("tensorboard", "wandb"):
        with pytest.raises(NotImplementedError, match="metrics.jsonl"):
            _toy_trainer(**{flag: True})


def _toy_engine(real_engine):
    """Wrap the port's VideoDiffusionEngine so the YAML's text, CLIP and VAE
    wrappers get toy widths; init_params then initialises only the DiT.
    Self-contained and jax-free: a subprocess test runs its source."""
    from scail_tpu_torch.models.clip_vit import ClipVisionConfig
    from scail_tpu_torch.models.umt5 import UMT5Config
    from scail_tpu_torch.models.wan_vae import WanVAEConfig

    def make(model_config, args=None, device="cuda"):
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

    return make


def _make_data_root(root, n_examples=2, frames=5, size=(40, 64), seed=0) -> str:
    """Example dirs of a reference PNG and driving / rendered GIFs."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for i in range(n_examples):
        d = os.path.join(root, f"{i:03d}")
        os.makedirs(d, exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (*size, 3), np.uint8)).save(
            os.path.join(d, "ref.png"))
        for name in ("driving.gif", "rendered.gif"):
            ims = [Image.fromarray(rng.integers(0, 255, (*size, 3), np.uint8))
                   for _ in range(frames)]
            ims[0].save(os.path.join(d, name), save_all=True, append_images=ims[1:],
                        duration=60)
    return root


def _toy_train_yaml(tmp_path):
    from scail_tpu.testing import tiny_model_config

    mc = tiny_model_config()
    mc["network_config"]["params"].update(text_dim=16, clip_dim=32)
    mc["conditioner_config"] = {"target": "sgm.modules.GeneralConditioner", "params": {
        "emb_models": [{"is_trainable": False, "input_key": "txt", "ucg_rate": 0.1,
                        "legacy_ucg_val": "",
                        "target": "sgm.modules.encoders.umt5.T5EncoderModel",
                        "params": {"max_length": 12}}]}}
    mc["i2v_clip_config"] = {"target": "sgm.modules.encoders.clip.CLIPModel", "params": {}}
    path = tmp_path / "toy_train.yaml"
    path.write_text(yaml.safe_dump({"model": mc, "args": {"bf16": False}}))
    return str(path)


def test_train_cli_trains_saves_and_resumes_on_cpu(tmp_path, monkeypatch):
    import scail_tpu_torch.engine as engine_mod
    from scail_tpu_torch.cli import train

    monkeypatch.setattr(engine_mod, "VideoDiffusionEngine",
                        _toy_engine(engine_mod.VideoDiffusionEngine))
    root = _make_data_root(str(tmp_path / "data"))
    save = tmp_path / "run"
    argv = ["--base", _toy_train_yaml(tmp_path), "--data-root", root, "--save", str(save),
            "--image-size", "32", "32", "--num-frames", "5", "--warmup-iters", "1",
            "--device", "cpu"]
    trainer = train.main(argv + ["--train-iters", "2"])
    assert trainer.step == 2 and len(trainer.history) == 2
    assert all(np.isfinite(m["loss"]) and m["ok"] for m in trainer.history)
    assert (save / "latest").read_text() == "2"
    assert (save / "2" / "state").is_dir() and (save / "model_config.json").is_file()
    resumed = train.main(argv + ["--train-iters", "3", "--resume"])
    assert resumed.step == 3 and len(resumed.history) == 1
    assert (save / "latest").read_text() == "3"


@pytest.mark.parametrize("flag", [["--lora-rank", "2"], ["--mesh-seq", "2"],
                                  ["--distributed"], ["--shard-activations"]])
def test_train_cli_raises_for_unported_flags(flag):
    from scail_tpu_torch.cli import train

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.main(["--data-root", ".", "--device", "cpu"] + flag)


def test_train_cli_device_cuda_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from scail_tpu_torch.cli import train

    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--base", _toy_train_yaml(tmp_path), "--data-root", str(tmp_path)])


# --------------------------------------------------------------------------
# The host helpers the port keeps its own copies of, against the JAX package's
# --------------------------------------------------------------------------
jvideo = importlib.import_module("scail_tpu.data.video")
jnative = importlib.import_module("scail_tpu.native")
jrk = importlib.import_module("scail_tpu.native.resize_kernels")


def test_config_and_misc_helpers_match_jax(tmp_path):
    from scail_tpu.utils import config as jcfg
    from scail_tpu.utils import misc as jmisc
    from scail_tpu_torch.utils import config as tcfg
    from scail_tpu_torch.utils import misc as tmisc

    a, b = tmp_path / "a.yaml", tmp_path / "b.yaml"
    a.write_text(yaml.safe_dump({"args": {"x": 1, "d": {"p": 1, "q": [1, 2]}},
                                 "model": {"m": {"k": 2}}}))
    b.write_text(yaml.safe_dump({"args": {"d": {"q": [3]}, "y": "s"}, "model": {"m": {"j": 3}}}))
    paths = [str(a), str(b)]
    want, got = jcfg.load_configs(paths), tcfg.load_configs(paths)
    assert got == want and got.model.m.j == 3 and got.args.d.q == [3]
    assert tcfg.split_reference_config(got) == jcfg.split_reference_config(want)
    assert tcfg.load_yaml(str(a)) == jcfg.load_yaml(str(a))
    assert tcfg.deep_merge({"a": {"b": 1}}, {"a": {"c": 2}}) == \
        jcfg.deep_merge({"a": {"b": 1}}, {"a": {"c": 2}})
    x = np.zeros((2, 3))
    assert tmisc.append_dims(x, 5).shape == jmisc.append_dims(x, 5).shape == (2, 3, 1, 1, 1)
    assert tmisc.default(None, lambda: 4) == jmisc.default(None, lambda: 4) == 4
    assert tmisc.default(0, 4) == jmisc.default(0, 4) == 0


@pytest.mark.parametrize("n_in,n_out", [(40, 32), (17, 64), (896, 224), (64, 64)])
def test_resize_weight_matrices_equal_jax(n_in, n_out):
    from scail_tpu_torch.ops import resize as tres

    for aa in (False, True):
        np.testing.assert_array_equal(tres.resize_matrix(n_in, n_out, aa),
                                      jrk.resize_matrix(n_in, n_out, aa))
        for ac in (False, True):
            np.testing.assert_array_equal(tres.lin_matrix(n_in, n_out, aa, ac),
                                          jrk.lin_matrix(n_in, n_out, aa, ac))


@pytest.mark.parametrize("antialias", [False, True])
def test_host_resize_and_crop_match_jax(antialias):
    """Two matrix products against the JAX package's host resize (its banded
    native kernel): f32 summation order sets the 1e-5 bound."""
    from scail_tpu_torch.ops import resize as tres

    x = np.random.default_rng(0).uniform(-1, 1, (3, 3, 40, 72)).astype(np.float32)
    for out in ((32, 48), (64, 100), (40, 36)):
        np.testing.assert_allclose(tres.resize_bicubic_host(x, *out, antialias=antialias),
                                   jnative.resize_bicubic_host(x, *out, antialias=antialias),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tres.resize_bilinear_host(x, *out, antialias=antialias),
                                   jnative.resize_bilinear_host(x, *out, antialias=antialias),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tres.center_crop(x, 3, 5, 30, 60),
                                  jnative.center_crop(x, 3, 5, 30, 60))


@pytest.mark.parametrize("size", [(32, 32), (24, 40), (48, 24)])
def test_rectangle_crop_and_pose_downsample_match_jax(size):
    from scail_tpu_torch.data import video as tvideo

    x = np.random.default_rng(1).uniform(-1, 1, (5, 3, 40, 64)).astype(np.float32)
    got = tvideo.resize_for_rectangle_crop(x, list(size), "center")
    want = np.asarray(jvideo.resize_for_rectangle_crop(x, list(size), "center"))
    assert got.shape == want.shape == (5, 3, *size)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tvideo.smpl_downsample(x), np.asarray(jvideo.smpl_downsample(x)),
                               rtol=1e-5, atol=1e-5)
    t = tvideo.resize_for_rectangle_crop(torch.from_numpy(x), list(size), "center")
    np.testing.assert_allclose(t.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["gif", "frames", "npz", "mp4"])
def test_video_io_helpers_match_jax(tmp_path, kind):
    from PIL import Image

    from scail_tpu_torch.data import video as tvideo

    rng = np.random.default_rng(2)
    frames = rng.integers(0, 255, (5, 24, 40, 3), np.uint8)
    if kind == "gif":
        path = str(tmp_path / "v.gif")
        ims = [Image.fromarray(f) for f in frames]
        ims[0].save(path, save_all=True, append_images=ims[1:], duration=60)
    elif kind == "frames":
        path = str(tmp_path / "rendered")
        os.makedirs(path)
        for i, f in enumerate(frames):
            Image.fromarray(f).save(os.path.join(path, f"{i:04d}.png"))
    elif kind == "npz":
        path = str(tmp_path / "v.npz")
        np.savez(path, frames=frames, fps=12.0)
    else:
        path = tvideo.save_multi_video_grid_and_mp4([frames.transpose(0, 3, 1, 2)[None] / 255.0],
                                                    str(tmp_path), fps=16.0, key="v")[0]
    got, got_fps = tvideo.load_video_frames(path)
    want, want_fps = jvideo.load_video_frames(path)
    np.testing.assert_array_equal(got, want)
    assert abs(got_fps - want_fps) < 1e-6
    np.testing.assert_allclose(tvideo.frames_to_tchw_normalized(got),
                               jvideo.frames_to_tchw_normalized(want), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tvideo.pad_last_frame(got, 8), jvideo.pad_last_frame(want, 8))
    np.testing.assert_array_equal(tvideo.pad_last_frame(got, 3), jvideo.pad_last_frame(want, 3))
    pats = ["missing.gif", os.path.basename(path)]
    assert tvideo.find_file_with_patterns(str(tmp_path), pats) == \
        jvideo.find_file_with_patterns(str(tmp_path), pats) == path
    Image.fromarray(frames[0]).save(tmp_path / "ref.png")
    np.testing.assert_array_equal(tvideo.load_image_chw_normalized(str(tmp_path / "ref.png")),
                                  jvideo.load_image_chw_normalized(str(tmp_path / "ref.png")))


def test_profiler_groups_the_backward_kernels_and_has_a_training_phase():
    from scail_tpu_torch.cli import profile

    assert profile._group("void scail::flash_bwd_dq_kernel(__nv_bfloat16 const*") == \
        "flash_attention_bwd"
    assert profile._group("void scail::flash_bwd_dkv_kernel(__nv_bfloat16 const*") == \
        "flash_attention_bwd"
    # K1 (the rope instantiations) keeps its group; K2 (none) has its own
    assert profile._group("void scail::flash_fwd_kernel<1>(__nv_bfloat16") == "flash_attention"
    assert profile._group("void scail::flash_fwd_kernel<0>(__nv_bfloat16") == \
        "flash_attention_norope"
    assert {"train_step", "train_step_sta"} <= set(profile.PHASES)
