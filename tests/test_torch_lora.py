"""LoRA fine-tuning in the port (training/lora.py and the LoRA branch of
models/common.dense) against the JAX package's (scail_tpu/training/lora.py),
on the CPU, in f32.

* The weight bridge carries a JAX `add_lora` tree, stacked and in the
  save_attn_frac split layout, into equal state dicts that load into a port
  DiT given the same rank by `add_lora`.
* With non-zero B, the DiT forward matches `dit_forward` on a float and on a
  W8A16 base (2e-4, f32 summation order); `merge_lora` matches JAX's to 1e-6.
* Two Trainer steps over the LoRA factors alone, from the same factors as the
  JAX Trainer with `train_mask = lora_mask(params)`: loss at 1e-5 and factors
  at 1e-6 (relative to each tensor's largest entry), base bit-equal.
* The train CLI with --lora-rank 2 on the CPU: the base stays bit-equal,
  every lora_b moves, and the checkpoint (with its EMA double-save) resumes
  under --lora-rank.
* The initial A is the same in two processes with different hash seeds.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scail_tpu.models.dit import DiTConfig as JaxDiTConfig
from scail_tpu.models.dit import dit_forward, init_dit_params, split_layer_params
from scail_tpu.ops.quant import quantize_model_params as jax_quantize
from scail_tpu.training import lora as jlora
from scail_tpu.training.engine import TrainConfig as JaxTrainConfig
from scail_tpu.training.engine import Trainer as JaxTrainer
from scail_tpu_torch.convert.from_jax import dit_state_dict_from_jax
from scail_tpu_torch.models.dit import DiT, DiTConfig
from scail_tpu_torch.ops import quant as tq
from scail_tpu_torch.training import lora as tlora
from scail_tpu_torch.training.engine import TrainConfig, Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden_size=32, num_layers=3, num_heads=2, inner_hidden_size=48, time_embed_dim=32,
            text_dim=16, clip_dim=8, share_adaln=True, use_i2v_clip=True, dtype="float32",
            interleaved_rope=True)
RANK = 2
LR = 1e-5
TARGETS = ("qkv", "attn_out", "cross_q", "cross_kv", "cross_out", "mlp_in", "mlp_out")


def _jax_lora_params(nonzero_b=True):
    """The tiny DiT's JAX params with rank-2 LoRA factors; B drawn from a seed
    unless the JAX init's zeros are asked for."""
    params = jlora.add_lora(init_dit_params(jax.random.PRNGKey(0), JaxDiTConfig(**TINY)),
                            jax.random.PRNGKey(1), rank=RANK, alpha=4.0)
    if nonzero_b:
        rng = np.random.default_rng(2)
        for name in TARGETS:
            b = params["layers"][name]["lora_b"]
            params["layers"][name]["lora_b"] = jnp.asarray(
                0.05 * rng.standard_normal(b.shape).astype(np.float32))
    return params


def _port_lora_model(params=None, **cfg):
    model = DiT(DiTConfig(**TINY, **cfg))
    tlora.add_lora(model, torch.Generator().manual_seed(0), rank=RANK)
    if params is not None:
        model.load_state_dict(dit_state_dict_from_jax(params))
    return model


def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inp = dict(x=f(1, 3, 16, 8, 8), t=np.full((1,), 600.0, np.float32), ctx=f(1, 6, 16),
               ref=f(1, 1, 16, 8, 8), smpl=f(1, 3, 16, 4, 4), clip=f(1, 5, 8))
    return inp, f(1, 3, 16, 8, 8)


def _jax_forward(params, inp, **cfg):
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    return dit_forward(params, JaxDiTConfig(**TINY, attn_impl="xla", **cfg), j["x"], j["t"],
                       j["ctx"], ref_concat=j["ref"], concat_smpl_render=j["smpl"],
                       image_clip_features=j["clip"])


def _port_forward(model, inp):
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    return model(t["x"], t["t"], t["ctx"], ref_concat=t["ref"], concat_smpl_render=t["smpl"],
                 image_clip_features=t["clip"])


@pytest.mark.parametrize("layout", ["stacked", "split"])
def test_bridge_carries_a_jax_lora_tree(layout):
    params = _jax_lora_params()
    tree = params
    if layout == "split":
        tree = split_layer_params(params, JaxDiTConfig(**TINY, remat=True,
                                                       remat_policy="save_attn_frac"))
        assert "head_layers" in tree["layers"]
    sd = dit_state_dict_from_jax(tree)
    want = dit_state_dict_from_jax(params)
    assert set(sd) == set(want) == set(_port_lora_model().state_dict())
    assert all(torch.equal(sd[k], want[k]) for k in want)
    for i in range(TINY["num_layers"]):
        a, b = sd[f"layers.{i}.qkv.lora_a"], sd[f"layers.{i}.qkv.lora_b"]
        assert a.shape == (32, RANK) and b.shape == (RANK, 96)
        np.testing.assert_array_equal(a.numpy(), np.asarray(params["layers"]["qkv"]["lora_a"][i]))
        assert sd[f"layers.{i}.qkv.lora_scale"].shape == () and \
            sd[f"layers.{i}.qkv.lora_scale"].item() == 2.0  # alpha / rank


@pytest.mark.parametrize("base", ["float", "w8a16"])
def test_lora_forward_matches_jax(base):
    params = _jax_lora_params()
    inp, _ = _inputs()
    want = np.asarray(_jax_forward(jax_quantize(params, bits=8) if base == "w8a16" else params,
                                   inp))
    model = _port_lora_model(params)
    if base == "w8a16":
        tq.quantize_model_params(model, bits=8)
        assert isinstance(model.layers[0].qkv, tq.QuantizedLinear)
        assert model.layers[0].qkv.lora_a.shape == (32, RANK)
    with torch.no_grad():
        got = _port_forward(model, inp).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # the delta is really on: without it the output moves
    with torch.no_grad():
        model.layers[1].mlp_out.lora_b.zero_()
        assert not np.allclose(_port_forward(model, inp).numpy(), want, rtol=2e-4, atol=2e-4)


def test_merge_lora_matches_jax():
    params = _jax_lora_params()
    want = dit_state_dict_from_jax(jlora.merge_lora(params))
    model = tlora.merge_lora(_port_lora_model(params))
    got = model.state_dict()
    assert set(got) == set(want) and not any("lora" in k for k in got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_add_lora_targets_the_layer_linears_and_mask_trains_only_the_factors():
    model = _port_lora_model()
    names = tlora.lora_mask(model)
    assert len(names) == 2 * len(TARGETS) * TINY["num_layers"]
    assert {n for n, p in model.named_parameters() if p.requires_grad} == set(names)
    assert all(n.startswith("layers.") for n in names)
    assert not hasattr(model.text_embedding.fc1, "lora_a")
    assert all(torch.count_nonzero(model.layers[i].mlp_in.lora_b) == 0 for i in range(3))
    a = [model.layers[i].qkv.lora_a for i in range(3)]
    assert not torch.equal(a[0], a[1])  # one (L, in, r) draw per path
    assert 0.005 < torch.cat([t.flatten() for t in a]).std().item() < 0.02
    with pytest.raises(ValueError, match="no dense layer"):
        tlora.add_lora(DiT(DiTConfig(**TINY)), torch.Generator(), targets=(r"^nothing$",))


def _loss_inputs():
    inp, w = _inputs(seed=7)
    return {**inp, "w": w}


def jax_two_lora_steps():
    """Two JAX Trainer steps with train_mask over the LoRA factors of the
    tiny DiT (readout loss, no random draw), from non-zero factors; returns
    (trainer, per-step losses, initial params).  Adam divides each
    gradient by its own size, so where a gradient is small the f32
    summation order of the two forwards moves its update by up to ~1e-4 of
    lr: from B = 0 with lr 5e-2 the factors differ by ~1e-5 of their size
    between two correct implementations.  So the steps start from non-zero
    factors with lr 1e-5: each step moves a factor by ~lr, 1e-4 to 1e-3 of
    its size, where a wrong update rule shows, and the rounding stays under
    1e-6."""
    params = _jax_lora_params()
    batch = {k: jnp.asarray(v) for k, v in _loss_inputs().items()}

    def loss_fn(p, key, b):
        out = dit_forward(p, JaxDiTConfig(**TINY, attn_impl="xla"), b["x"], b["t"], b["ctx"],
                          ref_concat=b["ref"], concat_smpl_render=b["smpl"],
                          image_clip_features=b["clip"])
        return jnp.mean(out * b["w"])

    cfg = JaxTrainConfig(train_iters=2, lr=LR, warmup_iters=1, log_interval=1,
                         tensorboard=False, save_dir=None)
    start = jax.tree.map(np.array, params)  # the Trainer donates its state
    trainer = JaxTrainer(params, loss_fn, cfg, train_mask=jlora.lora_mask(params))
    records = []
    trainer._log_metrics = records.append
    trainer.fit(iter([batch, batch]))
    return trainer, [r["loss"] for r in records], start


def port_two_lora_steps(params, save_dir=None):
    """The same two steps through the port's Trainer from the same factors."""
    model = _port_lora_model(params)
    tlora.lora_mask(model)
    batch = {k: torch.from_numpy(v) for k, v in _loss_inputs().items()}

    def loss_fn(gen, b):
        return (_port_forward(model, b) * b["w"]).mean()

    cfg = TrainConfig(train_iters=2, lr=LR, warmup_iters=1, log_interval=1,
                      save_dir=save_dir)
    trainer = Trainer(model, loss_fn, cfg)
    history = trainer.fit(iter([batch, batch]))
    return trainer, [m["loss"] for m in history]


def test_two_lora_steps_match_the_jax_trainer_with_train_mask():
    jtrainer, jlosses, params = jax_two_lora_steps()
    trainer, losses = port_two_lora_steps(params)
    assert len(losses) == len(jlosses) == 2
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[1] != losses[0]  # the first step moved the factors
    want = dit_state_dict_from_jax(jax.tree.map(np.asarray, jtrainer.state["params"]))
    start = dit_state_dict_from_jax(params)
    got = trainer.model.state_dict()
    assert set(trainer.params) == {k for k in got if k.endswith(("lora_a", "lora_b"))}
    assert set(trainer.opt_state.shadow) == set(trainer.params)  # no state for the base
    for k, w in want.items():
        if k in trainer.params:
            w = w.numpy()
            assert np.abs(w - start[k].numpy()).max() > 10 * 1e-6 * np.abs(w).max(), k
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(), err_msg=k)
        else:
            assert torch.equal(got[k], start[k]) and torch.equal(w, start[k]), k


def _snapshotting_fit(monkeypatch, seen):
    real_fit = Trainer.fit

    def fit(self, *a, **kw):
        seen.append({k: v.clone() for k, v in self.model.state_dict().items()})
        return real_fit(self, *a, **kw)

    monkeypatch.setattr(Trainer, "fit", fit)


def test_train_cli_with_lora_rank_keeps_the_base_and_resumes(tmp_path, monkeypatch):
    import scail_tpu_torch.engine as engine_mod
    from scail_tpu_torch.cli import train
    from scail_tpu_torch.training.checkpoint import load_checkpoint
    from test_torch_training import _make_data_root, _toy_engine, _toy_train_yaml

    monkeypatch.setattr(engine_mod, "VideoDiffusionEngine",
                        _toy_engine(engine_mod.VideoDiffusionEngine))
    seen = []
    _snapshotting_fit(monkeypatch, seen)
    save = tmp_path / "run"
    argv = ["--base", _toy_train_yaml(tmp_path), "--data-root",
            _make_data_root(str(tmp_path / "data")), "--save", str(save), "--image-size", "32",
            "32", "--num-frames", "5", "--warmup-iters", "1", "--lr", "1e-2", "--device", "cpu",
            "--lora-rank", "2"]
    trainer = train.main(argv + ["--train-iters", "2"])
    assert trainer.step == 2 and all(m["ok"] for m in trainer.history)
    start, end = seen[0], trainer.model.state_dict()
    lora = [k for k in end if "lora_" in k]
    assert lora and set(trainer.params) == {k for k in lora if not k.endswith("lora_scale")}
    for k in end:
        if k in trainer.params:
            assert not torch.equal(end[k], start[k]), k
        else:
            assert torch.equal(end[k], start[k]), k  # the base is bit-equal
    assert all(torch.count_nonzero(end[k]) > 0 for k in lora if k.endswith("lora_b"))
    assert (save / "latest").read_text() == "2"
    ema, it = load_checkpoint(str(save), ema=True)
    assert it == 2 and set(ema["params"]) == set(end)
    for k in end:
        want = trainer.opt_state.shadow[k] if k in trainer.params else end[k]
        assert torch.equal(ema["params"][k], want), k
    resumed = train.main(argv + ["--train-iters", "3", "--resume"])
    assert resumed.step == 3 and (save / "latest").read_text() == "3"
    assert all(torch.equal(seen[1][k], end[k]) for k in end)  # resumed from the save


def test_lora_init_is_the_same_in_two_processes():
    code = ("import torch\n"
            "from scail_tpu_torch.models.dit import DiT, DiTConfig\n"
            "from scail_tpu_torch.training.lora import add_lora\n"
            f"m = DiT(DiTConfig(**{TINY!r}))\n"
            "add_lora(m, torch.Generator().manual_seed(3), rank=2)\n"
            "print(m.layers[2].cross_kv.lora_a.flatten()[:6].tolist(), "
            "m.layers[0].qkv.lora_a.sum().item())\n")
    outs = [subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                           text=True, timeout=120, check=True,
                           env=dict(os.environ, PYTHONHASHSEED=seed)).stdout
            for seed in ("1", "2")]
    assert outs[0] == outs[1] and outs[0].strip()
