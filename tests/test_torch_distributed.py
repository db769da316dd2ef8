"""The port's multi-process training, VAE and CLI paths, on the CPU.

One world of 2 gloo ranks, started once by a module fixture (the spawning of
tests/test_torch_parallel.py), runs every case; each test reads its case.
The JAX side runs in this process.

* `vae_encode_cp` / `vae_decode_cp` over 2 seq ranks against JAX's on a seq-2
  mesh and against the port's own streamed path (1e-4).
* The sharded Trainer: one step under data 2, model 2 (with frozen
  parameters, the JAX train_mask; and with shard_activations), and seq 2
  with Ulysses, with the ring and with STA under Ulysses,
  each against the one-rank step on the global batch (loss, gradient norm,
  parameters after the EMA-Adam update: 1e-6); the moments of model-sharded
  parameters are sharded alike; a sharded run's checkpoint loads into a
  one-rank Trainer and a one-rank checkpoint into a sharded one (bit-exact).
* The train CLI with --distributed on 2 ranks: 2 steps, each data rank on its
  own slice of the data, the replicas equal afterwards, rank 0's checkpoint;
  and 3 steps with --mesh-model 2 and ucg on, the model ranks' conditioning,
  losses and gathered parameters equal.
* The ucg draws of each rank equal JAX's RandomState(process index) draws,
  correlated and not.
* Prompt lines sharded by rank as the JAX CLI shards them; the one-process
  initialisation is a no-op.
"""

import inspect
import os
import tempfile

import numpy as np
import pytest
import torch
from test_torch_parallel import collect_world, spawn_world

VAE_KW = dict(dim=8, z_dim=4, dim_mult=(1, 1, 2, 2), num_res_blocks=1,
              temporal_downsample=(False, True, True), dtype="float32")
# the toy text embedder of the ucg cases: each text becomes a (2, 3) block of
# its length plus one, so a swapped-in empty string shows
UCG_MODELS = [
    {"target": "tests.ToyTextEmbedder", "input_key": "txt", "ucg_rate": 0.5,
     "legacy_ucg_val": ""},
    {"target": "tests.ToyTextEmbedder", "input_key": "txt2", "ucg_rate": 0.5},
]
UCG_BATCH = {"txt": ["a cat", "two dogs", "", "a red bird"],
             "txt2": ["x", "yy", "zzz", "wwww"]}
# name: (mesh data x seq x model, the DiT's network params)
TRAIN_CASES = {"dp": ((2, 1, 1), {}), "tp": ((1, 1, 2), {}),
               "sp_ulysses": ((1, 2, 1), dict(attn_impl="ulysses")),
               "sp_ring": ((1, 2, 1), dict(attn_impl="ring")),
               "sta_ulysses": ((1, 2, 1), dict(attn_impl="sta", sta_tile=(1, 2),
                                               sta_window=(2, 2))),
               "shard_activations": ((1, 1, 2), dict(shard_activations=True))}
# the model-2 CLI run's conditioner: ucg zeroes the text embedding of an
# example with probability 0.6; RandomState(0) drops at step 1 only, while
# RandomState(1) (the global rank of the second model rank) drops at steps 1
# and 3, so a stream seeded by the global rank would split the model ranks
CLI_UCG_RATE = 0.6
CLI_UCG_DROPS = [True, False, False]


# --------------------------------------------------------------------------
# Port-side workers (the spawned ranks import this file: no jax at its top)
# --------------------------------------------------------------------------
def _toy_embedder_class(array_fn):
    class ToyTextEmbedder:
        def __call__(self, texts):
            return array_fn(np.stack([np.full((2, 3), len(t) + 1.0, np.float32) for t in texts]))

    return ToyTextEmbedder


def _ucg_port(rank):
    from scail_tpu_torch.diffusion.conditioner import GeneralConditioner
    from scail_tpu_torch.utils import registry

    registry.register(name="tests.ToyTextEmbedder")(_toy_embedder_class(torch.from_numpy))
    out = {}
    for mode, kw in (("plain", {}), ("correlated", dict(cor_embs=[0, 1], cor_p=[0.1, 0.2, 0.3,
                                                                                 0.4]))):
        cond = GeneralConditioner(UCG_MODELS, **kw)
        out[mode] = [cond(dict(UCG_BATCH))["crossattn"].numpy() for _ in range(3)]
    out["first_draw"] = GeneralConditioner(UCG_MODELS).ucg_prng.random()
    assert out["first_draw"] == np.random.RandomState(rank).random()
    return out


def _engine_factory(inp, network_params):
    """(build, model config): build() is a toy engine (tiny text, CLIP and VAE
    encoders) with its DiT drawn from seed 0, trainable, the DiT's network
    params updated by `network_params`."""
    namespace = {"torch": torch}
    exec(inp["toy_engine_src"], namespace)
    import scail_tpu_torch.engine as engine_mod

    make = namespace["_toy_engine"](engine_mod.VideoDiffusionEngine)
    mc = dict(inp["model_config"])
    nc = dict(mc["network_config"])
    nc["params"] = dict(nc["params"], **network_params)
    mc["network_config"] = nc

    def build():
        eng = make(mc, {"bf16": False}, device="cpu")
        eng.init_params(torch.Generator().manual_seed(0), trainable=True)
        return eng

    return build, mc


def _freeze(eng):
    """The frozen subset of the model-parallel case (the JAX train_mask):
    the cross-attention projections and the text embedding."""
    for n, p in eng.dit.named_parameters():
        if ".cross_" in n or n.startswith("text_embedding"):
            p.requires_grad_(False)


def _trainer_case(inp, name, workdir):
    import torch.distributed as dist

    from scail_tpu_torch.parallel import MeshSpec, make_mesh
    from scail_tpu_torch.training.engine import TrainConfig, Trainer

    spec, network_params = TRAIN_CASES[name]
    mesh = make_mesh(MeshSpec(*spec))
    build, _ = _engine_factory(inp, network_params)
    batch = {k: torch.from_numpy(v) for k, v in inp["train_batch"].items()}
    B = batch["lat"].shape[0]
    d, n_data = mesh.rank("data"), mesh.size("data")
    local = {k: v[d * B // n_data:(d + 1) * B // n_data] for k, v in batch.items()}

    def trainer(eng, m, save_dir=None):
        def loss_fn(g, b):
            cond = {k: b[k] for k in ("crossattn", "ref_concat", "concat_smpl_render",
                                      "image_clip_features")}
            return eng.loss(g, b["lat"], cond).mean()

        return Trainer(eng.dit, loss_fn, TrainConfig(train_iters=1, warmup_iters=1,
                                                     save_dir=save_dir), mesh=m,
                       rules=eng.param_rules)

    one = build()
    sharded = build()
    if name == "tp":
        _freeze(one)
        _freeze(sharded)
    sharded_full = {n: p.detach().clone() for n, p in sharded.dit.named_parameters()}
    sharded.shard_params(mesh)
    t1, t2 = trainer(one, None), trainer(sharded, mesh)
    m1, m2 = t1.train_step(batch), t2.train_step(local)
    full = t2.state_dict()
    res = dict(loss=(m1["loss"], m2["loss"]), grad_norm=(m1["grad_norm"], m2["grad_norm"]),
               param_err=max((full["params"][n] - p.detach()).abs().max().item()
                             for n, p in one.dit.named_parameters()),
               update_scale=max((p.detach() - sharded_full[n]).abs().max().item()
                                for n, p in one.dit.named_parameters()),
               moments_like_params=all(
                   t2.opt_state.exp_avg[n].shape == p.shape == t2.opt_state.shadow[n].shape
                   for n, p in t2.params.items()),
               sharded_moments=sorted(n for n, t in t2.opt_state.exp_avg.items()
                                      if t.shape != full["opt_state"]["exp_avg"][n].shape),
               trained=sorted(t2.params))
    if name != "tp":
        return res
    # checkpoints: sharded -> one rank, one rank -> sharded
    sharded_dir, one_dir = (os.path.join(workdir, n) for n in ("ckpt_tp", "ckpt_one"))
    t2.config.save_dir = sharded_dir
    t2.save(1)
    t2.wait_for_save()
    if dist.get_rank() == 0:
        t1.config.save_dir = one_dir
        t1.save(1)
        t1.wait_for_save()
    dist.barrier()
    fresh = build()
    _freeze(fresh)
    t3 = trainer(fresh, None, sharded_dir)
    t3.resume()
    res["one_from_sharded"] = all(torch.equal(full["params"][n], t)
                                  for n, t in fresh.dit.state_dict().items())
    again = build()
    _freeze(again)
    again.shard_params(mesh)
    t4 = trainer(again, mesh, one_dir)
    t4.resume()
    want = t1.state_dict()
    regathered = t4.state_dict()
    res["sharded_from_one"] = all(
        torch.equal(want["params"][n], regathered["params"][n]) for n in want["params"]) and all(
        torch.equal(want["opt_state"][f][n], regathered["opt_state"][f][n])
        for f in ("exp_avg", "exp_avg_sq", "shadow") for n in want["opt_state"][f])
    return res


def _patch_cli(inp):
    """Once per rank: the toy engine under the train CLI, and records of the
    dataset indices each rank loads and of the conditioner's crossattn."""
    import scail_tpu_torch.data.datasets as ds_mod
    import scail_tpu_torch.engine as engine_mod
    from scail_tpu_torch.diffusion.conditioner import GeneralConditioner

    namespace = {"torch": torch}
    exec(inp["toy_engine_src"], namespace)
    engine_mod.VideoDiffusionEngine = namespace["_toy_engine"](engine_mod.VideoDiffusionEngine)
    seen, conds = [], []
    getitem, call = ds_mod.VideoPoseDataset.__getitem__, GeneralConditioner.__call__

    def recording(self, i):
        seen.append(int(i))
        return getitem(self, i)

    def conditioning(self, *a, **kw):
        out = call(self, *a, **kw)
        conds.append(out["crossattn"].clone())
        return out

    ds_mod.VideoPoseDataset.__getitem__ = recording
    GeneralConditioner.__call__ = conditioning
    return seen, conds


def _cli_case(inp, workdir, records, yaml, name, args):
    """The train CLI with --distributed and `args`: its data indices,
    conditioning, losses and final parameters (this rank's and gathered) on
    this rank."""
    from scail_tpu_torch.cli import train

    seen, conds = records
    del seen[:], conds[:]
    save = os.path.join(workdir, name)
    t = train.main(["--base", yaml, "--data-root", inp["data_root"], "--save", save,
                    "--image-size", "32", "32", "--num-frames", "5", "--warmup-iters", "1",
                    "--device", "cpu", "--distributed", *args])
    torch.distributed.barrier()  # rank 0's checkpoint write has landed
    with open(os.path.join(save, "latest")) as f:
        latest = f.read()
    return dict(seen=list(seen), conds=list(conds), latest=latest,
                losses=[m["loss"] for m in t.history], ok=[m["ok"] for m in t.history],
                step=t.step, params={n: p.detach().clone() for n, p in t.model.named_parameters()},
                gathered=t.state_dict()["params"],
                data_coords=(t.mesh.rank("data"), t.mesh.size("data")))


def _w_world2(inp):
    import torch.distributed as dist

    from scail_tpu_torch.models import wan_vae as tvae
    from scail_tpu_torch.parallel import COLLECTIVES, MeshSpec, make_mesh, reset_collective_counts

    workdir = os.environ["WORKDIR"]
    res = {}
    mesh = make_mesh(MeshSpec(1, 2, 1))
    cfg = tvae.WanVAEConfig(**VAE_KW)
    model = tvae.WanVAEModel(cfg)
    model.load_state_dict(inp["vae_sd"])
    video, z = (torch.from_numpy(inp[k]) for k in ("video", "z"))
    with torch.no_grad():
        reset_collective_counts()
        enc = tvae.vae_encode_cp(model, cfg, video, mesh)
        dec = tvae.vae_decode_cp(model, cfg, z, mesh)
        res["vae"] = dict(enc=enc, dec=dec, collectives=dict(COLLECTIVES),
                          enc_streamed=tvae.vae_encode(model, cfg, video, streamed=True),
                          dec_streamed=tvae.vae_decode(model, cfg, z, streamed=True))
    res["ucg"] = _ucg_port(dist.get_rank())
    for name in TRAIN_CASES:
        res[name] = _trainer_case(inp, name, workdir)
    records = _patch_cli(inp)
    res["cli"] = _cli_case(inp, workdir, records, inp["yaml"], "cli", ["--train-iters", "2"])
    res["cli_tp"] = _cli_case(inp, workdir, records, inp["yaml_ucg"], "cli_tp",
                              ["--train-iters", "3", "--mesh-model", "2"])
    return res


# --------------------------------------------------------------------------
# The JAX side and the fixture
# --------------------------------------------------------------------------
def _vae_params(seed=0):
    import jax

    from scail_tpu.models import wan_vae as jvae

    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jvae.init_wan_vae_params(k, jvae.WanVAEConfig(**VAE_KW)),
                            jax.random.PRNGKey(0))

    def leaf(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return x * np.float32(np.prod(s.shape[:-1]) ** -0.5)
        return x * np.float32(0.1) + np.float32(path[-1].key == "gamma")

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_vae_cp(params, video, z):
    import jax
    import jax.numpy as jnp

    from scail_tpu.models import wan_vae as jvae
    from scail_tpu.parallel.mesh import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec(1, 2, 1), devices=jax.devices()[:2])
    cfg = jvae.WanVAEConfig(**VAE_KW)
    enc = jax.jit(lambda p, v: jvae.vae_encode_cp(p, cfg, v, mesh))(params, jnp.asarray(video))
    dec = jax.jit(lambda p, x: jvae.vae_decode_cp(p, cfg, x, mesh))(params, jnp.asarray(z))
    return np.asarray(enc), np.asarray(dec)


def _jax_ucg(rank):
    import jax
    import jax.numpy as jnp

    from scail_tpu.diffusion import conditioner as jcond
    from scail_tpu.utils import registry as jreg

    jreg.register(name="tests.ToyTextEmbedder")(_toy_embedder_class(jnp.asarray))
    real = jax.process_index
    out = {}
    try:
        jax.process_index = lambda: rank
        for mode, kw in (("plain", {}), ("correlated", dict(cor_embs=[0, 1],
                                                             cor_p=[0.1, 0.2, 0.3, 0.4]))):
            cond = jcond.GeneralConditioner(UCG_MODELS, **kw)
            out[mode] = [np.asarray(cond(dict(UCG_BATCH))["crossattn"]) for _ in range(3)]
    finally:
        jax.process_index = real
    return out


def _train_inputs():
    from scail_tpu.testing import tiny_model_config
    from test_torch_training import _make_data_root, _toy_engine

    rng = np.random.default_rng(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    mc = tiny_model_config()
    mc["network_config"]["params"].update(text_dim=16, clip_dim=32)
    mc["conditioner_config"] = {"target": "sgm.modules.GeneralConditioner", "params": {
        "emb_models": [{"is_trainable": False, "input_key": "txt", "ucg_rate": 0.1,
                        "legacy_ucg_val": "", "target": "sgm.modules.encoders.umt5.T5EncoderModel",
                        "params": {"max_length": 12}}]}}
    mc["i2v_clip_config"] = {"target": "sgm.modules.encoders.clip.CLIPModel", "params": {}}
    batch = dict(lat=f(2, 2, 16, 8, 8), crossattn=f(2, 6, 16), ref_concat=f(2, 1, 16, 8, 8),
                 concat_smpl_render=f(2, 2, 16, 4, 4), image_clip_features=f(2, 5, 32))
    return mc, batch, inspect.getsource(_toy_engine), _make_data_root


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    import yaml

    from scail_tpu_torch.convert.from_jax import wan_vae_state_dict_from_jax

    rng = np.random.default_rng(1)
    video = (rng.standard_normal((1, 17, 3, 16, 16)) * 0.5).astype(np.float32)
    z = rng.standard_normal((1, 5, 4, 2, 2)).astype(np.float32)
    vae_params = _vae_params()
    mc, batch, toy_src, make_root = _train_inputs()
    base = tmp_path_factory.mktemp("dist")
    cfg_path = base / "toy_train.yaml"
    cfg_path.write_text(yaml.safe_dump({"model": mc, "args": {"bf16": False}}))
    # the model-2 CLI run: the text embedding zeroed by ucg, no string swap
    mc_ucg = dict(mc, conditioner_config={"target": mc["conditioner_config"]["target"], "params": {
        "emb_models": [dict(mc["conditioner_config"]["params"]["emb_models"][0],
                            ucg_rate=CLI_UCG_RATE, legacy_ucg_val=None)]}})
    ucg_path = base / "toy_train_ucg.yaml"
    ucg_path.write_text(yaml.safe_dump({"model": mc_ucg, "args": {"bf16": False}}))
    inputs = dict(video=video, z=z, vae_sd=wan_vae_state_dict_from_jax(vae_params),
                  model_config=mc, train_batch=batch, toy_engine_src=toy_src,
                  yaml=str(cfg_path), yaml_ucg=str(ucg_path),
                  data_root=make_root(str(base / "data"), n_examples=4))
    with tempfile.TemporaryDirectory() as d:
        torch.save(inputs, os.path.join(d, "inputs.pt"))
        procs = spawn_world("test_torch_distributed", "_w_world2", 2, d)
        try:
            jax_ref = dict(vae=_jax_vae_cp(vae_params, video, z),
                           ucg={r: _jax_ucg(r) for r in range(2)})
        finally:
            ranks = collect_world(procs, d)
    return dict(ranks=ranks, jax=jax_ref)


# --------------------------------------------------------------------------
# Tests
# --------------------------------------------------------------------------
@pytest.mark.parametrize("stage", ["encode", "decode"])
def test_vae_context_parallel_matches_jax_and_streamed(world2, stage):
    """Frames after the first split over 2 seq ranks with the conv halos
    from the previous rank: the same frames on both ranks, equal to JAX's
    context-parallel result and to the port's streamed one."""
    key = stage[:3]
    want = world2["jax"]["vae"][0 if stage == "encode" else 1]
    for r in world2["ranks"]:
        got = r["vae"][key].numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, r["vae"][f"{key}_streamed"].numpy(), rtol=1e-4,
                                   atol=1e-4)
    # one halo pair per causal conv, and the frames gathered once per stage
    counts = world2["ranks"][0]["vae"]["collectives"]
    assert counts["all_gather"] == 2 and counts["p2p"] > 10, counts


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_sharded_trainer_step_equals_one_rank_step(world2, case):
    """One Trainer step on 2 ranks (data 2; model 2 with frozen parameters,
    and with shard_activations; seq 2 with Ulysses, with the ring and with
    STA under Ulysses) equals the one-rank step on the
    global batch: loss, gradient norm and every parameter after the
    EMA-Adam update (1e-6, the step moved them by ~1e-4)."""
    for r in world2["ranks"]:
        rec = r[case]
        np.testing.assert_allclose(*rec["loss"], rtol=1e-6)
        np.testing.assert_allclose(*rec["grad_norm"], rtol=1e-5)
        assert rec["param_err"] <= 1e-6, rec["param_err"]
        assert rec["update_scale"] > 1e-5  # the step moved the parameters
        assert rec["moments_like_params"]


def test_model_parallel_moments_are_sharded_with_frozen_params(world2):
    """Under model 2 the EMA-Adam moments and shadows of the column- and
    row-parallel weights are this rank's slices, like the parameters; the
    frozen parameters (the JAX train_mask) get no state."""
    rec = world2["ranks"][0]["tp"]
    assert rec["sharded_moments"] and all(
        n.split(".")[2] in ("qkv", "clip_kv", "mlp_in", "attn_out", "mlp_out")
        for n in rec["sharded_moments"])
    assert not any(".cross_" in n or n.startswith("text_embedding") for n in rec["trained"])


def test_checkpoints_move_between_sharded_and_one_rank_runs(world2):
    """A model-2 run's checkpoint (full state dicts, written by rank 0) loads
    into a one-rank Trainer, and a one-rank checkpoint resumes re-sharded:
    every parameter, moment and shadow bit-exact."""
    for r in world2["ranks"]:
        assert r["tp"]["one_from_sharded"]
        assert r["tp"]["sharded_from_one"]


def test_train_cli_distributed_on_two_ranks(world2):
    """`train --distributed` on 2 gloo ranks: data 2, each rank on its own
    slice of each epoch, 2 finite steps, the replicas equal afterwards, the
    final checkpoint written."""
    a, b = (r["cli"] for r in world2["ranks"])
    assert a["step"] == b["step"] == 2 and all(a["ok"] + b["ok"])
    assert all(np.isfinite(a["losses"] + b["losses"]))
    assert a["data_coords"] == (0, 2) and b["data_coords"] == (1, 2)
    assert a["latest"] == b["latest"] == "2"  # rank 0 wrote the final checkpoint
    # epoch 0's permutation of the 4 examples (seed 1234), cut in two slices
    perm = np.random.default_rng(1234).permutation(4).tolist()
    assert a["seen"][:2] == perm[:2] and b["seen"][:2] == perm[2:]
    assert a["losses"] == b["losses"]  # the loss is averaged over the data ranks
    for n, p in a["params"].items():
        assert torch.equal(p, b["params"][n]), n


def test_train_cli_model_parallel_ranks_share_ucg_draws(world2):
    """`train --distributed --mesh-model 2` on 2 gloo ranks, 3 steps with a
    ucg rate of 0.6: both model ranks hold the one data shard, so they load
    the same examples and drop the same prompts (the stream is seeded by the
    data coordinate, not the global rank); their conditioning, losses and
    gathered parameters are equal, and each rank's slices differ."""
    a, b = (r["cli_tp"] for r in world2["ranks"])
    assert a["step"] == b["step"] == 3 and all(a["ok"] + b["ok"])
    assert a["data_coords"] == b["data_coords"] == (0, 1)
    assert a["seen"] == b["seen"]
    # the drops that RandomState(0) draws, and the ones the global rank's
    # stream of the second rank would have drawn instead
    assert [bool(x < CLI_UCG_RATE) for x in np.random.RandomState(0).random(3)] == CLI_UCG_DROPS
    assert [bool(x < CLI_UCG_RATE) for x in np.random.RandomState(1).random(3)] != CLI_UCG_DROPS
    assert len(a["conds"]) == len(b["conds"]) == 3
    for ca, cb, dropped in zip(a["conds"], b["conds"], CLI_UCG_DROPS):
        assert torch.equal(ca, cb)
        assert bool((ca == 0).all()) == dropped
    assert a["losses"] == b["losses"] and all(np.isfinite(a["losses"]))
    for n, p in a["gathered"].items():
        assert torch.equal(p, b["gathered"][n]), n
    assert any(not torch.equal(p, b["params"][n]) for n, p in a["params"].items())


@pytest.mark.parametrize("rank", [0, 1])
def test_ucg_draws_per_rank_match_jax(world2, rank):
    """Each rank's ucg dropouts, plain and correlated, equal the JAX
    conditioner's with RandomState(process index = rank)."""
    got, want = world2["ranks"][rank]["ucg"], world2["jax"]["ucg"][rank]
    for mode in ("plain", "correlated"):
        for g, w in zip(got[mode], want[mode]):
            np.testing.assert_array_equal(g, w)
    other = world2["ranks"][1 - rank]["ucg"]["plain"]
    assert any(not np.array_equal(g, o) for g, o in zip(got["plain"], other))


@pytest.mark.parametrize("world", [2, 3])
def test_read_from_file_shards_lines_as_jax(tmp_path, world):
    """The sampling CLI's prompt lines per rank equal the JAX CLI's."""
    import importlib

    from scail_tpu_torch.cli.sample_video import read_from_file

    jsample = importlib.import_module("scail_tpu.cli.sample_video")
    path = tmp_path / "prompts.txt"
    path.write_text("".join(f"prompt {i}@@dir{i}\n" for i in range(7)))
    seen = []
    for rank in range(world):
        got = list(read_from_file(str(path), rank, world))
        assert got == list(jsample.read_from_file(str(path), rank=rank, world_size=world))
        seen += [cnt for _, cnt in got]
    assert sorted(seen) == list(range(7))


def test_initialize_distributed_is_a_noop_on_one_process(monkeypatch):
    from scail_tpu_torch.parallel.distributed import initialize_distributed

    for var in ("WORLD_SIZE", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed(device="cpu") is False
