"""The PyTorch port's sliding-tile attention (STA) against the JAX package, on
the CPU.

* The planners the port copied (ops/sta.py) return the JAX package's arrays,
  over the fingerprint, tests/test_sta.py and production geometries, with
  and without the windowed pose and the pose-kv window.
* `sta_attention` in the three layouts (dense pose, windowed pose, windowed
  pose with the pose-kv window) and at the production tile row counts
  (ts = 1344, pose tile 336), forward and gradients, against the JAX
  `sta_attention` run in interpret mode as tests/test_sta.py runs it, f32,
  2e-4 (f32 summation order).
* The DiT with attn_impl='sta', forward and parameter gradients against JAX
  `dit_forward`, with the windowed pose and the pose-kv window on, and with
  each of the JAX package's fallbacks; the committed `sta` CPU fingerprint.
* The entry points: the sampling CLI with --attn-impl sta, the train CLI with
  an `attn_impl: sta` YAML, the sta_validated.json default.
On CPU tensors the wrappers take their plain versions; no kernel launches.
"""

import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

import scail_tpu.ops.sta as jsta
from scail_tpu.models.dit import DiTConfig as JaxDiTConfig
from scail_tpu.models.dit import dit_forward, init_dit_params
from scail_tpu_torch.convert.from_jax import dit_state_dict_from_jax
from scail_tpu_torch.models.dit import DiT, DiTConfig
from scail_tpu_torch.ops import attention as tattn
from scail_tpu_torch.ops import sta as tsta

sys.path.insert(0, os.path.dirname(__file__))

# (name, grid_thw, ref_len, pose_len, tile, window)
GEOMS = {
    "fingerprint": ((3, 4, 4), 16, 12, (1, 2), (2, 2)),
    "test_sta": ((4, 4, 8), 8, 12, (2, 2), (2, 1)),
    "test_sta_pose": ((4, 4, 8), 8, 32, (2, 2), (1, 1)),
    "test_sta_pose_kv": ((4, 8, 8), 8, 64, (2, 2), (2, 2)),
    "test_sta_misaligned": ((3, 8, 56), 8, 336, (3, 8), (1, 1)),
    "production": ((21, 32, 56), 1792, 9408, (3, 8), (3, 2)),
}


def _windowed_pose_ok(grid, tile):
    _, _, Wp = grid
    return tile[1] % 2 == 0 and Wp % 2 == 0 and (tile[0] * tile[1] * Wp) % 32 == 0


PLANNER_CASES = [(g, wp, pkw) for g in GEOMS for wp in (False, True) for pkw in (0, 3)
                 if not wp or (_windowed_pose_ok(GEOMS[g][0], GEOMS[g][3])
                               and GEOMS[g][2] == np.prod(GEOMS[g][0]) // 4)]


def _window_table_args(grid, ref_len, pose_len, tile, window, wp, pkw):
    """The _window_table arguments and the kv block count of the JAX
    sta_attention (scail_tpu/ops/sta.py:508-528)."""
    T, Hp, Wp = grid
    _, _, n_t, n_h = jsta._strip_layout(T, Hp, Wp, ref_len, pose_len, *tile)
    ts = tile[0] * tile[1] * Wp
    if wp and pkw and n_h % 4 == 0:
        pad = (-ref_len) % ts
        args = (n_t, n_h, *window, pose_len // ts, (ref_len + pad) // ts, pkw)
    else:
        pad = (-(ref_len + pose_len)) % ts
        args = (n_t, n_h, *window, 0, (ref_len + pose_len + pad) // ts, 0)
    return args, (ref_len + T * Hp * Wp + pose_len + pad) // ts


@pytest.mark.parametrize("geom,wp,pkw", PLANNER_CASES)
def test_planners_equal_jax(geom, wp, pkw):
    grid, ref, pose, tile, window = GEOMS[geom]
    T, Hp, Wp = grid
    for got, want in zip(tsta._strip_layout(T, Hp, Wp, ref, pose, *tile),
                         jsta._strip_layout(T, Hp, Wp, ref, pose, *tile)):
        np.testing.assert_array_equal(got, want)
    if wp:
        np.testing.assert_array_equal(tsta._pose_perm(T, Hp, Wp, ref, pose, *tile),
                                      jsta._pose_perm(T, Hp, Wp, ref, pose, *tile))
    for got, want in zip(tsta.sta_order(grid, ref, pose, tile, windowed_pose=wp),
                         jsta.sta_order(grid, ref, pose, tile, windowed_pose=wp)):
        np.testing.assert_array_equal(got, want)
    args, n_blocks = _window_table_args(grid, ref, pose, tile, window, wp, pkw)
    table = jsta._window_table(*args)
    np.testing.assert_array_equal(tsta._window_table(*args), table)
    for got, want in zip(tsta._inverse_table(table, n_blocks),
                         jsta._inverse_table(table, n_blocks)):
        np.testing.assert_array_equal(got, want)
    plan = tsta.sta_plan(grid, ref, pose, tile, window, wp, pkw)
    np.testing.assert_array_equal(plan.table, table)
    inv, lens = jsta._inverse_table(table, n_blocks)
    np.testing.assert_array_equal(plan.inv, inv)
    np.testing.assert_array_equal(plan.lens, lens)
    assert tsta.sta_executed_pairs(grid, ref, pose, tile, window, wp, pkw) == \
        jsta.sta_executed_pairs(grid, ref, pose, tile, window, wp, pkw)
    s = ref + T * Hp * Wp + pose
    if s <= 4096:  # the production mask is 48,832^2 booleans
        np.testing.assert_array_equal(
            tsta.sta_block_mask(s, grid, ref, pose, tile, window, wp, pkw),
            jsta.sta_block_mask(s, grid, ref, pose, tile, window, wp, pkw))


def test_production_plan_has_the_expected_shape(capsys):
    """Tile (3, 8), window (3, 2) at 48,832 tokens: ts 1344, 28 video and 28
    pose q tiles, 37 kv blocks (28 video, 7 pose, 2 ref of which the last has
    448 rows), a 28 x 11 table, inverse rows of 2 to 28 tiles."""
    plan = tsta.sta_plan(*GEOMS["production"], True, 3)
    assert plan.ts == 1344 and plan.table.shape == (28, 11)
    assert plan.inv.shape[0] == 37 and plan.lens.min() == 2 and plan.lens.max() == 28
    assert 48832 - 36 * 1344 == 448
    assert list(plan.lens[35:]) == [28, 28]  # both ref blocks: every q tile
    pairs = tsta.sta_executed_pairs((21, 32, 56), 1792, 9408, (3, 8), (3, 2), True, 3)
    assert abs(pairs / 48832 ** 2 - 0.329) < 0.002  # tests/test_sta.py's reading


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


# (geometry, windowed_pose, pose_kv_window, batch): the three layouts and the
# production row counts of tests/test_sta.py
ATTN_CASES = {
    "dense_pose": ("test_sta", False, 0, 2),
    "windowed_pose": ("test_sta_pose", True, 0, 2),
    "windowed_pose_kv": ("test_sta_pose_kv", True, 1, 1),
    "production_rows": ("test_sta_misaligned", True, 0, 1),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_sta_attention_and_grads_match_jax(case):
    geom, wp, pkw, b = ATTN_CASES[case]
    grid, ref, pose, tile, window = GEOMS[geom]
    s = ref + int(np.prod(grid)) + pose
    kw = dict(grid_thw=grid, ref_len=ref, pose_len=pose, tile=tile, window=window,
              windowed_pose=wp, pose_kv_window=pkw)
    q, k, v, w = _qkv(7, (b, s, 2, 128))

    def jloss(q, k, v):
        out = jsta.sta_attention(q, k, v, **kw)
        return jnp.sum(out * w), out

    with pltpu.force_tpu_interpret_mode():
        (_, want), want_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
            *map(jnp.asarray, (q, k, v)))
    tattn.reset_launch_counts()
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = tsta.sta_attention(*ts, **kw)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    for t, g, name in zip(ts, want_grads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name}")
    assert all(n == 0 for n in tattn.LAUNCHES.values())


def test_pre_tiled_and_plain_impl_agree_with_the_gathered_call():
    grid, ref, pose, tile, window = GEOMS["test_sta_pose_kv"]
    kw = dict(grid_thw=grid, ref_len=ref, pose_len=pose, tile=tile, window=window,
              windowed_pose=True, pose_kv_window=1)
    s = ref + int(np.prod(grid)) + pose
    q, k, v, _ = (torch.from_numpy(x) for x in _qkv(3, (1, s, 2, 16)))
    want = tsta.sta_attention(q, k, v, **kw)
    order = torch.from_numpy(tsta.sta_plan(grid, ref, pose, tile, window, True, 1).order)
    tiled = tsta.sta_attention(q[:, order], k[:, order], v[:, order], pre_tiled=True, **kw)
    torch.testing.assert_close(tiled, want[:, order], rtol=0, atol=0)
    torch.testing.assert_close(tsta.sta_attention(q, k, v, impl="xla", **kw), want,
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tsta.sta_attention(q, k, v, impl="pallas", **kw)


def test_windowed_backward_plain_is_the_gradient_of_the_plain_forward():
    """dq over the table and dk/dv over the inverse table (the K8 plain
    version) equal autograd through the plain forward, here at a ragged
    geometry where the pose tiles (8 rows) and kv blocks (32 rows) are not
    multiples of 64 and the ref tail block is short."""
    grid, ref, pose, tile, window = ((2, 8, 16), 100, 64, (1, 2), (1, 2))
    plan = tsta.sta_plan(grid, ref, pose, tile, window, True, 3)
    s = ref + int(np.prod(grid)) + pose
    assert s % plan.ts != 0
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(5, (1, s, 2, 32)))
    sv = int(np.prod(grid))
    qp = q[:, sv:sv + pose].clone().requires_grad_()
    kk, vv = k.clone().requires_grad_(), v.clone().requires_grad_()
    tables = plan.tables("cpu")
    out, lse = tsta.sta_windowed_plain(qp, kk, vv, tables.table, ts=plan.ts, ts_q=plan.ts // 4)
    (out * do[:, :pose]).sum().backward()
    got = tsta.sta_windowed_bwd_plain(qp.detach(), k, v, out.detach(), lse.detach(),
                                      do[:, :pose], tables, ts=plan.ts, ts_q=plan.ts // 4)
    for g, t in zip(got, (qp, kk, vv)):
        torch.testing.assert_close(g, t.grad, rtol=1e-4, atol=1e-5)


TINY = dict(hidden_size=32, num_layers=2, num_heads=2, inner_hidden_size=48, time_embed_dim=32,
            text_dim=16, clip_dim=8, share_adaln=True, use_i2v_clip=True, dtype="float32",
            interleaved_rope=True)

# (latent (T, H, W), tile, window, the fallback's message, gradients too):
# windowed pose and pose-kv window on; the windowed pose off (ts % 32 != 0);
# the pose-kv window off (n_h % 4 != 0); dense attention (the tile does not
# divide T).  The layouts of the last two have their gradients checked in
# test_sta_attention_and_grads_match_jax and tests/test_torch_training.py.
DIT_CASES = {
    "windowed_pose_kv": ((1, 16, 32), (1, 2), (1, 2), "", True),
    "pose_fallback": ((3, 8, 8), (1, 2), (2, 2), "windowed pose disabled", True),
    "pose_kv_fallback": ((2, 8, 32), (1, 2), (1, 1), "pose_kv_window=3 ignored", False),
    "dense_fallback": ((2, 8, 8), (3, 2), (1, 1), "falling back to dense", False),
}


@pytest.mark.parametrize("case", list(DIT_CASES))
def test_dit_sta_forward_and_grads_match_jax(case, capsys):
    """The JAX side differentiates through its interpret-mode kernels, so it
    runs without remat (tests/test_torch_training.py); the port runs with
    remat, which must not change the gradients.  The readout sums 2-4k
    outputs, so gradients reach ~10: their limit is 2e-4 of each tensor's
    largest entry (f32 summation order reads <= 1e-5 relative L2)."""
    (T, H, W), tile, window, message, grads = DIT_CASES[case]
    kw = dict(TINY, attn_impl="sta", sta_tile=tile, sta_window=window)
    params = init_dit_params(jax.random.PRNGKey(0), JaxDiTConfig(**TINY))
    rng = np.random.default_rng(1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inp = dict(x=f(1, T, 16, H, W), t=np.full((1,), 700.0, np.float32), ctx=f(1, 6, 16),
               ref=f(1, 1, 16, H, W), smpl=f(1, T, 16, H // 2, W // 2), clip=f(1, 5, 8))
    w = f(1, T, 16, H, W)

    def jloss(p):
        out = dit_forward(p, JaxDiTConfig(**kw), *(jnp.asarray(inp[n]) for n in ("x", "t", "ctx")),
                          ref_concat=jnp.asarray(inp["ref"]),
                          concat_smpl_render=jnp.asarray(inp["smpl"]),
                          image_clip_features=jnp.asarray(inp["clip"]))
        return jnp.sum(out * w), out

    with pltpu.force_tpu_interpret_mode():
        if grads:
            (_, want), want_grads = jax.value_and_grad(jloss, has_aux=True)(params)
        else:
            want = jloss(params)[1]
    capsys.readouterr()
    tsta.sta_plan.cache_clear()  # its fallback message prints once per geometry
    model = DiT(DiTConfig(**kw, remat=True))
    model.load_state_dict(dit_state_dict_from_jax(params))
    model.requires_grad_(True)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    got = model(t["x"], t["t"], t["ctx"], ref_concat=t["ref"], concat_smpl_render=t["smpl"],
                image_clip_features=t["clip"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    if message:
        assert message in capsys.readouterr().out
    if not grads:
        return
    (got * torch.from_numpy(w)).sum().backward()
    want_grads = dit_state_dict_from_jax(jax.tree.map(np.asarray, want_grads))
    for n, p in model.named_parameters():
        want_g = want_grads[n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want_g, rtol=2e-4,
                                   atol=2e-4 * max(1.0, np.abs(want_g).max()), err_msg=n)


def test_dit_reads_the_sta_keys_of_the_yaml():
    cfg = DiTConfig.from_network_config({"attn_impl": "sta", "sta_tile": [1, 2],
                                         "sta_window": [2, 2], "sta_windowed_pose": False,
                                         "sta_pose_kv_window": 0})
    assert (cfg.attn_impl, cfg.sta_tile, cfg.sta_window, cfg.sta_windowed_pose,
            cfg.sta_pose_kv_window) == ("sta", (1, 2), (2, 2), False, 0)
    assert DiTConfig.from_network_config({}).sta_tile == JaxDiTConfig().sta_tile == (3, 8)
    with pytest.raises(ValueError, match="sta_impl"):
        DiT(DiTConfig(**TINY, attn_impl="sta", sta_impl="pallas"))


def test_port_reproduces_sta_cpu_fingerprint():
    from test_torch_sampling import port_fingerprint

    port_fingerprint("sta", attn_impl="sta", sta_tile=(1, 2), sta_window=(2, 2))


def test_cli_answers_a_request_with_sta_on_cpu(tmp_path, monkeypatch):
    """`--attn-impl sta` at toy size: the DiT runs sliding-tile attention
    (tile (1, 2) from the YAML; 32x64 pixels, 9 frames) and the clip is
    written."""
    import scail_tpu_torch.cli.sample_video as sv
    import scail_tpu_torch.models.dit as tdit
    from test_torch_sampling import ROOT, _tiny_cli_yaml
    from test_torch_training import _toy_engine

    calls = []
    real = tdit.sta_attention
    monkeypatch.setattr(tdit, "sta_attention", lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    monkeypatch.setattr(sv, "VideoDiffusionEngine", _toy_engine(sv.VideoDiffusionEngine))
    base = _tiny_cli_yaml(tmp_path)
    cfg = yaml.safe_load(open(base))
    cfg["model"]["network_config"]["params"].update(sta_tile=[1, 2], sta_window=[2, 2])
    with open(base, "w") as f:
        yaml.safe_dump(cfg, f)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text(f"a character dancing@@{os.path.join(ROOT, 'examples_synth', '001')}\n")
    tattn.reset_launch_counts()
    records = sv.main(["--base", base, "--input-type", "txt", "--input-file", str(prompts),
                       "--sampling-steps", "2", "--image-size", "32", "64", "--device", "cpu",
                       "--attn-impl", "sta", "--output-dir", str(tmp_path / "out")])
    assert len(records) == 1 and records[0]["finite"] and records[0]["frames"] == 9
    n_layers = cfg["model"]["network_config"]["params"]["num_layers"]
    assert len(calls) == 2 * n_layers  # 2 steps, one CFG-batched forward each
    assert calls[0]["grid_thw"] == (3, 2, 4) and calls[0]["tile"] == (1, 2)
    assert all(n == 0 for n in tattn.LAUNCHES.values())


def test_train_cli_trains_with_sta_from_the_yaml_on_cpu(tmp_path, monkeypatch):
    import scail_tpu_torch.engine as engine_mod
    import scail_tpu_torch.models.dit as tdit
    from scail_tpu_torch.cli import train
    from test_torch_training import _make_data_root, _toy_engine, _toy_train_yaml

    calls = []
    real = tdit.sta_attention
    monkeypatch.setattr(tdit, "sta_attention", lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    monkeypatch.setattr(engine_mod, "VideoDiffusionEngine",
                        _toy_engine(engine_mod.VideoDiffusionEngine))
    base = _toy_train_yaml(tmp_path)
    cfg = yaml.safe_load(open(base))
    cfg["model"]["network_config"]["params"].update(attn_impl="sta", sta_tile=[1, 2])
    with open(base, "w") as f:
        yaml.safe_dump(cfg, f)
    root = _make_data_root(str(tmp_path / "data"))
    trainer = train.main(["--base", base, "--data-root", root, "--image-size", "32", "32",
                          "--num-frames", "5", "--warmup-iters", "1", "--train-iters", "2",
                          "--device", "cpu"])
    assert trainer.step == 2 and all(np.isfinite(m["loss"]) and m["ok"]
                                     for m in trainer.history)
    assert trainer.model.config.attn_impl == "sta" and calls
    assert calls[0]["grid_thw"] == (2, 2, 2)


@pytest.mark.parametrize("marker,flag,want", [
    ({"validated": True}, None, "sta"),
    ({"validated": True}, "auto", "auto"),
    ({"validated": False}, None, None),
    (None, None, None),
])
def test_sta_validated_marker_selects_sta(tmp_path, marker, flag, want):
    from scail_tpu_torch.cli.arguments import get_args

    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    if marker is not None:
        (ckpt / "sta_validated.json").write_text(json.dumps(marker))
    yaml_path = tmp_path / "m.yaml"
    yaml_path.write_text(yaml.safe_dump({"model": {"network_config": {"params": {}}}}))
    argv = ["--base", str(yaml_path), "--load", str(ckpt)]
    if flag:
        argv += ["--attn-impl", flag]
    _, model_cfg = get_args(argv)
    assert model_cfg["network_config"]["params"].get("attn_impl") == want


def test_windowed_wrappers_take_plain_versions_on_cpu():
    grid, ref, pose, tile, window = GEOMS["test_sta_pose"]
    plan = tsta.sta_plan(grid, ref, pose, tile, window, True, 0)
    s = ref + int(np.prod(grid)) + pose
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(9, (1, s, 2, 16)))
    tables = plan.tables("cpu")
    qv = q[:, :plan.video_len]
    tattn.reset_launch_counts()
    out, lse = tsta.sta_windowed_fwd(qv, k, v, tables.table, ts=plan.ts, ts_q=plan.ts,
                                     with_lse=True)
    want, want_lse = tsta.sta_windowed_plain(qv, k, v, tables.table, ts=plan.ts, ts_q=plan.ts,
                                             scale=1 / math.sqrt(16))
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert tsta.sta_windowed_fwd(qv, k, v, tables.table, ts=plan.ts, ts_q=plan.ts)[1] is None
    got = tsta.sta_windowed_bwd(qv, k, v, out, lse, do[:, :plan.video_len], tables, ts=plan.ts,
                                ts_q=plan.ts)
    plain = tsta.sta_windowed_bwd_plain(qv, k, v, out, lse, do[:, :plan.video_len], tables,
                                        ts=plan.ts, ts_q=plan.ts, scale=1 / math.sqrt(16))
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert all(n == 0 for n in tattn.LAUNCHES.values())


# the dk/dv launch order: (geometry, windowed_pose, pose_kv_window), among
# them the production plan and the card tests' ragged one (blocks of 32 rows)
ORDER_CASES = {
    "production": ("production", True, 3),
    "production_rows": ("test_sta_misaligned", True, 0),
    "dense_pose": ("test_sta", False, 0),
    "ragged": (((2, 8, 16), 100, 64, (1, 2), (1, 2)), True, 3),
}


@pytest.mark.parametrize("case", list(ORDER_CASES))
def test_dkv_launch_order_is_every_cta_heaviest_first(case):
    """Every (kv block, 128-row chunk) that holds rows of the sequence comes
    once, the work of a CTA (the q tiles its block's inverse row lists) never
    grows along the order, and the order travels with the plan's device
    tables (built once, cached with them); without one the wrapper takes
    the same CTAs in block order."""
    geom, wp, pkw = ORDER_CASES[case]
    grid, ref, pose, tile, window = GEOMS[geom] if isinstance(geom, str) else geom
    plan = tsta.sta_plan(grid, ref, pose, tile, window, wp, pkw)
    skv = ref + int(np.prod(grid)) + pose
    n_blocks = -(-skv // plan.ts)
    every = {(j, c) for j in range(n_blocks)
             for c in range(-(-min(plan.ts, skv - j * plan.ts) // tsta.DKV_ROWS))}
    order = plan.dkv_order
    assert order.dtype == np.int32 and order.shape == (len(every), 2)
    assert {tuple(p) for p in order.tolist()} == every
    work = plan.lens[order[:, 0]]
    assert np.all(np.diff(work) <= 0)
    assert work[0] == plan.lens.max()
    np.testing.assert_array_equal(
        order, tsta.dkv_launch_order(plan.lens, plan.ts, skv))
    tables = plan.tables("cpu")
    assert tables is plan.tables("cpu")
    assert tables.dkv_order.dtype == torch.int32 and tables.dkv_order.is_contiguous()
    np.testing.assert_array_equal(tables.dkv_order.numpy(), order)
    # the order of a call given none: the same CTAs in block order
    blocks = tsta._block_order(plan.ts, skv, "cpu")
    assert blocks is tsta._block_order(plan.ts, skv, "cpu")
    assert [tuple(p) for p in blocks.tolist()] == sorted(every)


def test_dkv_launch_order_at_production_puts_the_ref_blocks_first():
    """Both ref blocks are attended by all 28 q tiles: their 11 + 4 CTAs (the
    last block holds 448 rows) lead; no CTA past the sequence is launched."""
    plan = tsta.sta_plan(*GEOMS["production"], True, 3)
    order = plan.dkv_order
    assert order[:15].tolist() == [[35, c] for c in range(11)] + [[36, c] for c in range(4)]
    assert len(order) == 36 * 11 + 4
