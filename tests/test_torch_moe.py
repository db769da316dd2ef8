"""The port's mixture of experts against the JAX package, on the CPU.

`scail_tpu_torch/ops/moe.py` against `scail_tpu/ops/moe.py` (the router, the
biased, gated and router-override MLPs, top 1); the MoE DiT against
`dit_forward` with `num_experts` (forward and parameter gradients, every
remat policy); expert parallelism: the MoE DiT sharded over a gloo world of 2
model ranks against the one-process path; Mixtral against `mixtral_forward`
(the HF converter through the weight bridge, the sharding rules).  Inputs
and weights are numpy arrays from seeds, f32.  Tolerances: 1e-4 for the ops
and Mixtral, 2e-4 for the DiT and its gradients (the port's DiT tolerance);
the router's choices exactly.

The spawned gloo ranks import this file, so it imports no jax at its top.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from test_torch_parallel import collect_world, spawn_world

TINY = dict(hidden_size=32, num_layers=2, num_heads=4, inner_hidden_size=48,
            time_embed_dim=32, text_dim=12, clip_dim=10, share_adaln=True,
            use_i2v_clip=True, dtype="float32", num_experts=4, moe_top_k=2)
MIXTRAL = dict(vocab_size=64, dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
               inner_hidden_size=48, num_experts=4, top_k=2, max_len=16)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _experts(rng, d=16, f=24, E=4, bias=True, gated=False):
    g = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    p = dict(gate=g(d, E) * 0.5, w_in=g(E, d, f) * 0.1, w_out=g(E, f, d) * 0.1)
    if bias:
        p.update(b_in=g(E, f) * 0.1, b_out=g(E, d) * 0.1)
    if gated:
        p["w_gate"] = g(E, d, f) * 0.1
    return p


def _port_moe(x, p, top_k, router=None, act=None):
    from scail_tpu_torch.ops.moe import moe_mlp

    kw = {} if act is None else dict(act=act)
    return moe_mlp(_t(x), _t(p["gate"]).t(), _t(p["w_in"]).transpose(1, 2),
                   _t(p["w_out"]).transpose(1, 2),
                   b_in=_t(p["b_in"]) if "b_in" in p else None,
                   b_out=_t(p["b_out"]) if "b_out" in p else None,
                   w_gate=_t(p["w_gate"]).transpose(1, 2) if "w_gate" in p else None,
                   top_k=top_k, router=router, **kw).numpy()


def _jax_moe(x, p, top_k, router=None, act=None):
    import jax.numpy as jnp

    from scail_tpu.ops.moe import moe_mlp

    w_in = {"kernel": jnp.asarray(p["w_in"])}
    w_out = {"kernel": jnp.asarray(p["w_out"])}
    if "b_in" in p:
        w_in["bias"], w_out["bias"] = jnp.asarray(p["b_in"]), jnp.asarray(p["b_out"])
    kw = {} if act is None else dict(act=act)
    return np.asarray(moe_mlp(jnp.asarray(x), {"kernel": jnp.asarray(p["gate"])}, w_in, w_out,
                              top_k=top_k, router=router,
                              w_gate={"kernel": jnp.asarray(p["w_gate"])}
                              if "w_gate" in p else None, **kw))


def test_router_matches_jax():
    """The same top-k experts, and weights within 1e-6 that sum to one."""
    import jax.numpy as jnp

    from scail_tpu.ops.moe import moe_router as jax_router
    from scail_tpu_torch.ops.moe import moe_router

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 33, 16)).astype(np.float32)
    gate = rng.standard_normal((16, 8)).astype(np.float32)
    w, idx = moe_router(_t(x), _t(gate).t(), 2)
    jw, jidx = jax_router(jnp.asarray(x), jnp.asarray(gate), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("case", ["biased", "gated_silu", "router_override", "top3"])
def test_moe_mlp_matches_jax(case):
    """The index dispatch equals JAX's dense combine: biased GELU-tanh
    experts (the DiT's), gated SiLU experts without bias (Mixtral's), a
    router given by the caller, and top 3 of 4."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    top_k, router, jrouter, act, jact = 2, None, None, None, None
    p = _experts(rng, bias=case != "gated_silu", gated=case == "gated_silu")
    if case == "gated_silu":
        import jax

        act, jact = torch.nn.functional.silu, jax.nn.silu
    if case == "router_override":
        idx = rng.integers(0, 4, (2, 9, 2))
        idx[..., 1] = (idx[..., 0] + 1 + rng.integers(0, 3, (2, 9))) % 4
        w = rng.uniform(0.1, 1.0, (2, 9, 2)).astype(np.float32)
        router = (torch.from_numpy(w), torch.from_numpy(idx))
        jrouter = (jnp.asarray(w), jnp.asarray(idx, jnp.int32))
    if case == "top3":
        top_k = 3
    got = _port_moe(x, p, top_k, router, act)
    want = _jax_moe(x, p, top_k, jrouter, jact)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_moe_top1_selects_single_expert():
    """top 1: each token's output is its argmax expert's plain MLP."""
    from scail_tpu_torch.models.common import gelu_tanh
    from scail_tpu_torch.ops.moe import moe_router

    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 5, 8)).astype(np.float32)
    p = _experts(rng, d=8, f=12, E=3, bias=False)
    got = _port_moe(x, p, 1)
    _, idx = moe_router(_t(x), _t(p["gate"]).t(), 1)
    for t in range(5):
        e = int(idx[0, t, 0])
        want = gelu_tanh(_t(x[0, t]) @ _t(p["w_in"][e])) @ _t(p["w_out"][e])
        np.testing.assert_allclose(got[0, t], want.numpy(), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# The MoE DiT
# --------------------------------------------------------------------------
def _dit_inputs(b=1, seed=5):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=f(b, 2, 16, 8, 8), t=np.array([100.0, 300.0], np.float32)[:b],
                ctx=f(b, 7, 12), ref=f(b, 1, 16, 8, 8), smpl=f(b, 2, 16, 4, 4),
                clip=f(b, 5, 10))


def _port_dit(sd, **kw):
    from scail_tpu_torch.models.dit import DiT, DiTConfig

    model = DiT(DiTConfig(**dict(TINY, **kw)))
    model.load_state_dict(sd)
    return model


def _port_forward(model, inp, mesh=None):
    x = {k: _t(v) for k, v in inp.items()}
    return model(x["x"], x["t"], x["ctx"], ref_concat=x["ref"], concat_smpl_render=x["smpl"],
                 image_clip_features=x["clip"], mesh=mesh)


@pytest.fixture(scope="module")
def jax_moe_dit():
    """JAX init_dit_params, the forward and the gradients of mean(out²)."""
    import jax
    import jax.numpy as jnp

    from scail_tpu.models.dit import DiTConfig as JaxDiTConfig
    from scail_tpu.models.dit import dit_forward, init_dit_params
    from scail_tpu_torch.convert.from_jax import dit_state_dict_from_jax

    cfg = JaxDiTConfig(**TINY, attn_impl="xla")
    params = jax.jit(lambda k: init_dit_params(k, cfg))(jax.random.PRNGKey(0))
    inp = _dit_inputs()
    j = {k: jnp.asarray(v) for k, v in inp.items()}

    def f(p):
        out = dit_forward(p, cfg, j["x"], j["t"], j["ctx"], ref_concat=j["ref"],
                          concat_smpl_render=j["smpl"], image_clip_features=j["clip"])
        return jnp.mean(out ** 2), out

    (loss, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    return dict(sd=dit_state_dict_from_jax(params), inp=inp, out=np.asarray(out),
                loss=float(loss), grads=dit_state_dict_from_jax(grads))


def test_moe_dit_forward_matches_jax(jax_moe_dit):
    model = _port_dit(jax_moe_dit["sd"])
    assert "layers.0.mlp_in.weight" not in jax_moe_dit["sd"]
    assert model.layers[1].moe_in.weight.shape == (4, 48, 32)
    with torch.no_grad():
        got = _port_forward(model, jax_moe_dit["inp"]).numpy()
    np.testing.assert_allclose(got, jax_moe_dit["out"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("policy", [None, "default", "save_attn", "save_attn_frac",
                                    "offload_attn"])
def test_moe_dit_gradients_match_jax(jax_moe_dit, policy):
    """Parameter gradients of mean(out²) through autograd, without remat and
    under every remat policy, against jax.value_and_grad: the router and the
    experts each get a gradient."""
    kw = {} if policy is None else dict(remat=True, remat_policy=policy, remat_save_frac=0.5)
    model = _port_dit(jax_moe_dit["sd"], **kw).requires_grad_(True)
    out = _port_forward(model, jax_moe_dit["inp"])
    loss = out.square().mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jax_moe_dit["loss"], rtol=2e-4)
    grads = dict(model.named_parameters())
    assert set(grads) == set(jax_moe_dit["grads"])
    for name, want in jax_moe_dit["grads"].items():
        np.testing.assert_allclose(grads[name].grad.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=name)
    assert grads["layers.0.moe_gate.weight"].grad.abs().max() > 0
    assert grads["layers.0.moe_in.weight"].grad.abs().max() > 0


def test_moe_sharding_rules_shard_whole_experts():
    """The port's rules put moe_in / moe_out (weight and bias) over 'model'
    on the expert axis, as JAX dit_param_rules does; the gate stays
    replicated."""
    from scail_tpu_torch.parallel.sharding import dit_param_rules

    rules = dit_param_rules()
    for name, ndim in (("layers.3.moe_in.weight", 3), ("layers.3.moe_in.bias", 2),
                       ("layers.3.moe_out.weight", 3), ("layers.3.moe_out.bias", 2)):
        assert rules.spec_for(name, ndim) == ("model",), name
    assert rules.spec_for("layers.3.moe_gate.weight", 2) == ()


def _w_ep(inp):
    """Rank of a world of 2 model ranks: the MoE DiT with its experts
    sharded (2 of 4 a rank), forward and the gradients of mean(out²)."""
    from scail_tpu_torch import parallel
    from scail_tpu_torch.parallel import MeshSpec, make_mesh
    from scail_tpu_torch.parallel.sharding import dit_param_rules, shard_module_

    mesh = make_mesh(MeshSpec(model=2))
    model = _port_dit(inp["sd"])
    shard_module_(model, dit_param_rules(), mesh)
    model.requires_grad_(True)
    parallel.reset_collective_counts()
    out = _port_forward(model, inp["inp"], mesh=mesh)
    collectives = {k: v for k, v in parallel.COLLECTIVES.items() if v}
    out.square().mean().backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if "moe" in n}
    from scail_tpu_torch.models.zoo.mixtral import Mixtral, MixtralConfig, mixtral_param_rules

    mixtral = Mixtral(MixtralConfig(**MIXTRAL))
    mixtral.load_state_dict(inp["mixtral_sd"])
    shard_module_(mixtral, mixtral_param_rules(), mesh)
    with torch.no_grad():
        logits = mixtral(inp["ids"], mesh=mesh)
    return dict(rank=mesh.rank("model"), out=out.detach(), grads=grads,
                shape=tuple(model.layers[0].moe_in.weight.shape), collectives=collectives,
                mixtral=logits, mixtral_experts=mixtral.layers[0].moe_w1.weight.shape[0])


def test_moe_dit_expert_parallel_matches_one_process(jax_moe_dit):
    """Two gloo ranks, each with 2 of the 4 experts: one all-reduce for the
    experts' sum a layer; the output equals the
    one-process port and JAX within 2e-4 on both ranks; each rank's expert
    gradients are its slice of the one-process gradients, and the
    replicated router's gradient is whole on both.  Mixtral sharded by
    mixtral_param_rules (2 of 4 experts a rank) gives the one-process logits
    within 1e-4."""
    from scail_tpu_torch.models.zoo.mixtral import Mixtral, MixtralConfig

    mixtral = Mixtral(MixtralConfig(**MIXTRAL)).init_weights_(torch.Generator().manual_seed(5))
    ids = torch.from_numpy(np.random.default_rng(6).integers(0, 64, (2, 8)))
    with tempfile.TemporaryDirectory() as d:
        torch.save(dict(sd=jax_moe_dit["sd"], inp=jax_moe_dit["inp"],
                        mixtral_sd=mixtral.state_dict(), ids=ids), os.path.join(d, "inputs.pt"))
        procs = spawn_world("test_torch_moe", "_w_ep", 2, d)
        with torch.no_grad():
            mixtral_want = mixtral(ids)
        results = collect_world(procs, d)
    model = _port_dit(jax_moe_dit["sd"]).requires_grad_(True)
    one = _port_forward(model, jax_moe_dit["inp"])
    one.square().mean().backward()
    full = {n: p.grad for n, p in model.named_parameters()}
    for r in results:
        assert r["shape"] == (2, 48, 32)
        # a layer's forward all-reduces 8 times over 'model': the five q/k
        # norms, attn_out, cross_out and the experts' sum
        assert r["collectives"] == {"all_reduce": 16}, r["collectives"]
        np.testing.assert_allclose(r["out"].numpy(), one.detach().numpy(), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(r["out"].numpy(), jax_moe_dit["out"], rtol=2e-4, atol=2e-4)
        assert r["mixtral_experts"] == 2
        np.testing.assert_allclose(r["mixtral"].numpy(), mixtral_want.numpy(), rtol=1e-4,
                                   atol=1e-4)
        for name, g in r["grads"].items():
            want = full[name]
            if "moe_gate" not in name:
                want = want[2 * r["rank"]:2 * r["rank"] + 2]
            np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=2e-4, atol=2e-4,
                                       err_msg=name)


# --------------------------------------------------------------------------
# Mixtral
# --------------------------------------------------------------------------
def test_mixtral_from_hf_matches_jax_converter_and_forward():
    """A tiny HF MixtralForCausalLM: the port's converter equals JAX's
    through the weight bridge (exactly), and the port's forward equals
    `mixtral_forward` and HF's logits."""
    import jax
    import jax.numpy as jnp
    from transformers import MixtralConfig as HFMixtralConfig
    from transformers import MixtralForCausalLM

    from scail_tpu.models.zoo.mixtral import MixtralConfig as JaxMixtralConfig
    from scail_tpu.models.zoo.mixtral import mixtral_forward as jax_mixtral_forward
    from scail_tpu.models.zoo.mixtral import mixtral_params_from_hf
    from scail_tpu_torch.convert.from_jax import mixtral_state_dict_from_jax
    from scail_tpu_torch.models.zoo.mixtral import Mixtral, MixtralConfig, mixtral_from_hf

    hf_cfg = HFMixtralConfig(
        vocab_size=96, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
        num_experts_per_tok=2, max_position_embeddings=32, rms_norm_eps=1e-5,
        rope_theta=10000.0, attention_dropout=0.0, output_router_logits=False)
    torch.manual_seed(3)
    hf = MixtralForCausalLM(hf_cfg).eval()
    sd = {k: v.detach().float() for k, v in hf.state_dict().items()}
    kw = dict(vocab_size=96, dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
              inner_hidden_size=48, num_experts=4, top_k=2, max_len=32, rope_theta=10000.0)
    jparams = mixtral_params_from_hf({k: v.numpy() for k, v in sd.items()},
                                     JaxMixtralConfig(**kw))
    bridged = mixtral_state_dict_from_jax(jparams)
    port_sd = mixtral_from_hf(sd, MixtralConfig(**kw))
    assert set(port_sd) == set(bridged)
    for k in bridged:
        assert torch.equal(port_sd[k], bridged[k]), k
    model = Mixtral(MixtralConfig(**kw))
    model.load_state_dict(port_sd)
    ids = np.random.default_rng(3).integers(0, 96, (2, 9))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
        hf_logits = hf(torch.from_numpy(ids)).logits.numpy()
    jcfg = JaxMixtralConfig(**kw)
    want = np.asarray(jax.jit(lambda p, i: jax_mixtral_forward(p, jcfg, i))(
        jparams, jnp.asarray(ids, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, hf_logits, rtol=5e-4, atol=5e-4)


def test_mixtral_init_forward_and_rules_match_jax():
    """JAX init_mixtral_params through the bridge: the forward within 1e-4;
    the port's rules shard moe_w1/w2/w3 over 'model' on the expert axis, as
    mixtral_param_rules does."""
    import jax
    import jax.numpy as jnp

    from scail_tpu.models.zoo.mixtral import MixtralConfig as JaxMixtralConfig
    from scail_tpu.models.zoo.mixtral import init_mixtral_params
    from scail_tpu.models.zoo.mixtral import mixtral_forward as jax_mixtral_forward
    from scail_tpu_torch.convert.from_jax import mixtral_state_dict_from_jax
    from scail_tpu_torch.models.zoo.mixtral import Mixtral, MixtralConfig, mixtral_param_rules

    jcfg = JaxMixtralConfig(**MIXTRAL)
    params = jax.jit(lambda k: init_mixtral_params(k, jcfg))(jax.random.PRNGKey(0))
    model = Mixtral(MixtralConfig(**MIXTRAL))
    model.load_state_dict(mixtral_state_dict_from_jax(params))
    ids = np.random.default_rng(4).integers(0, 64, (2, 8))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    want = np.asarray(jax.jit(lambda p, i: jax_mixtral_forward(p, jcfg, i))(
        params, jnp.asarray(ids, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    rules = mixtral_param_rules()
    for w in ("moe_w1", "moe_w2", "moe_w3"):
        assert rules.spec_for(f"layers.1.{w}.weight", 3) == ("model",)
    assert rules.spec_for("layers.1.moe_gate.weight", 2) == ()
    assert rules.spec_for("layers.1.q.weight", 2) == ()
