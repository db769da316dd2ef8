"""Parity of the PyTorch port's DiT with the JAX DiT at a tiny config.

The same numpy inputs and the JAX-initialised weights (bridged with
scail_tpu_torch.convert.from_jax) go through `scail_tpu.models.dit.dit_forward`
and `scail_tpu_torch.models.dit.DiT`.  Everything runs in f32 on the CPU,
where the port's attention wrappers take their plain versions.  Tolerance
2e-4: the JAX package's own interpret-mode DiT test uses the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scail_tpu.models.dit import DiTConfig as JaxDiTConfig
from scail_tpu.models.dit import dit_forward, init_dit_params
from scail_tpu_torch.convert.from_jax import dit_state_dict_from_jax
from scail_tpu_torch.models.dit import DiT, DiTConfig
from scail_tpu_torch.ops import attention as port_attention

TINY = dict(hidden_size=32, num_layers=2, num_heads=4, inner_hidden_size=48,
            time_embed_dim=32, text_dim=16, clip_dim=8, share_adaln=True,
            use_i2v_clip=True, dtype="float32", interleaved_rope=True)


def _inputs(seed=11):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=f(1, 2, 16, 8, 8), t=np.full((1,), 500.0, np.float32), ctx=f(1, 8, 16),
                ref=f(1, 1, 16, 8, 8), smpl=f(1, 2, 16, 4, 4), clip=f(1, 5, 8))


def _port_model(params, cfg):
    model = DiT(cfg)
    model.load_state_dict(dit_state_dict_from_jax(params, cfg))
    return model


def _run_port(model, inp):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    with torch.no_grad():
        return model(t["x"], t["t"], t["ctx"], ref_concat=t["ref"],
                     concat_smpl_render=t["smpl"], image_clip_features=t["clip"]).numpy()


def _run_jax(params, cfg, inp):
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    return np.asarray(dit_forward(params, cfg, j["x"], j["t"], j["ctx"], ref_concat=j["ref"],
                                  concat_smpl_render=j["smpl"],
                                  image_clip_features=j["clip"]))


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("interleaved", [True, False])
def test_dit_matches_jax(jax_impl, interleaved):
    kw = dict(TINY, interleaved_rope=interleaved)
    jcfg = JaxDiTConfig(**kw, attn_impl=jax_impl)
    params = init_dit_params(jax.random.PRNGKey(0), JaxDiTConfig(**kw))
    inp = _inputs()
    if jax_impl == "pallas":
        from jax.experimental.pallas import tpu as pltpu

        with pltpu.force_tpu_interpret_mode():
            want = _run_jax(params, jcfg, inp)
    else:
        want = _run_jax(params, jcfg, inp)
    port_attention.reset_launch_counts()
    got = _run_port(_port_model(params, DiTConfig(**kw)), inp)
    assert got.shape == want.shape == (1, 2, 16, 8, 8)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert all(v == 0 for v in port_attention.LAUNCHES.values())


def test_dit_plain_impl_matches_kernel_wrapper_on_cpu():
    """attn_impl 'xla' (plain on any device) and 'auto' (kernel wrapper,
    plain on CPU tensors) compute the same function."""
    params = init_dit_params(jax.random.PRNGKey(3), JaxDiTConfig(**TINY))
    inp = _inputs(5)
    a = _run_port(_port_model(params, DiTConfig(**TINY, attn_impl="auto")), inp)
    b = _run_port(_port_model(params, DiTConfig(**TINY, attn_impl="xla")), inp)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["heads_over_seq_model", "ring_rows_over_seq",
                                  "mesh_larger_than_world"])
def test_mesh_errors_raise(case):
    """What a mesh cannot run raises before any collective: heads that do not
    divide over seq x model under Ulysses, a token count that does not divide
    over the seq ranks under the ring (S = 4 + 4 + 1 at a 4x4 latent), and a
    mesh larger than the world.  The checks take the single-process view of
    a mesh (a Mesh without process groups)."""
    from scail_tpu_torch.parallel.mesh import Mesh, MeshSpec, make_mesh

    if case == "mesh_larger_than_world":
        with pytest.raises(RuntimeError, match="needs 2 ranks but the world has 1"):
            make_mesh(MeshSpec(seq=2))
        return
    impl, spec, hw, match = {
        "heads_over_seq_model": ("ulysses", MeshSpec(seq=2, model=4), 8,
                                 "heads 4 not divisible by seq\\*model"),
        "ring_rows_over_seq": ("ring", MeshSpec(seq=2), 4, "attn_impl='ring'.*9 tokens"),
    }[case]
    inp = _inputs()
    b = 1
    inp = dict(inp, x=inp["x"][:, :1, :, :hw, :hw], ref=inp["ref"][..., :hw, :hw],
               smpl=inp["smpl"][:, :1, :, :hw // 2, :hw // 2])
    t = {k: torch.from_numpy(np.ascontiguousarray(v))[:b] for k, v in inp.items()}
    with pytest.raises(ValueError, match=match):
        DiT(DiTConfig(**TINY, attn_impl=impl))(
            t["x"], t["t"], t["ctx"], ref_concat=t["ref"], concat_smpl_render=t["smpl"],
            image_clip_features=t["clip"], mesh=Mesh(spec))


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_unknown_attn_impl_raises(impl):
    with pytest.raises(ValueError, match="unknown attn_impl"):
        DiT(DiTConfig(**TINY, attn_impl=impl))


def test_moe_and_remat_training_raise():
    """MoE builds (tests/test_torch_moe.py holds it against the JAX DiT);
    every remat policy of the JAX package builds (tests/test_torch_remat.py
    trains them), and an unknown one raises."""
    moe = DiT(DiTConfig(**TINY, num_experts=2))
    assert moe.layers[0].moe_in.weight.shape == (2, 48, 32)
    for policy in ("default", "save_attn", "save_attn_frac", "offload_attn"):
        DiT(DiTConfig(**TINY, remat=True, remat_policy=policy))
    with pytest.raises(ValueError, match="unknown remat_policy"):
        DiT(DiTConfig(**TINY, remat=True, remat_policy="save_everything"))
    DiT(DiTConfig(**TINY, remat=False, remat_policy="save_everything"))  # ignored without remat
