"""The port's remat policies that keep the flash outputs (save_attn,
save_attn_frac, offload_attn) against the JAX DiT and against the port's
own `default` policy, on the CPU, dense and STA.

* Loss and gradients against `dit_forward` under the same policy, at 2e-4 of
  each tensor's largest entry (the readout sums a few thousand outputs, so
  gradients reach ~10; f32 summation order).  The dense JAX side runs its
  XLA attention under jax.checkpoint, which cannot partially evaluate the
  interpret-mode Pallas kernels (tests/test_torch_training.py); its STA
  kernels run in interpret mode, so the STA case holds the port's policy
  against the JAX STA forward without remat: a policy changes what is kept,
  not the function.
* Against the port's `default` policy at 1e-6: the recompute takes the kept
  (out, lse) back, which are the very values it would recompute.
* The plain flash forwards run L times under save_attn and offload_attn and
  L + (L - k) times under save_attn_frac, against 2L under `default`
  (forward and recompute; on CPU tensors the wrappers take their plain
  versions, which count here as the kernels do on the card).
* save_attn_head_layers equals the JAX function.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scail_tpu.models.dit import DiTConfig as JaxDiTConfig
from scail_tpu.models.dit import dit_forward, init_dit_params
from scail_tpu.models.dit import save_attn_head_layers as jax_head_layers
from scail_tpu_torch.convert.from_jax import dit_state_dict_from_jax
from scail_tpu_torch.models.dit import DiT, DiTConfig, save_attn_head_layers
from scail_tpu_torch.ops import attention as tattn
from scail_tpu_torch.ops import sta as tsta

TINY = dict(hidden_size=32, num_layers=3, num_heads=2, inner_hidden_size=48, time_embed_dim=32,
            text_dim=16, clip_dim=8, share_adaln=True, use_i2v_clip=True, dtype="float32",
            interleaved_rope=True)
# (latent (T, H, W), extra config): the STA geometry runs the windowed video
# and pose calls (K7) and the dense ref rows (K2) in every layer
ATTN = {"dense": ((3, 8, 8), {}),
        "sta": ((1, 16, 32), dict(attn_impl="sta", sta_tile=(1, 2), sta_window=(1, 2)))}
POLICIES = ("save_attn", "save_attn_frac", "offload_attn")
SAVE_FRAC = 0.5  # 3 layers -> 1 head layer keeps its flash outputs


def _inputs(attn):
    (T, H, W), _ = ATTN[attn]
    rng = np.random.default_rng(1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inp = dict(x=f(1, T, 16, H, W), t=np.full((1,), 700.0, np.float32), ctx=f(1, 6, 16),
               ref=f(1, 1, 16, H, W), smpl=f(1, T, 16, H // 2, W // 2), clip=f(1, 5, 8))
    return inp, f(1, T, 16, H, W)


@functools.lru_cache(maxsize=None)
def _params():
    return init_dit_params(jax.random.PRNGKey(0), JaxDiTConfig(**TINY))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(attn, policy):
    """The readout loss and its parameter gradients (as a port state dict)."""
    inp, w = _inputs(attn)
    kw = dict(TINY, **ATTN[attn][1])
    if attn == "dense":
        kw.update(attn_impl="xla", remat=True, remat_policy=policy, remat_save_frac=SAVE_FRAC)

    def loss(p):
        out = dit_forward(p, JaxDiTConfig(**kw), *(jnp.asarray(inp[n]) for n in ("x", "t", "ctx")),
                          ref_concat=jnp.asarray(inp["ref"]),
                          concat_smpl_render=jnp.asarray(inp["smpl"]),
                          image_clip_features=jnp.asarray(inp["clip"]))
        return jnp.sum(out * w)

    with pltpu.force_tpu_interpret_mode():
        value, grads = jax.value_and_grad(loss)(_params())
    return float(value), dit_state_dict_from_jax(jax.tree.map(np.asarray, grads))


def _port_loss_and_grads(attn, policy, monkeypatch=None):
    """(loss, {name: grad}, plain flash forward calls) of the port's DiT."""
    inp, w = _inputs(attn)
    calls = {"n": 0}
    if monkeypatch is not None:
        for mod, name in ((tattn, "flash_attention_plain"), (tsta, "sta_windowed_plain")):
            real = getattr(mod, name)

            def counted(*a, _real=real, **k):
                calls["n"] += 1
                return _real(*a, **k)

            monkeypatch.setattr(mod, name, counted)
    tsta.sta_plan.cache_clear()
    model = DiT(DiTConfig(**TINY, **ATTN[attn][1], remat=True, remat_policy=policy,
                          remat_save_frac=SAVE_FRAC))
    model.load_state_dict(dit_state_dict_from_jax(_params()))
    model.requires_grad_(True)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    out = model(t["x"], t["t"], t["ctx"], ref_concat=t["ref"], concat_smpl_render=t["smpl"],
                image_clip_features=t["clip"])
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}, calls["n"]


def _calls_per_forward(attn):
    """Plain flash forwards in one layer's forward: the dense self-attention,
    or the windowed video and pose calls and the dense ref rows."""
    return 1 if attn == "dense" else 3


@pytest.mark.parametrize("attn", list(ATTN))
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_loss_and_grads_match_jax(policy, attn):
    want_loss, want = _jax_loss_and_grads(attn, policy)
    loss, grads, _ = _port_loss_and_grads(attn, policy)
    np.testing.assert_allclose(loss, want_loss, rtol=2e-4)
    assert set(grads) == set(want)
    for n, g in want.items():
        g = g.numpy()
        np.testing.assert_allclose(grads[n].numpy(), g, rtol=2e-4,
                                   atol=2e-4 * max(1.0, np.abs(g).max()), err_msg=n)


@pytest.mark.parametrize("attn", list(ATTN))
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_equals_default_and_skips_the_recompute(policy, attn, monkeypatch):
    L = TINY["num_layers"]
    per = _calls_per_forward(attn)
    base_loss, base, base_calls = _port_loss_and_grads(attn, "default", monkeypatch)
    loss, grads, calls = _port_loss_and_grads(attn, policy, monkeypatch)
    assert base_calls == 2 * L * per
    k = save_attn_head_layers(DiTConfig(**TINY, remat_save_frac=SAVE_FRAC))
    assert k == 1
    assert calls == (L + (L - k) if policy == "save_attn_frac" else L) * per
    np.testing.assert_allclose(loss, base_loss, rtol=1e-6)
    for n, g in base.items():
        np.testing.assert_allclose(grads[n].numpy(), g.numpy(), rtol=1e-6,
                                   atol=1e-6 * max(1.0, g.abs().max().item()), err_msg=n)


@pytest.mark.parametrize("layers, frac", [(4, 0.5), (30, 0.7), (3, 0.0), (3, 1.0)])
def test_save_attn_head_layers_match_jax(layers, frac):
    kw = dict(TINY, num_layers=layers, remat=True, remat_policy="save_attn_frac",
              remat_save_frac=frac)
    assert save_attn_head_layers(DiTConfig(**kw)) == jax_head_layers(JaxDiTConfig(**kw))


def test_stash_refuses_a_second_replay():
    """The recompute takes each kept output once; a replay past them raises
    and names the policy."""
    stash = tattn.FlashStash("save_attn")
    record, replay = stash.contexts()
    x = torch.ones(2)
    with record:
        got = tattn.stashed_flash(lambda: (x, x))
    assert got == (x, x)
    with replay:
        assert all(torch.equal(a, x) for a in tattn.stashed_flash(lambda: 1 / 0))
        with pytest.raises(RuntimeError, match="save_attn"):
            tattn.stashed_flash(lambda: (x, x))
    assert tattn.stashed_flash(lambda: "launched") == "launched"  # no stash outside
