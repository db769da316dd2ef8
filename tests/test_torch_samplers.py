"""The port's EDM-era diffusion modules against the JAX package, on the CPU.

* Every discretization's ladder (append, flip, indices), exact to 1e-6.
* The scalings and weightings, the denoisers (sigma and c_noise quantised by
  nearest rung, per sample and per frame), the guiders and the training sigma
  samplers, on the same inputs and injected draws.
* Every zoo sampler over 3 steps on a closed-form denoiser with CFG, on the
  LegacyDDPM ladder and three of them also on the EDM ladder, JAX's own
  per-step noise fed to the port (rtol 1e-4), and the port's network calls
  per sampler (a second call only where the next sigma, or sigma_down, is
  not 0); under IdentityGuider, one call a step on the batch itself.
* DPMPP2MSampler over EDMDiscretization through VideoDiffusionEngine.sample
  on the tiny DiT, JAX's start noise injected (rtol 1e-4).
* The PD, TASD and TASD-RF losses and their gradients with injected draws
  (values 1e-5, gradients 1e-4); the standard loss in l2 and l1, and its
  offset noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scail_tpu.utils.registry import instantiate_from_config as jax_instantiate
from scail_tpu_torch.utils.registry import instantiate_from_config

D = "sgm.modules.diffusionmodules."
LEGACY = {"target": D + "discretizer.LegacyDDPMDiscretization"}
EDM = {"target": D + "discretizer.EDMDiscretization",
       "params": {"sigma_min": 0.0292, "sigma_max": 14.6146, "rho": 3.0}}
ZERO_SNR = {"target": D + "discretizer.ZeroSNRDDPMDiscretization",
            "params": {"num_timesteps": 1000}}
CFG = {"target": D + "guiders.VanillaCFG", "params": {"scale": 5.0}}


def _both(config):
    return jax_instantiate(config), instantiate_from_config(config)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# ladders, scalings, denoisers, guiders, sigma samplers
# ---------------------------------------------------------------------------
DISCRETIZATIONS = {
    "legacy": LEGACY, "edm": EDM, "edm_default": {"target": D + "discretizer.EDMDiscretization"},
    "zero_snr": ZERO_SNR,
    "zero_snr_shift": {"target": ZERO_SNR["target"],
                       "params": {"shift_scale": 3.0, "keep_start": True}},
    "zero_snr_post": {"target": ZERO_SNR["target"],
                      "params": {"shift_scale": 2.0, "post_shift": True}},
    "rf": {"target": D + "discretizer.RFDiscretization"},
    "rf_reverse": {"target": D + "discretizer.RFDiscretization", "params": {"reverse": True}},
}


@pytest.mark.parametrize("name", sorted(DISCRETIZATIONS))
def test_discretization_ladders_match_jax(name):
    jd, pd = _both(DISCRETIZATIONS[name])
    for n in (1, 4, 50, 1000):
        for kw in ({}, {"do_append_zero": False}, {"flip": True},
                   {"do_append_zero": False, "flip": True}):
            want, got = jd(n, return_idx=True, **kw), pd(n, return_idx=True, **kw)
            np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
            assert got[0].dtype == np.asarray(want[0]).dtype
            if want[1] is None:
                assert got[1] is None
            else:
                np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(pd(n, **kw), got[0])


SCALINGS = ("EDMScaling", "EpsScaling", "VScaling", "RFScaling")


@pytest.mark.parametrize("name", SCALINGS + ("VideoScaling",))
def test_scalings_match_jax(name):
    js, ps = _both({"target": D + f"denoiser_scaling.{name}"})
    sigma = np.array([0.03, 0.4, 1.0, 7.5, 14.6], np.float32)[:, None, None]
    idx = np.array([3, 40, 100, 700, 999], np.int64)
    kw = {"idx": idx} if name == "VideoScaling" else {}
    sigma_in = np.clip(sigma / 15.0, 0.0, 0.999) if name == "VideoScaling" else sigma
    want = js(jnp.asarray(sigma_in), **kw)
    got = ps(_t(sigma_in), **{k: _t(v) for k, v in kw.items()})
    for w, g in zip(want, got):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ("UnitWeighting", "EpsWeighting", "VWeighting"))
def test_weightings_match_jax(name):
    jw, pw = _both({"target": D + f"denoiser_weighting.{name}"})
    sigma = np.array([0.03, 0.4, 1.0, 7.5], np.float32)
    np.testing.assert_allclose(pw(_t(sigma)).numpy(), np.asarray(jw(jnp.asarray(sigma))),
                               rtol=1e-6)


def _discrete_denoiser(target="DiscreteDenoiser", quantize_c_noise=True):
    return {"target": D + f"denoiser.{target}", "params": {
        "num_idx": 1000, "quantize_c_noise": quantize_c_noise,
        "weighting_config": {"target": D + "denoiser_weighting.EpsWeighting"},
        "scaling_config": {"target": D + "denoiser_scaling.EpsScaling"},
        "discretization_config": LEGACY}}


@pytest.mark.parametrize("config", [
    _discrete_denoiser(), _discrete_denoiser(quantize_c_noise=False),
    _discrete_denoiser("DiscreteDenoiser_TASD"),
    {"target": D + "denoiser.Denoiser", "params": {
        "weighting_config": {"target": D + "denoiser_weighting.VWeighting"},
        "scaling_config": {"target": D + "denoiser_scaling.VScaling"}}}],
    ids=["discrete", "discrete_raw_c_noise", "tasd", "plain"])
def test_denoisers_match_jax(config):
    """Sigma snapped to the nearest rung, c_noise to its index; the TASD
    variant with a per-frame (b, t) sigma."""
    jd, pd = _both(config)
    rng = np.random.default_rng(0)
    tasd = "TASD" in config["target"]
    shape = (2, 3, 4, 4, 4) if tasd else (3, 4, 4, 4)
    sig_shape = shape[:2] if tasd else shape[:1]
    x = rng.standard_normal(shape).astype(np.float32)
    sigma = rng.uniform(0.03, 14.0, sig_shape).astype(np.float32)
    seen = {}

    def net(lib):
        def f(xin, c_noise, cond, **kw):
            seen[lib] = np.asarray(c_noise)
            scale = c_noise.reshape(c_noise.shape + (1,) * (xin.ndim - c_noise.ndim))
            return xin * 0.5 + 1e-3 * scale
        return f

    want = jd(net("jax"), jnp.asarray(x), jnp.asarray(sigma), {})
    got = pd(net("torch"), _t(x), _t(sigma), {})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(seen["torch"], seen["jax"], rtol=1e-6)
    np.testing.assert_allclose(pd.w(_t(sigma)).numpy(), np.asarray(jd.w(jnp.asarray(sigma))),
                               rtol=1e-6)
    if hasattr(pd, "sigma_to_idx"):
        np.testing.assert_array_equal(pd.sigma_to_idx(_t(sigma)).numpy(),
                                      np.asarray(jd.sigma_to_idx(jnp.asarray(sigma))))


@pytest.mark.parametrize("config,kw", [
    (CFG, {}), (CFG, {"scale": 2.5}),
    ({"target": D + "guiders.DynamicCFG", "params": {"scale": 6, "exp": 5, "num_steps": 50}},
     {"step_index": 17, "scale": 99.0}),
    ({"target": D + "guiders.LinearPredictionGuider",
      "params": {"max_scale": 3.0, "num_frames": 3, "min_scale": 1.5}}, {}),
    ({"target": D + "guiders.IdentityGuider"}, {})],
    ids=["vanilla", "vanilla_scale", "dynamic", "linear_prediction", "identity"])
def test_guiders_match_jax(config, kw):
    jg, pg = _both(config)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 3, 2, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(pg(_t(x), 0.7, **kw).numpy(),
                               np.asarray(jg(jnp.asarray(x), 0.7, **kw)), rtol=1e-6, atol=1e-6)
    assert pg.scale_at(0.7, step_index=kw.get("step_index", 3)) == pytest.approx(
        jg.scale_at(0.7, step_index=kw.get("step_index", 3)))
    c = {"crossattn": rng.standard_normal((2, 5, 4)).astype(np.float32),
         "vector": rng.standard_normal((2, 6)).astype(np.float32),
         "ref": rng.standard_normal((2, 3)).astype(np.float32)}
    uc = {"crossattn": np.zeros((2, 3, 4), np.float32), "vector": np.zeros((2, 6), np.float32),
          "ref": c["ref"]}
    want = jg.prepare_cond({k: jnp.asarray(v) for k, v in c.items()},
                           {k: jnp.asarray(v) for k, v in uc.items()})
    got = pg.prepare_cond({k: _t(v) for k, v in c.items()}, {k: _t(v) for k, v in uc.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_edm_sampling_matches_jax_on_the_same_draw(monkeypatch):
    js, ps = _both({"target": D + "sigma_sampling.EDMSampling",
                    "params": {"p_mean": -1.0, "p_std": 1.4}})
    gen = torch.Generator().manual_seed(3)
    got = ps(gen, 6)
    z = torch.randn((6,), generator=torch.Generator().manual_seed(3)).numpy()
    monkeypatch.setattr(jax.random, "normal", lambda key, shape: jnp.asarray(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(js(jax.random.PRNGKey(0), 6)), rtol=1e-6)


@pytest.mark.parametrize("params", [
    {"discretization_config": ZERO_SNR, "num_idx": 1000},
    {"num_idx": 1000, "uniform_sampling": True, "group_num": 4},
    {"discretization_config": LEGACY, "num_idx": 1000, "do_append_zero": False}],
    ids=["zero_snr", "uniform_groups", "legacy"])
def test_discrete_sampling_matches_jax(params, monkeypatch):
    """The ladder and the lookup from injected indices; under
    uniform_sampling the group offsets of contiguous batch chunks from an
    injected in-interval draw."""
    js, ps = _both({"target": D + "sigma_sampling.DiscreteSampling", "params": params})
    np.testing.assert_allclose(ps.sigmas_np, np.asarray(js.sigmas), rtol=1e-6)
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 1000, (4, 3))
    got_s, got_i = ps(torch.Generator(), (4, 3), rand=_t(idx), return_idx=True)
    want_s, want_i = js(jax.random.PRNGKey(0), (4, 3), rand=jnp.asarray(idx), return_idx=True)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    if params.get("uniform_sampling"):
        r = rng.integers(0, 250, (8, 2))
        monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi: jnp.asarray(r))
        monkeypatch.setattr(torch, "randint", lambda lo, hi, shape, **kw: _t(r))
        _, got_i = ps(torch.Generator(), (8, 2), return_idx=True)
        _, want_i = js(jax.random.PRNGKey(0), (8, 2), return_idx=True)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        assert got_i[:2].max() < 250 and got_i[6:].min() >= 750


# ---------------------------------------------------------------------------
# the zoo on a closed-form denoiser
# ---------------------------------------------------------------------------
ZOO = ("EulerEDMSampler", "HeunEDMSampler", "DPMPP2MSampler", "SDEDPMPP2MSampler",
       "DDIMSampler", "EulerAncestralSampler", "DPMPP2SAncestralSampler",
       "LinearMultistepSampler")
STOCHASTIC = ("SDEDPMPP2MSampler", "DDIMSampler", "EulerAncestralSampler",
              "DPMPP2SAncestralSampler")
# the port's network calls at n steps into sigma 0 (PERF.md states them for
# the UNet): a second call a step for Heun and DPM++ 2S, but not into sigma 0
CALLS = {"HeunEDMSampler": lambda n: 2 * n - 1, "DPMPP2SAncestralSampler": lambda n: 2 * n - 1}


def _closed_form(lib):
    """denoise_fn(x, sigma, cond): a smooth x0 estimate that reads sigma and
    the conditioning, in JAX or in torch."""
    calls = []

    def fn(x, sigma, cond, cfg_scale=None, **kw):
        calls.append(x.shape[0])
        v = cond["vector"]
        if lib == "jax":
            s = sigma.reshape(-1, 1, 1, 1)
            return 0.8 * x / jnp.sqrt(1.0 + s ** 2) + 0.2 * v[:, :, None, None] - 0.01 * s
        s = sigma.reshape(-1, 1, 1, 1)
        return 0.8 * x / torch.sqrt(1.0 + s ** 2) + 0.2 * v[:, :, None, None] - 0.01 * s

    return fn, calls


def _jax_step_noise(seed, n, shape):
    """The stochastic JAX samplers' draws: the key split once a step."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.normal(sub, shape, jnp.float32)))
    return out


@pytest.mark.parametrize("name,disc", [(n, "legacy") for n in ZOO] + [
    (n, "edm") for n in ("EulerEDMSampler", "DPMPP2MSampler", "DPMPP2SAncestralSampler")])
def test_zoo_sampler_matches_jax(name, disc):
    n, shape = 3, (2, 4, 5, 5)
    params = {"num_steps": n, "discretization_config": LEGACY if disc == "legacy" else EDM,
              "guider_config": CFG}
    if name in STOCHASTIC:
        params["seed"] = 7
    js, ps = _both({"target": D + f"sampling.{name}", "params": params})
    rng = np.random.default_rng(4)
    x0 = rng.standard_normal(shape).astype(np.float32)
    c = {"vector": rng.standard_normal((2, 4)).astype(np.float32)}
    uc = {"vector": np.zeros((2, 4), np.float32)}
    jfn, _ = _closed_form("jax")
    pfn, calls = _closed_form("torch")
    want = js(jfn, jnp.asarray(x0), {k: jnp.asarray(v) for k, v in c.items()},
              uc={k: jnp.asarray(v) for k, v in uc.items()})
    noise = [_t(a) for a in _jax_step_noise(7, n, shape)] if name in STOCHASTIC else None
    got = ps(pfn, _t(x0), {k: _t(v) for k, v in c.items()}, uc={k: _t(v) for k, v in uc.items()},
             noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4 *
                               float(np.abs(np.asarray(want)).max()))
    assert len(calls) == CALLS.get(name, lambda k: k)(n) and set(calls) == {4}
    if name in STOCHASTIC:  # the generator path draws from the seed, repeatably
        again = [ps(pfn, _t(x0), {k: _t(v) for k, v in c.items()}) for _ in range(2)]
        torch.testing.assert_close(again[0], again[1], rtol=0, atol=0)


def test_lms_coefficients_and_video_ddim_match_jax():
    """The host coefficients of the multistep sampler, and VideoDDIMSampler
    over the zero-SNR ladder with DynamicCFG (the PD loss's sampler)."""
    import scail_tpu.diffusion.samplers as jax_samplers
    from scail_tpu_torch.diffusion import samplers as port_samplers

    t = np.asarray(instantiate_from_config(LEGACY)(6), np.float64)
    for order in (1, 2, 4):
        for i in range(6):
            for j in range(min(i + 1, order)):
                assert port_samplers._lms_coeff(min(i + 1, order), t, i, j) == \
                    jax_samplers._lms_coeff(min(i + 1, order), t, i, j)
    params = {"num_steps": 4, "discretization_config": ZERO_SNR,
              "guider_config": {"target": D + "guiders.DynamicCFG",
                                "params": {"scale": 6, "exp": 5, "num_steps": 4}}}
    js, ps = _both({"target": D + "sampling.VideoDDIMSampler", "params": params})
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32)
    c = {"vector": rng.standard_normal((2, 3)).astype(np.float32)}
    uc = {"vector": np.zeros((2, 3), np.float32)}
    seen = {}

    def fn(lib):
        def f(x, a, cond, idx=None, cfg_scale=None, **kw):
            seen.setdefault(lib, []).append(np.asarray(idx).copy())
            v = cond["vector"].reshape(x.shape[0], -1, 1, 1, 1)
            a = a.reshape(-1, 1, 1, 1, 1)
            return 0.7 * x * a + 0.1 * v
        return f

    want = js(fn("jax"), jnp.asarray(x0), {k: jnp.asarray(v) for k, v in c.items()},
              uc={k: jnp.asarray(v) for k, v in uc.items()})
    got = ps(fn("torch"), _t(x0), {k: _t(v) for k, v in c.items()},
             uc={k: _t(v) for k, v in uc.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    for a, b in zip(seen["torch"], seen["jax"]):
        np.testing.assert_array_equal(a, b)


def test_dpmpp2m_over_edm_through_the_video_engine_matches_jax():
    """VideoDiffusionEngine.sample with the zoo's DPMPP2MSampler on the EDM
    ladder and VanillaCFG over the tiny DiT, the JAX start noise injected."""
    from scail_tpu.engine import VideoDiffusionEngine as JaxEngine
    from scail_tpu.testing import tiny_cond, tiny_model_config
    from scail_tpu_torch.convert.from_jax import dit_state_dict_from_jax
    from scail_tpu_torch.engine import VideoDiffusionEngine

    mc = tiny_model_config()
    mc["network_config"]["params"]["attn_impl"] = "xla"  # plain attention on both sides
    del mc["first_stage_config"], mc["loss_fn_config"]  # sampling needs neither
    mc["sampler_config"] = {"target": D + "sampling.DPMPP2MSampler", "params": {
        "num_steps": 3, "guider_config": {"target": D + "guiders.VanillaCFG",
                                          "params": {"scale": 4.0}},
        "discretization_config": {"target": D + "discretizer.EDMDiscretization",
                                  "params": {"sigma_min": 0.01, "sigma_max": 1.0}}}}
    jeng = JaxEngine(mc, {"bf16": False})
    # sampling needs the DiT only
    jeng.params["dit"] = jax.jit(jeng.network.init)(jax.random.PRNGKey(0))
    cond = tiny_cond(jax.random.PRNGKey(1))
    uc = dict(cond, crossattn=jnp.zeros_like(cond["crossattn"]))
    shape = (2, 16, 8, 8)
    want = jeng.sample(jax.random.PRNGKey(2), cond, uc, batch_size=1, shape=shape)
    start = np.array(jax.random.normal(jax.random.PRNGKey(2), (1, *shape), jnp.float32))

    eng = VideoDiffusionEngine(mc, {"bf16": False}, device="cpu")
    assert type(eng.sampler).__module__ == "scail_tpu_torch.diffusion.samplers"
    eng.init_params(torch.Generator().manual_seed(0))
    eng.dit.load_state_dict(dit_state_dict_from_jax(jax.tree.map(np.asarray, jeng.params["dit"])))
    to_t = lambda d: {k: _t(v) for k, v in d.items()}  # noqa: E731
    got = eng.sample(None, to_t(cond), to_t(uc), batch_size=1, shape=shape, noise=_t(start))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * float(np.abs(np.asarray(want)).max()))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _video_denoiser(scaling="VideoScaling", weighting="UnitWeighting", target="Denoiser",
                    **params):
    return {"target": D + f"denoiser.{target}", "params": dict(
        weighting_config={"target": D + f"denoiser_weighting.{weighting}"},
        scaling_config={"target": D + f"denoiser_scaling.{scaling}"}, **params)}


def _value_and_grad(lib, loss_of, w0):
    """(loss value (b,), d sum / d w) in JAX or torch for a scalar weight."""
    if lib == "jax":
        val = loss_of(jnp.asarray(w0))
        g = jax.grad(lambda w: jnp.sum(loss_of(w)))(jnp.asarray(w0))
        return np.asarray(val), np.asarray(g)
    w = torch.tensor(w0, requires_grad=True)
    val = loss_of(w)
    val.sum().backward()
    return val.detach().numpy(), w.grad.numpy()


def _check(jres, pres):
    np.testing.assert_allclose(pres[0], jres[0], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pres[1], jres[1], rtol=1e-4, atol=1e-7)


def _student(lib):
    """A student with a weight, reading c_noise, cfg_scale and positions."""
    def make(w):
        def net(x, c_noise, cond, cfg_scale=None, rope_position_ids=None, **kw):
            shape = c_noise.shape + (1,) * (x.ndim - c_noise.ndim)
            out = w * x + 1e-4 * c_noise.reshape(shape)
            if cfg_scale is not None:
                out = out + 0.01 * cfg_scale.reshape((-1,) + (1,) * (x.ndim - 1))
            if rope_position_ids is not None:
                out = out + 1e-3 * rope_position_ids.sum() / rope_position_ids.reshape(-1).shape[0]
            return out
        return net
    return make


def test_pd_loss_value_and_gradient_match_jax(monkeypatch):
    """Two teacher DDIM steps without gradient, the student at a random
    scale: JAX's rung, scale and noise draws fed to the port."""
    import scail_tpu.diffusion.loss as jloss

    cfg = {"target": D + "loss.PDDiffusionLoss",
           "params": {"discretization_config": ZERO_SNR, "num_idx": 1000, "add_dsm_loss": True}}
    jl, pl = _both(cfg)
    jden, pden = _both(_video_denoiser())
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    k_rand, k_scale, k_noise = jax.random.split(key, 3)
    rand = np.array(jax.random.randint(k_rand, (2,), 1, 501) * 2)
    scale = np.array(1.5 + jax.random.uniform(k_scale, (2,)) * 7.5)
    noise = np.array(jax.random.normal(k_noise, x.shape, jnp.float32))

    def teacher(xin, c_noise, cond, **kw):
        return 0.9 * xin + 1e-4 * c_noise.reshape((-1,) + (1,) * (xin.ndim - 1))

    jres = _value_and_grad("jax", lambda w: jl(key, _student("jax")(w), jden, {},
                                               jnp.asarray(x), teacher_fn=teacher), 0.5)
    pres = _value_and_grad("torch", lambda w: pl(None, _student("torch")(w), pden, {}, _t(x),
                                                 teacher_fn=teacher, rand=_t(rand),
                                                 scale=_t(scale), noise=_t(noise)), 0.5)
    _check(jres, pres)
    emb = jloss.guidance_scale_embedding(jnp.asarray([2.0, 7.5]), 11)
    from scail_tpu_torch.diffusion.loss import guidance_scale_embedding

    np.testing.assert_allclose(guidance_scale_embedding(torch.tensor([2.0, 7.5]), 11).numpy(),
                               np.asarray(emb), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("min_snr", (None, 5.0))
def test_tasd_loss_value_and_gradient_match_jax(min_snr):
    cfg = {"target": D + "loss.TASDLoss", "params": {
        "min_snr_value": min_snr,
        "sigma_sampler_config": {"target": D + "sigma_sampling.DiscreteSampling",
                                 "params": {"discretization_config": ZERO_SNR,
                                            "num_idx": 1000}}}}
    jl, pl = _both(cfg)
    den = _video_denoiser(target="DiscreteDenoiser_TASD", num_idx=1000,
                          discretization_config=ZERO_SNR, quantize_c_noise=False)
    jden, pden = _both(den)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32)
    idx = rng.integers(1, 999, (2, 3))
    noise = rng.standard_normal(x.shape).astype(np.float32)
    kw = dict(patch_size=(1, 2, 2))
    jres = _value_and_grad("jax", lambda w: jl(jax.random.PRNGKey(0), _student("jax")(w), jden,
                                               {}, jnp.asarray(x), noise=jnp.asarray(noise),
                                               alphas_idx=jnp.asarray(idx), **kw), 0.6)
    pres = _value_and_grad("torch", lambda w: pl(None, _student("torch")(w), pden, {}, _t(x),
                                                 noise=_t(noise), alphas_idx=_t(idx), **kw), 0.6)
    _check(jres, pres)


@pytest.mark.parametrize("params", [{}, {"schedule_shift": True, "remove_first": False}],
                         ids=["plain", "shift_keep_first"])
def test_tasd_rf_loss_value_and_gradient_match_jax(params):
    cfg = {"target": D + "loss.TASDLoss_RF", "params": dict(
        params, sigma_sampler_config={"target": D + "sigma_sampling.RFSampling"})}
    jl, pl = _both(cfg)
    jden, pden = _both(_video_denoiser("RFScaling", "EpsWeighting"))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32)
    t_idx = rng.uniform(0.05, 0.95, (2, 3)).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    jres = _value_and_grad("jax", lambda w: jl(jax.random.PRNGKey(0), _student("jax")(w), jden,
                                               {}, jnp.asarray(x), noise=jnp.asarray(noise),
                                               t_indices=jnp.asarray(t_idx)), 0.4)
    pres = _value_and_grad("torch", lambda w: pl(None, _student("torch")(w), pden, {}, _t(x),
                                                 noise=_t(noise), t_indices=_t(t_idx)), 0.4)
    _check(jres, pres)


@pytest.mark.parametrize("kind", ("l2", "l1"))
def test_standard_loss_matches_jax(kind, monkeypatch):
    """The standard denoising loss on the EDM parametrization, JAX's sigma and
    noise injected; with offset noise, x + sigma * (noise + level * offset)."""
    cfg = {"target": D + "loss.StandardDiffusionLoss", "params": {
        "type": kind, "sigma_sampler_config": {"target": D + "sigma_sampling.EDMSampling"}}}
    jl, pl = _both(cfg)
    jden, pden = _both(_video_denoiser("EDMScaling", "VWeighting"))
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 4, 6, 6)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    k_sig, k_noise = jax.random.split(key)
    sigma = np.array(jl.sigma_sampler(k_sig, 3))
    noise = np.array(jax.random.normal(k_noise, x.shape, jnp.float32))
    jres = _value_and_grad("jax", lambda w: jl(key, _student("jax")(w), jden, {},
                                               jnp.asarray(x)), 0.3)
    pres = _value_and_grad("torch", lambda w: pl(None, _student("torch")(w), pden, {}, _t(x),
                                                 sigma=_t(sigma), noise=_t(noise)), 0.3)
    _check(jres, pres)

    pl.offset_noise_level = 0.1
    offset = np.array([0.5, -1.0, 2.0], np.float32)
    got = pl(None, _student("torch")(0.3), pden, {}, _t(x), sigma=_t(sigma), noise=_t(noise),
             offset=_t(offset))
    pl.offset_noise_level = 0.0
    shifted = noise + 0.1 * offset[:, None, None, None]
    np.testing.assert_allclose(got.numpy(), pl(None, _student("torch")(0.3), pden, {}, _t(x),
                                               sigma=_t(sigma), noise=_t(shifted)).numpy(),
                               rtol=1e-6)


def test_zoo_under_the_identity_guider_calls_the_network_once_a_step_on_the_batch():
    """Without CFG the zoo calls the network on the batch itself and equals
    VanillaCFG at scale 1 (the conditional branch alone).  The JAX zoo always
    doubles the batch, which its IdentityGuider does not undo."""
    params = {"num_steps": 3, "discretization_config": LEGACY}
    ident = instantiate_from_config({"target": D + "sampling.HeunEDMSampler", "params": dict(
        params, guider_config={"target": D + "guiders.IdentityGuider"})})
    cfg1 = instantiate_from_config({"target": D + "sampling.HeunEDMSampler", "params": dict(
        params, guider_config={"target": D + "guiders.VanillaCFG", "params": {"scale": 1.0}})})
    x0 = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 4, 5, 5)).astype(
        np.float32))
    c = {"vector": torch.ones((2, 4))}
    fn, calls = _closed_form("torch")
    got = ident(fn, x0, c, uc={"vector": torch.zeros((2, 4))})
    assert set(calls) == {2} and len(calls) == 5
    torch.testing.assert_close(got, cfg1(fn, x0, c, uc={"vector": torch.zeros((2, 4))}),
                               rtol=1e-6, atol=1e-6)
