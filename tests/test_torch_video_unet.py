"""The port's SVD VideoUNet (scail_tpu_torch/models/video_unet.py) against
the JAX VideoUNet, on the CPU, f32.

The port's model is drawn with random non-zero weights (zero-init layers
drawn too, so every block moves the output); its sgm-named state dict goes
through the JAX loader `video_unet_params_from_torch`, and both models run
the same numpy inputs.  The weight bridge takes the JAX tree back to the
port's names exactly, and `video_unet_state_dict_from_sgm` picks the same
tensors.  Tolerance 1e-4 (relative L2 and elementwise, the port's module
tolerance).
"""

import numpy as np
import pytest
import torch

T = 3
CFG = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
           attention_resolutions=[1, 2], channel_mult=(1, 2), num_head_channels=8,
           context_dim=12, extra_ff_mix_layer=True, video_kernel_size=[3, 1, 1],
           use_linear_in_transformer=True, num_classes="sequential", adm_in_channels=10,
           time_downup=True)
CASES = {
    "time_ctx": dict(use_spatial_context=False, time_context_dim=12,
                     merge_strategy="learned_with_images"),
    "spatial_ctx": dict(use_spatial_context=True, merge_strategy="learned_with_images"),
    "fixed_conv_proj": dict(merge_strategy="fixed", use_linear_in_transformer=False,
                            extra_ff_mix_layer=False, num_classes=None,
                            disable_temporal_crossattention=True),
}


def _inputs(case, seed=3):
    rng = np.random.default_rng(seed)
    b = 2
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inp = dict(x=f(b * T, 4, 8, 8), t=rng.uniform(0, 999, (b * T,)).astype(np.float32),
               ctx=f(b * T, 5, 12))
    cfg = dict(CFG, **CASES[case])
    if cfg["num_classes"] is not None:
        inp["y"] = f(b * T, 10)
    if cfg["merge_strategy"] == "learned_with_images":
        inp["ioi"] = np.stack([np.zeros(T), np.ones(T)]).astype(np.float32)
    if not cfg.get("use_spatial_context") and cfg.get("time_context_dim"):
        inp["tc"] = f(b, 5, 12)
    return cfg, inp


def _port(cfg, seed=0):
    from scail_tpu_torch.models.video_unet import VideoUNet

    model = VideoUNet(**cfg)
    model.init_random_(torch.Generator().manual_seed(seed), zero_modules=False)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("mix_factor"):
                p.fill_(0.3)  # a mix the sigmoid does not saturate
    return model


def _run_port(model, inp):
    g = lambda k: torch.from_numpy(inp[k]) if k in inp else None  # noqa: E731
    with torch.no_grad():
        return model(g("x"), g("t"), context=g("ctx"), y=g("y"), time_context=g("tc"),
                     num_video_frames=T, image_only_indicator=g("ioi")).numpy()


def _run_jax(jmodel, params, inp):
    import jax
    import jax.numpy as jnp

    g = {k: jnp.asarray(v) for k, v in inp.items()}
    g["x"] = g["x"].transpose(0, 2, 3, 1)

    def run(p, g):
        return jmodel(p, g["x"], g["t"], context=g["ctx"], y=g.get("y"),
                      time_context=g.get("tc"), num_video_frames=T,
                      image_only_indicator=g.get("ioi"))

    return np.asarray(jax.jit(run)(params, g)).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("case", list(CASES))
def test_video_unet_matches_jax(case):
    from scail_tpu.models.video_unet import VideoUNet as JaxVideoUNet
    from scail_tpu.models.video_unet import video_unet_params_from_torch
    from scail_tpu_torch.convert.from_jax import video_unet_state_dict_from_jax
    from scail_tpu_torch.models.video_unet import video_unet_state_dict_from_sgm

    cfg, inp = _inputs(case)
    model = _port(cfg)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jmodel = JaxVideoUNet(**cfg)
    params = video_unet_params_from_torch(sd, jmodel)
    # the converters: JAX's from the sgm names, bridged back, and the port's
    bridged = video_unet_state_dict_from_jax(params, cfg["num_classes"])
    picked = video_unet_state_dict_from_sgm(sd, model)
    assert set(bridged) == set(picked) == set(sd)
    for k in sd:
        assert np.array_equal(bridged[k].numpy(), sd[k]), k
        assert np.array_equal(picked[k].numpy(), sd[k]), k
    got, want = _run_port(model, inp), _run_jax(jmodel, params, inp)
    assert got.shape == (2 * T, 4, 8, 8)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-4, rel
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_video_unet_jax_init_loads_through_the_bridge():
    """JAX `VideoUNet.init` bridged loads strictly into the port's model, every
    tensor as JAX drew it (the AlphaBlenders at merge_factor)."""
    import jax

    from scail_tpu.models.video_unet import VideoUNet as JaxVideoUNet
    from scail_tpu_torch.convert.from_jax import video_unet_state_dict_from_jax
    from scail_tpu_torch.models.video_unet import VideoUNet

    cfg = dict(CFG, **CASES["time_ctx"], channel_mult=(1,), attention_resolutions=[1])
    params = JaxVideoUNet(**cfg).init(jax.random.PRNGKey(0))
    model = VideoUNet(**cfg)
    sd = video_unet_state_dict_from_jax(params, cfg["num_classes"])
    model.load_state_dict(sd)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())
    mix = [v for k, v in sd.items() if k.endswith("mix_factor")]
    assert mix and all(float(v) == 0.5 for v in mix)


def test_sgm_loader_raises_on_missing_and_misshapen_keys():
    from scail_tpu_torch.models.video_unet import video_unet_state_dict_from_sgm

    cfg, _ = _inputs("fixed_conv_proj")
    model = _port(cfg)
    sd = dict(model.state_dict())
    sd.pop("out.2.weight")
    with pytest.raises(KeyError, match="out.2.weight"):
        video_unet_state_dict_from_sgm(sd, model)
    sd = dict(model.state_dict(), **{"out.0.weight": torch.zeros(3)})
    with pytest.raises(ValueError, match="out.0.weight"):
        video_unet_state_dict_from_sgm(sd, model)


def test_registry_alias_builds_the_port_model():
    """sgm's target name builds the port's VideoUNet (ensure_imports lists
    the module)."""
    from scail_tpu_torch.models.video_unet import VideoUNet
    from scail_tpu_torch.utils import registry

    registry.ensure_imports()
    model = registry.instantiate_from_config(
        {"target": "sgm.modules.diffusionmodules.video_model.VideoUNet",
         "params": dict(CFG, **CASES["fixed_conv_proj"])})
    assert type(model) is VideoUNet
