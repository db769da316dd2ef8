"""SCAIL's shared-AdaLN DiT (Wan2.1 family): everything of the network that
the harness, the check and the control take from an architecture.

A configuration whose file names no `architecture` runs on this module.  It
binds the benchmark's SCAIL pieces: the weights' recipe
(portbench/weights.py), the work counts (portbench/flops.py), the inputs
(portbench/inputs.py), the reference's guided RF step (portbench/reference)
and the port's VideoDiffusionEngine with its one DiT.  Another architecture
is a module of its own beside this one, with the same names.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench import flops, inputs
from portbench.geometry import Geometry
from portbench.reference import step as ref_step
from portbench.reference.dit import Matmuls, exact_f32
from portbench.weights import Spec, block_tensors, dit_param_specs

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def net(cell) -> dict:
    """The DiT's network params as the cell runs them: the configuration's,
    with the model's use_i2v_clip (the engine passes it on) and the
    traffic's attention implementation."""
    params = dict(cell.config["model"]["network_config"]["params"])
    params["use_i2v_clip"] = bool(cell.config["model"].get("use_i2v_clip", False))
    params["attn_impl"] = cell.traffic["attn_impl"]
    sta = cell.traffic.get("sta")
    if sta is not None:
        params.update(sta_tile=list(sta["tile"]), sta_window=list(sta["window"]),
                      sta_windowed_pose=bool(sta["windowed_pose"]),
                      sta_pose_kv_window=int(sta["pose_kv_window"]))
    return params


def _sampler(cell) -> dict:
    return cell.config["model"]["sampler_config"]["params"]


def build_engine(cell, device: str):
    """The port's engine from the cell's configuration: its DiT, denoiser and
    sampler (the encoders are not in these cells)."""
    from scail_tpu_torch.engine import VideoDiffusionEngine

    model = cell.config["model"]
    model_config = {k: model[k] for k in ("use_i2v_clip", "latent_input", "use_pose",
                                            "denoiser_config", "sampler_config") if k in model}
    model_config["network_config"] = dict(model["network_config"], params=cell.net)
    return VideoDiffusionEngine(model_config, {"bf16": cell.config["dtype"] == "bfloat16"},
                                device=device)


def _param_specs(cell) -> Dict[str, Dict[str, Spec]]:
    """{network: {block: [(parameter name, shape), ...]}}: the one DiT."""
    return {"dit": dit_param_specs(cell.net)}


def load_weights(engine, cell, seed: int) -> List[torch.nn.Module]:
    """Build the port's DiT on the meta device and give it the benchmark's
    weights for `seed` as its parameters (no copy); returns the networks
    the window hooks, [the DiT]."""
    dit = engine.network.build("meta")
    specs = _param_specs(cell)["dit"]
    want = {name: tuple(shape) for spec in specs.values() for name, shape in spec}
    have = {name: tuple(p.shape) for name, p in dit.named_parameters()}
    if want != have:
        raise RuntimeError(f"the DiT's parameters differ from the benchmark's: "
                           f"{sorted(set(want.items()) ^ set(have.items()))[:8]}")
    dtype = engine.network.config.compute_dtype
    for block, spec in specs.items():
        for name, t in block_tensors(seed, block, spec, device=engine.device, dtype=dtype).items():
            parent, _, leaf = name.rpartition(".")
            dit.get_submodule(parent)._parameters[leaf] = torch.nn.Parameter(t, requires_grad=False)
    engine.dit = dit.eval()
    return [engine.dit]


def conditioning(cell, seed: int, device) -> Tuple[Dict, Dict]:
    return inputs.conditioning(seed, cell.net, cell.traffic, device=device)


def noise(cell, seed: int, request: int, device) -> torch.Tensor:
    return inputs.noise(seed, request, cell.net, cell.traffic, device=device)


def sample(engine, cell, cond, uncond, noise) -> None:
    """One request: the sampler's steps from `noise`."""
    traffic = cell.traffic
    shape = inputs.latent_shape(Geometry(traffic["frames"], traffic["height"], traffic["width"]),
                                cell.net["out_channels"])
    gen = torch.Generator(device=engine.device).manual_seed(0)  # unused: noise is given
    engine.sample(gen, cond, uncond, batch_size=traffic["batch"], shape=shape, noise=noise)


def step_view(args, out):
    """(x, sigma, next sigma, x next) of a call of RFSampler.step
    (denoise_fn, x, sigma, next_sigma, ...) that returned `out`."""
    return args[1], args[2], args[3], out


def start_state(cell, noise: torch.Tensor) -> torch.Tensor:
    """The state a request's first step begins from: RF starts at the noise."""
    return noise


def step_sigmas(cell, step: int) -> Tuple[float, float]:
    return ref_step.step_sigmas(_sampler(cell), step)


def reference_weights(cell, seed: int, device):
    """block -> {name: f32 tensor}: the served weights drawn again."""
    specs = _param_specs(cell)["dit"]
    dtype = DTYPES[cell.config["dtype"]]

    def weights(block):
        return {n: t.float() for n, t in block_tensors(seed, block, specs[block], device=device,
                                                       dtype=dtype).items()}
    return weights


def reference_velocity(cell, seed: int, x, step: int, cond, uncond, device,
                       control: bool = False) -> torch.Tensor:
    """The guided velocity of step `step` from x, by the plain f32 reference;
    with `control`, by the reference with float8 (e4m3) matrix products."""
    weights = reference_weights(cell, seed, device)
    with exact_f32():
        return ref_step.denoise_step(cell.net, _sampler(cell), weights, x, step, cond, uncond,
                                     sta=cell.traffic.get("sta"),
                                     matmuls=Matmuls(fp8=True) if control else None)[1]


def step_work(cell) -> flops.StepWork:
    return flops.step_work(cell.net, cell.traffic)


def expected_launches(cell, forwards: int) -> Dict[str, int]:
    """The port's kernel launches in `forwards` DiT forwards: the traffic's
    launches a layer times num_layers, and its launches a forward."""
    L = cell.net["num_layers"]
    out: Dict[str, int] = {}
    for name, n in cell.traffic["launches_per_layer"].items():
        out[name] = out.get(name, 0) + n * L * forwards
    for name, n in cell.traffic.get("launches_per_forward", {}).items():
        out[name] = out.get(name, 0) + n * forwards
    return out
