"""ImageDiffusionEngine, the sgm DiffusionEngine of the image models, on
PyTorch (counterpart of scail_tpu/inference/engine.py).

The UNet and the first stage are built on the meta device and made on the
engine's device by `init_params` (random weights from a torch.Generator,
smoke mode) or `load_checkpoint` (a reference checkpoint:
`model.diffusion_model.*` the UNet, `first_stage_model.*` the KL autoencoder,
`conditioner.embedders.N.*` the text towers).  `network_fn` routes the
conditioning as the reference's OpenAIWrapper does: `concat` joins the
latent on the channel axis (dim 1, NCHW), `crossattn` is the UNet's context,
`vector` its class / adm vector y.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from scail_tpu_torch.engine import resolve_device
from scail_tpu_torch.utils.registry import ensure_imports, instantiate_from_config, register


def _load_module(module: torch.nn.Module, sd: Dict[str, torch.Tensor], what: str, device,
                 strict_extra: bool = True) -> None:
    """`sd` into `module` on `device`, tensor by tensor; a missing, extra
    (when strict_extra) or misshapen tensor raises and names `what`."""
    keys = set(module.state_dict())
    missing, extra = sorted(keys - set(sd)), sorted(set(sd) - keys)
    if missing or (strict_extra and extra):
        raise KeyError(f"{what}: checkpoint lacks {len(missing)} tensors (e.g. {missing[:3]}) "
                       f"and has {len(extra) if strict_extra else 0} unknown ones "
                       f"(e.g. {extra[:3] if strict_extra else []})")
    module.to_empty(device=device)
    module.load_state_dict({k: sd[k] for k in keys}, strict=True)


@register(alias="sgm.models.diffusion.DiffusionEngine")
class ImageDiffusionEngine:
    def __init__(self, network_config: Dict, denoiser_config: Dict,
                 first_stage_config: Optional[Dict] = None,
                 conditioner_config: Optional[Dict] = None, sampler_config: Optional[Dict] = None,
                 loss_fn_config: Optional[Dict] = None, scale_factor: float = 1.0,
                 input_key: str = "jpg", disable_first_stage_autocast: bool = False,
                 network_wrapper=None, ckpt_path: Optional[str] = None, device="cuda", **_):
        ensure_imports()
        self.device = resolve_device(device)
        self.scale_factor = scale_factor
        self.input_key = input_key
        self.network = instantiate_from_config(network_config, device="meta")
        self.denoiser = instantiate_from_config(denoiser_config)
        self.first_stage_model = (instantiate_from_config(first_stage_config, device="meta")
                                  if first_stage_config else None)
        self.conditioner = (instantiate_from_config(conditioner_config)
                            if conditioner_config else None)
        self.sampler = instantiate_from_config(sampler_config) if sampler_config else None
        self.loss_fn = instantiate_from_config(loss_fn_config) if loss_fn_config else None
        if ckpt_path:
            self.load_checkpoint(ckpt_path)

    def text_embedders(self):
        """The conditioner's text embedders (those that hold a tower)."""
        return [e for e in getattr(self.conditioner, "embedders", []) if hasattr(e, "model")]

    # ------------------------------------------------------------------
    def init_params(self, generator: torch.Generator):
        """Random weights on the engine's device for every part that holds
        none (smoke mode): the UNet, the first stage, then each text tower,
        drawn from `generator` in that order.  A first stage or a tower that
        loaded its own file keeps it."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, engine on {self.device}")
        self.network.init_random_(generator, device=self.device)
        fs = self.first_stage_model
        if fs is not None and not fs.loaded:
            fs.init_random_(generator, device=self.device)
        elif fs is not None:
            fs.to(self.device)
        for emb in self.text_embedders():
            if emb.loaded:
                emb.model.to(self.device)
            else:
                emb.init(generator, device=self.device)
        return self

    def load_checkpoint(self, path: str):
        """A reference checkpoint (a .pt / .ckpt pickle) onto the engine's
        device: the UNet strictly, the first stage, and each text embedder
        whose tensors the file holds (their wrapper's `transformer.` /
        `model.` prefix stripped)."""
        from scail_tpu_torch.convert.torch_ckpt import load_torch_state_dict

        sd = load_torch_state_dict(path)

        def sub(prefix):
            return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

        _load_module(self.network, sub("model.diffusion_model."), "UNet", self.device)
        if self.first_stage_model is not None:
            _load_module(self.first_stage_model, sub("first_stage_model."), "first stage",
                         self.device, strict_extra=False)
            self.first_stage_model.loaded = True
        for i, emb in enumerate(getattr(self.conditioner, "embedders", [])):
            esub = sub(f"conditioner.embedders.{i}.")
            if esub and hasattr(emb, "load_state_dict"):
                for head in ("transformer.", "model."):
                    if any(k.startswith(head) for k in esub):
                        esub = {k[len(head):]: v for k, v in esub.items() if k.startswith(head)}
                        break
                emb.load_state_dict(esub, device=self.device)
        return self

    # ------------------------------------------------------------------
    def network_fn(self):
        def net(x, c_noise, cond, **kw):
            if cond.get("concat") is not None:
                x = torch.cat([x, cond["concat"].to(x.dtype)], dim=1)
            return self.network(x, c_noise, context=cond.get("crossattn"), y=cond.get("vector"))

        return net

    def denoise_fn(self, **model_kwargs):
        net = self.network_fn()

        def fn(x, sigma, c, cfg_scale=None, **kw):
            return self.denoiser(net, x, sigma, c, **model_kwargs)

        return fn

    # ------------------------------------------------------------------
    @torch.no_grad()
    def encode_first_stage(self, x, generator=None):
        """x (b, 3, H, W) in [-1, 1] -> scale_factor * latent."""
        return self.scale_factor * self.first_stage_model.encode(x, generator)

    @torch.no_grad()
    def decode_first_stage(self, z):
        return self.first_stage_model.decode(z / self.scale_factor)

    @torch.no_grad()
    def sample(self, generator: torch.Generator, cond: Dict, uc: Optional[Dict] = None,
               batch_size: int = 1, shape: Tuple[int, int, int] = None, noise=None, **kw):
        """Start noise (b, *shape) from `generator` on the engine's device
        unless given, then the sampler."""
        randn = (torch.randn((batch_size, *shape), generator=generator, device=self.device)
                 if noise is None else noise.to(self.device, torch.float32))
        return self.sampler(self.denoise_fn(), randn, cond, uc=uc, **kw)
