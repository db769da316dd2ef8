"""VideoDiffusionEngine on PyTorch (counterpart of scail_tpu/engine.py).

Holds the DiT, denoiser, sampler, conditioner, CLIP, VAE and training loss
built from the YAML `model:` block through the port's registry, on one
explicit torch.device, and exposes init_params / load_checkpoint /
encode_first_stage / decode_first_stage / network_fn / sample and, for
training, loss / add_noise_to_first_frame / shared_step.  Noise comes from an
explicit torch.Generator.  The encoders are frozen: only the DiT is trained.

Weights: the VAE, CLIP and text-encoder wrappers read the files their YAML
paths name when the engine builds them (memory-mapped, on the CPU), and the
engine moves each to its device one parameter at a time, in the wrapper's
compute dtype; `load_checkpoint` fills the DiT from a SAT checkpoint
directory the same way.  Each load is recorded in `weight_loads`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from scail_tpu_torch.convert.torch_ckpt import (load_dit_, load_torch_state_dict,
                                                resolve_latest_checkpoint, to_device_)
from scail_tpu_torch.ops.resize import resize_bilinear
from scail_tpu_torch.utils.misc import append_dims, default
from scail_tpu_torch.utils.registry import ensure_imports, instantiate_from_config


def _half_res(video):
    """0.5x bilinear downsample of a (b, T, C, H, W) clip (the smpl_downsample
    representation of the pose render)."""
    H, W = video.shape[-2:]
    return resize_bilinear(video, H // 2, W // 2)


def _timed(fn, device: torch.device):
    """(fn(), seconds), the device synchronised at both ends."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without CUDA raises (there is
    no silent CPU run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


class VideoDiffusionEngine:
    def __init__(self, model_config: Dict, args=None, device="cuda"):
        self.device = resolve_device(device)
        ensure_imports()
        mc = dict(model_config)
        self.scale_factor = mc.get("scale_factor", 1.0)
        self.latent_input = mc.get("latent_input", False)
        self.use_pose = mc.get("use_pose", False)
        self.use_i2v_clip = mc.get("use_i2v_clip", False)
        self.i2v_encode_video = mc.get("i2v_encode_video", False)
        self.noised_image_input = mc.get("noised_image_input", False)
        self.pose_dropout = mc.get("pose_dropout", 0.0)

        def _flag(name, dflt=False):
            if args is None:
                return dflt
            return args.get(name, dflt) if isinstance(args, dict) else getattr(args, name, dflt)

        if _flag("fp16"):
            dtype_str = "fp16"
        elif not _flag("bf16", True):
            dtype_str = "fp32"
        else:
            dtype_str = "bf16"
        network_config = dict(mc["network_config"])
        network_config["params"] = dict(network_config.get("params", {}) or {},
                                        dtype=dtype_str, use_i2v_clip=self.use_i2v_clip)
        self.network = instantiate_from_config(network_config)
        self.network.config.check_supported()
        self.dit = None
        # parallel.mesh.Mesh of a sharded DiT (shard_params), else None
        self.mesh = None
        # parallel.sharding.PathRules the DiT was sharded by (shard_params)
        self.param_rules = None
        # (rank, size) of this process among the data-parallel ranks: the
        # training draws are made for the global batch and this slice kept
        self.data_shard = (0, 1)

        def build(key, cond=True):
            return instantiate_from_config(mc[key]) if cond and mc.get(key) else None

        self.denoiser = build("denoiser_config")
        self.sampler = build("sampler_config")
        self.conditioner = build("conditioner_config")
        self.i2v_clip = build("i2v_clip_config", self.use_i2v_clip)
        self.first_stage_model = build("first_stage_config")
        self.loss_fn = build("loss_fn_config")
        # {what, path, bytes, seconds} of every file loaded onto the device
        self.weight_loads: List[Dict] = []
        for what, wrapper in self._weight_holders():
            if wrapper.model is not None:
                n, s = _timed(lambda: to_device_(wrapper.model, self.device,
                                                wrapper.config.compute_dtype), self.device)
                self._record_load(what, wrapper.checkpoint_path, n, s)

    def _weight_holders(self):
        """(name, wrapper) of the frozen sub-models that read a file."""
        out = [("Wan VAE", self.first_stage_model), ("CLIP", self.i2v_clip)]
        out += [("text encoder", e) for e in getattr(self.conditioner, "embedders", [])]
        return [(what, w) for what, w in out if w is not None and hasattr(w, "checkpoint_path")]

    def _record_load(self, what, path, nbytes, seconds):
        self.weight_loads.append(dict(what=what, path=path, bytes=nbytes, seconds=seconds))
        print(f"{what} weights from {path}: {nbytes / 1e9:.3f} GB onto {self.device} in "
              f"{seconds:.2f} s", flush=True)

    def init_params(self, generator: torch.Generator, trainable: bool = False):
        """Random-init every sub-model that has no weights (smoke mode), so
        neither a loaded DiT nor a loaded encoder is touched.
        The DiT is built on the meta device and made one parameter at a time
        on the engine's device: for serving each parameter is cast to the
        compute dtype once drawn, so the DiT never holds a whole f32 copy (the
        14B's would be 66 GB); `trainable` keeps its parameters in f32 with
        gradients on, as the JAX trainer keeps its params.  The values are
        those of an f32 build cast afterwards.  The text encoder keeps its
        width but is cut to 2 layers, as in the JAX engine: random weights
        only need shape-correct embeddings."""
        if self.dit is None:
            dit = self.network.build("meta")
            if trainable:
                dit.init_weights_(generator, device=self.device)
                self.dit = dit.requires_grad_(True).train()
            else:
                dit.init_weights_(generator, device=self.device,
                                  dtype=self.network.config.compute_dtype)
                self.dit = dit.eval()
        if self.first_stage_model is not None and self.first_stage_model.model is None:
            self.first_stage_model.init(generator, device=self.device)
        if self.i2v_clip is not None and self.i2v_clip.model is None:
            self.i2v_clip.init(generator, device=self.device)
        for emb in getattr(self.conditioner, "embedders", []):
            if getattr(emb, "model", None) is None and hasattr(emb, "init"):
                cfg = emb.config
                emb.init(generator, dataclasses.replace(cfg, num_layers=min(cfg.num_layers, 2)),
                         device=self.device)
        return self.dit

    def load_checkpoint(self, load_dir: str, trainable: bool = False):
        """Fill the DiT from the SAT layout `<dir>/<latest>/mp_rank_00_model_states.pt`,
        one parameter at a time onto the engine's device: in the compute
        dtype for serving, in f32 with gradients on when `trainable`.  A file
        that does not load, a missing tensor or a wrong shape raises, and so
        does a sub-model whose YAML path held no file: nothing falls back to
        random weights."""
        missing = [f"{what} ({w.__class__.__name__})" for what, w in self._weight_holders()
                   if w.model is None]
        if missing:
            raise FileNotFoundError(f"loading {load_dir}: no weights for {', '.join(missing)}; "
                                    "point the YAML's checkpoint_path / vae_pth at the files")
        path = resolve_latest_checkpoint(load_dir)
        print(f"loading DiT checkpoint from {path}", flush=True)
        dit = self.network.build("meta")
        dtype = torch.float32 if trainable else self.network.config.compute_dtype
        n, s = _timed(lambda: load_dit_(dit, load_torch_state_dict(path), device=self.device,
                                       dtype=dtype), self.device)
        self._record_load("DiT", path, n, s)
        self.dit = dit.requires_grad_(True).train() if trainable else dit.eval()
        return self.dit

    def shard_params(self, mesh):
        """Keep this rank's tensor-parallel slice of the DiT's parameters
        (by `param_rules`, which the Trainer takes to gather and re-shard
        them) and run the DiT under `mesh`.  The training draws are then
        made for the global batch and sliced by the rank's data coordinate,
        and the conditioner's ucg stream is seeded with that coordinate:
        the seq and model ranks of one data group hold the same batch and
        must drop the same prompts."""
        from scail_tpu_torch.ops.quant import QuantizedLinear
        from scail_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
        from scail_tpu_torch.parallel.sharding import dit_param_rules, shard_module_

        self.param_rules = dit_param_rules()
        if mesh.size(MODEL_AXIS) > 1:
            bad = [n for n, m in self.dit.named_modules()
                   if isinstance(m, QuantizedLinear) or getattr(m, "lora_a", None) is not None]
            if bad:
                raise NotImplementedError(f"tensor parallel shards plain linears only; "
                                          f"{bad[0]} is quantized or carries LoRA factors")
            shard_module_(self.dit, self.param_rules, mesh)
        self.mesh = None if mesh.trivial else mesh
        self.data_shard = (mesh.rank(DATA_AXIS), mesh.size(DATA_AXIS))
        if self.conditioner is not None:
            self.conditioner.seed_ucg(mesh.rank(DATA_AXIS))
        return self.dit

    def network_fn(self):
        """(x, c_noise, cond, **kw) -> velocity, over the DiT (under the
        engine's mesh, if any)."""
        cfg = self.network.config

        def fn(x, c_noise, cond: Dict, **kw):
            if "concat" in cond:
                x = torch.cat([x, cond["concat"].to(x.dtype)], dim=2)
            extra = {}
            if cfg.cfg_embed_dim and kw.get("cfg_scale") is not None:
                extra["cfg_scale"] = kw["cfg_scale"]
            return self.dit(x, c_noise, cond["crossattn"], ref_concat=cond["ref_concat"],
                            concat_smpl_render=cond["concat_smpl_render"],
                            image_clip_features=cond.get("image_clip_features"),
                            history_mask=kw.get("history_mask"), mesh=self.mesh, **extra)

        return fn

    @torch.no_grad()
    def encode_first_stage(self, x, force_encode: bool = False, streamed=None):
        """x (b, T, 3, H, W) in [-1, 1] -> scaled latent (b, t, 16, h, w)."""
        if not force_encode and self.latent_input:
            return x * self.scale_factor
        z = self.first_stage_model.encode(x, streamed=default(streamed, x.shape[1] > 9))
        return z * self.scale_factor

    @torch.inference_mode()
    def decode_first_stage(self, z, streamed=None):
        z = z / self.scale_factor
        return self.first_stage_model.decode(z, streamed=default(streamed, z.shape[1] > 3))

    @torch.inference_mode()
    def sample(self, generator: torch.Generator, cond: Dict, uc: Optional[Dict] = None,
               batch_size: int = 1, shape: Tuple[int, int, int, int] = None, prefix=None,
               tile_indices=None, noise=None):
        """Noise from `generator` (on the engine's device) unless given as
        `noise`, then the sampler's denoise loop (`tile_indices` goes to a
        tiled sampler, RFSamplerLong); returns the latent in the DiT's compute
        dtype."""
        randn = (torch.randn((batch_size, *shape), generator=generator, device=self.device,
                             dtype=torch.float32) if noise is None
                 else noise.to(self.device, torch.float32))
        if prefix is not None:
            randn = torch.cat([prefix, randn[:, prefix.shape[1]:]], dim=1)
        net = self.network_fn()

        def denoise_fn(x, sigma, c, cfg_scale=None, **dkw):
            return self.denoiser(net, x, sigma, c, **dkw)

        sampler_kw = {} if tile_indices is None else {"tile_indices": tile_indices}
        samples = self.sampler(denoise_fn, randn, cond, uc=uc, **sampler_kw)
        return samples.to(self.network.config.compute_dtype)

    # ------------------------------------------------------------------
    # training (the JAX engine's loss / shared_step)
    # ------------------------------------------------------------------
    def _global_draw(self, draw, b: int):
        """draw(n) for the global batch (n = b x the data size), this data
        rank's b rows: every data rank draws what one rank would draw for the
        whole batch (on one rank, draw(b) itself)."""
        r, size = self.data_shard
        return draw(b * size)[r * b:(r + 1) * b]

    def loss(self, generator: torch.Generator, latents, cond: Dict, history_mask=None, **kw):
        """Per-sample training loss of the DiT on `latents` (b,); sigma, then
        the noise, drawn for the global batch (`_global_draw`) unless given."""
        b, dev = latents.shape[0], latents.device
        sampler = getattr(self.loss_fn, "sigma_sampler", None)
        if sampler is not None and kw.get("sigma") is None:
            kw["sigma"] = self._global_draw(lambda n: sampler(generator, n), b)
        if kw.get("noise") is None:
            kw["noise"] = self._global_draw(lambda n: torch.randn(
                (n, *latents.shape[1:]), generator=generator, device=dev), b)
        return self.loss_fn(generator, self.network_fn(), self.denoiser, cond, latents,
                            history_mask=history_mask,
                            patch_size=self.network.config.patch_size, **kw)

    def add_noise_to_first_frame(self, generator: torch.Generator, image):
        """image + sigma * noise with sigma ~ exp(N(-2.5, 0.5)) per sample."""
        dev = image.device
        sigma = torch.exp(-2.5 + 0.5 * torch.randn((image.shape[0],), generator=generator,
                                                   device=dev))
        noise = torch.randn(image.shape, generator=generator, device=dev)
        return image + (noise * append_dims(sigma, image.dim())).to(image.dtype)

    def shared_step(self, generator: torch.Generator, batch: Dict):
        """Raw-pixel training step: VAE-encode the clip, the reference frame
        and the half-resolution pose, drop the pose conditioning with
        probability pose_dropout, embed the text and CLIP features, then the
        loss.  batch: {'mp4': (b,T,3,H,W), 'pose': (b,T,3,H,W),
        'ref_frame': (b,1,3,H,W) in [-1, 1], and 'txt' [str]*b or a
        precomputed 'crossattn'} on the engine's device.  Returns
        (loss_mean, {'diffusion loss': loss_mean}).

        The JAX step also VAE-encodes the noised first frame
        (add_noise_to_first_frame) into cond['concat_images'] and drops it
        with image_cond_dropout; no module reads that entry, and XLA removes
        the dead encode from the jitted step, so it is not computed here.
        Everything before the DiT runs without gradients (frozen encoders)."""
        if not (self.use_pose and self.noised_image_input and self.i2v_encode_video):
            raise NotImplementedError("shared_step is the pose-conditioned SCAIL step "
                                      "(use_pose, noised_image_input, i2v_encode_video)")
        x_pix, ref, pose_pix = batch["mp4"], batch["ref_frame"], batch["pose"]
        b = x_pix.shape[0]
        with torch.no_grad():
            ref_concat = self.encode_first_stage(ref, force_encode=True, streamed=False)
            latents = self.encode_first_stage(x_pix, force_encode=True)
            pose_latent = self.encode_first_stage(_half_res(pose_pix), force_encode=True)
            keep_pose = self._global_draw(lambda n: torch.rand(
                (n,), generator=generator, device=self.device), b) >= self.pose_dropout
            pose_latent = pose_latent * append_dims(keep_pose.to(pose_latent.dtype), 5)
            if "crossattn" in batch:
                cond = {"crossattn": batch["crossattn"]}
            elif self.conditioner is not None:
                cond = self.conditioner({"txt": batch["txt"]})
            else:
                cond = {}
            cond["ref_concat"] = ref_concat
            cond["concat_smpl_render"] = pose_latent
            if self.use_i2v_clip and self.i2v_clip is not None:
                cond["image_clip_features"] = self.i2v_clip.visual(ref.transpose(1, 2))
        loss = self.loss(generator, latents, cond, history_mask=batch.get("history_mask"))
        loss_mean = loss.mean()
        return loss_mean, {"diffusion loss": loss_mean}
