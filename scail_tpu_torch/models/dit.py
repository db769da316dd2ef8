"""The SCAIL DiT on PyTorch (counterpart of scail_tpu/models/dit.py).

One explicit forward over an nn.ModuleList of blocks: patch embed of
[ref | video] and of the half-resolution pose latent into one fused
sequence, 3-regime 3D rotary, AdaLN blocks with a shared projection plus
per-layer tables, full-width q/k RMS norm, flash self-attention with the
rotary fused into the kernel for q, the summed text + CLIP dual
cross-attention kernel, a GELU(tanh) MLP, and the AdaLN final layer with
unpatchify of the video tokens.  The three AdaLN LayerNorm-modulate passes
run the fused AdaLN kernel at dit_forward's roundings (round_ln: the
LayerNorm rounded to the compute dtype before modulating) and the
interleaved rotary of q/k the rotary kernel (ops/fused_norms.py, K9 and K10)
under the impl the layer's other kernels take.

Single device.  attn_impl='sta' keeps the layer stack in the sliding-tile
order of ops/sta.py (one gather before the layers, one after) with q and k
roped in torch, as the JAX package does; attn_impl='pallas_int8' ropes q and
k in torch and runs the int8-QK flash kernel (ops/attention.py
attention_int8).  Linears replaced by ops/quant.py's QuantizedLinear (W8A16 /
W4A16) run the quantized matmul kernel.  num_experts > 1 replaces the MLP by
the top-k mixture of experts of ops/moe.py (moe_gate, moe_in, moe_out with
the JAX (E, ...) stacking); under a 'model' mesh the experts shard over the
model ranks (expert parallelism) and the output is all-reduced once.
attn_impl 'ulysses' and 'ring' without a mesh compute the dense path with q
and k roped by the rotary kernel, as the JAX package does.

Under a mesh (parallel/mesh.py; `forward(mesh=...)`) each rank computes only
its shard, with explicit collectives (parallel/comm.py), as the JAX
dit_forward's mesh paths: the seq ranks each keep a contiguous S/P of the
token rows after the patch embed (tile-major first under STA), the rotary
tables sliced by global row; the model ranks hold the column-parallel
linears' heads and the row-parallel linears' inputs (parallel/sharding.py,
`shard_params`), all-reduce the row-parallel outputs and add the bias once
after; the replicated input of each column-parallel block passes Megatron's
`copy_to`; the full-width q/k RMS norm all-reduces its sum of squares over
'model'.  Self-attention: 'ulysses' (parallel/ulysses.py, K2), 'ring'
(parallel/ring.py, K2 per step), 'sta' under seq > 1 Ulysses with the
windowed kernels inside, under model > 1 alone the windowed kernels on the
rank's heads, else the rank's q rows against k and v all-gathered over
'seq'.  Cross-attention runs on each rank's rows and heads.  The final
layer projects the rank's rows, which are all-gathered over 'seq' before the
unpatchify.  shard_activations keeps the carries between layers sharded over
'model' along the hidden dimension.  Shapes that do not divide the mesh
raise (there is no global array to fall back to).  For training,
`remat` checkpoints each layer under `remat_policy`, as the JAX package's
policies: 'default' recomputes the whole layer; 'save_attn' keeps each
layer's flash outputs (out, lse) across the recompute, so the recompute
launches no flash forward; 'save_attn_frac' does so for the first
save_attn_head_layers() layers and recomputes the rest; 'offload_attn' keeps
them in pinned host memory (ops/attention.py FlashStash).  Parameters may be
f32 (training) or the compute dtype (serving): every use casts them to the
compute dtype, which costs nothing when they already have it.
State-dict paths mirror the JAX parameter tree (convert/from_jax.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, noop_context_fn

from scail_tpu_torch.models.common import (container, dense, gelu_exact, gelu_tanh, linear,
                                           parameter, random_init_, silu, timestep_embedding)
from scail_tpu_torch.ops.attention import IMPLS as ATTN_IMPLS
from scail_tpu_torch.ops.attention import (FlashStash, attention, attention_int8,
                                           dual_cross_attention)
from scail_tpu_torch.ops.fused_norms import adaln_layer_norm, apply_rotary_fused
from scail_tpu_torch.ops.moe import moe_mlp
from scail_tpu_torch.ops.norms import layer_norm, rms_norm
from scail_tpu_torch.ops.rotary import build_scail_rope
from scail_tpu_torch.ops.sta import sta_attention, sta_plan
from scail_tpu_torch.parallel import comm
from scail_tpu_torch.parallel.mesh import MODEL_AXIS, SEQ_AXIS
from scail_tpu_torch.parallel.ring import check_ring_rows, ring_attention
from scail_tpu_torch.parallel.ulysses import ulysses_attention
from scail_tpu_torch.utils.registry import register

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}

# self-attention impls of the sequence-parallel paths (the dense path without
# a mesh)
SEQ_PARALLEL_ATTN = ("ulysses", "ring")
# remat policies: 'default' recomputes each layer; the others keep the flash
# outputs across the recompute (on the device, or in pinned host memory)
REMAT_POLICIES = ("default", "save_attn", "save_attn_frac", "offload_attn")


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    hidden_size: int = 5120
    num_layers: int = 40
    num_heads: int = 40
    inner_hidden_size: int = 13824
    in_channels: int = 20
    out_channels: int = 16
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_dim: int = 4096
    time_freq_dim: int = 256
    time_embed_dim: int = 5120
    clip_dim: int = 1280
    clip_tokens: int = 257
    cfg_embed_dim: Optional[int] = None
    share_adaln: bool = True
    use_i2v_clip: bool = True
    qk_ln: bool = True
    qk_ln_affine: bool = True
    elementwise_affine: bool = False
    layernorm_epsilon: float = 1e-6
    interleaved_rope: bool = True
    rope_theta: float = 10000.0
    pose_w_offset: int = 120
    num_experts: int = 1
    moe_top_k: int = 2
    dtype: str = "bfloat16"
    remat: bool = False
    remat_policy: str = "default"
    # save_attn_frac: the share of the layers (the first ones) that keep the
    # flash outputs
    remat_save_frac: float = 0.7
    # under a mesh with model > 1: the carries between layers sharded over
    # 'model' along the hidden dimension (a layer gathers them before its
    # LayerNorm and keeps its slice after the last residual add)
    shard_activations: bool = False
    attn_impl: str = "auto"
    # attn_impl='sta' (ops/sta.py): strip tiles of (sta_tile[0] latent frames,
    # sta_tile[1] latent rows, full width), the clamped window in tiles, the
    # half-res pose queries windowed too, and the t-window (in strips) of
    # attention into the pose region (0 = dense); the JAX package's defaults
    sta_tile: tuple = (3, 8)
    sta_window: tuple = (3, 2)
    sta_windowed_pose: bool = True
    sta_pose_kv_window: int = 3
    # the port's own: which attention impl the STA calls and the
    # cross-attention take under attn_impl='sta' ('auto' kernels, 'xla' plain)
    sta_impl: str = "auto"
    # the port's own: which impl the quantized paths take -- every
    # QuantizedLinear and, under attn_impl='pallas_int8', the int8 attention
    # and the cross-attention ('auto' kernels, 'xla' plain versions)
    quant_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def compute_dtype(self):
        return DTYPES[self.dtype]

    @property
    def kernel_impl(self) -> str:
        """The impl of the layers' kernels ('auto' | 'xla'): under 'sta' the
        dense fallback and the cross-attention take sta_impl, under
        'pallas_int8' the int8 attention and the cross-attention quant_impl
        (the JAX cross_impl is 'auto' for both), under 'ulysses' and 'ring'
        the kernels; the AdaLN and rotary kernels follow."""
        return {"sta": self.sta_impl, "pallas_int8": self.quant_impl, "ulysses": "auto",
                "ring": "auto"}.get(self.attn_impl, self.attn_impl)

    @staticmethod
    def from_network_config(params: dict, **overrides) -> "DiTConfig":
        """Map a reference `network_config.params` YAML block onto DiTConfig
        (the same mapping as the JAX package)."""
        p = dict(params)
        modules = p.get("modules", {}) or {}
        adaln = dict(modules.get("adaln_layer_config", {}).get("params", {}) or {})
        pos = dict(modules.get("pos_embed_config", {}).get("params", {}) or {})
        kw = dict(
            hidden_size=p.get("hidden_size", 5120),
            num_layers=p.get("num_layers", 40),
            num_heads=p.get("num_attention_heads", 40),
            inner_hidden_size=p.get("inner_hidden_size") or p.get("hidden_size", 5120) * 4,
            in_channels=p.get("in_channels", 20),
            out_channels=p.get("out_channels", 16),
            patch_size=tuple(p.get("patch_size", (1, 2, 2))),
            text_dim=p.get("text_dim", 4096),
            time_freq_dim=p.get("time_freq_dim") or p.get("hidden_size", 5120),
            time_embed_dim=p.get("time_embed_dim") or p.get("hidden_size", 5120),
            share_adaln=p.get("share_adaln", False),
            use_i2v_clip=p.get("use_i2v_clip", False),
            clip_dim=p.get("clip_dim", 1280),
            cfg_embed_dim=p.get("cfg_embed_dim"),
            qk_ln=adaln.get("qk_ln", True),
            qk_ln_affine=adaln.get("qk_ln_affine", True),
            elementwise_affine=p.get("elementwise_affine", False),
            layernorm_epsilon=float(p.get("layernorm_epsilon", 1e-6)),
            interleaved_rope=pos.get("interleaved_rope", False),
            num_experts=p.get("num_experts", 1),
            moe_top_k=p.get("moe_top_k", 2),
            attn_impl=p.get("attn_impl", "auto"),
            sta_tile=tuple(p.get("sta_tile", (3, 8))),
            sta_window=tuple(p.get("sta_window", (3, 2))),
            sta_windowed_pose=p.get("sta_windowed_pose", True),
            sta_pose_kv_window=p.get("sta_pose_kv_window", 3),
            remat=p.get("remat", False),
            remat_policy=p.get("remat_policy", "default"),
            remat_save_frac=p.get("remat_save_frac", 0.7),
            shard_activations=p.get("shard_activations", False),
            dtype={"bf16": "bfloat16", "fp16": "float16", "fp32": "float32"}.get(
                p.get("dtype", "bf16"), p.get("dtype", "bfloat16")),
        )
        if p.get("num_multi_query_heads", 0) or p.get("use_SwiGLU", False):
            raise NotImplementedError("MQA and SwiGLU MLPs are not used by SCAIL configs")
        kw.update(overrides)
        return DiTConfig(**kw)

    def check_supported(self) -> None:
        """Raise for the JAX package's options this port does not run."""
        if self.attn_impl not in ATTN_IMPLS + ("sta", "pallas_int8") + SEQ_PARALLEL_ATTN:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}, expected one of "
                             f"{ATTN_IMPLS} (kernels, plain), 'sta', 'pallas_int8' or "
                             f"{SEQ_PARALLEL_ATTN}")
        for field in ("sta_impl", "quant_impl"):
            if getattr(self, field) not in ATTN_IMPLS:
                raise ValueError(f"unknown {field} {getattr(self, field)!r}, expected one of "
                                 f"{ATTN_IMPLS}")
        if self.remat and self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}, expected one of "
                             f"{REMAT_POLICIES}")
        if self.patch_size[0] != 1:
            raise NotImplementedError("temporal patching > 1 is not used by SCAIL configs")


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig, device=None):
        super().__init__()
        h, inner = cfg.hidden_size, cfg.inner_hidden_size
        lin = lambda i, o: linear(i, o, device=device)  # noqa: E731
        self.qkv = lin(h, 3 * h)
        self.attn_out = lin(h, h)
        self.cross_q = lin(h, h)
        self.cross_kv = lin(h, 2 * h)
        self.cross_out = lin(h, h)
        if cfg.num_experts > 1:
            # stacked experts and their router (JAX dit.py:248-258): expert e's
            # linears are moe_in.weight[e] (inner, h) and moe_out.weight[e]
            E = cfg.num_experts
            self.moe_gate = linear(h, E, bias=False, device=device)
            self.moe_in = container(weight=parameter(E, inner, h, device=device),
                                    bias=parameter(E, inner, fill=0.0, device=device))
            self.moe_out = container(weight=parameter(E, h, inner, device=device),
                                     bias=parameter(E, h, fill=0.0, device=device))
        else:
            self.mlp_in = lin(h, inner)
            self.mlp_out = lin(inner, h)
        if cfg.share_adaln:
            self.adaln = parameter(6, h, device=device)
        else:
            self.adaln_mlp = lin(cfg.time_embed_dim, 6 * h)
        if cfg.qk_ln:
            norms = ["q_norm", "k_norm", "cross_q_norm", "cross_k_norm"]
            if cfg.use_i2v_clip:
                norms.append("clip_k_norm")
            for n in norms:
                setattr(self, n, container(scale=parameter(h, fill=1.0, device=device)))
        if cfg.use_i2v_clip:
            self.clip_kv = lin(h, 2 * h)


class DiT(nn.Module):
    """The DiT forward as an nn.Module (JAX `dit_forward`)."""

    def __init__(self, cfg: DiTConfig, device=None):
        super().__init__()
        cfg.check_supported()
        self.config = cfg
        h, te = cfg.hidden_size, cfg.time_embed_dim
        pt, ph, pw = cfg.patch_size
        patch_in = cfg.in_channels * pt * ph * pw
        patch_out = cfg.out_channels * pt * ph * pw
        lin = lambda i, o: linear(i, o, device=device)  # noqa: E731
        self.patch_embed = container(proj=lin(patch_in, h), proj_pose=lin(patch_in, h))
        self.time_embed = container(fc1=lin(cfg.time_freq_dim, te), fc2=lin(te, te))
        self.text_embedding = container(fc1=lin(cfg.text_dim, h), fc2=lin(h, h))
        self.final_layer = container(linear=lin(h, patch_out))
        if cfg.share_adaln:
            self.adaln_projection = container(fc=lin(te, 6 * h))
            self.final_layer.adaln = parameter(2, h, device=device)
        else:
            self.final_layer.adaln_mlp = lin(te, 2 * h)
        if cfg.use_i2v_clip:
            ln = lambda d: container(scale=parameter(d, fill=1.0, device=device),  # noqa: E731
                                     bias=parameter(d, fill=0.0, device=device))
            self.clip_proj = container(ln_in=ln(cfg.clip_dim),
                                       fc1=lin(cfg.clip_dim, cfg.clip_dim),
                                       fc2=lin(cfg.clip_dim, h), ln_out=ln(h))
        if cfg.cfg_embed_dim:
            self.cfg_embed = container(fc1=lin(cfg.time_freq_dim, cfg.cfg_embed_dim),
                                       fc2=lin(cfg.cfg_embed_dim, cfg.cfg_embed_dim))
        self.layers = nn.ModuleList(DiTBlock(cfg, device) for _ in range(cfg.num_layers))
        self._rope_cache = {}
        self._sta_cache = {}

    def init_weights_(self, generator: torch.Generator, *, device=None, dtype=None) -> None:
        """Random smoke-mode init with the JAX package's scales: N(0, 0.02)
        linears, xavier-like patch/final projections, AdaLN tables
        N(0, 1/h); zero-init AdaLN MLPs and cfg-embedding output.  A DiT
        built on the meta device is made on `device` one parameter at a
        time, each cast to `dtype` once drawn (common.random_init_)."""
        h = self.config.hidden_size

        def std(name, p):
            if name.endswith("adaln"):
                return h ** -0.5
            if name.startswith(("patch_embed.", "final_layer.linear")):
                return (2.0 / (p.shape[0] + p.shape[1])) ** 0.5
            if "adaln_mlp" in name or name.startswith("cfg_embed.fc2"):
                return 0.0
            return 0.02

        random_init_(self, generator, std, device=device, dtype=dtype)

    def _rope(self, T, Hp, Wp, h_shift, w_shift, device):
        cfg = self.config
        key = (T, Hp, Wp, h_shift, w_shift, str(device))
        if key not in self._rope_cache:
            self._rope_cache[key] = build_scail_rope(
                cfg.head_dim, T, Hp, Wp, h_shift=h_shift, w_shift=w_shift,
                pose_w_offset=cfg.pose_w_offset, theta=cfg.rope_theta,
                interleaved=cfg.interleaved_rope, device=device)
        return self._rope_cache[key]

    def _sta(self, T, Hp, Wp, h_shift, w_shift, device):
        """The sliding-tile layout of a geometry, or None where the tiles do
        not divide (T, Hp): the JAX dit_forward's conditions and messages,
        printed once per geometry."""
        cfg = self.config
        tile = tuple(cfg.sta_tile)
        key = (T, Hp, Wp, h_shift, w_shift, str(device), tile, tuple(cfg.sta_window),
               cfg.sta_windowed_pose, cfg.sta_pose_kv_window)
        if key in self._sta_cache:
            return self._sta_cache[key]
        layout = None
        if T % tile[0] or Hp % tile[1]:
            print(f"[sta] tile {cfg.sta_tile} does not divide (T={T}, Hp={Hp}); "
                  f"falling back to dense attention for this geometry")
        else:
            windowed_pose = cfg.sta_windowed_pose
            if windowed_pose and (Wp % 2 or tile[1] % 2 or (tile[0] * tile[1] * Wp) % 32):
                print(f"[sta] windowed pose disabled: needs even Wp/tile_h and "
                      f"ts % 32 == 0 (Wp={Wp}, tile={cfg.sta_tile}); pose "
                      f"queries stay dense")
                windowed_pose = False
            ref_len, pose_len = Hp * Wp, T * (Hp // 2) * (Wp // 2)
            kwargs = dict(grid_thw=(T, Hp, Wp), ref_len=ref_len, pose_len=pose_len,
                          tile=tile, window=tuple(cfg.sta_window),
                          windowed_pose=windowed_pose, pose_kv_window=cfg.sta_pose_kv_window)
            # the plan sta_attention takes from the same cache for every layer
            # (positional, as it calls sta_plan)
            plan = sta_plan((T, Hp, Wp), ref_len, pose_len, tile, tuple(cfg.sta_window),
                            bool(windowed_pose), int(cfg.sta_pose_kv_window))
            order = torch.from_numpy(plan.order).to(device)
            rope = self._rope(T, Hp, Wp, h_shift, w_shift, device)
            layout = _StaLayout(
                order=order,
                video_rows=torch.from_numpy(plan.inverse[ref_len:ref_len + T * Hp * Wp])
                .to(device),
                cos=rope.cos[order], sin=rope.sin[order], kwargs=kwargs)
        self._sta_cache[key] = layout
        return layout

    def forward(self, x, timesteps, context, *, ref_concat, concat_smpl_render,
                image_clip_features=None, history_mask=None, cfg_scale=None,
                h_shift: int = 0, w_shift: int = 0, mesh=None):
        """x (b, T, 16, H, W) noisy latent, timesteps (b,) c_noise, context
        (b, S_txt, text_dim); returns the velocity (b, T, 16, H, W).  Under a
        non-trivial `mesh` the inputs are this data rank's, replicated over
        its seq and model ranks, and so is the result."""
        cfg = self.config
        if mesh is not None and mesh.trivial:
            mesh = None
        lin = functools.partial(dense, impl=cfg.quant_impl)
        cdtype = cfg.compute_dtype
        eps = cfg.layernorm_epsilon
        b, T, _, H, W = x.shape
        _, ph, pw = cfg.patch_size
        Hp, Wp = H // ph, W // pw
        dev = x.device
        x = x.to(cdtype)

        if history_mask is None:
            history_mask = torch.zeros((b, T, 4, H, W), dtype=cdtype, device=dev)
        x = torch.cat([x, history_mask.to(cdtype)], dim=2)
        ref = torch.cat([ref_concat.to(cdtype),
                         torch.ones((b, 1, 4, H, W), dtype=cdtype, device=dev)], dim=2)
        pose = torch.cat([concat_smpl_render.to(cdtype),
                          torch.ones((b, T, 4, H // 2, W // 2), dtype=cdtype, device=dev)],
                         dim=2)

        te = self.text_embedding
        context = lin(te.fc2, gelu_tanh(lin(te.fc1, context.to(cdtype))))
        clip_tokens = None
        if cfg.use_i2v_clip:
            if image_clip_features is None:
                raise ValueError("use_i2v_clip needs image_clip_features")
            cp = self.clip_proj
            y = layer_norm(image_clip_features.to(cdtype), cp.ln_in.scale, cp.ln_in.bias,
                           eps=1e-5)
            y = lin(cp.fc2, gelu_exact(lin(cp.fc1, y)))
            clip_tokens = layer_norm(y, cp.ln_out.scale, cp.ln_out.bias, eps=1e-5)

        t_emb = timestep_embedding(timesteps, cfg.time_freq_dim, dtype=cdtype)
        emb = lin(self.time_embed.fc2, silu(lin(self.time_embed.fc1, t_emb)))
        if cfg.cfg_embed_dim and cfg_scale is not None:
            cs = torch.as_tensor(cfg_scale, dtype=torch.float32, device=dev).reshape(-1)
            cfg_emb = timestep_embedding(cs.expand(b), cfg.time_freq_dim, dtype=cdtype)
            emb = emb + lin(self.cfg_embed.fc2, silu(lin(self.cfg_embed.fc1, cfg_emb)))
        adaln_emb = None
        if cfg.share_adaln:
            adaln_emb = lin(self.adaln_projection.fc, silu(emb)).reshape(b, 6, -1)

        hidden = torch.cat([
            _patchify_tokens(torch.cat([ref, x], dim=1), self.patch_embed.proj, cfg.patch_size,
                             cfg.quant_impl),
            _patchify_tokens(pose, self.patch_embed.proj_pose, cfg.patch_size, cfg.quant_impl),
        ], dim=1)
        ref_len = Hp * Wp
        seq_len = T * Hp * Wp
        # self-attention positions: the rope tables, or under attn_impl='sta'
        # the tile-major layout the whole layer stack is held in
        attn_pos = self._rope(T, Hp, Wp, h_shift, w_shift, dev)
        video_rows = slice(ref_len, ref_len + seq_len)
        if cfg.attn_impl == "sta":
            sta = self._sta(T, Hp, Wp, h_shift, w_shift, dev)
            if sta is not None:
                hidden = hidden[:, sta.order]
                attn_pos, video_rows = sta, sta.video_rows
        if mesh is not None:
            # this rank's rows (and the rotary rows they take), its heads, and
            # the conditioning the column-parallel cross projections read
            self._check_mesh(mesh, hidden.shape, x.shape)
            rows = comm.local_slice(torch.arange(hidden.shape[1], device=dev), mesh,
                                    SEQ_AXIS, 0)
            hidden = comm.local_slice(hidden, mesh, SEQ_AXIS, 1)
            attn_pos = _local_rows(attn_pos, rows)
            context = comm.copy_to(context, mesh, MODEL_AXIS)
            if clip_tokens is not None:
                clip_tokens = comm.copy_to(clip_tokens, mesh, MODEL_AXIS)
            if self._shards_carries(mesh):
                hidden = comm.split(hidden, mesh, MODEL_AXIS, -1)
        remat = cfg.remat and torch.is_grad_enabled()
        keep = kept_flash_layers(cfg)
        for i, blk in enumerate(self.layers):
            args = (blk, hidden, emb, adaln_emb, context, clip_tokens, attn_pos, mesh)
            if not remat:
                hidden = self._layer(*args)
                continue
            # remat: keep each layer's input and recompute the layer in the
            # backward (jax.checkpoint per layer); the first `keep` layers also
            # keep their flash outputs, which the recompute takes back
            context_fn = noop_context_fn
            if i < keep:
                context_fn = FlashStash(cfg.remat_policy,
                                        offload=cfg.remat_policy == "offload_attn").contexts
            hidden = checkpoint(self._layer, *args, use_reentrant=False, context_fn=context_fn)

        fl = self.final_layer
        if cfg.share_adaln:
            fmod = emb[:, None, :] + fl.adaln[None].to(emb.dtype)
        else:
            fmod = lin(fl.adaln_mlp, silu(emb)).reshape(b, 2, -1)
        if mesh is None:
            # only the video tokens are unpatchified: project just those rows
            hidden = hidden[:, video_rows]
        elif self._shards_carries(mesh):
            hidden = comm.gather(hidden, mesh, MODEL_AXIS, -1, replicated=True)
        out = adaln_layer_norm(hidden, fmod[:, 0:1], fmod[:, 1:2], eps=eps, round_ln=True,
                               impl=cfg.kernel_impl)
        out = lin(fl.linear, out)
        if mesh is not None:
            # every rank projected its rows: gather them, keep the video ones
            out = comm.gather(out, mesh, SEQ_AXIS, 1, replicated=True)[:, video_rows]
        return _unpatchify(out, T, Hp, Wp, cfg.patch_size, cfg.out_channels)

    def _shards_carries(self, mesh) -> bool:
        return self.config.shard_activations and mesh.size(MODEL_AXIS) > 1

    def _check_mesh(self, mesh, tokens_shape, x_shape) -> None:
        """Raise, before any collective, where the shapes do not divide the
        mesh or the parameters are not this rank's shards."""
        cfg = self.config
        seq, model = mesh.size(SEQ_AXIS), mesh.size(MODEL_AXIS)
        n, h = cfg.num_heads, cfg.hidden_size
        if n % model or h % model or cfg.inner_hidden_size % model:
            raise ValueError(f"heads {n}, hidden {h} and MLP width {cfg.inner_hidden_size} "
                             f"must divide over {model} model ranks")
        ulysses = cfg.attn_impl == "ulysses" or (cfg.attn_impl == "sta" and seq > 1)
        if ulysses and n % (seq * model):
            raise ValueError(f"heads {n} not divisible by seq*model shards ({seq}*{model}) "
                             f"for attn_impl={cfg.attn_impl!r}")
        S = tokens_shape[1]
        if cfg.attn_impl == "ring":
            check_ring_rows(S, mesh, {"x": tuple(x_shape), "tokens": tuple(tokens_shape)})
        elif S % seq:
            raise ValueError(f"attn_impl={cfg.attn_impl!r}: the sequence of {S} tokens does not "
                             f"divide over {seq} seq ranks (x {tuple(x_shape)}, tokens "
                             f"{tuple(tokens_shape)})")
        weight = getattr(self.layers[0].qkv, "weight", None) if len(self.layers) else None
        if model > 1 and (weight is None or weight.shape[0] != 3 * h // model):
            raise ValueError(f"model={model} needs plain linears holding a model rank's shard "
                             f"(qkv rows {3 * h // model}): shard the DiT's parameters "
                             "(engine.shard_params or parallel.sharding.shard_module_)")

    def _layer(self, blk, hidden, emb, adaln_emb, context, clip_tokens, attn_pos, mesh=None):
        """One DiT block: AdaLN self-attention (q roped in the kernel, or q
        and k roped by the rotary kernel for sliding-tile, int8 and
        sequence-parallel attention), the dual text + CLIP cross-attention,
        and the AdaLN GELU-tanh MLP.  Under a mesh: this rank's rows and
        heads, the collectives of the module docstring."""
        cfg = self.config
        eps = cfg.layernorm_epsilon
        lin = functools.partial(dense, impl=cfg.quant_impl)
        impl = cfg.kernel_impl
        tp = mesh is not None and mesh.size(MODEL_AXIS) > 1
        n_heads = cfg.num_heads // (mesh.size(MODEL_AXIS) if tp else 1)

        def heads(t):
            return t.unflatten(-1, (n_heads, -1))

        def qk_norm(t, norm):
            scale = norm.scale if cfg.qk_ln_affine else None
            if not tp:
                return rms_norm(t, scale, eps=eps)
            if scale is not None:
                scale = comm.local_slice(comm.copy_to(scale, mesh, MODEL_AXIS), mesh,
                                         MODEL_AXIS, 0)
            return _rms_norm_sharded(t, scale, mesh, cfg.hidden_size, eps)

        def col(layer, t):
            # column-parallel: the replicated input passes copy_to
            return lin(layer, comm.copy_to(t, mesh, MODEL_AXIS) if tp else t)

        def row(layer, t):
            # row-parallel: partial sums reduced over 'model', then the bias once
            if not tp:
                return lin(layer, t)
            y = comm.reduce_from(F.linear(t, layer.weight.to(t.dtype)), mesh, MODEL_AXIS)
            return y + layer.bias.to(y.dtype) if layer.bias is not None else y

        if mesh is not None and self._shards_carries(mesh):
            hidden = comm.gather(hidden, mesh, MODEL_AXIS, -1, replicated=True)

        if cfg.share_adaln:
            mod = adaln_emb + blk.adaln[None].to(adaln_emb.dtype)
        else:
            mod = lin(blk.adaln_mlp, silu(emb)).reshape(emb.shape[0], 6, -1)
        s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = mod.unsqueeze(2).unbind(1)

        def rope(t):
            # q and k roped outside attention, in q's dtype (JAX _rope_per_head)
            return apply_rotary_fused(heads(t), attn_pos.cos, attn_pos.sin,
                                      interleaved=cfg.interleaved_rope, impl=impl)

        # self attention: q roped inside the flash kernel and k by the rotary
        # kernel; or both roped before STA, int8 and sequence-parallel
        # attention (JAX ropes in XLA when the rope is not fused)
        ai = adaln_layer_norm(hidden, s_msa, sc_msa, eps=eps, round_ln=True, impl=impl)
        q, k, v = col(blk.qkv, ai).chunk(3, dim=-1)
        if cfg.qk_ln:
            q, k = qk_norm(q, blk.q_norm), qk_norm(k, blk.k_norm)
        sta_layout = isinstance(attn_pos, _StaLayout)
        if sta_layout:
            def sta(a, b_, c):
                return sta_attention(a, b_, c, pre_tiled=True, impl=impl, **attn_pos.kwargs)

            if mesh is not None and mesh.size(SEQ_AXIS) > 1:
                attn = ulysses_attention(rope(q), rope(k), heads(v), mesh, attn_fn=sta)
            else:
                attn = sta(rope(q), rope(k), heads(v))
        elif cfg.attn_impl == "pallas_int8" and mesh is None:
            attn = attention_int8(rope(q), rope(k), heads(v), impl=impl)
        elif cfg.attn_impl == "ulysses" and mesh is not None:
            attn = ulysses_attention(rope(q), rope(k), heads(v), mesh, impl=impl)
        elif cfg.attn_impl == "ring" and mesh is not None:
            attn = ring_attention(rope(q), rope(k), heads(v), mesh, impl=impl)
        elif mesh is not None:
            # the rank's q rows against k and v gathered over 'seq' (each rank
            # uses the whole k and v, so their gradients reduce-scatter back)
            kf, vf = (comm.gather(t, mesh, SEQ_AXIS, 1, replicated=False)
                      for t in (rope(k), heads(v)))
            if cfg.attn_impl == "pallas_int8":
                attn = attention_int8(rope(q), kf, vf, impl=impl)
            else:
                attn = attention(rope(q), kf, vf, impl=impl)
        elif cfg.attn_impl in SEQ_PARALLEL_ATTN:
            attn = attention(rope(q), rope(k), heads(v), impl=impl)
        else:
            attn = attention(heads(q), heads(k), heads(v), impl=impl,
                             rope=(attn_pos.cos, attn_pos.sin),
                             rope_interleaved=cfg.interleaved_rope)
        hidden = hidden + g_msa * row(blk.attn_out, attn.flatten(2))

        # dual cross attention, no AdaLN modulation or gate; context and the
        # CLIP tokens passed copy_to once, before the layers
        cq = col(blk.cross_q, layer_norm(hidden, eps=eps))
        ck, cv = lin(blk.cross_kv, context).chunk(2, dim=-1)
        if cfg.qk_ln:
            cq, ck = qk_norm(cq, blk.cross_q_norm), qk_norm(ck, blk.cross_k_norm)
        if cfg.use_i2v_clip:
            pk, pv = lin(blk.clip_kv, clip_tokens).chunk(2, dim=-1)
            if cfg.qk_ln:
                pk = qk_norm(pk, blk.clip_k_norm)
            cross = dual_cross_attention(heads(cq), heads(ck), heads(cv), heads(pk), heads(pv),
                                         impl=impl)
        else:
            cross = attention(heads(cq), heads(ck), heads(cv), impl=impl)
        hidden = hidden + row(blk.cross_out, cross.flatten(2))

        # MLP
        mi = adaln_layer_norm(hidden, s_mlp, sc_mlp, eps=eps, round_ln=True, impl=impl)
        if cfg.num_experts > 1:
            mo = _moe(blk, mi, cfg.moe_top_k, mesh if tp else None)
        else:
            mo = row(blk.mlp_out, gelu_tanh(col(blk.mlp_in, mi)))
        hidden = hidden + g_mlp * mo
        if mesh is not None and self._shards_carries(mesh):
            hidden = comm.split(hidden, mesh, MODEL_AXIS, -1)
        return hidden


def _moe(blk, x, top_k: int, mesh=None):
    """The MoE MLP (ops/moe.py).  Under a 'model' mesh each rank holds
    E / model experts (expert parallelism): the router scores all of them
    on the replicated input, the rank runs its own, and the ranks' partial
    outputs are all-reduced once.  The input and the replicated gate pass
    copy_to, so their gradients are summed over the ranks."""
    gate = blk.moe_gate.weight
    offset = 0
    if mesh is not None:
        x = comm.copy_to(x, mesh, MODEL_AXIS)
        gate = comm.copy_to(gate, mesh, MODEL_AXIS)
        offset = mesh.rank(MODEL_AXIS) * blk.moe_in.weight.shape[0]
    y = moe_mlp(x, gate, blk.moe_in.weight, blk.moe_out.weight, b_in=blk.moe_in.bias,
                b_out=blk.moe_out.bias, top_k=top_k, act=gelu_tanh, expert_offset=offset)
    return y if mesh is None else comm.reduce_from(y, mesh, MODEL_AXIS)


def _rms_norm_sharded(x, scale, mesh, width: int, eps: float):
    """rms_norm over the full `width` of a projection whose columns are
    sharded over 'model': the sum of squares all-reduced over the axis (both
    ways: every rank uses the sum on its own columns); `scale` the rank's
    slice of the affine scale."""
    xf = x.float()
    ss = comm.all_reduce(xf.square().sum(-1, keepdim=True), mesh, MODEL_AXIS)
    xf = xf * torch.rsqrt(ss / width + eps)
    if scale is not None:
        xf = scale.float() * xf
    return xf.to(x.dtype)


def _local_rows(pos, rows):
    """The rotary tables (or the STA layout's) restricted to this rank's rows."""
    if isinstance(pos, _StaLayout):
        return dataclasses.replace(pos, cos=pos.cos[rows], sin=pos.sin[rows])
    return _RopeRows(cos=pos.cos[rows], sin=pos.sin[rows])


@dataclasses.dataclass(frozen=True)
class _RopeRows:
    cos: torch.Tensor
    sin: torch.Tensor


def save_attn_head_layers(cfg: DiTConfig) -> int:
    """Number of leading layers the save_attn_frac policy keeps the flash
    outputs of (the JAX function of the same name)."""
    return max(0, min(cfg.num_layers, int(cfg.num_layers * cfg.remat_save_frac)))


def kept_flash_layers(cfg: DiTConfig) -> int:
    """Number of leading layers whose flash outputs the remat policy keeps."""
    if not cfg.remat or cfg.remat_policy == "default":
        return 0
    if cfg.remat_policy == "save_attn_frac":
        return save_attn_head_layers(cfg)
    return cfg.num_layers


@dataclasses.dataclass(frozen=True)
class _StaLayout:
    """The tile-major token layout of one geometry (ops/sta.py sta_plan):
    the gather into it, the rows of the video tokens in it, the rope tables
    permuted to it, and sta_attention's geometry arguments."""

    order: torch.Tensor
    video_rows: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor
    kwargs: dict


def _patchify_tokens(x, proj, patch_size, impl="auto"):
    """(b, T, C, H, W) -> (b, T*(H/ph)*(W/pw), hidden), (t h w) token order and
    (c, kh, kw) feature order: the stride == kernel patch conv."""
    _, ph, pw = patch_size
    b, T, C, H, W = x.shape
    x = x.reshape(b, T, C, H // ph, ph, W // pw, pw).permute(0, 1, 3, 5, 2, 4, 6)
    return dense(proj, x.reshape(b, T * (H // ph) * (W // pw), C * ph * pw), impl=impl)


def _unpatchify(x, T, Hp, Wp, patch_size, out_channels):
    """tokens (b, T*Hp*Wp, pt*ph*pw*c) -> (b, T, c, H, W)."""
    pt, ph, pw = patch_size
    b = x.shape[0]
    x = x.reshape(b, T, Hp, Wp, pt, ph, pw, out_channels).permute(0, 1, 4, 7, 2, 5, 3, 6)
    return x.reshape(b, T * pt, out_channels, Hp * ph, Wp * pw)


@register(alias="dit_video_crossattn_sc_xc.DiffusionTransformer")
class DiffusionTransformer:
    """Config-driven wrapper so `instantiate_from_config` on the reference
    YAML yields the config; `build(device)` makes the nn.Module."""

    def __init__(self, **network_params):
        targs = dict(network_params.get("transformer_args", {}) or {})
        for k in ("transformer_args", "num_frames", "time_compressed_rate", "latent_width",
                  "latent_height", "use_RMSNorm", "parallel_output"):
            network_params.pop(k, None)
        self.config = DiTConfig.from_network_config(
            network_params, remat=bool(targs.get("checkpoint_activations", False)))

    def build(self, device=None) -> DiT:
        return DiT(self.config, device=device)
