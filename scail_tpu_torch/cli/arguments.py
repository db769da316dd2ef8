"""CLI argument handling (counterpart of scail_tpu/cli/arguments.py).

`--base a.yaml b.yaml` YAMLs are merged (utils/config.py);
their `args:` block fills the runtime namespace and `model:` is the model
graph.  `--device` (default cuda) takes the place of the JAX `--platform`.
A `sta_validated.json` marker with `"validated": true` in the `--load`
checkpoint dir makes sliding-tile attention the default; `--attn-impl`
overrides it.
"""

from __future__ import annotations

import argparse
import json
import os
from types import SimpleNamespace

from scail_tpu_torch.utils.config import load_configs, split_reference_config

# 'auto' runs the CUDA kernels, 'xla' the plain versions, 'sta' sliding-tile
# attention; the port's DiT raises for the JAX CLI's values not ported yet
ATTN_IMPLS = [None, "auto", "xla", "pallas_int8", "ulysses", "sta"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("scail_tpu_torch", add_help=True)
    p.add_argument("--base", nargs="*", default=[],
                   help="YAML config paths, merged left-to-right")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--input-type", dest="input_type", default=None,
                   choices=[None, "cli", "txt"])
    p.add_argument("--input-file", dest="input_file", default=None)
    p.add_argument("--output-dir", dest="output_dir", default=None)
    p.add_argument("--load", default=None, help="checkpoint dir (SAT layout)")
    p.add_argument("--sampling-num-frames", type=int, default=None,
                   help="cap the number of pose/video frames used")
    p.add_argument("--sampling-steps", type=int, default=None,
                   help="override the sampler's num_steps (smoke runs)")
    p.add_argument("--image-size", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="override sampling_image_size")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when CUDA is not available")
    p.add_argument("--attn-impl", dest="attn_impl", default=None, choices=ATTN_IMPLS,
                   help="override the DiT attention impl from the YAML")
    return p


def get_args(argv=None):
    """Returns (runtime_args: SimpleNamespace, model_config: dict)."""
    cli = build_parser().parse_args(argv)
    run_cfg, model_cfg = split_reference_config(load_configs(cli.base))
    args = SimpleNamespace(
        mode="inference", batch_size=1, input_type="cli", input_file=None,
        sampling_image_size=[512, 896], vae_compress_size=[4, 8, 8], bf16=True, fp16=False,
        sampling_fps=16, image2video=True, use_i2v_clip=True, use_pose=True,
        representation="smpl_downsample", output_dir="samples", load=None)
    for k, v in dict(run_cfg).items():
        setattr(args, k, v)
    for k in ("input_type", "input_file", "output_dir", "load"):
        v = getattr(cli, k)
        if v is not None:
            setattr(args, k, v)
    args.seed = cli.seed
    args.device = cli.device
    args.sampling_num_frames = cli.sampling_num_frames
    if cli.image_size is not None:
        args.sampling_image_size = list(cli.image_size)
    model_cfg = dict(model_cfg)
    if cli.sampling_steps is not None:
        sc = dict(model_cfg.get("sampler_config", {}))
        sc["params"] = dict(sc.get("params", {}), num_steps=cli.sampling_steps)
        model_cfg["sampler_config"] = sc
    attn_impl = cli.attn_impl
    if attn_impl is None and args.load:
        # once the STA quality check passed for this checkpoint, sliding-tile
        # sampling is the default
        marker = os.path.join(str(args.load), "sta_validated.json")
        try:
            if os.path.isfile(marker):
                with open(marker) as f:
                    if json.load(f).get("validated"):
                        attn_impl = "sta"
                        print("[scail] sta_validated.json found: defaulting "
                              "to attn_impl='sta' (override with --attn-impl)")
        except (OSError, ValueError):
            pass
    if attn_impl is not None:
        nc = dict(model_cfg.get("network_config", {}))
        nc["params"] = dict(nc.get("params", {}), attn_impl=attn_impl)
        model_cfg["network_config"] = nc
    return args, model_cfg
