"""Pose-conditioned sampling CLI on PyTorch (counterpart of
scail_tpu/cli/sample_video.py).

Input lines are "<prompt>@@<example_dir>"; the dir holds a reference image
(ref.jpg/ref.png/...) and a rendered pose video.  Outputs land in
<output_dir>/<case>/<case>_output_000000.mp4.  With the long-clip sampler
(configs/sampling/pose_cli_long.yaml, RFSamplerLong) the latent frames are cut
into tiles of `long_tile` frames overlapping by `long_overlap` (YAML args,
default 21 and 8), each tile with its own slice of the pose latent.

Weights: `--load <dir>` reads the DiT from the SAT layout
<dir>/<latest>/mp_rank_00_model_states.pt and the VAE, CLIP and umt5 from the
YAML's vae_pth / checkpoint_path files; a directory that exists but does not
load raises.  Without a --load directory every model is random (smoke mode).

Several processes: with WORLD_SIZE > 1 (and RANK / MASTER_ADDR / MASTER_PORT)
torch.distributed is initialised and each process answers every
WORLD_SIZE-th line of the --input-file, from line RANK, as the JAX CLI
shards prompts over its processes.  The DiT itself runs on each process's
card alone (the JAX CLI parses --mesh-seq / --mesh-model and reads neither;
this one does not take them).

Usage:
  python -m scail_tpu_torch.cli.sample_video \\
      --base configs/video_model/scail_1p3b.yaml configs/sampling/pose_cli.yaml \\
      --input-type txt --input-file prompts.txt [--sampling-steps N] [--load DIR] \\
      --device cuda
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from scail_tpu_torch.cli.arguments import get_args
from scail_tpu_torch.data.video import (
    find_file_with_patterns,
    frames_to_tchw_normalized,
    load_image_chw_normalized,
    load_video_frames,
    resize_for_rectangle_crop,
    save_multi_video_grid_and_mp4,
    smpl_downsample,
)
from scail_tpu_torch.diffusion.samplers import RFSampler, RFSamplerLong, make_tile_indices
from scail_tpu_torch.engine import VideoDiffusionEngine
from scail_tpu_torch.parallel.distributed import initialize_distributed
from scail_tpu_torch.ops.resize import resize_bilinear_host

REF_IMAGE_PATTERNS = ["ref.jpg", "ref.png", "ref_image.jpg", "ref_image.png"]
POSE_PATTERNS = ["rendered_aligned.mp4", "rendered.mp4", "rendered_aligned.gif",
                 "rendered.gif", "rendered.npz", "rendered.npy", "rendered"]


def read_from_cli():
    cnt = 0
    try:
        while True:
            x = input("Please input in format like <prompt>@@<example_dir> (Ctrl-D quit): ")
            yield x.strip(), cnt
            cnt += 1
    except EOFError:
        pass


def read_from_file(path, rank: int = 0, world_size: int = 1):
    """(line, line number) of the requests of data rank `rank`: every
    world_size-th line from line `rank`, blank lines skipped (the JAX CLI's
    sharding of prompt lines over its processes)."""
    with open(path) as fin:
        for cnt, line in enumerate(fin):
            if cnt % world_size == rank and line.strip():
                yield line.strip(), cnt


def prepare_case(engine, args, text: str):
    """Conditioning for one request: resize/crop on the host, VAE encodes,
    CLIP tokens and the (c, uc) text pair on the engine's device."""
    if not args.use_pose:
        raise NotImplementedError("this CLI is the pose-conditioned path (use_pose: true)")
    prompt, input_dir = text.split("@@")
    if prompt == "None":
        prompt = ""
    image_path = find_file_with_patterns(input_dir, REF_IMAGE_PATTERNS)
    pose_path = find_file_with_patterns(input_dir, POSE_PATTERNS)
    if image_path is None:
        raise FileNotFoundError(f"reference image not found in {input_dir}")
    if pose_path is None:
        raise FileNotFoundError(f"pose video not found in {input_dir} (run SCAIL-Pose first)")

    gt_path = find_file_with_patterns(input_dir, ["GT.mp4", "GT.gif", "GT.npz"])
    gt = frames_to_tchw_normalized(load_video_frames(gt_path)[0]) if gt_path else None

    image = load_image_chw_normalized(image_path)  # (1, 3, H, W)
    if image.shape[2] < image.shape[3]:
        target_h, target_w = args.sampling_image_size
    else:
        target_w, target_h = args.sampling_image_size

    pose_frames, driving_fps = load_video_frames(pose_path)
    pose_video = frames_to_tchw_normalized(pose_frames)
    if getattr(args, "sampling_num_frames", None):
        pose_video = pose_video[:args.sampling_num_frames]
    pose_video = np.asarray(resize_for_rectangle_crop(pose_video, [target_h, target_w], "center"))
    image = np.asarray(resize_for_rectangle_crop(image, [target_h, target_w], "center"))
    if gt is not None:
        gt = np.asarray(resize_for_rectangle_crop(gt, [target_h, target_w], "center"))
    smpl_render = pose_video
    if "smpl_downsample" in args.representation:
        smpl_render = np.asarray(smpl_downsample(pose_video))

    dev = engine.device
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    T_in = pose_video.shape[0]
    ori_image = torch.from_numpy(image).to(dev, dtype)[None]  # (1, 1, 3, H, W)
    img_seq = torch.cat([ori_image, ori_image.new_zeros((1, T_in - 1, 3, target_h, target_w))],
                        dim=1)
    concat_images = engine.encode_first_stage(img_seq, force_encode=True)
    ref_concat = engine.encode_first_stage(ori_image, force_encode=True, streamed=False)
    smpl_latent = engine.encode_first_stage(torch.from_numpy(smpl_render).to(dev, dtype)[None],
                                            force_encode=True)
    clip_features = None
    if engine.use_i2v_clip:
        with torch.inference_mode():
            clip_features = engine.i2v_clip.visual(ori_image.transpose(1, 2))
    with torch.inference_mode():
        c, uc = engine.conditioner.get_unconditional_conditioning(
            {"txt": [prompt]}, batch_uc={"txt": [""]})
    for d in (c, uc):
        d["concat_images"] = concat_images
        d["ref_concat"] = ref_concat
        d["concat_pose"] = smpl_latent
        d["concat_smpl_render"] = smpl_latent
        if clip_features is not None:
            d["image_clip_features"] = clip_features

    shape = (smpl_latent.shape[1], 16, target_h // 8, target_w // 8)
    meta = dict(prompt=prompt, input_dir=input_dir, driving_fps=driving_fps, gt=gt,
                smpl_render=smpl_render, image=image, frames=T_in)
    return c, uc, shape, meta


def _save_concat(meta, samples, save_dir, case):
    """Pose | reference | GT | sample grid, every panel aligned to the
    sample's (t, h, w)."""
    def unit(x):  # [-1, 1] -> [0, 1], in one new array
        y = x + 1
        y /= 2
        return np.clip(y, 0, 1, out=y)

    gt_h, gt_w = meta["gt"].shape[-2:]
    up = resize_bilinear_host(meta["smpl_render"], gt_h, gt_w)
    ref = unit(meta["image"][None])  # the reference image on every frame, as a view
    panels = [unit(up[None]), np.broadcast_to(ref, (1, meta["frames"], *ref.shape[2:])),
              unit(meta["gt"][None]), samples]
    t_min = min(e.shape[1] for e in panels)
    h_s, w_s = samples.shape[-2:]
    panels = [e[:, :t_min] if e.shape[-2:] == (h_s, w_s)
              else resize_bilinear_host(e[:, :t_min], h_s, w_s) for e in panels]
    save_multi_video_grid_and_mp4(panels, save_dir, fps=meta["driving_fps"],
                                  key=f"{case}_concat")


def sampling_main(args, model_config):
    """Answer every request; returns one record per request: {'case',
    'seconds', 'phases' (prepare/sample/decode/save seconds), 'outputs',
    'frames', 'finite'}."""
    initialize_distributed(device=args.device)  # from the environment when WORLD_SIZE > 1
    engine = VideoDiffusionEngine(model_config, args, device=args.device)
    if not isinstance(engine.sampler, RFSampler):  # RFSamplerLong is one
        raise NotImplementedError(f"sampler {type(engine.sampler).__name__} is not ported")
    if getattr(args, "load", None) and os.path.isdir(str(args.load)):
        engine.load_checkpoint(str(args.load))
    else:
        print(f"checkpoint dir {getattr(args, 'load', None)} not found -- using random init "
              "(smoke mode)", flush=True)
        engine.init_params(torch.Generator(device=engine.device).manual_seed(args.seed))

    if args.input_type == "cli":
        data_iter = read_from_cli()
    elif args.input_type == "txt":
        # one process per data rank: each answers its share of the lines
        rank, world = ((dist.get_rank(), dist.get_world_size()) if dist.is_initialized()
                       else (0, 1))
        data_iter = read_from_file(args.input_file, rank, world)
    else:
        raise NotImplementedError(args.input_type)

    def clock():
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        return time.perf_counter()

    records = []
    for text, cnt in data_iter:
        print(f"{cnt}: {text}", flush=True)
        marks = [clock()]
        c, uc, shape, meta = prepare_case(engine, args, text)
        marks.append(clock())
        case = os.path.basename(meta["input_dir"].rstrip("/"))
        save_dir = os.path.join(args.output_dir, case)
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "text.txt"), "w") as f:
            f.write(meta["prompt"])

        tile_indices = None
        if isinstance(engine.sampler, RFSamplerLong):
            tile_indices = make_tile_indices(shape[0], int(getattr(args, "long_tile", 21)),
                                             int(getattr(args, "long_overlap", 8)))
            smpl = c["concat_smpl_render"]
            smpl_tiled = torch.stack([smpl[:, t] for t in tile_indices], dim=1)
            c["smpl_tiled"] = smpl_tiled
            uc["smpl_tiled"] = smpl_tiled
        gen = torch.Generator(device=engine.device).manual_seed(args.seed + cnt)
        samples_z = engine.sample(gen, c, uc, batch_size=1, shape=tuple(shape),
                                  tile_indices=tile_indices)
        marks.append(clock())
        samples_x = engine.decode_first_stage(samples_z)
        samples = np.clip((samples_x.float().cpu().numpy() + 1.0) / 2.0, 0.0, 1.0)
        marks.append(clock())
        outputs = save_multi_video_grid_and_mp4([samples], save_dir, fps=meta["driving_fps"],
                                                key=f"{case}_output")
        if meta["gt"] is not None:
            _save_concat(meta, samples, save_dir, case)
        marks.append(clock())
        phases = dict(zip(("prepare", "sample", "decode", "save"), np.diff(marks).tolist()))
        seconds = marks[-1] - marks[0]
        print(f"saved {save_dir} ({seconds:.2f} s: "
              + ", ".join(f"{k} {v:.2f} s" for k, v in phases.items()) + ")", flush=True)
        records.append({"case": case, "seconds": seconds, "phases": phases, "outputs": outputs,
                        "frames": samples.shape[1], "finite": bool(np.isfinite(samples).all())})
    return records


def main(argv=None):
    args, model_config = get_args(argv)
    return sampling_main(args, model_config)


if __name__ == "__main__":
    main(sys.argv[1:])
