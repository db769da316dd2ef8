"""Host-side video IO for the port.

Everything but GIF reading and the clip writer is the JAX package's jax-free
host code (scail_tpu/data/video.py), re-exported.  GIFs are read with Pillow
so no video backend is needed.  Clips are written as MPEG-4 through OpenCV,
which needs no imageio or ffmpeg install of its own.
"""

from __future__ import annotations

import os

import numpy as np

from scail_tpu.data.video import (  # noqa: F401
    find_file_with_patterns,
    frames_to_tchw_normalized,
    load_image_chw_normalized,
    resize_for_rectangle_crop,
    smpl_downsample,
)
from scail_tpu.data.video import load_video_frames as _load_video_frames_shared


def load_gif_frames(path: str):
    """All frames of a GIF as (T, H, W, 3) uint8, plus fps from the frame duration."""
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        frames = [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]
        duration = im.info.get("duration") or 0
    return np.stack(frames), (1000.0 / duration if duration else 16.0)


def load_video_frames(path: str):
    if path.lower().endswith(".gif"):
        return load_gif_frames(path)
    return _load_video_frames_shared(path)


def save_multi_video_grid_and_mp4(video_batches, save_dir: str, fps: float, key: str):
    """Stack (B, T, 3, H, W) streams in [0, 1] side by side per frame and write
    one clip per batch element as `<save_dir>/<key>_<i:06d>.mp4` (MPEG-4 part 2
    through OpenCV).  Returns the paths written; raises if OpenCV cannot
    encode MPEG-4."""
    import cv2

    os.makedirs(save_dir, exist_ok=True)
    stacked = np.stack([np.asarray(v) for v in video_batches], axis=2)  # b t n c h w
    written = []
    for i, vid in enumerate(stacked):
        t, n, c, h, w = vid.shape
        frames = np.clip(vid.transpose(0, 3, 1, 4, 2).reshape(t, h, n * w, c) * 255.0,
                         0, 255).astype(np.uint8)
        path = os.path.join(save_dir, f"{key}_{i:06d}.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), float(fps), (n * w, h))
        if not writer.isOpened():
            raise RuntimeError(f"OpenCV {cv2.__version__} cannot encode MPEG-4 to {path}")
        for frame in frames:
            writer.write(np.ascontiguousarray(frame[..., ::-1]))  # RGB -> BGR
        writer.release()
        written.append(path)
    return written
