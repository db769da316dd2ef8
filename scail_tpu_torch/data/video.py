"""Host-side video and image IO and preprocessing for the port (its own copy
of the helpers of scail_tpu/data/video.py; nothing here imports the JAX
package).

Frames are decoded without imageio: GIFs and frame directories with Pillow,
.npy/.npz archives with numpy, everything else (mp4) with OpenCV.  Clips are
written as MPEG-4 through OpenCV.  The resize and crop run on the host with
numpy (ops/resize.py), so the data loader never touches the device.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from scail_tpu_torch.ops.resize import (center_crop, resize_bicubic, resize_bicubic_host,
                                        resize_bilinear, resize_bilinear_host)


def find_file_with_patterns(directory: str, patterns: List[str]) -> Optional[str]:
    """The first `directory/pattern` that exists, or None."""
    for pattern in patterns:
        p = os.path.join(directory, pattern)
        if os.path.exists(p):
            return p
    return None


def load_gif_frames(path: str):
    """All frames of a GIF as (T, H, W, 3) uint8, plus fps from the frame duration."""
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        frames = [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]
        duration = im.info.get("duration") or 0
    return np.stack(frames), (1000.0 / duration if duration else 16.0)


def load_image_dir(path: str) -> list:
    """The .png / .jpg / .jpeg images of a directory, sorted by name, as RGB
    PIL images; an empty directory raises."""
    from PIL import Image

    names = sorted(f for f in os.listdir(path) if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if not names:
        raise FileNotFoundError(f"no frames in {path}")
    return [Image.open(os.path.join(path, n)).convert("RGB") for n in names]


def _load_frame_dir(path: str) -> np.ndarray:
    return np.stack([np.asarray(im) for im in load_image_dir(path)])


def load_video_frames(path: str) -> Tuple[np.ndarray, float]:
    """Decode all frames -> ((T, H, W, 3) uint8, fps).  Accepts a directory of
    numbered image frames, .npy/.npz archives, GIFs and anything OpenCV reads."""
    if os.path.isdir(path):
        return _load_frame_dir(path), 16.0
    if path.endswith((".npy", ".npz")):
        data = np.load(path)
        if isinstance(data, np.lib.npyio.NpzFile):
            fps = float(data["fps"]) if "fps" in data else 16.0
            return np.asarray(data["frames"]), fps
        return np.asarray(data), 16.0
    if path.lower().endswith(".gif"):
        return load_gif_frames(path)
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 16.0
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise RuntimeError(f"OpenCV could not decode {path}")
    return np.stack(frames), float(fps)


def load_image_chw_normalized(path: str) -> np.ndarray:
    """An image file as (1, 3, H, W) float32 in [-1, 1]."""
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return img.transpose(2, 0, 1)[None] * 2.0 - 1.0


def frames_to_tchw_normalized(frames: np.ndarray) -> np.ndarray:
    """uint8 (T, H, W, 3) -> float32 (T, 3, H, W) in [-1, 1]: (x - 127.5) / 127.5."""
    x = np.asarray(frames).astype(np.float32).transpose(0, 3, 1, 2)
    return np.ascontiguousarray((x - 127.5) / 127.5)


def resize_for_rectangle_crop(arr, image_size, reshape_mode: str = "center",
                              rng: Optional[np.random.Generator] = None):
    """Aspect-preserving torch-bicubic (antialias) resize, then a crop to
    image_size = [H_out, W_out].  arr (T, C, H, W): a numpy array is resized on
    the host, a torch tensor on its device."""
    t, c, h, w = arr.shape
    th, tw = image_size
    if w / h > tw / th:
        nh, nw = th, int(w * th / h)
    else:
        nh, nw = int(h * tw / w), tw
    dh, dw = nh - th, nw - tw
    if reshape_mode == "center":
        top, left = dh // 2, dw // 2
    elif reshape_mode in ("random", "none"):
        rng = rng or np.random.default_rng()
        top, left = int(rng.integers(0, dh + 1)), int(rng.integers(0, dw + 1))
    else:
        raise NotImplementedError(reshape_mode)
    if isinstance(arr, np.ndarray):
        return center_crop(resize_bicubic_host(arr, nh, nw, antialias=True), top, left, th, tw)
    return resize_bicubic(arr, nh, nw, antialias=True)[:, :, top:top + th, left:left + tw]


def smpl_downsample(video_tchw):
    """0.5x bilinear downsample of the pose render (host for numpy input)."""
    h, w = video_tchw.shape[-2:]
    if isinstance(video_tchw, np.ndarray):
        return resize_bilinear_host(video_tchw, h // 2, w // 2)
    return resize_bilinear(video_tchw, h // 2, w // 2)


def pad_last_frame(tensor: np.ndarray, num_frames: int) -> np.ndarray:
    """The first num_frames frames, repeating the last one where there are fewer."""
    if tensor.shape[0] >= num_frames:
        return tensor[:num_frames]
    pad = np.repeat(tensor[-1:], num_frames - tensor.shape[0], axis=0)
    return np.concatenate([tensor, pad], axis=0)


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
