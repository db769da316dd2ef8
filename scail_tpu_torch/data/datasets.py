"""Training data (counterpart of the parts of scail_tpu/data/datasets.py that
the training CLI runs): paired video + pose example directories, a
deterministic shuffled batch sampler with `start_iter` resume, numpy
collation and a loader that prefetches on a background thread.

Everything stays on the host as numpy; the trainer moves each batch to the
device.  A sample that fails to load raises in the training loop (the JAX
loader prints it and skips the batch).
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
from typing import Any, Dict, Iterator, List

import numpy as np

from scail_tpu_torch.data.video import (find_file_with_patterns, frames_to_tchw_normalized,
                                        load_image_chw_normalized, load_video_frames,
                                        pad_last_frame, resize_for_rectangle_crop)

VIDEO_PATTERNS = ["driving.mp4", "driving.gif", "GT.mp4", "GT.gif", "driving.npz"]
POSE_PATTERNS = ["rendered.mp4", "rendered.gif", "rendered.npz", "rendered"]
REF_PATTERNS = ["ref.jpg", "ref.png"]


class VideoPoseDataset:
    """Example directories under `root`, each holding a driving video, a
    rendered pose video and a reference image.  Items are dicts of float32
    (T, 3, H, W) / (1, 3, H, W) arrays in [-1, 1], resized and center-cropped
    to image_size, the clips padded with their last frame to num_frames."""

    def __init__(self, root: str, image_size=(256, 448), num_frames: int = 9):
        self.root = root
        self.dirs = sorted(os.path.join(root, d) for d in os.listdir(root)
                           if os.path.isdir(os.path.join(root, d)))
        self.image_size = list(image_size)
        self.num_frames = num_frames

    def __len__(self):
        return len(self.dirs)

    def _find(self, d, patterns, what):
        path = find_file_with_patterns(d, patterns)
        if path is None:
            raise FileNotFoundError(f"no {what} ({', '.join(patterns)}) in {d}")
        return path

    def __getitem__(self, idx):
        d = self.dirs[idx]
        frames, _ = load_video_frames(self._find(d, VIDEO_PATTERNS, "driving video"))
        pose, _ = load_video_frames(self._find(d, POSE_PATTERNS, "pose video"))

        def clip(x):
            x = frames_to_tchw_normalized(pad_last_frame(x, self.num_frames))
            return resize_for_rectangle_crop(x, self.image_size, "center")

        mp4 = clip(frames)
        ref = resize_for_rectangle_crop(
            load_image_chw_normalized(self._find(d, REF_PATTERNS, "reference image")),
            self.image_size, "center")
        return {"mp4": mp4, "pose": clip(pose), "ref_frame": ref, "txt": ""}


class DistributedBatchSampler:
    """Deterministic shuffled epochs of full batches, resumable at
    `start_iter` batches, each epoch's permutation cut into `world_size`
    equal slices of which data rank `rank` takes its own (the JAX sampler,
    shuffled, dropping the remainder)."""

    def __init__(self, n: int, batch_size: int, seed: int = 0, start_iter: int = 0,
                 rank: int = 0, world_size: int = 1):
        self.n, self.batch_size = n, batch_size
        self.seed, self.start_iter = seed, start_iter
        self.rank, self.world_size = rank, world_size

    def epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.random.default_rng(self.seed + epoch).permutation(self.n)
        per = self.n // self.world_size
        return idx[self.rank * per:(self.rank + 1) * per]

    def __iter__(self) -> Iterator[List[int]]:
        it = 0
        for epoch in itertools.count():
            idx = self.epoch_indices(epoch)
            for i in range(0, len(idx) - self.batch_size + 1, self.batch_size):
                if it >= self.start_iter:
                    yield idx[i:i + self.batch_size].tolist()
                it += 1


def default_collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack arrays, turn numbers into arrays, keep anything else as a list."""
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        elif isinstance(vals[0], (int, float)):
            out[k] = np.asarray(vals)
        else:
            out[k] = vals
    return out


class DataLoader:
    """Collates the sampler's batches on a background thread, PREFETCH
    batches ahead.  An error while loading is raised to the consumer."""

    PREFETCH = 2

    def __init__(self, dataset, sampler: DistributedBatchSampler):
        self.dataset, self.sampler = dataset, sampler

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch_idx in self.sampler:
                    if not put(default_collate([self.dataset[i] for i in batch_idx])):
                        return
            except Exception as e:  # raised again in the consumer
                put(e)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def make_loaders(train_ds, batch_size: int, *, seed: int = 0, start_iter: int = 0,
                 rank: int = 0, world_size: int = 1):
    """The training loader of data rank `rank` of `world_size`, from batch
    `start_iter` of the seeded epochs (the JAX function also builds a
    validation loader, which no caller uses)."""
    return DataLoader(train_ds, DistributedBatchSampler(len(train_ds), batch_size, seed,
                                                        start_iter, rank, world_size))
