"""Dataset plumbing (counterpart of scail_tpu/data/datasets.py; reference:
sat/data_utils/configure_data.py, datasets.py, samplers.py, webds.py,
data_video.py).

Map-style datasets, weighted and alternating mixtures, a distributed batch
sampler with deterministic `start_iter` resume, numpy collation and a loader
that collates on a background thread.  A batch whose load raises is skipped
with a warning, and training goes on (the reference guards hung video decodes
with timeout threads, data_video.py:109-138).  Webdataset-style tar shards
stream through `TarShardDataset`: local shards through the native index
(native/tario.py), any other URL through `gopen` and `tarfile`.

Everything stays on the host as numpy; the trainer moves each batch to the
device.
"""

from __future__ import annotations

import io
import itertools
import json
import os
import queue
import re
import shutil
import tempfile
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from scail_tpu_torch.data.video import (find_file_with_patterns, frames_to_tchw_normalized,
                                        load_image_chw_normalized, load_video_frames,
                                        pad_last_frame, resize_for_rectangle_crop)
from scail_tpu_torch.utils.logging import print_rank0

VIDEO_PATTERNS = ["driving.mp4", "driving.gif", "GT.mp4", "GT.gif", "driving.npz"]
POSE_PATTERNS = ["rendered.mp4", "rendered.gif", "rendered.npz", "rendered"]
REF_PATTERNS = ["ref.jpg", "ref.png"]


class Dataset:
    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int):
        raise NotImplementedError


class TensorDictDataset(Dataset):
    """In-memory dict-of-arrays dataset (first axis indexes examples)."""

    def __init__(self, data: Dict[str, np.ndarray]):
        self.data = data
        self.n = len(next(iter(data.values())))

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        return {k: v[idx] for k, v in self.data.items()}


class JsonlDataset(Dataset):
    """One JSON object a line, blank lines skipped (sat/data_utils/jsonlds.py)."""

    def __init__(self, path: str, process_fn: Callable = None):
        with open(path) as f:
            self.rows = [json.loads(line) for line in f if line.strip()]
        self.process_fn = process_fn or (lambda r: r)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        return self.process_fn(self.rows[idx])


def load_video_pose_example(d: str, image_size, num_frames: int) -> Dict[str, Any]:
    """One example directory (a driving video, a rendered pose video and a
    reference image) as float32 arrays in [-1, 1]: mp4 and pose (T, 3, H, W),
    ref_frame and first_frame (1, 3, H, W), resized and center-cropped to
    image_size, the clips padded with their last frame to num_frames."""
    def find(patterns, what):
        path = find_file_with_patterns(d, patterns)
        if path is None:
            raise FileNotFoundError(f"no {what} ({', '.join(patterns)}) in {d}")
        return path

    frames, _ = load_video_frames(find(VIDEO_PATTERNS, "driving video"))
    pose, _ = load_video_frames(find(POSE_PATTERNS, "pose video"))

    def clip(x):
        x = frames_to_tchw_normalized(pad_last_frame(x, num_frames))
        return resize_for_rectangle_crop(x, list(image_size), "center")

    mp4 = clip(frames)
    ref = load_image_chw_normalized(find(REF_PATTERNS, "reference image"))
    ref = resize_for_rectangle_crop(ref, list(image_size), "center")
    return {"mp4": mp4, "pose": clip(pose), "ref_frame": ref, "first_frame": mp4[:1], "txt": ""}


class VideoPoseDataset(Dataset):
    """Paired video + pose example directories under `root`, the training-side
    analogue of data_video.load_video_with_pose (data_video.py:30-108); each
    item is `load_video_pose_example` of one directory, in sorted order."""

    def __init__(self, root: str, image_size=(256, 448), num_frames: int = 9):
        self.root = root
        self.dirs = sorted(os.path.join(root, d) for d in os.listdir(root)
                           if os.path.isdir(os.path.join(root, d)))
        self.image_size = list(image_size)
        self.num_frames = num_frames

    def __len__(self):
        return len(self.dirs)

    def __getitem__(self, idx):
        return load_video_pose_example(self.dirs[idx], self.image_size, self.num_frames)


class VideoPoseSample:
    """The process_fn of a tar shard of video + pose examples: a webdataset
    sample whose members are named `<key>.driving.mp4`, `<key>.rendered.mp4`,
    `<key>.ref.jpg` (any name of VIDEO_PATTERNS, POSE_PATTERNS, REF_PATTERNS
    after the key) and optionally `<key>.txt`, decoded exactly as
    VideoPoseDataset decodes a directory holding those files.  The text is
    the sample's "caption" where sidecar metadata injected one
    (MetaTarShardDataset with meta_names=["caption"]), else its txt member,
    else ""."""

    def __init__(self, image_size=(256, 448), num_frames: int = 9):
        self.image_size = list(image_size)
        self.num_frames = num_frames

    def __call__(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        d = tempfile.mkdtemp(prefix="scail_sample_")
        try:
            for ext, payload in sample.items():
                if ext in VIDEO_PATTERNS + POSE_PATTERNS + REF_PATTERNS:
                    with open(os.path.join(d, ext), "wb") as f:
                        f.write(payload)
            item = load_video_pose_example(d, self.image_size, self.num_frames)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        txt = sample.get("caption")
        if txt is None:
            txt = bytes(sample.get("txt", b"")).decode("utf-8")
        item["txt"] = txt
        return item


class WeightedConcatDataset(Dataset):
    """Sample datasets proportionally to weights
    (sat/data_utils/configure_data.py:303-380): each __getitem__ draws the
    dataset and then its item from the mixture's own seeded generator."""

    def __init__(self, datasets: Sequence[Dataset], weights: Sequence[float], seed: int = 0):
        self.datasets = list(datasets)
        w = np.asarray(weights, np.float64)
        self.probs = w / w.sum()
        self.rng = np.random.default_rng(seed)
        self.n = int(sum(len(d) for d in self.datasets))

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        di = int(self.rng.choice(len(self.datasets), p=self.probs))
        d = self.datasets[di]
        return d[int(self.rng.integers(0, len(d)))]


class AlterDataset(Dataset):
    """Round-robin alternation (configure_data.py:383-446)."""

    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        self.n = sum(len(d) for d in self.datasets)

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        d = self.datasets[idx % len(self.datasets)]
        return d[(idx // len(self.datasets)) % len(d)]


class DistributedBatchSampler:
    """Deterministic epochs (shuffled by `seed + epoch` when `shuffle`) cut into
    `world_size` slices of which data rank `rank` takes its own, in batches,
    resumable at `start_iter` batches (sat/data_utils/samplers.py).  A slice
    holds n // world_size indices with drop_last, else the ceiling (the last
    rank's slice is then shorter); a slice's remainder short of a batch is
    dropped, and a slice shorter than a batch raises (the JAX sampler then
    yields nothing and its loader waits for ever)."""

    def __init__(self, n: int, batch_size: int, rank: int = 0, world_size: int = 1,
                 shuffle: bool = True, seed: int = 0, start_iter: int = 0,
                 drop_last: bool = True):
        self.n, self.batch_size = n, batch_size
        self.rank, self.world_size = rank, world_size
        self.shuffle, self.seed = shuffle, seed
        self.start_iter = start_iter
        self.drop_last = drop_last

    def epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.n)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + epoch).permutation(idx)
        per = self.n // self.world_size if self.drop_last else -(-self.n // self.world_size)
        return idx[self.rank * per:(self.rank + 1) * per]

    def __iter__(self) -> Iterator[List[int]]:
        per = len(self.epoch_indices(0))
        if per < self.batch_size:  # no batch in any epoch: the loader would wait for ever
            raise ValueError(f"rank {self.rank} of {self.world_size} holds {per} of {self.n} "
                             f"indices an epoch, fewer than a batch of {self.batch_size}")
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


def _put_until(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """A bounded put that gives up once `stop` is set: a consumer that
    abandons its iterator (early stop, islice) must not strand the producer
    on a full queue.  Returns whether the item went in."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


class DataLoader:
    """Collates the sampler's batches on a background thread, `prefetch`
    batches ahead.  A batch whose load or collation raises is skipped with a
    warning; an error of the sampler is raised to the consumer; `timeout`
    bounds the wait for the next batch (queue.Empty past it), a guard
    against hung decodes."""

    def __init__(self, dataset, sampler: DistributedBatchSampler,
                 collate_fn: Callable = default_collate, prefetch: int = 2,
                 timeout: Optional[float] = None):
        self.dataset, self.sampler = dataset, sampler
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self.timeout = timeout

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            try:
                for batch_idx in self.sampler:
                    if stop.is_set():
                        return
                    try:
                        batch = self.collate_fn([self.dataset[i] for i in batch_idx])
                    except Exception as e:  # skip the corrupt sample, keep training
                        print_rank0(f"dataloader: skipping batch {batch_idx}: {e}", "warning")
                        continue
                    if not _put_until(q, batch, stop):
                        return
            except Exception as e:  # the sampler's own error: raised in the consumer
                _put_until(q, e, stop)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while True:
                item = q.get(timeout=self.timeout)
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


class TarShardDataset:
    """Streaming webdataset-style tar shards (reference: sat/data_utils/webds.py
    SimpleDistributedWebDataset).

    Members group into samples by the name before its first dot
    (`000001.jpg`, `000001.txt`, ...); iteration yields dicts keyed by the
    rest of the name, with the key under `__key__`.  The shards are sorted,
    shuffled by `seed` when `shuffle_shards`, split `rank::world_size`, and
    cycled over without end.
    """

    def __init__(self, shard_paths: Sequence[str], process_fn: Callable = None,
                 rank: int = 0, world_size: int = 1, seed: int = 0,
                 shuffle_shards: bool = True):
        self.shards = sorted(shard_paths)
        if shuffle_shards:
            self.shards = list(np.random.default_rng(seed).permutation(self.shards))
        self.shards = self.shards[rank::world_size]
        self.process_fn = process_fn or (lambda s: s)
        self._index_cache: Dict[str, Any] = {}

    def _begin_shard(self, shard: str) -> None:
        """Per-shard hook before iteration (MetaTarShardDataset loads its
        sidecar metadata here)."""

    def __iter__(self):
        for shard in itertools.cycle(self.shards):
            self._begin_shard(shard)
            if os.path.isfile(shard):
                yield from self._iter_local(shard)
            else:
                yield from self._iter_stream(shard)

    def _iter_local(self, shard):
        """A local shard: its native index (built once a shard), the samples
        read with pread on a prefetch thread (the foreign calls release the
        GIL, so the next read overlaps process_fn and the device step)."""
        from scail_tpu_torch.native.tario import TarShardIndex

        idx = self._index_cache.get(shard)
        if idx is None:
            idx = self._index_cache[shard] = TarShardIndex(shard)
        q: "queue.Queue" = queue.Queue(maxsize=4)
        stop = threading.Event()

        def reader():
            try:
                for i in range(len(idx)):
                    if not _put_until(q, idx.read_sample(i), stop):
                        return
                _put_until(q, None, stop)
            except BaseException as e:  # raised again in the consumer
                _put_until(q, e, stop)

        threading.Thread(target=reader, daemon=True).start()
        try:
            while True:
                s = q.get()
                if s is None:
                    break
                if isinstance(s, BaseException):
                    raise s
                yield self.process_fn(s)
        finally:  # runs on close and garbage collection too
            stop.set()

    def _iter_stream(self, shard):
        """Any other URL: a gopen stream (file, pipe, rclone, s3, http) read
        by tarfile in stream mode (webds.py:290-368), grouped like the local
        path."""
        import tarfile

        from scail_tpu_torch.data.gopen import gopen

        with gopen(shard) as stream, tarfile.open(fileobj=stream, mode="r|*") as tf:
            sample: Dict[str, Any] = {}
            key = None
            for member in tf:
                if not member.isfile():
                    continue
                base, _, ext = member.name.partition(".")
                if key is not None and base != key and sample:
                    yield self.process_fn(dict(sample, __key__=key))
                    sample = {}
                key = base
                sample[ext] = tf.extractfile(member).read()
            if sample:
                yield self.process_fn(dict(sample, __key__=key))


def braceexpand(pattern: str) -> List[str]:
    """Brace expansion for shard patterns: numeric ranges `{000..123}`
    (zero-padding kept) and comma lists `{a,b}`, recursively; the webdataset
    shard-URL idiom the reference takes from the braceexpand package
    (sat/data_utils/webds.py:260)."""
    m = re.search(r"\{([^{}]*)\}", pattern)
    if not m:
        return [pattern]
    head, tail = pattern[:m.start()], pattern[m.end():]
    body = m.group(1)
    rng = re.fullmatch(r"(\d+)\.\.(\d+)", body)
    if rng:
        a, b = rng.group(1), rng.group(2)
        width = len(a) if a.startswith("0") or len(a) == len(b) else 0
        parts = [str(i).zfill(width) for i in range(int(a), int(b) + 1)]
    else:
        parts = body.split(",")
    out: List[str] = []
    for p in parts:
        out.extend(braceexpand(head + p + tail))
    return out


def expand_shard_paths(path: str = "", include_dirs: Optional[str] = None) -> List[str]:
    """A brace pattern plus `dirA,dirB*3`-style include dirs as a list of
    shards (MetaDistributedWebDataset.__init__, webds.py:243-268): each dir is
    walked in sorted order for non-empty .tar files, and an `*n` suffix
    repeats a dir's shards n times.  The walk is sorted, so every rank
    computes the same list without a broadcast."""
    paths: List[str] = list(braceexpand(path)) if path else []
    if include_dirs:
        for spec in include_dirs.split(","):
            n = 1
            if "*" in spec:
                spec, rep = spec.rsplit("*", 1)
                n = int(rep)
            found: List[str] = []
            for cur, _dirs, files in sorted(os.walk(spec)):
                for f in sorted(files):
                    full = os.path.join(cur, f)
                    if f.endswith(".tar") and os.path.getsize(full) > 0:
                        found.append(full)
            paths.extend(found * n)
    return paths


class MetaTarShardDataset(TarShardDataset):
    """Tar shards with sidecar metadata (MetaDistributedWebDataset,
    sat/data_utils/webds.py:233-289): beside each `X.tar` an optional
    `X.meta.jsonl` holds one JSON object a line whose 'key' names a sample;
    its `meta_names` fields are injected into that sample before process_fn
    runs.  Malformed lines, and JSON that is no object or has no key, are
    skipped (webds.py:110-117)."""

    def __init__(self, shard_paths: Sequence[str], process_fn: Callable = None, *,
                 meta_names: Sequence[str] = (), **kw):
        self.meta_names = list(meta_names)
        self._meta: Dict[str, Dict[str, Any]] = {}
        inner = process_fn or (lambda s: s)

        def inject(sample):
            md = self._meta.get(sample.get("__key__"), None)
            if md:
                for name in self.meta_names:
                    if name in md:
                        sample[name] = md[name]
            return inner(sample)

        super().__init__(shard_paths, inject, **kw)

    @staticmethod
    def meta_path_for(shard: str) -> str:
        d, fname = os.path.split(shard)
        # only the last extension goes: 'clips.v2-000.tar' -> 'clips.v2-000.meta.jsonl'
        return os.path.join(d, os.path.splitext(fname)[0] + ".meta.jsonl")

    def _load_meta(self, shard: str) -> Dict[str, Dict[str, Any]]:
        if not self.meta_names:
            return {}
        meta_path = self.meta_path_for(shard)
        out: Dict[str, Dict[str, Any]] = {}
        try:
            if os.path.isfile(meta_path):
                stream = open(meta_path, "r")
            else:
                from scail_tpu_torch.data.gopen import gopen

                stream = io.TextIOWrapper(gopen(meta_path))
        except (OSError, ValueError):
            return {}
        with stream:
            for line in stream:
                try:
                    item = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(item, dict) or "key" not in item:
                    continue
                entry = out.setdefault(item["key"], {})
                for name in self.meta_names:
                    if name in item:
                        entry[name] = item[name]
        return out

    def _begin_shard(self, shard: str) -> None:
        self._meta = self._load_meta(shard)


def make_loaders(train_ds, batch_size: int, *, valid_ds=None, rank: int = 0,
                 world_size: int = 1, seed: int = 0, start_iter: int = 0):
    """(train, valid) loaders of data rank `rank` of `world_size`
    (configure_data.py:168-264): train shuffled by `seed` from batch
    `start_iter`, valid (None without `valid_ds`) in order."""
    train = DataLoader(train_ds, DistributedBatchSampler(
        len(train_ds), batch_size, rank, world_size, True, seed, start_iter))
    valid = None
    if valid_ds is not None:
        valid = DataLoader(valid_ds, DistributedBatchSampler(
            len(valid_ds), batch_size, rank, world_size, False, seed))
    return train, valid
