"""Demo image datasets (counterpart of scail_tpu/data/demo.py): MNIST and
CIFAR-10 loaders with the reference's record contract (sgm/data/mnist.py,
sgm/data/cifar10.py).

The reference wraps torchvision datasets in a dict adapter yielding
``{"jpg": tensor CHW in [-1, 1], "cls": int}`` (ToTensor -> [0,1] ->
``x * 2 - 1``) and exposes train/test/val loaders from a Lightning
DataModule.  This module keeps that contract but parses the on-disk
formats itself (IDX for MNIST, the pickled python batches for CIFAR-10),
so no torchvision and no download step is needed (the files are fetched
once with ``scail_tpu_torch.utils.download.auto_create`` or by hand).  A
deterministic ``synthetic`` mode serves the same record shapes from a
seeded generator, so smoke tests and demo configs run with no data on disk.
The records stay numpy; the trainer moves each batch to the device.

The reference's third data module (sgm/data/dataset.py
StableDataModuleFromConfig) hard-exits without an out-of-tree
``stable-datasets`` submodule and has no counterpart; the config-driven
tar / jsonl / hf pipelines live in data/datasets.py and data/hf_dataset.py.
"""

import gzip
import os
import pickle
import struct
from typing import Dict, Optional

import numpy as np

from scail_tpu_torch.data.datasets import DataLoader, Dataset, DistributedBatchSampler

__all__ = ["read_idx", "load_mnist", "load_cifar10",
           "MNISTDemo", "CIFAR10Demo", "DemoImageLoader"]


def _open_maybe_gz(path: str):
    if os.path.exists(path + ".gz") and not os.path.exists(path):
        path = path + ".gz"
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_idx(path: str) -> np.ndarray:
    """Parse one IDX-format file (the MNIST container: magic byte 0x08 =
    ubyte, then ndim, then big-endian dims)."""
    with _open_maybe_gz(path) as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0 or dtype_code != 0x08:
            raise ValueError(f"{path}: not a ubyte IDX file "
                             f"(header {zero:#x}/{dtype_code:#x})")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def load_mnist(root: str, train: bool = True) -> Dict[str, np.ndarray]:
    """Read the 4 canonical MNIST IDX files (plain or .gz) from `root`
    (accepts both `root/` and `root/MNIST/raw/` layouts)."""
    stem = "train" if train else "t10k"
    names = [f"{stem}-images-idx3-ubyte", f"{stem}-images.idx3-ubyte"]
    search = [root, os.path.join(root, "MNIST", "raw")]
    for d in search:
        for n in names:
            if os.path.exists(os.path.join(d, n)) or \
               os.path.exists(os.path.join(d, n + ".gz")):
                images = read_idx(os.path.join(d, n))
                labels = read_idx(os.path.join(
                    d, n.replace("images", "labels")
                       .replace("idx3", "idx1")))
                return {"images": images[:, None], "labels": labels}
    raise FileNotFoundError(
        f"MNIST IDX files not found under {search}; fetch them once "
        "(e.g. utils.download) or use synthetic=True")


def load_cifar10(root: str, train: bool = True) -> Dict[str, np.ndarray]:
    """Read the pickled `cifar-10-batches-py` batches from `root`."""
    d = os.path.join(root, "cifar-10-batches-py")
    if not os.path.isdir(d):
        d = root
    batches = [f"data_batch_{i}" for i in range(1, 6)] if train \
        else ["test_batch"]
    imgs, labels = [], []
    for b in batches:
        p = os.path.join(d, b)
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"{p} missing; fetch cifar-10-python once or use "
                "synthetic=True")
        with open(p, "rb") as f:
            rec = pickle.load(f, encoding="bytes")
        imgs.append(np.asarray(rec[b"data"], np.uint8)
                    .reshape(-1, 3, 32, 32))
        labels.append(np.asarray(rec[b"labels"], np.int64))
    return {"images": np.concatenate(imgs),
            "labels": np.concatenate(labels)}


def _synthetic(n: int, chw, seed: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {"images": rng.integers(0, 256, (n,) + tuple(chw), np.uint8)
                         .astype(np.uint8),
            "labels": rng.integers(0, 10, (n,), np.int64)}


class _DemoDataset(Dataset):
    """uint8 CHW images + int labels -> the reference record contract:
    {"jpg": float32 CHW in [-1,1], "cls": int} (ToTensor /255 then
    x*2-1 — sgm/data/mnist.py:24-26)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        self.images, self.labels = images, labels

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        x = self.images[i].astype(np.float32) / 255.0
        return {"jpg": x * 2.0 - 1.0, "cls": int(self.labels[i])}


class MNISTDemo(_DemoDataset):
    def __init__(self, root: Optional[str] = None, train: bool = True,
                 synthetic: bool = False, synthetic_n: int = 256, seed: int = 0):
        d = _synthetic(synthetic_n, (1, 28, 28), seed) if synthetic \
            else load_mnist(root or ".data", train)
        super().__init__(d["images"], d["labels"])


class CIFAR10Demo(_DemoDataset):
    def __init__(self, root: Optional[str] = None, train: bool = True,
                 synthetic: bool = False, synthetic_n: int = 256, seed: int = 0):
        d = _synthetic(synthetic_n, (3, 32, 32), seed) if synthetic \
            else load_cifar10(root or ".data", train)
        super().__init__(d["images"], d["labels"])


class DemoImageLoader:
    """Reference DataModule surface (MNISTLoader / CIFAR10Loader):
    train/test/val_dataloader() over the dp-sharded loader stack.  The
    reference serves the test split as val too (sgm/data/cifar10.py:62)."""

    def __init__(self, dataset: str = "mnist", batch_size: int = 32,
                 root: Optional[str] = None, shuffle: bool = True,
                 synthetic: bool = False, seed: int = 0,
                 rank: int = 0, world_size: int = 1):
        cls = {"mnist": MNISTDemo, "cifar10": CIFAR10Demo}[dataset.lower()]
        self.batch_size, self.seed = batch_size, seed
        self.shuffle = shuffle
        self.rank, self.world_size = rank, world_size
        self.train_dataset = cls(root, True, synthetic=synthetic, seed=seed)
        self.test_dataset = cls(root, False, synthetic=synthetic, seed=seed + 1)

    def _loader(self, ds, shuffle):
        return DataLoader(ds, DistributedBatchSampler(
            len(ds), self.batch_size, self.rank, self.world_size,
            shuffle, self.seed))

    def train_dataloader(self):
        return self._loader(self.train_dataset, self.shuffle)

    def test_dataloader(self):
        return self._loader(self.test_dataset, False)

    def val_dataloader(self):
        return self._loader(self.test_dataset, False)
