"""Native tar-shard IO (counterpart of scail_tpu/native/tario.py): a one-pass
index of a local webdataset shard and pread member reads, from
scail_tpu_torch/csrc/tario.cpp through ctypes.

The library is built by g++ at first use, from this checkout's source only,
into `build/scail_tpu_torch/` at the repository root, named after a hash of
the source and the flags (as ops/cuda_build.py names the CUDA library), so
an edited source is never served by a stale build.  A build or load failure
raises: there is no silent fallback.  `_index_tarfile`, the same index
through Python's tarfile, is the plain version that a caller (the tests)
asks for by name.

ctypes releases the GIL around the foreign calls, so a prefetch thread
reading the next sample overlaps the host's decode and the device step.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from scail_tpu_torch.ops.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "tario.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# the first buffers tar_scan fills; a shard with more members or longer names
# returns -2, and index_tar grows both 4x and scans again
MAX_ENTRIES = 1 << 16
NAMES_CAP = 1 << 22

_LOCK = threading.Lock()
_LIB = None
BUILD_INFO: dict = {}


def _digest() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile the library if no build of the current source exists.
    Returns {'path', 'cached', 'cmd'}; raises on failure."""
    lib_path = BUILD_DIR / f"libscail_tario_{_digest()}.so"
    if lib_path.is_file():
        return {"path": str(lib_path), "cached": True, "cmd": None}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".tmp{os.getpid()}")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the native tar index cannot be built") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed (rc {proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return {"path": str(lib_path), "cached": False, "cmd": cmd}


def get_lib() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            info = build()
            lib = ctypes.CDLL(info["path"])
            lib.tar_scan.restype = ctypes.c_int64
            lib.tar_scan.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
            lib.tar_pread.restype = ctypes.c_int64
            lib.tar_pread.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_void_p]
            BUILD_INFO.update(info)
            _LIB = lib
        return _LIB


def _index_tarfile(path: str) -> List[Tuple[str, int, int]]:
    """The plain version of index_tar, through Python's tarfile."""
    import tarfile

    out = []
    with tarfile.open(path) as tf:
        for m in tf.getmembers():
            if m.isfile():
                out.append((m.name, m.offset_data, m.size))
    return out


def index_tar(path: str) -> List[Tuple[str, int, int]]:
    """[(member name, payload offset, size)] of the regular files, in archive
    order.  A truncated or corrupt archive raises OSError, where tarfile
    raises ReadError."""
    lib = get_lib()
    max_entries, names_cap = MAX_ENTRIES, NAMES_CAP
    while True:
        offsets = np.empty(max_entries, np.int64)
        sizes = np.empty(max_entries, np.int64)
        names = ctypes.create_string_buffer(names_cap)
        n = lib.tar_scan(path.encode(), offsets.ctypes.data, sizes.ctypes.data, names,
                         names_cap, max_entries)
        if n == -2:
            max_entries *= 4
            names_cap *= 4
            continue
        if n == -3:
            raise OSError(f"truncated or corrupt tar: {path}")
        if n < 0:
            raise OSError(f"tar_scan failed for {path}")
        break
    out, pos = [], 0
    raw = names.raw
    for i in range(n):
        end = raw.index(b"\0", pos)
        # surrogateescape, as Python's tarfile decodes names
        out.append((raw[pos:end].decode("utf-8", "surrogateescape"), int(offsets[i]),
                    int(sizes[i])))
        pos = end + 1
    return out


def read_member(path: str, offset: int, size: int) -> bytearray:
    """One member's payload, read by pread straight into the returned
    bytearray (the GIL released in the native call)."""
    lib = get_lib()
    buf = bytearray(size)
    addr = (ctypes.c_char * size).from_buffer(buf) if size else None
    got = lib.tar_pread(path.encode(), offset, size, addr)
    if got != size:
        raise OSError(f"short read from {path} @{offset}: {got}/{size}")
    return buf


class TarShardIndex:
    """Random-access view of one local shard: members grouped into webdataset
    samples by the full name before the first dot, as the stream path groups
    them (so nested names give the same keys on both paths), in archive
    order."""

    def __init__(self, path: str):
        self.path = path
        self.members = index_tar(path)
        self.samples: List[Tuple[str, Dict[str, Tuple[int, int]]]] = []
        cur_key, cur = None, {}
        for name, off, size in self.members:
            base, _, ext = name.partition(".")
            if cur_key is not None and base != cur_key and cur:
                self.samples.append((cur_key, cur))
                cur = {}
            cur_key = base
            cur[ext] = (off, size)
        if cur:
            self.samples.append((cur_key, cur))

    def __len__(self):
        return len(self.samples)

    def read_sample(self, i: int) -> Dict[str, bytes]:
        key, exts = self.samples[i]
        out: Dict[str, bytes] = {"__key__": key}
        for ext, (off, size) in exts.items():
            out[ext] = read_member(self.path, off, size)
        return out
