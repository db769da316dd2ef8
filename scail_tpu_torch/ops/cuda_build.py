"""Build the hand-written CUDA kernels (scail_tpu_torch/csrc) and bind them.

The kernels are compiled by nvcc for sm_90a into one shared library with a
plain C interface, at first use, from the sources in this checkout only, into
`build/scail_tpu_torch/` at the repository root: one nvcc per source, all
started together, then one link.  The library name carries a
hash of the sources and flags, so an edited source is never served by a stale
build.  The library is loaded with ctypes; a build failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "scail_tpu_torch"
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "dual_cross_attention.cu",
           "sta_attention.cu", "flash_attention_int8.cu", "w8a16_matmul.cu", "fused_norms.cu")
HEADERS = ("mma_common.cuh", "wgmma_common.cuh", "flash_bodies.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile the kernels if no build of the current sources exists.
    Returns {'path', 'seconds', 'cached', 'log'}; raises on failure."""
    lib_path = BUILD_DIR / f"libscail_kernels_{_digest()}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.is_file():
        log = log_path.read_text() if log_path.is_file() else ""
        return {"path": str(lib_path), "seconds": 0.0, "cached": True, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib_path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    t0 = time.perf_counter()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC_DIR / s)]
                         for s, o in zip(SOURCES, objs))]
    logs = []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0:
            for _, other in procs:
                other.kill()
            raise RuntimeError(f"nvcc failed (rc {proc.returncode}):\n{' '.join(cmd)}\n{out}")
    tmp = lib_path.with_suffix(f".tmp{os.getpid()}")
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = "".join(logs) + proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed (rc {proc.returncode}):\n{' '.join(cmd)}\n{log}")
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink()
    os.replace(tmp, lib_path)
    log_path.write_text(log)
    return {"path": str(lib_path), "seconds": seconds, "cached": False, "log": log}


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            info = build()
            cdll = ctypes.CDLL(info["path"])
            cdll.scail_flash_attention_fwd.argtypes = (
                [_P] * 7 + [_I] * 4 + [_L] * 12 + [_F, _I, _P])
            cdll.scail_flash_attention_fwd.restype = _I
            cdll.scail_dual_cross_attention_fwd.argtypes = (
                [_P] * 6 + [_I] * 5 + [_L] * 18 + [_F, _P])
            cdll.scail_dual_cross_attention_fwd.restype = _I
            cdll.scail_flash_attention_bwd_dq.argtypes = (
                [_P] * 7 + [_I] * 4 + [_L] * 15 + [_F, _P])
            cdll.scail_flash_attention_bwd_dq.restype = _I
            cdll.scail_flash_attention_bwd_dkv.argtypes = [_P] * 8 + [_I] * 4 + [_L] * 18 + [_P]
            cdll.scail_flash_attention_bwd_dkv.restype = _I
            cdll.scail_sta_attention_fwd.argtypes = [_P] * 6 + [_I] * 7 + [_L] * 12 + [_F, _P]
            cdll.scail_sta_attention_fwd.restype = _I
            cdll.scail_sta_attention_bwd_dq.argtypes = (
                [_P] * 8 + [_I] * 7 + [_L] * 15 + [_F, _P])
            cdll.scail_sta_attention_bwd_dq.restype = _I
            cdll.scail_sta_attention_bwd_dkv.argtypes = [_P] * 11 + [_I] * 8 + [_L] * 18 + [_P]
            cdll.scail_sta_attention_bwd_dkv.restype = _I
            cdll.scail_flash_attention_int8_fwd.argtypes = [_P] * 7 + [_I] * 4 + [_L] * 12 + [_P]
            cdll.scail_flash_attention_int8_fwd.restype = _I
            for fn in (cdll.scail_w8a16_matmul, cdll.scail_w4a16_matmul):
                fn.argtypes = [_P] * 5 + [_I] * 3 + [_L, _P]
                fn.restype = _I
            cdll.scail_adaln_layer_norm.argtypes = [_P] * 4 + [_I] * 3 + [_L] * 3 + [_I, _I, _F, _P]
            cdll.scail_adaln_layer_norm.restype = _I
            cdll.scail_rotary_interleaved.argtypes = [_P] * 4 + [_I] * 4 + [_L] * 3 + [_P]
            cdll.scail_rotary_interleaved.restype = _I
            _LIB = cdll
        return _LIB


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {rc}")
