"""Calibration probe (counterpart of scail_tpu/utils/benchmarking.py).

`calibration_probe` times a chain of `chain` n x n bf16 matrix products on
the card in the same process as whatever is being measured, so that a slow
card (a lower power limit or clock, a warm machine) separates from a code
regression: record its reading beside every measurement of a session.  It
is a plain matrix product, so cuBLAS carries it (`torch.matmul`).  The
timed region ends with `torch.cuda.synchronize()`, not with a host copy.
"""

from __future__ import annotations

import time

import torch

# dense bf16 tensor-core peak of the H100 SXM (NVIDIA data sheet), the card of
# the port's measurements (NVIDIA H100 80GB HBM3, 700.00 W power limit); pass
# another peak for another card
PEAK_TFLOPS = 989.0


def calibration_probe(peak_tflops: float = PEAK_TFLOPS, n: int = 8192, chain: int = 16,
                      device: str = "cuda") -> dict:
    """Time `chain` chained n x n bf16 matrix products on `device` after one
    warm-up chain; returns {probe_matmul_tflops, probe_frac_of_peak}."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(n, n, generator=g, device=dev, dtype=torch.bfloat16)
    # entries of std 1/sqrt(n) keep the chain's scale (no inf or nan in the timing)
    b = (torch.randn(n, n, generator=g, device=dev, dtype=torch.float32)
         / n ** 0.5).to(torch.bfloat16)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def mm_chain(x):
        for _ in range(chain):
            x = torch.matmul(x, b)
        return x

    mm_chain(a)
    sync()
    t0 = time.perf_counter()
    mm_chain(a)
    sync()
    dt = time.perf_counter() - t0
    tflops = chain * 2 * n ** 3 / dt / 1e12
    return {"probe_matmul_tflops": round(tflops, 1),
            "probe_frac_of_peak": round(tflops / peak_tflops, 4)}
