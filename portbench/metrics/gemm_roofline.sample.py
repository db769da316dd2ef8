"""gemm_roofline.sample: the linears' share of their bound on cuBLAS.

The bound time of every linear of the step (portbench.flops: operations at
989 TFLOP/s bf16, or bytes at 3.35 TB/s where larger, linear by linear)
times the traced steps, over the device time of the GEMM kernels cuBLAS
runs for models/common.py `dense` (names below)."""

UNIT = "%"
MOVES = "denoise_step_s"
GEMM = ("gemm", "gemv", "nvjet", "cutlass")


def read(r):
    if r.trace is None:
        return None
    seconds = r.trace.op_seconds(GEMM)
    if seconds == 0:
        return None
    return 100.0 * r.work.linear_bound_s * r.steps / seconds
