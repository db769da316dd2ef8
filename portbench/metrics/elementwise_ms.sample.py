"""elementwise_ms.sample: device milliseconds a step of the DiT's glue.

Every device operation of the traced window outside the GEMM, self-
attention, dual cross-attention, AdaLN LayerNorm and rotary kernels (the
names below): the casts, concatenations, norms, activations, residual adds
and copies around them (models/dit.py)."""

UNIT = "ms/step"
MOVES = "denoise_step_s"
# kernel-name substrings of the groups left out
NOT_GLUE = ("gemm", "gemv", "nvjet", "cutlass",      # cuBLAS behind the linears
            "flash_fwd_kernel", "sta_fwd_kernel",     # K1, K2, K7
            "dual_cross_kernel",                      # K3
            "adaln_ln_kernel",                        # K9
            "rotary_kernel")                          # K10


def read(r):
    if r.trace is None:
        return None
    glue = r.trace.op_seconds() - r.trace.op_seconds(NOT_GLUE)
    return 1e3 * glue / r.steps
