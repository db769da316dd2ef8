"""attn_roofline.sample: the self-attention kernels' share of their bound.

The bound time of the step's self-attention work (portbench.flops: the
pairs the request needs, at 989 TFLOP/s bf16, or its bytes at 3.35 TB/s
where larger) times the traced steps, over the device time of the kernels
that do it: K1 and K2 (flash_fwd_kernel), K7 (sta_fwd_kernel)."""

UNIT = "%"
MOVES = "denoise_step_s"
SELF_ATTENTION = ("flash_fwd_kernel", "sta_fwd_kernel")


def read(r):
    if r.trace is None:
        return None
    seconds = r.trace.op_seconds(SELF_ATTENTION)
    if seconds == 0:
        return None
    return 100.0 * r.work.self_attn_bound_s * r.steps / seconds
