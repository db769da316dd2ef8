"""cross_attn_ms.sample: device milliseconds a step in the DiT layers'
dual text + CLIP cross-attention.

The port's span `dit.cross_attn` (models/dit.py `DiT._layer`), CUDA events
on the stream: the LayerNorm, cross_q, cross_kv and clip_kv, their RMS
norms, K3 and cross_out with its residual, a step of the window but its
first."""

from portbench.program_spans import per_step_ms

UNIT = "ms/step"
MOVES = "denoise_step_s"


def read(r):
    return per_step_ms("dit.cross_attn")
