"""self_attn_ms.sample: device milliseconds a step in the DiT layers'
self-attention.

The port's span `dit.self_attn` (models/dit.py `DiT._layer`), CUDA events
on the stream: the AdaLN LayerNorm (K9), the qkv linear, the q/k RMS norms,
the rotary (K10), K1 (or K7 and K2 under STA), attn_out and the gated
residual, summed over the layers, a step of the window but its first."""

from portbench.program_spans import per_step_ms

UNIT = "ms/step"
MOVES = "denoise_step_s"


def read(r):
    return per_step_ms("dit.self_attn")
