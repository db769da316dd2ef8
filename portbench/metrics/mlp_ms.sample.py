"""mlp_ms.sample: device milliseconds a step in the DiT layers' MLP.

The port's span `dit.mlp` (models/dit.py `DiT._layer`), CUDA events on the
stream: the AdaLN LayerNorm (K9), mlp_in, the GELU-tanh, mlp_out and the
gated residual, a step of the window but its first."""

from portbench.program_spans import per_step_ms

UNIT = "ms/step"
MOVES = "denoise_step_s"


def read(r):
    return per_step_ms("dit.mlp")
