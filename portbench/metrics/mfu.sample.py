"""mfu.sample: the denoise step's model operations over the card's peak.

The step's operations from the configuration's shapes (portbench.flops:
linears, dual cross-attention, and self-attention over the pairs the
request needs), over the traced window's seconds a step times the bf16
peak, 989 TFLOP/s (H100 SXM).  The card's power limit is on the run's
standard error beside it."""

from portbench.flops import BF16_PEAK_FLOPS

UNIT = "%"
MOVES = "denoise_step_s"


def read(r):
    return 100.0 * r.work.model_flops / (r.step_s * BF16_PEAK_FLOPS)
