"""sampler_update_ms.sample: device milliseconds a step in the sampler's
step outside the DiT forward.

The self time of the port's span `sampler.step` (diffusion/samplers.py
`RFSampler.step`): its CUDA events' interval less its `dit.forward` span.
The CFG batch concat, the denoiser's scaling, the guider's combine and the
Euler update, measured from inside the program; sampler_ms.sample measures
the same work from outside, in the gaps between the harness's forward
hooks.  Over the window's steps but the first (program_spans.py)."""

from portbench.program_spans import STEP, per_step_ms

UNIT = "ms/step"
MOVES = "denoise_step_s"


def read(r):
    return per_step_ms(STEP, self_time=True)
