"""sampler_ms.sample: device milliseconds a step outside the DiT forward.

The gap between one DiT forward's end and the next one's start, from the
CUDA events the harness's forward hooks record in the traced window: the
CFG combine, the Euler update, the denoiser's scaling and the copies that
build the next forward's CFG batch (engine.py, diffusion/samplers.py,
guiders.py).  Nothing to read where the window held one step."""

UNIT = "ms/step"
MOVES = "denoise_step_s"


def read(r):
    if not r.forward_gaps_ms:
        return None
    return sum(r.forward_gaps_ms) / len(r.forward_gaps_ms)
