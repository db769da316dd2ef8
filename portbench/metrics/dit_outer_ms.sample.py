"""dit_outer_ms.sample: device milliseconds a step in the DiT forward
outside its layers' three sub-blocks.

The self time of the port's span `dit.forward` (models/dit.py
`DiT.forward`): its CUDA events' interval less its `dit.self_attn`,
`dit.cross_attn` and `dit.mlp` spans.  The patch and text/CLIP/time
embeddings, the token concat, the per-layer AdaLN tables, the final layer
and the unpatchify, a step of the window but its first."""

from portbench.program_spans import per_step_ms

UNIT = "ms/step"
MOVES = "denoise_step_s"


def read(r):
    return per_step_ms("dit.forward", self_time=True)
