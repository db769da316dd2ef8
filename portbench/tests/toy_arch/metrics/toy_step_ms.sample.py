"""toy_step_ms.sample: milliseconds a step of the test-only toy cell, on the
host clock of the traced run."""

UNIT = "ms/step"
MOVES = "denoise_step_s"


def read(r):
    return 1e3 * r.step_s
