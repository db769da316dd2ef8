"""idle_pct.sample: the share of the traced window the card ran nothing.

One minus the union of the device operations' intervals (kernels, copies,
memsets, from CUPTI) over the window's length."""

UNIT = "%"
MOVES = "denoise_step_s"


def read(r):
    if r.trace is None:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
