"""imports_s.setup: host seconds of set-up spent importing the port's
registered modules.

The port's host-clock span `setup.imports` (utils/registry.py
`ensure_imports`, once a process): every module that registers a YAML
target, the UNet, VideoUNet, VAEs, umt5, CLIP, vqgan and the image engine
among them, whether the cell builds them or not."""

from portbench.program_spans import profiling

UNIT = "s"
MOVES = "setup_s"


def read(r):
    p = profiling()
    if p is None:
        return None
    got = [s.host_ms for s in p.spans() if s.name == "setup.imports" and s.host_ms is not None]
    return sum(got) / 1e3 if got else None
