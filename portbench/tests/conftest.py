"""Each test starts with no span recorded by the port in this process (the
readers of the port's spans read what the process recorded)."""

import pytest


@pytest.fixture(autouse=True)
def no_recorded_spans():
    from scail_tpu_torch.utils import profiling

    if hasattr(profiling, "reset"):
        profiling.reset()
    yield
