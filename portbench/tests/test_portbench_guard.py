"""The whole-name check for JAX modules, and the command's refusal without
a card."""

import os
import subprocess
import sys

from portbench.guard import forbidden_modules
from portbench.manifest import ROOT


def test_whole_top_level_names_only():
    assert forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                              "scail_tpu", "scail_tpu.ops.attention"]) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "scail_tpu",
        "scail_tpu.ops.attention"]
    # the port's name begins with the JAX package's and is no match
    assert forbidden_modules(["scail_tpu_torch", "scail_tpu_torch.ops.attention", "jaxtyping",
                              "flaxen", "torch", "portbench.run"]) == []


def test_the_benchmark_loads_no_jax_module():
    code = ("import sys; import portbench.harness, portbench.control, portbench.run; "
            "import scail_tpu_torch.engine; from portbench.guard import forbidden_modules; "
            "print(forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, USE_FLAX="0", USE_TF="0"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "sample-1p3b-dense-81f", "--seed", "5", "--seconds", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
