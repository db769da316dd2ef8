"""BENCHMARK.json against the benchmark's contract, and everything of a cell
found by name: configuration, traffic mix, limits, metric readers."""

import json
import re

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ROOT = manifest.ROOT


@pytest.fixture(scope="module")
def bench():
    return manifest.manifest()


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "-m", "portbench.run"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) < 64 * 1024


def test_check_budget_fits_24_cells(bench):
    """2 + 14 x cells runs of run_seconds + 60 s, 2 x 90 s a cell to compile,
    1200 s spare, within 43,200 s at the most cells a later PR may add."""
    cells = 24
    total = (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200


def test_names_units_and_keys(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert c["reduced"] == [] and 0 < len(c["why"]) <= 200
        names.add(c["name"])
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cells.add(w["name"])
    assert len(cells) == len(bench["workloads"])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                     "higher")
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert set(m["workloads"]) <= cells


def test_cells_in_the_issues_order(bench):
    """The first cell stays first; every configuration's file exists and
    every cell names a configuration, so an added configuration passes."""
    assert [w["name"] for w in bench["workloads"]][:1] == ["sample-1p3b-dense-81f"]
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file(), c["file"]
    assert {w["config"] for w in bench["workloads"]} <= {c["name"] for c in bench["configs"]}


@pytest.mark.parametrize("cell", ["sample-1p3b-dense-81f", "sample-14b-dense-81f",
                                  "sample-1p3b-sta-81f"])
def test_cell_found_by_name(cell, bench):
    if cell not in {w["name"] for w in bench["workloads"]}:
        pytest.skip(f"{cell} is not among the benchmark's cells")
    c = manifest.load_cell(cell)
    assert c.config["name"] in {x["name"] for x in bench["configs"]}
    assert c.traffic["frames"] == 81 and (c.traffic["height"], c.traffic["width"]) == (512, 896)
    assert c.limits is not None and set(c.limits) >= {"rel_l2", "worst_frame_rel_l2"}
    assert [m["name"] for m in c.end_to_end] == ["denoise_step_s", "setup_s"]
    assert len(c.per_layer) == sum(cell in m.get("workloads", ()) for m in bench["per_layer"])
    assert c.net["attn_impl"] == c.traffic["attn_impl"]


def test_metric_readers_match_the_manifest(bench):
    for m in bench["per_layer"]:
        reader = manifest.metric_reader(m["name"])
        assert reader.UNIT == m["unit"] and reader.MOVES == m["moves"]
        assert callable(reader.read)


def test_config_files_hold_the_yaml_widths():
    import yaml

    for name, yml in (("scail-1p3b", "scail_1p3b.yaml"), ("scail-14b", "scail_14b.yaml")):
        with open(ROOT / "portbench" / "configs" / f"{name}.json") as f:
            cfg = json.load(f)
        with open(ROOT / "configs" / "video_model" / yml) as f:
            model = yaml.safe_load(f)["model"]
        got = cfg["model"]["network_config"]["params"]
        want = model["network_config"]["params"]
        for key in ("hidden_size", "num_layers", "num_attention_heads", "inner_hidden_size",
                    "text_dim", "time_embed_dim", "in_channels", "out_channels"):
            assert got[key] == want[key], key
        assert float(got["layernorm_epsilon"]) == float(want["layernorm_epsilon"])
        assert cfg["model"]["sampler_config"] == model["sampler_config"]
