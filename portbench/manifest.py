"""Everything of a cell, found by name from BENCHMARK.json.

A cell names a configuration (its file is given in `configs`) and a traffic
mix (`portbench/traffic/<traffic>.json`); its correctness limits are
`portbench/limits/<cell>.json`; each per-layer metric is a reader in
`portbench/metrics/<metric>.py`.  Adding a cell, a configuration, a mix or
a metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict              # the configuration's file
    traffic: dict             # the traffic mix's file
    limits: Optional[dict]    # the correctness limits, None before they are set
    end_to_end: List[dict]    # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: List[dict]     # ... and its per-layer metrics

    @property
    def net(self) -> dict:
        """The DiT's network params as the cell runs them: the
        configuration's, with the model's use_i2v_clip (the engine passes it
        on) and the traffic's attention implementation."""
        params = dict(self.config["model"]["network_config"]["params"])
        params["use_i2v_clip"] = bool(self.config["model"].get("use_i2v_clip", False))
        params["attn_impl"] = self.traffic["attn_impl"]
        sta = self.traffic.get("sta")
        if sta is not None:
            params.update(sta_tile=list(sta["tile"]), sta_window=list(sta["window"]),
                          sta_windowed_pose=bool(sta["windowed_pose"]),
                          sta_pose_kv_window=int(sta["pose_kv_window"]))
        return params

    @property
    def sampler(self) -> dict:
        return self.config["model"]["sampler_config"]["params"]


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with its files read."""
    m = manifest(root)
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    config = {c["name"]: c for c in m["configs"]}[w["config"]]
    e2e = [x for x in m["end_to_end"] if _applies(x, name, [x["name"]])]
    reported = [x["name"] for x in e2e]
    limits_path = root / "portbench" / "limits" / f"{name}.json"
    return Cell(name=name, chips=int(w["chips"]), config=_json(root / config["file"]),
                traffic=_json(root / "portbench" / "traffic" / f"{w['traffic']}.json"),
                limits=_json(limits_path) if limits_path.is_file() else None,
                end_to_end=e2e,
                per_layer=[x for x in m["per_layer"] if _applies(x, name, reported)])


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """The reader module portbench/metrics/<name>.py."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_readers(cell: Cell, root: Path = ROOT) -> Dict[str, ModuleType]:
    return {x["name"]: metric_reader(x["name"], root) for x in cell.per_layer}
