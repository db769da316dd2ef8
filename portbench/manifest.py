"""Everything of a cell, found by name from BENCHMARK.json.

A cell names a configuration (its file is given in `configs`) and a traffic
mix (`portbench/traffic/<traffic>.json`); its correctness limits are
`portbench/limits/<cell>.json`; each per-layer metric is a reader in
`portbench/metrics/<metric>.py`; the configuration's `architecture` (SCAIL's
DiT, `scail_dit`, where the file names none) is the module
`portbench/arch/<architecture>.py` that holds everything of the network
(see portbench/README.md).  Adding a cell, a configuration, an
architecture, a mix or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = Path(__file__).resolve().parent
DEFAULT_ARCHITECTURE = "scail_dit"


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict              # the configuration's file
    traffic: dict             # the traffic mix's file
    limits: Optional[dict]    # the correctness limits, None before they are set
    end_to_end: List[dict]    # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: List[dict]     # ... and its per-layer metrics
    root: Path                # the checkout the cell's files were read from
    arch: ModuleType          # portbench/arch/<architecture>.py of that checkout

    @property
    def net(self) -> dict:
        """The network params as the cell runs them (the architecture's)."""
        return self.arch.net(self)


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


def _module(path: Path, name: str) -> ModuleType:
    """The module at `path`, executed as `name` (registered in sys.modules
    first, as an import does, so that its dataclasses and pickles resolve)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def architecture(name: str, root: Path = ROOT) -> ModuleType:
    """The architecture's module portbench/arch/<name>.py."""
    return _module(root / "portbench" / "arch" / f"{name}.py", f"portbench_arch_{name}")


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
    cfg = _json(root / config["file"])
    return Cell(name=name, chips=int(w["chips"]), config=cfg,
                traffic=_json(root / "portbench" / "traffic" / f"{w['traffic']}.json"),
                limits=_json(limits_path) if limits_path.is_file() else None,
                end_to_end=e2e,
                per_layer=[x for x in m["per_layer"] if _applies(x, name, reported)],
                root=root, arch=architecture(cfg.get("architecture", DEFAULT_ARCHITECTURE),
                                             root))


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """The reader module portbench/metrics/<name>.py."""
    return _module(root / "portbench" / "metrics" / f"{name}.py",
                   f"portbench_metric_{name.replace('.', '_')}")


def metric_readers(cell: Cell) -> Dict[str, ModuleType]:
    """The readers of the cell's per-layer metrics, from the cell's checkout."""
    return {x["name"]: metric_reader(x["name"], cell.root) for x in cell.per_layer}
