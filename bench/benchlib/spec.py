"""What a run of one cell needs from ``BENCHMARK.json``, found by name.

A cell (an entry of ``workloads``) names its configuration and its
traffic mix.  The configuration's file is the one ``configs`` gives for
it; the mix is ``bench/traffic/<traffic>.json``; a per-layer metric's
reader is ``bench/metrics/<name>.py``; the system a configuration runs
is ``benchlib/systems/<system>.py``, ``system`` being a key of the
configuration's file.  Adding a cell is adding files and entries: no
file here names one.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict              # the configuration's file, as run
    traffic: dict             # the traffic mix's file
    end_to_end: list          # BENCHMARK.json metric entries this cell reports
    per_layer: list
    root: Path                # the checkout the run is in


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(workload: str, root: Path) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with its files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[workload]
    return Cell(name=workload, chips=int(w["chips"]),
                config=_config(spec, w["config"], root), traffic=_traffic(w["traffic"], root),
                end_to_end=[m for m in spec["end_to_end"] if _reports(m, workload)],
                per_layer=[m for m in spec["per_layer"] if _reports(m, workload)],
                root=root)


def _config(spec: dict, name: str, root: Path) -> dict:
    configs = {c["name"]: c for c in spec["configs"]}
    return json.loads((root / configs[name]["file"]).read_text())


def _traffic(name: str, root: Path) -> dict:
    return json.loads((root / "bench" / "traffic" / f"{name}.json").read_text())


def system(name: str):
    """The module that runs configurations of system ``name``."""
    return importlib.import_module(f"benchlib.systems.{name}")


def reader(metric: str, root: Path):
    """The ``read(records)`` function of per-layer metric ``metric``."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
