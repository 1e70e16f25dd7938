"""Find a cell, its configuration, its traffic mix and its metrics' readers by name.

``BENCHMARK.json`` at the repository root names each cell's configuration and traffic;
``configs/<config>.json``, ``traffic/<traffic>.json`` and ``metrics/<metric>.py`` hold
them.  Adding one is adding a file and an entry.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def applies(metric: dict, cell: str) -> bool:
    """A metric without ``workloads`` is reported in every cell."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict = None) -> Dict:
    """The cell ``name``: its entry, configuration, traffic and the metrics it reports
    (``end_to_end`` without a trace, ``per_layer`` with one)."""
    bench = bench if bench is not None else benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise SystemExit(f"unknown workload {name!r}; known: {known}")
    return assemble(name, entry["config"], entry["traffic"], int(entry["chips"]), bench)


def assemble(name: str, config_name: str, traffic_name: str, chips: int, bench: dict) -> Dict:
    """A cell from its configuration's and traffic's files, whether or not
    ``BENCHMARK.json`` lists it yet."""
    return {
        "name": name,
        "chips": chips,
        "config": config(config_name),
        "traffic": traffic(traffic_name),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if applies(m, name)],
    }


def reader(metric: str):
    """The module ``metrics/<metric>.py``: ``UNIT`` and ``read(ctx)``."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_name = "perfbench_metric_" + "".join(c if c.isalnum() else "_" for c in metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_names(bench: dict) -> List[str]:
    return [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
