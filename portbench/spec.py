"""What a run measures, found by name: the cell of ``BENCHMARK.json``, its
configuration file, its traffic mix (``traffic/<name>.json``) and the
reader of each metric (``metrics/<name>.py``). Adding a configuration, a
mix or a metric adds files and entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict            # the configuration file's contents
    config_name: str
    traffic_name: str
    mix: Dict               # the traffic mix's parameters
    end_to_end: List[Dict]  # the metrics of BENCHMARK.json this cell reports
    per_layer: List[Dict]


def _applies(metric: Dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with everything it
    names read in. Raises KeyError for an unknown cell."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    base = os.path.join(root, bench["paths"][0])
    with open(os.path.join(base, "traffic", w["traffic"] + ".json")) as f:
        mix = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), config=config, config_name=w["config"],
                traffic_name=w["traffic"], mix=mix,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str, base: str = HERE) -> ModuleType:
    """The module ``metrics/<metric>.py`` (a name may hold dots), which
    has ``read(run) -> float | None``."""
    path = os.path.join(base, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}",
                                                  path)
    if spec is None or not os.path.isfile(path):
        raise FileNotFoundError(f"metric {metric!r} has no reader at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(mix: Dict) -> ModuleType:
    """The driver module a traffic mix names (``drivers/<driver>.py``)."""
    return importlib.import_module(f"portbench.drivers.{mix['driver']}")
