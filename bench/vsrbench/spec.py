"""Where the benchmark's pieces live, found by the names in BENCHMARK.json.

A cell names a configuration and a traffic mix; each resolves to a file of
its own: ``configs/<config>.json``, ``mixes/<traffic>.json``,
``policies/<config>.vsr`` and ``limits/<cell>.json``.  A metric resolves to
``metrics/<metric>.py``.  A later change adds a cell, a mix or a metric by
adding files and entries, never by editing one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC_FILE = ROOT / "BENCHMARK.json"


def load_spec(path: Path = SPEC_FILE) -> dict:
    with open(path) as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    config: dict
    mix: dict
    policy: str
    limits: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(cell_name: str, spec: dict = None) -> Cell:
    """The cell ``cell_name`` with its files read and its metrics listed
    (those whose ``workloads`` name it, or that name none)."""
    spec = spec if spec is not None else load_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json; "
                       f"cells: {', '.join(sorted(cells))}")
    w = cells[cell_name]
    configs = {c["name"]: c for c in spec["configs"]}
    c = configs[w["config"]]
    return Cell(
        name=cell_name, config_name=w["config"], traffic=w["traffic"],
        chips=int(w["chips"]),
        config=load_json(ROOT / c["file"]),
        mix=load_json(BENCH / "mixes" / f"{w['traffic']}.json"),
        policy=(BENCH / "policies" / f"{w['config']}.vsr").read_text(),
        limits=load_json(BENCH / "limits" / f"{cell_name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, cell_name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, cell_name)])


def metric_file(name: str) -> Path:
    return BENCH / "metrics" / f"{name}.py"


def load_module(path: Path, name: str):
    """A module from a file path (metric readers carry dots in their names,
    so they are loaded by path, not imported by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_READERS: Dict[str, object] = {}


def reader(name: str):
    """The ``read(run)`` function of metric ``name``."""
    if name not in _READERS:
        mod = load_module(metric_file(name),
                          "vsrbench_metric_" + name.replace(".", "_"))
        _READERS[name] = mod.read
    return _READERS[name]


def family(config: dict):
    """The plain reference module of a configuration's family
    (``reference/<family>.py``)."""
    return importlib.import_module(f"reference.{config['family']}")


def flops_model(config: dict):
    """The model-FLOP arithmetic of a configuration's family
    (``roofline/<family>.py``)."""
    return importlib.import_module(f"roofline.{config['family']}")
