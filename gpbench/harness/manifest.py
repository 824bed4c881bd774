"""BENCHMARK.json and the files it names, found by name.

A cell's configuration is `configs[].file`; everything else is found from
the names alone, so that a later change adds a configuration, a traffic
mix, a cell or a per-layer metric by adding files and entries:
    gpbench/traffic/<traffic>.json    the mix's parameters (traffic.py)
    gpbench/systems/<system>.py       how a configuration's `system` is
                                      built, counted and checked
    gpbench/counts/<config>.py        the configuration's frozen bound
    gpbench/cells/<cell>.json         the cell's check: how many cycles
                                      are compared, and the limits
    gpbench/metrics/<metric>.py       a per-layer metric's reader
A metric named `<base>.<qualifier>` is its base quantity in the cells it
lists: an end-to-end one is measured as <base>, a per-layer one is read by
<base>'s reader unless it has a file of its own.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_module(path: str):
    """Import the Python file at path under a name of its own."""
    name = "gpbench_file_" + os.path.relpath(path, HERE).replace(
        os.sep, "_").replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def path(*parts) -> str:
    return os.path.join(HERE, *parts)


@dataclass
class Cell:
    """One workload of BENCHMARK.json with what its names lead to."""
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    check: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def reported(metrics: list, cell: str) -> list:
    """The metrics of the list that the cell reports."""
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load(cell_name: str, root: str = ROOT) -> Cell:
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json")
    w = cells[cell_name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=cell_name, chips=int(w["chips"]), config_name=w["config"],
        config=read_json(os.path.join(root, cfg["file"])),
        traffic_name=w["traffic"],
        traffic=read_json(path("traffic", w["traffic"] + ".json")),
        check=read_json(path("cells", cell_name + ".json")),
        end_to_end=reported(bench["end_to_end"], cell_name),
        per_layer=reported(bench["per_layer"], cell_name))


def system(config: dict):
    return load_module(path("systems", config["system"] + ".py"))


def counts(config_name: str):
    return load_module(path("counts", config_name + ".py"))


def reader(metric: str):
    """metrics/<metric>.py; a qualified name (`<metric>.<qualifier>`, the
    same quantity in other cells, reported against another end-to-end
    metric) falls back to its base's reader."""
    name = metric
    while not os.path.isfile(path("metrics", name + ".py")) and "." in name:
        name = name.rsplit(".", 1)[0]
    return load_module(path("metrics", name + ".py"))
