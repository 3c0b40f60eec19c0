"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<mix>`` runs the configuration ``configs/<config>.json``
under the traffic mix ``traffic/<mix>.json`` and is judged against
``limits/<cell>.json``. The mix names its run loop (``kind``: the class
``Cell`` of ``kinds/<kind>.py``) and its draws (each ``recipe``: the
function ``draw`` of ``recipes/<recipe>.py``); the configuration names its
planner (``formulation.planner``: ``planners/<planner>.py``, which builds the
program's problem and the reference's rows). A per-layer metric ``<name>``
is read by ``metrics/<name>.py``. Nothing here knows a cell, a mix, a
planner or a metric by name.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # portbench/
ROOT = HERE.parent  # the checkout

_MODULES: dict = {}


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as fh:
        return json.load(fh)


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def module(folder: str, name: str):
    """The module ``<folder>/<name>.py`` under ``portbench/``, loaded once."""
    path = HERE / folder / f"{name}.py"
    if path not in _MODULES:
        if not path.exists():
            raise KeyError(f"no {folder} file for {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def kind(name: str):
    """The run loop class of traffic kind ``name``."""
    return module("kinds", name).Cell


def planner(name: str):
    """The planner module of ``formulation.planner`` ``name``."""
    return module("planners", name)


def recipe(name: str):
    """The ``draw(ctx, raw, recipe)`` function of recipe ``name``."""
    return module("recipes", name).draw


def reader(metric_name: str):
    """The ``read(run)`` function of ``metrics/<metric_name>.py``."""
    return module("metrics", metric_name).read


def applies(metric: dict, cell_name: str) -> bool:
    """Whether ``metric`` is reported in the cell: listed there, or, with no
    ``workloads`` key, in every cell (a per-layer reader returns nothing
    where it has nothing to read)."""
    return cell_name in metric.get("workloads", [cell_name])


def resolve(bench: dict, name: str) -> dict:
    """Everything a run of cell ``name`` needs: its entry, configuration,
    traffic mix, limits, and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    return assemble(bench, cells[name])


def assemble(bench: dict, cell: dict, limits: dict = None, traffic: dict = None) -> dict:
    """The spec of a workload entry ``cell``, its limits and traffic mix
    read from their files unless given."""
    name = cell["name"]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(ROOT / configs[cell["config"]]["file"])
    traffic = traffic if traffic is not None else _json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = limits if limits is not None else _json(HERE / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    layers = [m for m in bench["per_layer"] if applies(m, name)]
    return {"cell": cell, "config": config, "traffic": traffic, "limits": limits, "end_to_end": e2e, "per_layer": layers}
