"""BENCHMARK.json against the contract's shape, and every name it holds
resolved to its file."""

from __future__ import annotations

import re

import pytest
from conftest import BENCH, CELLS, HERE, ROOT

from yardstick import spec as specs

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"] and BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("group", sorted(ENTRY_KEYS))
def test_entries_names_and_units(group):
    for e in BENCH[group]:
        extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
        assert ENTRY_KEYS[group] <= set(e) <= ENTRY_KEYS[group] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))


def test_end_to_end_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for cell in CELLS:
        reported = [m for m in BENCH["end_to_end"] if specs.applies(m, cell)]
        assert len(reported) >= 2 and any(m["name"] == "setup_s" for m in reported)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    spec = specs.resolve(BENCH, cell)
    w = spec["cell"]
    assert w["name"] == f"{w['config']}.{w['traffic']}" and w["chips"] == 1
    assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
    assert (HERE / "limits" / f"{cell}.json").exists()
    assert (HERE / "kinds" / f"{spec['traffic']['kind']}.py").exists() and specs.kind(spec["traffic"]["kind"])
    for d in spec["traffic"]["draws"]:
        assert (HERE / "recipes" / f"{d['recipe']}.py").exists() and callable(specs.recipe(d["recipe"]))
    planner = specs.planner(spec["config"]["formulation"]["planner"])
    assert all(callable(getattr(planner, f)) for f in ("make_problem", "thetas", "rows", "work"))
    config = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert config["file"].startswith("portbench/") and spec["config"]["name"] == config["name"]
    assert spec["config"]["reduced"] == config["reduced"] == []
    assert spec["per_layer"], "every cell reports a per-layer metric"
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e, (cell, m["name"])
        assert callable(specs.reader(m["name"]))
    assert set(spec["limits"]["limits"]), "every cell compares its outputs"


def test_every_metric_has_a_reader_and_a_cell():
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_a_name_with_no_file_is_refused():
    with pytest.raises(KeyError, match="missing"):
        specs.kind("no_such_kind")
    with pytest.raises(KeyError, match="missing"):
        specs.recipe("no_such_recipe")


def test_a_kind_refuses_a_planner_it_does_not_run():
    """The fleet loop runs the tracking fleet alone: a point-stabilization
    configuration under it is refused, not run as another planner."""
    import torch

    w = {"name": "point_stab.fleet_arc", "config": "point_stab", "traffic": "fleet_arc", "chips": 1}
    spec = specs.assemble(BENCH, w, {"limits": {}})
    with pytest.raises(ValueError, match="tracking"):
        specs.kind("fleet")(spec, 1, torch.device("cpu"))
