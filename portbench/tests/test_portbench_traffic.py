"""The one traffic generator: deterministic in the seed, and the cluttered
recipe keeps start and goal clear of every kept point."""

from __future__ import annotations

import pytest
import torch
from conftest import tiny

from yardstick import traffic


def _bank(spec, seed):
    return traffic.pool(dict(spec["traffic"], B=64, pool=2), spec["config"], seed, "cpu", chunk=32)


@pytest.mark.parametrize("cell", ["point_stab.bank_cluttered", "point_stab.bank_open"])
def test_banks_are_deterministic_in_the_seed(cell):
    spec = tiny(cell)
    a, b = _bank(spec, 2**31 + 5), _bank(spec, 2**31 + 5)
    for k in ("x0", "goal", "ox", "oy"):
        assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b))
    other = dict(spec, traffic=dict(spec["traffic"], set_seed=spec["traffic"]["set_seed"] + 1))
    assert not torch.equal(a[0]["goal"], _bank(other, 2**31 + 5)[0]["goal"])


@pytest.mark.parametrize("cell", ["point_stab.bank_cluttered", "point_stab.bank_open"])
def test_start_and_goal_clear_of_every_kept_point(cell):
    spec = tiny(cell)
    clearance = spec["traffic"]["draws"][1]["clearance"]
    for bank in _bank(spec, 123):
        live = (bank["ox"].abs() < 90) | (bank["oy"].abs() < 90)
        for p in (bank["x0"], bank["goal"]):
            d = torch.hypot(bank["ox"] - p[:, :1], bank["oy"] - p[:, 1:2])
            assert bool((d[live] >= clearance).all())


def test_scan_keeps_the_nearest_returns_in_the_window():
    spec = tiny("point_stab.bank_cluttered")
    bank = _bank(spec, 9)[0]
    live = (bank["ox"].abs() < 90) | (bank["oy"].abs() < 90)
    n = traffic.live_prefix(bank["ox"], bank["oy"])
    assert bool((live.sum(1) == n).all()), "live points form a prefix"
    d = torch.hypot(bank["ox"] - bank["x0"][:, :1], bank["oy"] - bank["x0"][:, 1:2])
    d = torch.where(live, d, torch.inf)
    assert bool((d[:, 1:] >= d[:, :-1]).all()), "nearest first"
    w = spec["traffic"]["draws"][1]["window"]
    assert bool(((bank["ox"] - bank["x0"][:, :1]).abs()[live] <= w + 1e-5).all())
    assert float(n.float().mean()) > 40, "a room's walls and boxes fill many slots"


def test_arc_paths_are_deterministic_in_the_seed_and_the_pool_index():
    spec = tiny("tracking.fleet_arc")
    draws = spec["traffic"]["draws"]

    def fleet(seed, index, part=0):
        return traffic.draw(draws, traffic.context(spec["config"], seed, "cpu", index=index, part=part, B=12))

    a, b = fleet(77, 1), fleet(77, 1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert set(a) == {"x0", "wps", "yaw", "speed", "omega", "goal", "ox", "oy"}
    for other in (fleet(77, 2), fleet(77, 1, part=1), fleet(78, 1)):
        assert not torch.equal(a["wps"], other["wps"])
    assert torch.equal(a["goal"][:, :2], a["wps"][:, -1]) and bool((a["ox"] == 1000.0).all())


@pytest.mark.parametrize("cell", ["point_stab.bank_cluttered", "point_stab.bank_open"])
def test_every_seed_deals_the_same_set(cell):
    """A bank mix's ``set_seed`` fixes the batches; the run's seed only
    orders them, so that every run does the same work."""
    spec = tiny(cell)
    assert "set_seed" in spec["traffic"]
    spec["traffic"]["pool"] = 6
    pools = [traffic.pool(dict(spec["traffic"], B=16), spec["config"], s, "cpu") for s in (2**31 + 5, 2**31 + 6)]
    key = lambda b: tuple(b["x0"][:, 0].tolist())  # noqa: E731
    assert sorted(map(key, pools[0])) == sorted(map(key, pools[1]))
    assert list(map(key, pools[0])) != list(map(key, pools[1])), "another order"
    first = {key(b): b for b in pools[0]}
    for b in pools[1]:
        assert all(torch.equal(b[k], first[key(b)][k]) for k in b)
