"""The port's spans (``utils/telemetry.py::span``) on the CPU: under
``torch.profiler`` the bank call, the fleet ticks and rollouts and the packed
tick mark their work with nested spans; without a profiler ``span`` is one
shared null context and never reaches ``record_function``; and a profiler
changes no output bit."""

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ros2_mpc_tpu_torch import solver as ts
from ros2_mpc_tpu_torch.config import Params
from ros2_mpc_tpu_torch.parallel import fleet as tf
from ros2_mpc_tpu_torch.parallel import mesh as tmesh
from ros2_mpc_tpu_torch.solver import cuda_kernel as ck
from ros2_mpc_tpu_torch.solver import packed
from ros2_mpc_tpu_torch.utils import telemetry

PARAMS = Params()
N, B, TICKS = 6, 4, 3
FAST = dict(barrier_stages=2, iters_per_stage=2, n_alphas=4)
PREFIXES = ("bank.", "fleet.", "tick.")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _point():
    return ts.make_point_stabilization(
        PARAMS, horizon=N, reference_parity=False, settings=ts.SolverSettings(**FAST), device="cpu"
    )


def _tracking():
    return ts.make_tracking(
        PARAMS, horizon=N, reference_parity=False, settings=ts.SolverSettings(**FAST), device="cpu"
    )


def _bank():
    p = _point()
    th, U0 = tf.random_fleet(p, B, seed=1, device="cpu")
    return lambda: ck.make_cuda_point_stab_solver(p.ocp, p.settings)(th, U0)


def _goal_fleet():
    p = _point()
    th, U0 = tf.random_fleet(p, B, seed=2, device="cpu")
    return lambda: tf.make_fleet_rollout(p, TICKS, PARAMS.dt, device="cpu")(th, U0)


def _tracking_fleet():
    p = _tracking()
    th, paths, U0 = tf.arc_path_fleet(p, B, n_waypoints=16, seed=3, device="cpu")
    return lambda: tf.make_tracking_fleet_rollout(p, TICKS, PARAMS.dt, device="cpu")(th, paths, U0)


def _sharded_tracking_fleet():
    p = _tracking()
    th, paths, U0 = tf.arc_path_fleet(p, B, n_waypoints=16, seed=4, device="cpu")
    mesh = tmesh.make_mesh(2, device="cpu")
    roll = tf.make_sharded_tracking_fleet_rollout(p, mesh, TICKS, PARAMS.dt)
    return lambda: roll(th, paths, U0)


def _packed_point():
    p = _point()
    solve_packed, pack = packed.make_packed_point_stab(
        p, PARAMS, solve_fn=ck.single_scenario(ck.make_cuda_point_stab_solver(p.ocp, p.settings))
    )
    rng = np.random.default_rng(5)
    n = PARAMS.n_obstacle_points
    obs = np.full(n, 100.0, np.float32)
    obs[:3] = rng.uniform(-0.5, 0.5, 3)

    def tick():
        sol, warm = solve_packed(pack([0.0, 0.0, 0.3], [0.8, -0.4, 1.0], obs, obs[::-1].copy()), torch.zeros(N, 2))
        return packed.read_tick(sol), sol, warm

    return tick


def _packed_tracking():
    p = _tracking()
    solve_packed, pack = packed.make_packed_tracking(
        p, PARAMS, solve_fn=ck.single_scenario(ck.make_cuda_tracking_solver(p.ocp, p.settings))
    )
    n = PARAMS.n_obstacle_points
    s = np.linspace(0.0, 0.5, N, dtype=np.float32)
    x_ref = np.stack([s, 0.2 * s, np.zeros(N, np.float32)], 1)
    u_ref = np.tile(np.float32([0.1, 0.0]), (N, 1))

    def tick():
        vec = pack([0.02, -0.03, 0.1], x_ref, u_ref, np.full(n, 100.0), np.full(n, 100.0))
        sol, warm = solve_packed(vec, torch.zeros(N, 2))
        return packed.read_tick(sol), sol, warm

    return tick


BANK = ("bank.call", [("bank.pack", []), ("bank.plain", []), ("bank.finish", [])])
TRACK_TICK = ("fleet.tick", [("fleet.window", []), ("fleet.solve", [BANK]), ("fleet.plant", [])])
CASES = {
    "bank": (_bank, [BANK]),
    "goal_fleet": (_goal_fleet, [("fleet.tick", [("fleet.solve", [BANK]), ("fleet.plant", [])])] * TICKS),
    "tracking_fleet": (_tracking_fleet, [("fleet.rollout", [TRACK_TICK] * TICKS + [("fleet.summary", [])])]),
    "sharded_tracking_fleet": (
        _sharded_tracking_fleet,
        [("fleet.rollout", [TRACK_TICK] * (2 * TICKS) + [("fleet.summary", [])])],
    ),
    "packed_point": (_packed_point, [("tick.pack", []), ("tick.solve", [BANK]), ("tick.read", [])]),
    "packed_tracking": (_packed_tracking, [("tick.pack", []), ("tick.solve", [BANK]), ("tick.read", [])]),
}


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [
        (e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.name.startswith(PREFIXES)
    ]
    return out, spans


def _tree(spans):
    """The spans as (name, children) by containment, each list in start
    order; raises where two spans cross."""
    for i, (na, a0, a1) in enumerate(spans):
        for nb, b0, b1 in spans[i + 1 :]:
            inside = (a0 <= b0 and b1 <= a1) or (b0 <= a0 and a1 <= b1)
            assert inside or a1 <= b0 or b1 <= a0, f"{na} [{a0}, {a1}] crosses {nb} [{b0}, {b1}]"
    root = ("", [])
    stack = [(root, float("inf"))]
    for name, t0, t1 in sorted(spans, key=lambda s: (s[1], -s[2])):
        while t0 >= stack[-1][1]:
            stack.pop()
        node = (name, [])
        stack[-1][0][1].append(node)
        stack.append((node, t1))
    return root[1]


def _leaves(x):
    """Every tensor and number of an output, in order."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, tmesh.Sharded):
        return _leaves(x.shards)
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [torch.as_tensor(np.asarray(x))] if x is not None else []


@functools.cache
def _runs(case):
    """The case's outputs with no profiler, and its outputs and spans under
    one."""
    fn = CASES[case][0]()
    plain = fn()
    return plain, *_profiled(fn)


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_nest(case):
    assert _tree(_runs(case)[2]) == CASES[case][1]


@pytest.mark.parametrize("case", sorted(CASES))
def test_outputs_bit_equal_under_profiler(case):
    plain, traced = (_leaves(out) for out in _runs(case)[:2])
    assert len(plain) == len(traced) > 0
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_span_off_is_one_null_context(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) called with no profiler running")

    monkeypatch.setattr(telemetry, "record_function", refused)
    assert not torch.autograd._profiler_enabled()
    first = telemetry.span("bank.call")
    assert first is telemetry.span("fleet.tick") is telemetry.span("tick.read")
    with first:
        pass
    _bank()()  # a whole call with its spans, and no profiler
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="record_function"):
            telemetry.span("bank.call")
