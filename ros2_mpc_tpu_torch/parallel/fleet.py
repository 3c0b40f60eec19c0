"""Fleet closed-loop evaluation: thousands of simulated robots on one card,
or sharded over a device mesh.

Port of :mod:`ros2_mpc_tpu.parallel.fleet`. The whole closed loop of a
Monte-Carlo fleet of (start, goal) scenarios: every control tick one bank
solve of the fleet, the first control of each robot through a plant, and
shift-and-hold warm starts, over ``n_ticks`` ticks.

The JAX package's jitted ``lax.scan`` over ticks becomes a Python loop over
ticks on device tensors, written once per fleet as a generator that yields
after each tick. Each tick is one bank-solve call (with ``engine="cuda"``
one K1 or K2 launch) and a few tensor ops; nothing in the loop reads the
device back (no ``.item()``, no data-dependent shape, no pageable copy), so
the host queues tick after tick while the card works, and the fleet is one
program in the sense that matters on this card. ``chip_smoke.py`` runs every
rollout under ``torch.cuda.set_sync_debug_mode("error")`` to hold it to
that.

The sharded rollouts (``make_sharded_*``, over a
:class:`~ros2_mpc_tpu_torch.parallel.mesh.Mesh`) run one such loop per shard
on its slot's device and interleave them tick by tick (:func:`_lockstep`);
the swarm gathers every shard's positions and velocities each tick
(:func:`~ros2_mpc_tpu_torch.parallel.mesh.gather_rows`).

Under a profiler each tick of a goal or tracking loop is the span
``fleet.tick``, enclosing ``fleet.window`` (the tracking windows and
handoff gains), ``fleet.solve`` (the bank call) and ``fleet.plant`` (latch,
first control, plant, warm shift, cross-track sums); a tick's span closes
before the loop yields, so the spans of interleaved shards never cross. A
tracking rollout is ``fleet.rollout``, its closing statistics
``fleet.summary``.

Engines: ``"cuda"`` (K1 for point stabilization, K2 for tracking, through
:mod:`~ros2_mpc_tpu_torch.solver.cuda_kernel`: the kernel on CUDA tensors,
its plain version on CPU tensors), ``"fast"``
(:func:`~ros2_mpc_tpu_torch.solver.batched.make_bank_solver_fast`),
``"vmap"`` (``torch.func.vmap(problem.solve)``), or a callable
``engine(ocp, settings) -> solve_bank``. Any bank size B >= 1. Each rollout
carries ``rollout.engines``, the bank solve it calls, so a caller can read
its launch counter or set its ``record``.

The rollouts and the scenario builders take ``device`` (``None``: the card,
which raises without one; the CPU only as ``device="cpu"``): a rollout moves
its inputs there once, before the loop.

Obstacles default to far sentinels (open-floor evaluation); pass per-robot
obstacle vectors for cluttered scenes.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import device_constant, indexed_device, resolve_device
from ..models import unicycle
from ..ops.integrators import rk4_step
from ..solver.multistart_bank import bank_engine
from ..solver.warmstart import shift_controls
from ..utils.telemetry import span
from .mesh import Sharded, gather_rows, reduce_parts, shard_bank

_F32 = torch.float32


class FleetResult(NamedTuple):
    final_states: torch.Tensor  # (B, n)
    goal_dist: torch.Tensor  # (B,) final distance to goal (position components)
    reach_fraction: torch.Tensor  # scalar: goal_dist < threshold
    mean_dist: torch.Tensor  # scalar
    trajectories: Optional[torch.Tensor]  # (T+1, B, n) when record=True


# shift-and-hold warm starts of a bank (B, N, m), every row
_shift = torch.func.vmap(shift_controls)


def _first_control(sols) -> torch.Tensor:
    """Each robot's first control; a non-finite one becomes zero (graceful
    degradation, as the JAX package)."""
    u0 = sols.U[:, 0]
    return torch.where(torch.isfinite(u0), u0, 0.0)


def _on(tree: dict, device) -> dict:
    return {k: v.to(device) for k, v in tree.items()}


def _bank_solver(problem, engine, allow_tracking=False):
    """The fleet tick's bank solve ``solve_bank(thetas, U0s) -> Solution``.

    The goal-driven fleet and swarm take point-stabilization banks; the
    tracking fleet passes ``allow_tracking=True`` and routes tracking
    problems to K2."""
    kind = getattr(problem, "kind", "point_stabilization")
    allowed = ("point_stabilization", "legacy") + (("tracking",) if allow_tracking else ())
    if kind not in allowed:
        hint = (
            "use make_tracking_fleet_rollout for tracking problems (per-robot "
            "reference windows advancing along per-robot paths)"
            if kind == "tracking"
            else "model-generic problem families go to make_generic_fleet_rollout"
        )
        raise ValueError(f"this fleet rollout takes {allowed} problems; got {kind!r} — {hint}")
    return bank_engine(engine, problem.ocp, problem.settings, kind=kind)


def _plant(dt):
    """The unicycle fleets' plant: RK4 at the control rate (the solvers'
    Euler/RK4 shooting against the RK4 truth is the model mismatch a live
    node sees)."""

    def plant(x, u):
        return rk4_step(unicycle.f, x, u, dt)

    return plant


def _summary(xs, goals, pd, goal_threshold, traj):
    goal_dist = torch.linalg.vector_norm(xs[:, :pd] - goals[:, :pd], dim=-1)
    return FleetResult(
        final_states=xs,
        goal_dist=goal_dist,
        reach_fraction=(goal_dist < goal_threshold).to(_F32).mean(),
        mean_dist=goal_dist.mean(),
        trajectories=torch.stack(traj) if traj is not None else None,
    )


def _lockstep(loops, exchange=None):
    """Run closed loops tick by tick: ``loops`` are generators, one per
    shard, each yielding once a tick; tick t of every loop runs, then tick
    t+1, so that one host thread keeps every shard's device fed. Coupled
    loops (the swarm) yield a message at the start of each tick and are sent
    back their entry of ``exchange(messages)``. Returns the loops' return
    values."""
    out, replies = [None] * len(loops), [None] * len(loops)
    live = list(range(len(loops)))
    while live:
        msgs = {}
        for i in live:
            try:
                msgs[i] = loops[i].send(replies[i])
            except StopIteration as stop:
                out[i] = stop.value
        live = [i for i in live if i in msgs]
        if exchange is not None and live:
            for i, reply in zip(live, exchange([msgs[i] for i in live])):
                replies[i] = reply
    return out


def _goal_loop(solve_bank, plant, n_ticks, record, thetas, U0s):
    """solve -> actuate -> shift for ``n_ticks``, a generator that yields
    after each tick and returns (final states, trajectory list or None)."""
    xs, warm = thetas["x0"], U0s
    traj = [xs] if record else None
    for _ in range(n_ticks):
        with span("fleet.tick"):
            th = dict(thetas)
            th["x0"] = xs
            with span("fleet.solve"):
                sols = solve_bank(th, warm)
            with span("fleet.plant"):
                xs = plant(xs, _first_control(sols))
                warm = _shift(sols.U)
                if record:
                    traj.append(xs)
        yield
    return xs, traj


def _sharded_summary(mesh, xs, goals, goal_threshold, trajs):
    """The fleet statistics of per-shard final states (goal distance over
    the planar position), reduced across shards as ``bank_metrics``."""
    goal_dist = [torch.linalg.vector_norm(x[:, :2] - g[:, :2], dim=-1) for x, g in zip(xs, goals)]
    n = xs[0].shape[0] * mesh.size
    return FleetResult(
        final_states=Sharded(tuple(xs), mesh),
        goal_dist=Sharded(tuple(goal_dist), mesh),
        reach_fraction=reduce_parts(mesh, [(d < goal_threshold).to(_F32).sum() for d in goal_dist], "sum") / n,
        mean_dist=reduce_parts(mesh, [d.sum() for d in goal_dist], "sum") / n,
        trajectories=Sharded(tuple(torch.stack(t) for t in trajs), mesh, dim=1) if trajs is not None else None,
    )


def make_fleet_rollout(
    problem,
    n_ticks: int,
    dt: float,
    goal_threshold: float = 0.2,
    record: bool = False,
    engine="cuda",
    device=None,
):
    """Build ``rollout(thetas, U0s) -> FleetResult``: the full closed loop of
    a point-stabilization fleet. ``thetas`` is a B-leading bank (the goal
    field drives each robot); the plant is RK4 at the control rate.
    ``engine``: ``"cuda"`` (K1, the default), ``"fast"``, ``"vmap"`` or a
    callable."""
    dev = resolve_device(device)
    solve_bank = _bank_solver(problem, engine)
    plant = _plant(dt)

    def rollout(thetas, U0s):
        thetas, U0s = _on(thetas, dev), U0s.to(dev)
        ((xs, traj),) = _lockstep([_goal_loop(solve_bank, plant, n_ticks, record, thetas, U0s)])
        return _summary(xs, thetas["goal"], 2, goal_threshold, traj)

    rollout.engines = (solve_bank,)
    return rollout


def make_sharded_fleet_rollout(
    problem,
    mesh,
    n_ticks: int,
    dt: float,
    goal_threshold: float = 0.2,
    record: bool = False,
    engine="cuda",
):
    """:func:`make_fleet_rollout` over a device mesh
    (:mod:`~ros2_mpc_tpu_torch.parallel.mesh`): each shard runs the whole
    closed loop on its slot's device, the shards' ticks interleaved (robots
    are independent, so nothing crosses shards inside the loop), and only
    the fleet statistics reduce across the mesh.
    ``rollout(thetas, U0s) -> FleetResult``: the inputs are
    :func:`~.mesh.shard_bank` results over ``mesh`` (or whole banks);
    ``final_states``, ``goal_dist`` and ``trajectories`` are
    :class:`~.mesh.Sharded` (``gather`` them), the two statistics 0-d
    tensors on the first slot's device."""
    solve_bank = _bank_solver(problem, engine)
    plant = _plant(dt)

    def rollout(thetas, U0s):
        th, U = shard_bank(thetas, mesh), shard_bank(U0s, mesh)
        outs = _lockstep([_goal_loop(solve_bank, plant, n_ticks, record, t, u) for t, u in zip(th.shards, U.shards)])
        trajs = [traj for _, traj in outs] if record else None
        return _sharded_summary(mesh, [xs for xs, _ in outs], [t["goal"] for t in th.shards], goal_threshold, trajs)

    rollout.engines = (solve_bank,)
    return rollout


class TrackingFleetResult(NamedTuple):
    final_states: torch.Tensor  # (B, 3)
    goal_dist: torch.Tensor  # (B,) final distance to the path's last waypoint
    reach_fraction: torch.Tensor  # scalar: goal_dist < threshold
    mean_cross_track: torch.Tensor  # scalar: mean over robots and ticks of the
    #   distance to the nearest waypoint (the tracking-quality number)
    max_cross_track: torch.Tensor  # scalar: worst excursion anywhere
    trajectories: Optional[torch.Tensor]  # (T+1, B, 3) when record=True


def _tracking_window(pos, goal, wps, yaw, speed, omega, horizon):
    """Every robot's reference window at once, on the device: the fleet twin
    of :func:`~ros2_mpc_tpu_torch.nodes.reference_gen.tracking_reference_window`
    (path_follower_local_planner.py:26-73), branch-free:

    * anchor at the waypoint nearest the robot;
    * within 0.5 m of the final waypoint the state reference collapses to
      ``horizon`` copies of the goal pose (terminal latch);
    * windows running past the end hold the final sample.

    One corrected-mode deviation, as the JAX package: inside the terminal
    latch the *velocity* reference is zeroed too, so the MPC brakes and
    parks.

    ``pos`` (B, 2), ``goal`` (B, 3), ``wps`` (B, P, 2), ``yaw``/``speed``/
    ``omega`` (B, P). Returns ``(x_ref (B,N,3), u_ref (B,N,2), cross_track
    (B,))``."""
    d2 = ((wps - pos[:, None, :]) ** 2).sum(-1)  # (B, P)
    anchor = torch.argmin(d2, dim=1)  # the first of equal distances, as jnp.argmin
    steps = torch.arange(horizon, device=pos.device)
    rows = torch.clamp(anchor[:, None] + steps, max=wps.shape[1] - 1)  # (B, N)
    near_end = ((pos - wps[:, -1]) ** 2).sum(-1) < 0.25  # the 0.5 m terminal latch
    xy = torch.gather(wps, 1, rows[..., None].expand(-1, -1, 2))
    xr_path = torch.cat([xy, torch.gather(yaw, 1, rows)[..., None]], dim=2)
    x_ref = torch.where(near_end[:, None, None], goal[:, None, :].expand_as(xr_path), xr_path)
    u_path = torch.stack([torch.gather(speed, 1, rows), torch.gather(omega, 1, rows)], dim=2)
    u_ref = torch.where(near_end[:, None, None], 0.0, u_path)
    cross_track = torch.sqrt(torch.gather(d2, 1, anchor[:, None])[:, 0])
    return x_ref, u_ref, cross_track


DEFAULT_HANDOFF_RADIUS = 0.35
DEFAULT_HANDOFF_Q = (5.0, 5.0, 0.05)
DEFAULT_HANDOFF_TERMINAL = (50.0, 50.0, 5.0)
# the reference's hard-coded goal latch (path_follower_local_planner.py:205-219)
LATCH_RADIUS = 0.15
_HANDOFF_Q = device_constant(DEFAULT_HANDOFF_Q)
_HANDOFF_TERMINAL = device_constant(DEFAULT_HANDOFF_TERMINAL)


def make_tracking_fleet_rollout(
    problem,
    n_ticks: int,
    dt: float,
    goal_threshold: float = 0.2,
    record: bool = False,
    engine="cuda",
    device=None,
    handoff_radius: Optional[float] = DEFAULT_HANDOFF_RADIUS,
):
    """The closed-loop *tracking* fleet: the fleet-scale evaluator of the
    reference's flagship loop (scripts/path_follower_local_planner.py:134-223).
    Each robot carries its own path; every tick its reference window is
    regenerated on the device (:func:`_tracking_window`), the tracking bank
    solves (K2 with ``engine="cuda"``), and the first control drives an RK4
    plant.

    ``rollout(thetas, paths, U0s) -> TrackingFleetResult`` where ``paths``
    is a dict of B-leading tensors ``wps (B,P,2)``, ``yaw``, ``speed``,
    ``omega`` (B,P) (see :func:`arc_path_fleet`).

    Per robot and branch-free, as the JAX package:

    * the sticky goal latch: inside :data:`LATCH_RADIUS` a robot stops for
      good;
    * the parking handoff: inside ``handoff_radius`` of the goal the robot's
      ``Q``/``terminal_weight`` become :data:`DEFAULT_HANDOFF_Q`/
      :data:`DEFAULT_HANDOFF_TERMINAL` (point-stabilization gains; K2
      carries both per scenario).
      ``handoff_radius=None`` disables it. The default 0.35 applies to
      parity banks too, as in the JAX package;
    * with the OCP's ``meta`` carrying ``"wrap_yaw"`` (corrected mode) the
      plant's yaw is wrapped every tick, which keeps it inside the fast
      sin/cos range (|x| <= 60) for rollouts of any length; parity fleets
      keep the raw yaw (wrapping would change their cost)."""
    dev = resolve_device(device)
    loop = _tracking_loop_factory(problem, n_ticks, dt, record, engine, handoff_radius, (dev,))

    def rollout(thetas, paths, U0s):
        with span("fleet.rollout"):
            thetas, paths, U0s = _on(thetas, dev), _on(paths, dev), U0s.to(dev)
            ((xs, goals, ct_sum, ct_max, traj),) = _lockstep([loop(thetas, paths, U0s)])
            with span("fleet.summary"):
                goal_dist = torch.linalg.vector_norm(xs[:, :2] - goals[:, :2], dim=-1)
                return TrackingFleetResult(
                    final_states=xs,
                    goal_dist=goal_dist,
                    reach_fraction=(goal_dist < goal_threshold).to(_F32).mean(),
                    mean_cross_track=(ct_sum / n_ticks).mean(),
                    max_cross_track=ct_max.max(),
                    trajectories=torch.stack(traj) if record else None,
                )

    rollout.engines = loop.engines
    return rollout


def _tracking_loop_factory(problem, n_ticks, dt, record, engine, handoff_radius, devices):
    """``loop(thetas, paths, U0s)``: the tracking closed loop of one bank as
    a generator that yields after each tick and returns (final states, path
    end poses, cross-track sum and max per robot, trajectory list or None).
    The handoff gains are put on ``devices`` here, once, so that no tick
    copies from the host."""
    if getattr(problem, "kind", None) != "tracking":
        raise ValueError(
            "make_tracking_fleet_rollout takes a tracking problem "
            "(solver.problems.make_tracking); goal-driven banks go to "
            "make_fleet_rollout"
        )
    solve_bank = _bank_solver(problem, engine, allow_tracking=True)
    N = problem.ocp.horizon
    wrap_state = "wrap_yaw" in getattr(problem.ocp, "meta", ())
    step = _plant(dt)
    two_pi = 2.0 * math.pi
    for d in devices:  # fill the constants' caches outside any tick
        _HANDOFF_Q(d), _HANDOFF_TERMINAL(d)

    def plant(x, u):
        xn = step(x, u)
        if wrap_state:
            yaw = xn[:, 2]
            xn = torch.cat([xn[:, :2], (yaw - two_pi * torch.round(yaw / two_pi))[:, None]], dim=1)
        return xn

    def loop(thetas, paths, U0s):
        dev = U0s.device
        wps, yaw, speed, omega = paths["wps"], paths["yaw"], paths["speed"], paths["omega"]
        goals = torch.cat([wps[:, -1], yaw[:, -1:]], dim=1)  # (B, 3): the path's end pose
        B = goals.shape[0]
        hq, htw = _HANDOFF_Q(dev), _HANDOFF_TERMINAL(dev)
        xs, warm = thetas["x0"], U0s
        latched = torch.zeros(B, dtype=torch.bool, device=dev)
        ct_sum = torch.zeros(B, dtype=_F32, device=dev)
        ct_max = torch.zeros(B, dtype=_F32, device=dev)
        traj = [xs] if record else None
        for _ in range(n_ticks):
            with span("fleet.tick"):
                with span("fleet.window"):
                    x_ref, u_ref, ct = _tracking_window(xs[:, :2], goals, wps, yaw, speed, omega, N)
                    th = dict(thetas)
                    th["x0"], th["x_ref"], th["u_ref"] = xs, x_ref, u_ref
                    to_goal = ((xs[:, :2] - goals[:, :2]) ** 2).sum(-1)
                    if handoff_radius is not None:
                        near = (to_goal < handoff_radius**2)[:, None]
                        th["Q"] = torch.where(near, hq, thetas["Q"])
                        th["terminal_weight"] = torch.where(near, htw, thetas["terminal_weight"])
                with span("fleet.solve"):
                    sols = solve_bank(th, warm)
                with span("fleet.plant"):
                    latched = latched | (to_goal < LATCH_RADIUS**2)
                    u0 = torch.where(latched[:, None], 0.0, _first_control(sols))
                    xs = plant(xs, u0)
                    warm = _shift(sols.U)
                    ct_sum = ct_sum + ct
                    ct_max = torch.maximum(ct_max, ct)
                    if record:
                        traj.append(xs)
            yield
        return xs, goals, ct_sum, ct_max, traj

    loop.engines = (solve_bank,)
    return loop


def make_sharded_tracking_fleet_rollout(
    problem,
    mesh,
    n_ticks: int,
    dt: float,
    goal_threshold: float = 0.2,
    record: bool = False,
    engine="cuda",
    handoff_radius: Optional[float] = DEFAULT_HANDOFF_RADIUS,
):
    """:func:`make_tracking_fleet_rollout` over a device mesh: robots are
    independent (each follows its own path), so each shard runs the whole
    closed loop on its slot's device, the shards' ticks interleaved, and
    only the fleet statistics reduce across the mesh.
    ``rollout(thetas, paths, U0s) -> TrackingFleetResult`` with the inputs
    sharded (or whole banks) and ``final_states``, ``goal_dist`` and
    ``trajectories`` :class:`~.mesh.Sharded`."""
    loop = _tracking_loop_factory(problem, n_ticks, dt, record, engine, handoff_radius, mesh.devices)

    def rollout(thetas, paths, U0s):
        with span("fleet.rollout"):
            th, P, U = shard_bank(thetas, mesh), shard_bank(paths, mesh), shard_bank(U0s, mesh)
            outs = _lockstep([loop(t, p, u) for t, p, u in zip(th.shards, P.shards, U.shards)])
            xs, goals, ct_sum, ct_max, trajs = zip(*outs)
            with span("fleet.summary"):
                goal_dist = [torch.linalg.vector_norm(x[:, :2] - g[:, :2], dim=-1) for x, g in zip(xs, goals)]
                n = xs[0].shape[0] * mesh.size
                return TrackingFleetResult(
                    final_states=Sharded(tuple(xs), mesh),
                    goal_dist=Sharded(tuple(goal_dist), mesh),
                    reach_fraction=reduce_parts(mesh, [(d < goal_threshold).to(_F32).sum() for d in goal_dist], "sum") / n,
                    mean_cross_track=reduce_parts(mesh, [(c / n_ticks).sum() for c in ct_sum], "sum") / n,
                    max_cross_track=reduce_parts(mesh, [c.max() for c in ct_max], "max"),
                    trajectories=Sharded(tuple(torch.stack(t) for t in trajs), mesh, dim=1) if record else None,
                )

    rollout.engines = loop.engines
    return rollout


def _bank_of(problem, device, *columns):
    """``torch.func.vmap(problem.make_theta)`` over numpy columns, the bank
    then moved to ``device``, each leaf contiguous."""
    pdev = problem.default_u0.device
    tens = lambda a: torch.as_tensor(np.asarray(a), dtype=_F32, device=pdev)  # noqa: E731
    thetas = torch.func.vmap(problem.make_theta)(*map(tens, columns))
    return {k: v.to(device).contiguous() for k, v in thetas.items()}


def _zero_warm(problem, B, device):
    return torch.zeros((B,) + tuple(problem.default_u0.shape), dtype=_F32, device=device)


def arc_path_fleet(
    problem,
    B: int,
    n_waypoints: int = 64,
    seed: int = 0,
    start_jitter: float = 0.05,
    device=None,
):
    """A (theta bank, path bank, warm start) for the tracking fleet: B
    constant-curvature arc paths with the reference's motion-profile
    contract (``nodes/reference_gen.py::path_motion_profile``: speed is
    segment length / dt *doubled*, turn rate the yaw difference *halved*).
    Waypoint spacing keeps the doubled profile speed inside the velocity
    bounds; robots start near (not on) their path with heading error. The
    draws are the JAX package's, call for call, so one seed gives both
    packages one fleet."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    dt = float(problem.ocp.transition(torch.zeros(3), torch.tensor([0.0, 1.0]))[2])
    v_hi = float(problem.ocp.u_hi[0])
    P = n_waypoints
    # nominal path speed: the doubled parity profile must stay within bounds
    v_nom = rng.uniform(0.3 * v_hi, 0.5 * v_hi, size=(B, 1))
    ds = v_nom * dt  # -> profile speed = 2 * v_nom in [0.6, 1.0] * v_hi
    kappa = rng.uniform(-0.6, 0.6, size=(B, 1))  # 1/m curvature
    yaw0 = rng.uniform(-np.pi, np.pi, size=(B, 1))
    s = np.arange(P)[None, :] * ds  # (B, P) arclength
    heading = yaw0 + kappa * s
    wx = np.cumsum(np.cos(heading) * ds, axis=1) - np.cos(heading[:, :1]) * ds
    wy = np.cumsum(np.sin(heading) * ds, axis=1) - np.sin(heading[:, :1]) * ds
    start = rng.uniform(-1.0, 1.0, size=(B, 2))
    wps = np.stack([wx + start[:, :1], wy + start[:, 1:]], axis=2)  # (B, P, 2)

    # the parity motion profile, vectorized path_motion_profile
    steps = np.diff(wps, axis=1)
    yaw = np.arctan2(steps[..., 1], steps[..., 0])
    yaw = np.concatenate([yaw, yaw[:, -1:]], axis=1)  # (B, P)
    omega = np.diff(yaw, axis=1) / 2.0
    omega = np.concatenate([omega, omega[:, -1:]], axis=1)  # clamped tail
    speed = np.hypot(steps[..., 0], steps[..., 1]) / dt * 2.0
    speed = np.concatenate([speed, speed[:, -1:]], axis=1)

    x0 = np.concatenate(
        [
            wps[:, 0] + rng.uniform(-start_jitter, start_jitter, size=(B, 2)),
            yaw[:, :1] + rng.uniform(-0.4, 0.4, size=(B, 1)),
        ],
        axis=1,
    )
    N = problem.ocp.horizon
    thetas = _bank_of(problem, dev, x0, np.zeros((B, N, 3)), np.zeros((B, N, 2)))
    tens = lambda a: torch.as_tensor(a, dtype=_F32, device=dev)  # noqa: E731
    paths = {"wps": tens(wps), "yaw": tens(yaw), "speed": tens(speed), "omega": tens(omega)}
    return thetas, paths, _zero_warm(problem, B, dev)


def make_generic_fleet_rollout(
    problem,
    n_ticks: int,
    goal_threshold: float = 0.2,
    record: bool = False,
    engine="fast",
    device=None,
):
    """The closed-loop fleet for ANY model family: solve -> actuate -> shift,
    with the OCP's own ``transition`` as the plant (an exact-model closed
    loop; the unicycle fleets above keep the reference's RK4-plant / solver
    mismatch). The 12-state quadrotor fleet runs through the same code as a
    bicycle fleet.

    ``thetas`` carries ``x0`` and a ``goal`` whose leading components are a
    position (2 planar / 3 spatial, from the goal width: 4 or more is
    spatial). ``engine``: ``"fast"`` (the
    generic bank engine, the default), ``"vmap"`` or a callable. Returns
    :class:`FleetResult` with ``goal_dist`` over the position components.
    Plain PyTorch: no kernel of the port hard-codes these models."""
    if getattr(problem, "kind", "") == "tracking":
        raise ValueError("tracking problems go to make_tracking_fleet_rollout")
    if engine == "cuda":
        raise ValueError("the generic fleet takes engine='fast'|'vmap' or a callable: K1/K2 hard-code the unicycle")
    dev = resolve_device(device)
    solve_bank = bank_engine(engine, problem.ocp, problem.settings)
    plant = torch.func.vmap(problem.ocp.transition)

    def rollout(thetas, U0s):
        thetas, U0s = _on(thetas, dev), U0s.to(dev)
        pd = 3 if thetas["goal"].shape[-1] >= 4 else 2
        ((xs, traj),) = _lockstep([_goal_loop(solve_bank, plant, n_ticks, record, thetas, U0s)])
        return _summary(xs, thetas["goal"], pd, goal_threshold, traj)

    rollout.engines = (solve_bank,)
    return rollout


class SwarmResult(NamedTuple):
    final_states: torch.Tensor  # (B, 3)
    goal_dist: torch.Tensor  # (B,)
    reach_fraction: torch.Tensor  # scalar
    mean_dist: torch.Tensor  # scalar
    min_separation: torch.Tensor  # scalar: closest any two robots ever got
    trajectories: Optional[torch.Tensor]  # (T+1, B, 3) when record=True


DEFAULT_PREDICT_TAUS = (0.0, 0.8)
DEFAULT_AVOIDANCE_RADIUS = 0.3
DEFAULT_AVOIDANCE_WEIGHT = 1.0


def _swarm_obstacle_theta(thetas, xs, nbr_pos, nbr_vel, taus):
    """The tick's theta: each of the k nearest neighbors enters the live
    obstacle prefix as a short constant-velocity *sweep*, its position
    extrapolated to the ``taus`` offsets. Static-point avoidance alone fails
    head-on (both robots dodge the other's stale position and meet anyway);
    the sweep makes the oncoming robot's near future visible to the solver.
    Caller-provided static obstacles survive in the remaining slots; the
    bank's inflation_radius/obstacle_weight become
    :data:`DEFAULT_AVOIDANCE_RADIUS`/:data:`DEFAULT_AVOIDANCE_WEIGHT`."""
    pred = nbr_pos[:, :, None, :] + nbr_vel[:, :, None, :] * taus[None, None, :, None]
    obs = pred.reshape(pred.shape[0], -1, 2)  # (B, k * n_taus, 2)
    n_used = obs.shape[1]
    th = dict(thetas)
    th["x0"] = xs
    th["obs_x"] = torch.cat([obs[..., 0], thetas["obs_x"][:, n_used:]], dim=1)
    th["obs_y"] = torch.cat([obs[..., 1], thetas["obs_y"][:, n_used:]], dim=1)
    th["inflation_radius"] = torch.full(xs.shape[:1], DEFAULT_AVOIDANCE_RADIUS, dtype=_F32, device=xs.device)
    th["obstacle_weight"] = torch.full(xs.shape[:1], DEFAULT_AVOIDANCE_WEIGHT, dtype=_F32, device=xs.device)
    return th


def make_swarm_rollout(
    problem,
    n_ticks: int,
    dt: float,
    k_neighbors: int = 4,
    predict_taus=DEFAULT_PREDICT_TAUS,
    goal_threshold: float = 0.2,
    record: bool = False,
    engine="cuda",
    device=None,
):
    """The closed-loop multi-robot swarm: every tick each robot's k nearest
    neighbors enter its live obstacle slots as constant-velocity sweeps, so
    the fleet avoids itself through the soft obstacle cost alone. The B x B
    neighbor search is one distance matrix (``1e9`` on the diagonal) and one
    ``torch.topk`` a tick, on the device. ``torch.topk`` and ``lax.top_k``
    may order tied distances differently, and the neighbor order sets the
    obstacle-slot order: jittered starts (as both builders below draw)
    have no ties.

    ``problem`` must be a corrected-mode point stabilization (the parity
    formulation's dead obstacle cost avoids nothing, quirk #1).
    Perfectly symmetric fleets deadlock at the saddle: jitter the starts.

    Heading is integrated unwrapped (point-stabilization costs are not
    2pi-periodic in the state yaw): with K1's fast sin/cos (valid for
    |x| <= 60 rad) that bounds a rollout to ~1500 ticks at the reference's
    0.2 rad/s turn-rate cap."""
    dev = resolve_device(device)
    loop = _swarm_loop_factory(problem, n_ticks, dt, k_neighbors, predict_taus, record, engine, (dev,))

    def rollout(thetas, U0s):
        thetas, U0s = _on(thetas, dev), U0s.to(dev)
        _check_swarm(thetas, k_neighbors, predict_taus)
        # one shard: the gathered table of positions and velocities is its own
        ((xs, sep, traj),) = _lockstep([loop(thetas, U0s, 0, U0s.shape[0])], exchange=lambda msgs: msgs)
        goal_dist = torch.linalg.vector_norm(xs[:, :2] - thetas["goal"][:, :2], dim=-1)
        return SwarmResult(
            final_states=xs,
            goal_dist=goal_dist,
            reach_fraction=(goal_dist < goal_threshold).to(_F32).mean(),
            mean_dist=goal_dist.mean(),
            min_separation=sep.amin(),
            trajectories=torch.stack(traj) if record else None,
        )

    rollout.engines = loop.engines
    return rollout


def _check_swarm(thetas, k_neighbors, predict_taus, B=None):
    B = thetas["x0"].shape[0] if B is None else B
    if k_neighbors >= B:
        raise ValueError(f"k_neighbors={k_neighbors} must be < fleet size {B}")
    if k_neighbors * len(predict_taus) > thetas["obs_x"].shape[1]:
        raise ValueError("k_neighbors * len(predict_taus) exceeds the obstacle slots")


def _swarm_loop_factory(problem, n_ticks, dt, k_neighbors, predict_taus, record, engine, devices):
    """``loop(thetas, U0s, offset, B_total)``: the swarm closed loop of one
    shard (global robots ``offset .. offset + b - 1`` of ``B_total``) as a
    generator. At the start of each tick it yields its robots' (b, 4)
    positions and velocities and is sent back the fleet's (B_total, 4)
    table; it searches its robots' neighbors in that table, excluding
    itself by global index, solves, actuates and shifts; it returns (final
    states, closest distance each robot ever saw, trajectory list or
    None). The prediction offsets are put on ``devices`` here, once."""
    if k_neighbors < 1:
        raise ValueError("k_neighbors must be >= 1")
    if len(predict_taus) < 1:
        raise ValueError("predict_taus must name at least one horizon offset")
    solve_bank = _bank_solver(problem, engine)
    plant = _plant(dt)
    taus = {indexed_device(d): torch.tensor(predict_taus, dtype=_F32, device=d) for d in devices}

    def loop(thetas, U0s, offset, B_total):
        x0s = thetas["x0"]
        dev, b = x0s.device, x0s.shape[0]
        col = torch.arange(B_total, device=dev)
        row = torch.arange(b, device=dev) + offset
        self_mask = torch.where(col[None, :] == row[:, None], 1e9, 0.0)
        xs, prev_pos, warm = x0s, x0s[:, :2], U0s
        sep = torch.full((b,), math.inf, dtype=_F32, device=dev)
        traj = [xs] if record else None
        for _ in range(n_ticks):
            pos = xs[:, :2]
            vel = (pos - prev_pos) / dt
            table = yield torch.cat([pos, vel], dim=1)
            all_pos, all_vel = table[:, :2], table[:, 2:]
            diff = pos[:, None, :] - all_pos[None, :, :]
            d2 = (diff * diff).sum(-1) + self_mask
            _, idx = torch.topk(-d2, k_neighbors, dim=1)
            th = _swarm_obstacle_theta(thetas, xs, all_pos[idx], all_vel[idx], taus[dev])
            sols = solve_bank(th, warm)
            xs = plant(xs, _first_control(sols))
            warm = _shift(sols.U)
            sep = torch.minimum(sep, torch.sqrt(d2.amin(dim=1)))
            prev_pos = pos
            if record:
                traj.append(xs)
        return xs, sep, traj

    loop.engines = (solve_bank,)
    return loop


def make_sharded_swarm_rollout(
    problem,
    mesh,
    n_ticks: int,
    dt: float,
    k_neighbors: int = 4,
    predict_taus=DEFAULT_PREDICT_TAUS,
    goal_threshold: float = 0.2,
    record: bool = False,
    engine="cuda",
):
    """:func:`make_swarm_rollout` over a 1D device mesh. The swarm couples
    robots: every tick each shard's positions and velocities are gathered
    onto every slot's device (a non-blocking copy per shard in one process,
    ``all_gather_into_tensor`` across ranks: :func:`~.mesh.gather_rows`),
    and each shard searches its robots' neighbors against the global table,
    excluding each robot itself by its global index. Solve, plant and warm
    start stay on the shard; the shards' ticks are interleaved.
    ``rollout(thetas, U0s) -> SwarmResult`` with ``final_states``,
    ``goal_dist`` and ``trajectories`` :class:`~.mesh.Sharded`; the
    statistics reduce across the mesh."""
    if len(mesh.axis_names) != 1:
        raise ValueError("swarm sharding expects a 1D mesh (one robot axis)")
    loop = _swarm_loop_factory(problem, n_ticks, dt, k_neighbors, predict_taus, record, engine, mesh.devices)

    def rollout(thetas, U0s):
        th, U = shard_bank(thetas, mesh), shard_bank(U0s, mesh)
        b = U.shards[0].shape[0]
        _check_swarm(th.shards[0], k_neighbors, predict_taus, B=b * mesh.size)
        loops = [loop(t, u, (mesh.first_shard + i) * b, b * mesh.size) for i, (t, u) in enumerate(zip(th.shards, U.shards))]
        outs = _lockstep(loops, exchange=lambda msgs: gather_rows(mesh, msgs))
        xs, sep, trajs = zip(*outs)
        res = _sharded_summary(mesh, list(xs), [t["goal"] for t in th.shards], goal_threshold, trajs if record else None)
        return SwarmResult(*res[:4], min_separation=reduce_parts(mesh, [s.amin() for s in sep], "min"), trajectories=res[4])

    rollout.engines = loop.engines
    return rollout


def circle_swarm(problem, B: int, radius: float = 2.0, jitter: float = 0.06, seed: int = 0, device=None):
    """The antipodal swap: B robots on a circle, each goal diametrically
    opposite, so every straight-line plan collides at the center. ``jitter``
    perturbs the starts (a bit-perfect mirror fleet sits on the avoidance
    saddle and deadlocks)."""
    dev = resolve_device(device)
    ang = 2 * np.pi * np.arange(B) / B
    x0 = np.stack([radius * np.cos(ang), radius * np.sin(ang), ang + np.pi], axis=1)
    if jitter > 0:
        rng = np.random.default_rng(seed)
        x0[:, :2] += rng.uniform(-jitter, jitter, size=(B, 2))
        x0[:, 2] += rng.uniform(-3 * jitter, 3 * jitter, size=B)
    goal = np.stack([radius * np.cos(ang + np.pi), radius * np.sin(ang + np.pi), ang + np.pi], axis=1)
    return _bank_of(problem, dev, x0, goal), _zero_warm(problem, B, dev)


def grid_swap_swarm(problem, side: int = 32, pitch: float = 2.0, seed: int = 0, device=None):
    """The warehouse reshuffle: side x side robots on a grid, each trading
    places with its horizontal partner, side^2/2 simultaneous head-on
    exchanges in one crowd (B = side^2)."""
    if side % 2:
        raise ValueError("side must be even (disjoint horizontal pairs)")
    dev = resolve_device(device)
    B = side * side
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    cells = np.stack([gx.ravel(), gy.ravel()], axis=1).astype(float) * pitch
    starts = cells + rng.uniform(-0.15, 0.15, cells.shape)
    partner = np.arange(B).reshape(side, side // 2, 2)[..., ::-1].reshape(B)
    x0 = np.c_[starts, rng.uniform(-np.pi, np.pi, (B, 1))]
    goal = np.c_[starts[partner], rng.uniform(0, 2 * np.pi, (B, 1))]
    return _bank_of(problem, dev, x0, goal), _zero_warm(problem, B, dev)


def random_fleet(problem, B: int, seed: int = 0, spread: float = 1.2, device=None):
    """A (start, goal) scenario bank on open floor."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x0 = np.concatenate(
        [rng.uniform(-0.3, 0.3, size=(B, 2)), rng.uniform(-np.pi, np.pi, size=(B, 1))], axis=1
    )
    goal = np.concatenate(
        [rng.uniform(-spread, spread, size=(B, 2)), rng.uniform(0, 2 * np.pi, size=(B, 1))], axis=1
    )
    return _bank_of(problem, dev, x0, goal), _zero_warm(problem, B, dev)
