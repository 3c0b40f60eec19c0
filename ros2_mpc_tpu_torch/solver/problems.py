"""The three reference MPC formulations as configurations of one solver.

Port of :mod:`ros2_mpc_tpu.solver.problems`: live point stabilization, live
trajectory tracking and the legacy point stabilization, each an
:class:`~ros2_mpc_tpu_torch.solver.ilqr.OCP` template plus a theta builder
that returns a dict of float32 tensors on the problem's ``device``: the card
unless the caller passes another (``device=None`` is ``torch.device("cuda")``
and raises without one; the CPU only as ``device="cpu"``).

The reference's behavioural quirks are reproduced under
``reference_parity=True`` (the default) and corrected otherwise, exactly as
in the JAX package (its module docstring lists them):

1. the live planners' obstacle cost is inert (``obstacle_weight`` 0.0);
2. the ``cost_factor``/``reverse_factor`` swap at the point-stabilization
   call sites;
3. Euler for tracking, RK4 for point stabilization;
4. tracking stage ``k`` compares ``x_k`` against ``x_ref[k]``;
5. no terminal state cost (the legacy obstacle sum alone covers k = 0..N).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import Params
from ..device import resolve_device
from ..models import unicycle
from ..ops import costs
from ..ops.integrators import make_step
from .ilqr import OCP, SolverSettings, make_solver

_F32 = torch.float32


class Problem(NamedTuple):
    """A ready problem: ``solve(theta, U0) -> Solution`` plus helpers."""

    solve: Callable
    make_theta: Callable
    default_u0: torch.Tensor  # (N, m) zeros — the reference's warm start
    ocp: OCP
    settings: SolverSettings
    kind: str = "point_stabilization"  # | "tracking" | "legacy"
    # build-time capability tags, e.g. "terminal_cost" when the optional
    # terminal pose weight is nonzero
    tags: tuple = ()


def _no_obstacles(params: Params, device, far: float = 1e3):
    """Padded obstacle vectors representing 'nothing nearby'."""
    n = params.n_obstacle_points
    return torch.full((n,), far, dtype=_F32, device=device), torch.full(
        (n,), far, dtype=_F32, device=device
    )


def _zero_terminal(x, theta):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def make_point_stabilization(
    params: Params = Params(),
    *,
    reference_parity: bool = True,
    settings: Optional[SolverSettings] = None,
    horizon: Optional[int] = None,
    device=None,
) -> Problem:
    """Live point-stabilization NMPC.

    theta keys: ``x0`` (3,), ``goal`` (3,), ``obs_x``/``obs_y`` (n_obs,),
    ``Q`` (3,), ``R`` (2,), ``reverse_factor``, ``obstacle_gain``,
    ``inflation_radius``, ``obstacle_weight`` (0.0 under parity — quirk #1).
    """
    N = horizon if horizon is not None else params.N
    device = resolve_device(device)
    F = make_step(unicycle.f, "rk4", params.dt)  # quirk #3: RK4 here

    def stage_cost(x, u, k, theta):
        e = x - theta["goal"]
        c = (
            costs.quadratic_error(e, theta["Q"])
            + costs.quadratic_error(u, theta["R"])
            + costs.reverse_penalty(u, theta["reverse_factor"])
        )
        return c + theta["obstacle_weight"] * costs.gaussian_obstacle_cost(
            x[:2], theta["obs_x"], theta["obs_y"], theta["inflation_radius"], theta["obstacle_gain"]
        )

    ocp = OCP(
        transition=F,
        stage_cost=stage_cost,
        terminal_cost=_zero_terminal,
        horizon=N,
        n_states=unicycle.N_STATES,
        n_controls=unicycle.N_CONTROLS,
        u_lo=(params.pointstab_v_bounds[0], params.pointstab_w_bounds[0]),
        u_hi=(params.pointstab_v_bounds[1], params.pointstab_w_bounds[1]),
    )
    settings = settings or SolverSettings()

    def make_theta(x0, goal, obs_x=None, obs_y=None):
        if obs_x is None or obs_y is None:
            obs_x, obs_y = _no_obstacles(params, device)
        t = lambda v: torch.as_tensor(v, dtype=_F32, device=device)  # noqa: E731
        return {
            "x0": t(x0),
            "goal": t(goal),
            "obs_x": t(obs_x),
            "obs_y": t(obs_y),
            "Q": t(params.Q),
            # R = 0.5 * I hardcoded in the reference
            "R": t((0.5, 0.5)),
            # quirk #2: exponent is cost_factor, gain is reverse_factor
            "reverse_factor": t(params.cost_factor),
            "obstacle_gain": t(params.reverse_factor),
            "inflation_radius": t(params.inflation_radius),
            "obstacle_weight": t(0.0 if reference_parity else 1.0),
        }

    return Problem(
        solve=make_solver(ocp, settings),
        make_theta=make_theta,
        default_u0=torch.zeros((N, 2), dtype=_F32, device=device),
        ocp=ocp,
        settings=settings,
        kind="point_stabilization",
    )


def make_tracking(
    params: Params = Params(),
    *,
    reference_parity: bool = True,
    settings: Optional[SolverSettings] = None,
    horizon: Optional[int] = None,
    terminal_weight=(0.0, 0.0, 0.0),
    device=None,
) -> Problem:
    """Live trajectory-tracking NMPC.

    theta keys: ``x0`` (3,), ``x_ref`` (N, 3), ``u_ref`` (N, 2), obstacle
    vectors, ``Q``, ``R``, ``reverse_factor``, ``obstacle_gain``,
    ``inflation_radius``, ``obstacle_weight``, ``terminal_weight``.

    ``terminal_weight`` weighs an optional terminal pose cost
    ``||x_N - x_ref[N-1]||^2_W``; the default zeros keep parity (quirk #5).
    Corrected mode uses the Gaussian obstacle family and wraps the yaw
    tracking error to (-pi, pi] (``OCP.meta`` carries ``"wrap_yaw"``).
    """
    N = horizon if horizon is not None else params.N
    device = resolve_device(device)
    F = make_step(unicycle.f, "euler", params.dt)  # quirk #3: Euler here
    obstacle_fn = costs.barrier_obstacle_cost if reference_parity else costs.gaussian_obstacle_cost
    wrap_yaw = not reference_parity

    def obstacle_term(x, theta):
        return theta["obstacle_weight"] * obstacle_fn(
            x[:2], theta["obs_x"], theta["obs_y"], theta["inflation_radius"], theta["obstacle_gain"]
        )

    def _yaw_err(e):
        if not wrap_yaw:
            return e
        two_pi = 2.0 * np.pi
        return e - two_pi * torch.round(e / two_pi)  # half to even, as jnp.round

    def _pose_err(x, ref):
        e = x - ref
        return torch.cat([e[:2], _yaw_err(e[2:3])])

    def stage_cost(x, u, k, theta):
        # quirk #4: x_k is tracked against x_ref[k]
        e_x = _pose_err(x, theta["x_ref"][k])
        e_u = u - theta["u_ref"][k]
        return (
            costs.quadratic_error(e_x, theta["Q"])
            + costs.quadratic_error(e_u, theta["R"])
            + costs.reverse_penalty(u, theta["reverse_factor"])
            + obstacle_term(x, theta)
        )

    def terminal_cost(x, theta):
        # the reference's (inactive) obstacle sum covers k = 0..N
        e_N = _pose_err(x, theta["x_ref"][-1])
        return obstacle_term(x, theta) + costs.quadratic_error(e_N, theta["terminal_weight"])

    ocp = OCP(
        transition=F,
        stage_cost=stage_cost,
        terminal_cost=terminal_cost,
        horizon=N,
        n_states=unicycle.N_STATES,
        n_controls=unicycle.N_CONTROLS,
        u_lo=(params.tracking_v_bounds[0], params.tracking_w_bounds[0]),
        u_hi=(params.tracking_v_bounds[1], params.tracking_w_bounds[1]),
        meta=("wrap_yaw",) if wrap_yaw else (),
    )
    settings = settings or SolverSettings()

    def make_theta(x0, x_ref, u_ref, obs_x=None, obs_y=None):
        if obs_x is None or obs_y is None:
            obs_x, obs_y = _no_obstacles(params, device)
        t = lambda v: torch.as_tensor(v, dtype=_F32, device=device)  # noqa: E731
        return {
            "x0": t(x0),
            "x_ref": t(x_ref).reshape(N, 3),
            "u_ref": t(u_ref).reshape(N, 2),
            "obs_x": t(obs_x),
            "obs_y": t(obs_y),
            "Q": t(params.Q),
            "R": t(params.R),
            "reverse_factor": t(params.reverse_factor),
            # parity: barrier gain = cost_factor; corrected: Gaussian gain =
            # reverse_factor as at the point-stabilization call site
            "obstacle_gain": t(params.cost_factor if reference_parity else params.reverse_factor),
            "inflation_radius": t(params.inflation_radius),
            "obstacle_weight": t(0.0 if reference_parity else 1.0),
            "terminal_weight": t(terminal_weight).reshape(3),
        }

    return Problem(
        solve=make_solver(ocp, settings),
        make_theta=make_theta,
        default_u0=torch.zeros((N, 2), dtype=_F32, device=device),
        ocp=ocp,
        settings=settings,
        kind="tracking",
        tags=("terminal_cost",) if np.any(np.asarray(terminal_weight)) else (),
    )


def make_legacy_point_stabilization(
    params: Params = Params(),
    *,
    settings: Optional[SolverSettings] = None,
    horizon: Optional[int] = None,
    device=None,
) -> Problem:
    """Legacy standalone point-stabilization NMPC — the only reference
    variant whose (inverse-square barrier) obstacle cost is live, with
    hardcoded Q = diag(5e-5, 0.05, 0.05), R = 0.01*I and its own bounds.
    The obstacle sum covers states k = 0..N, so stage N is the terminal
    cost."""
    N = horizon if horizon is not None else params.N
    device = resolve_device(device)
    F = make_step(unicycle.f, "rk4", params.dt)

    def obstacle_term(x, theta):
        return costs.barrier_obstacle_cost(
            x[:2], theta["obs_x"], theta["obs_y"], theta["inflation_radius"], theta["obstacle_gain"]
        )

    def stage_cost(x, u, k, theta):
        e = x - theta["goal"]
        return (
            costs.quadratic_error(e, theta["Q"])
            + costs.quadratic_error(u, theta["R"])
            + costs.reverse_penalty(u, theta["reverse_factor"])
            + obstacle_term(x, theta)
        )

    ocp = OCP(
        transition=F,
        stage_cost=stage_cost,
        terminal_cost=obstacle_term,
        horizon=N,
        n_states=unicycle.N_STATES,
        n_controls=unicycle.N_CONTROLS,
        u_lo=(params.legacy_v_bounds[0], params.legacy_w_bounds[0]),
        u_hi=(params.legacy_v_bounds[1], params.legacy_w_bounds[1]),
    )
    settings = settings or SolverSettings()

    def make_theta(x0, goal, obs_x=None, obs_y=None):
        if obs_x is None or obs_y is None:
            obs_x, obs_y = _no_obstacles(params, device)
        t = lambda v: torch.as_tensor(v, dtype=_F32, device=device)  # noqa: E731
        return {
            "x0": t(x0),
            "goal": t(goal),
            "obs_x": t(obs_x),
            "obs_y": t(obs_y),
            "Q": t((0.00005, 0.05, 0.05)),
            "R": t((0.01, 0.01)),
            # quirk #2: exponent cost_factor, obstacle gain reverse_factor
            "reverse_factor": t(params.cost_factor),
            "obstacle_gain": t(params.reverse_factor),
            "inflation_radius": t(params.inflation_radius),
        }

    return Problem(
        solve=make_solver(ocp, settings),
        make_theta=make_theta,
        default_u0=torch.zeros((N, 2), dtype=_F32, device=device),
        ocp=ocp,
        settings=settings,
        kind="legacy",
    )
