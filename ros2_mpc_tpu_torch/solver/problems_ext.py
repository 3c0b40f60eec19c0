"""Beyond-reference problem families on the same solver core.

Port of :mod:`ros2_mpc_tpu.solver.problems_ext`. The solver is generic over
the :class:`~.ilqr.OCP` template, so a new platform is a page of pure
functions:

* :func:`make_bicycle_point_stabilization`: kinematic bicycle
  (``models/bicycle.py``), drive-to-pose with steering bounds and active
  Gaussian obstacle costs;
* :func:`make_smooth_point_stabilization`: smooth-actuation unicycle
  (``models/unicycle_dyn.py``), accelerations as controls;
* :func:`make_quadrotor_hover`: 12-state / 4-control quadrotor
  (``models/quadrotor.py``), fly-to-pose with thrust/torque bounds.

Each returns the standard :class:`~.problems.Problem` with its thetas as
float32 tensors on ``device`` (``None`` is the card and raises without one;
the CPU only as ``device="cpu"``). The CUDA bank kernels hard-code the
unicycle; these families run on the model-generic bank engine
(``solver/batched.py``) or ``torch.func.vmap(problem.solve)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Params
from ..device import device_constant, resolve_device
from ..models import bicycle, quadrotor, unicycle_dyn
from ..ops import costs
from ..ops.integrators import make_step
from .ilqr import OCP, SolverSettings, make_solver
from .problems import Problem, _no_obstacles, _zero_terminal

_F32 = torch.float32


def _tensor_fn(device):
    return lambda v: torch.as_tensor(v, dtype=_F32, device=device)


def make_bicycle_point_stabilization(
    params: Params = Params(),
    *,
    wheelbase: float = 0.3,
    v_bounds: tuple = (-0.1, 0.3),
    steer_max: float = 0.45,
    horizon: Optional[int] = None,
    settings: Optional[SolverSettings] = None,
    device=None,
) -> Problem:
    """Drive-to-pose NMPC for a car-like robot (kinematic bicycle).

    theta keys: ``x0`` (3,), ``goal`` (3,), ``obs_x``/``obs_y`` (n_obs,),
    ``Q`` (3,), ``R`` (2,), ``obstacle_gain``, ``inflation_radius``,
    ``obstacle_weight`` (active: a corrected-mode-only family).
    """
    N = horizon if horizon is not None else params.N
    device = resolve_device(device)
    F = make_step(bicycle.make_f(wheelbase), "rk4", params.dt)

    def stage_cost(x, u, k, theta):
        e = x - theta["goal"]
        return (
            costs.quadratic_error(e, theta["Q"])
            + costs.quadratic_error(u, theta["R"])
            + theta["obstacle_weight"]
            * costs.gaussian_obstacle_cost(
                x[:2], theta["obs_x"], theta["obs_y"], theta["inflation_radius"], theta["obstacle_gain"]
            )
        )

    ocp = OCP(
        transition=F,
        stage_cost=stage_cost,
        terminal_cost=_zero_terminal,
        horizon=N,
        n_states=bicycle.N_STATES,
        n_controls=bicycle.N_CONTROLS,
        u_lo=(v_bounds[0], -steer_max),
        u_hi=(v_bounds[1], steer_max),
    )
    settings = settings or SolverSettings()

    def make_theta(x0, goal, obs_x=None, obs_y=None):
        if obs_x is None or obs_y is None:
            obs_x, obs_y = _no_obstacles(params, device)
        t = _tensor_fn(device)
        return {
            "x0": t(x0),
            "goal": t(goal),
            "obs_x": t(obs_x),
            "obs_y": t(obs_y),
            "Q": t(params.Q),
            "R": t((0.5, 0.5)),
            "obstacle_gain": t(params.reverse_factor),
            "inflation_radius": t(params.inflation_radius),
            "obstacle_weight": t(1.0),
        }

    return Problem(
        solve=make_solver(ocp, settings),
        make_theta=make_theta,
        default_u0=torch.zeros((N, 2), dtype=_F32, device=device),
        ocp=ocp,
        settings=settings,
        kind="bicycle",
    )


def make_smooth_point_stabilization(
    params: Params = Params(),
    *,
    a_bounds: tuple = (-0.3, 0.3),
    alpha_bounds: tuple = (-1.0, 1.0),
    v_limit: float = 0.2,
    w_limit: float = 0.5,
    horizon: Optional[int] = None,
    settings: Optional[SolverSettings] = None,
    device=None,
) -> Problem:
    """Drive-to-pose NMPC with actuator dynamics in the OCP.

    State ``(x, y, theta, v, w)``; controls are accelerations. Velocity
    magnitudes are kept under ``v_limit``/``w_limit`` by a smooth quadratic
    hinge; the terminal cost parks the platform (pose error plus velocity
    magnitude).

    theta keys: ``x0`` (5,), ``goal`` (3,), obstacle vectors, ``Q`` (3,),
    ``R`` (2,), ``damp`` (2,), ``vel_limit_weight``, ``terminal_weight``,
    ``obstacle_gain``, ``inflation_radius``, ``obstacle_weight``.
    """
    N = horizon if horizon is not None else params.N
    device = resolve_device(device)
    F = make_step(unicycle_dyn.f, "rk4", params.dt)
    vw_lim = device_constant((v_limit, w_limit))

    def _vel_hinge(x, theta):
        # smooth one-sided quadratic: zero inside the limit, (|v|-lim)^2 out
        over = torch.clamp(torch.abs(x[3:5]) - vw_lim(x.device, x.dtype), min=0.0)
        return theta["vel_limit_weight"] * torch.sum(over * over)

    def stage_cost(x, u, k, theta):
        e = x[:3] - theta["goal"]
        return (
            costs.quadratic_error(e, theta["Q"])
            + costs.quadratic_error(x[3:5], theta["damp"])
            + costs.quadratic_error(u, theta["R"])
            + _vel_hinge(x, theta)
            + theta["obstacle_weight"]
            * costs.gaussian_obstacle_cost(
                x[:2], theta["obs_x"], theta["obs_y"], theta["inflation_radius"], theta["obstacle_gain"]
            )
        )

    def terminal_cost(x, theta):
        e = x[:3] - theta["goal"]
        return theta["terminal_weight"] * (costs.quadratic_error(e, theta["Q"]) + torch.sum(x[3:5] * x[3:5]))

    ocp = OCP(
        transition=F,
        stage_cost=stage_cost,
        terminal_cost=terminal_cost,
        horizon=N,
        n_states=unicycle_dyn.N_STATES,
        n_controls=unicycle_dyn.N_CONTROLS,
        u_lo=(a_bounds[0], alpha_bounds[0]),
        u_hi=(a_bounds[1], alpha_bounds[1]),
    )
    settings = settings or SolverSettings()

    def make_theta(x0, goal, obs_x=None, obs_y=None):
        if obs_x is None or obs_y is None:
            obs_x, obs_y = _no_obstacles(params, device)
        t = _tensor_fn(device)
        return {
            "x0": t(x0),
            "goal": t(goal),
            "obs_x": t(obs_x),
            "obs_y": t(obs_y),
            "Q": t(params.Q),
            "R": t((0.5, 0.5)),
            "damp": t((0.05, 0.05)),
            "vel_limit_weight": t(50.0),
            "terminal_weight": t(10.0),
            "obstacle_gain": t(params.reverse_factor),
            "inflation_radius": t(params.inflation_radius),
            "obstacle_weight": t(1.0),
        }

    return Problem(
        solve=make_solver(ocp, settings),
        make_theta=make_theta,
        default_u0=torch.zeros((N, 2), dtype=_F32, device=device),
        ocp=ocp,
        settings=settings,
        kind="smooth",
        tags=("terminal_cost",),
    )


def make_quadrotor_hover(
    *,
    mass: float = 0.5,
    inertia: tuple = (2.3e-3, 2.3e-3, 4.0e-3),
    tau_max: float = 0.02,
    dt: float = 0.05,
    horizon: int = 30,
    settings: Optional[SolverSettings] = None,
    device=None,
) -> Problem:
    """Fly-to-pose NMPC for a 12-state quadrotor (``models/quadrotor.py``).

    Thrust in [0, 2 m g] and body torques in [-tau_max, tau_max];
    ``default_u0`` tiles the analytic hover input.

    theta keys: ``x0`` (12,), ``goal`` (4: x, y, z, yaw), ``Qp``, ``Qv``,
    ``Qatt``, ``Qw`` (scalars), ``R`` (4,), ``terminal_weight``.
    """
    N = horizon
    device = resolve_device(device)
    F = make_step(quadrotor.make_f(mass, inertia), "rk4", dt)
    u_hover_list = [mass * quadrotor.GRAVITY, 0.0, 0.0, 0.0]
    u_hover = device_constant(u_hover_list)

    def _errors(x, theta):
        ep = x[0:3] - theta["goal"][0:3]
        epsi = x[8] - theta["goal"][3]
        return ep, x[3:6], x[6], x[7], epsi, x[9:12]

    def stage_cost(x, u, k, theta):
        ep, v, phi, th, epsi, w = _errors(x, theta)
        eu = u - u_hover(u.device, u.dtype)
        return (
            theta["Qp"] * torch.sum(ep * ep)
            + theta["Qv"] * torch.sum(v * v)
            + theta["Qatt"] * (phi * phi + th * th + epsi * epsi)
            + theta["Qw"] * torch.sum(w * w)
            + costs.quadratic_error(eu, theta["R"])
        )

    def terminal_cost(x, theta):
        ep, v, phi, th, epsi, w = _errors(x, theta)
        return theta["terminal_weight"] * (
            torch.sum(ep * ep) + torch.sum(v * v) + phi * phi + th * th + epsi * epsi + torch.sum(w * w)
        )

    ocp = OCP(
        transition=F,
        stage_cost=stage_cost,
        terminal_cost=terminal_cost,
        horizon=N,
        n_states=quadrotor.N_STATES,
        n_controls=quadrotor.N_CONTROLS,
        u_lo=(0.0, -tau_max, -tau_max, -tau_max),
        u_hi=(2.0 * mass * quadrotor.GRAVITY, tau_max, tau_max, tau_max),
    )
    settings = settings or SolverSettings()

    def make_theta(x0, goal):
        t = _tensor_fn(device)
        return {
            "x0": t(x0),
            "goal": t(goal).reshape(4),
            "Qp": t(1.0),
            "Qv": t(0.1),
            "Qatt": t(0.5),
            "Qw": t(0.01),
            "R": t((0.1, 10.0, 10.0, 10.0)),
            "terminal_weight": t(10.0),
        }

    return Problem(
        solve=make_solver(ocp, settings),
        make_theta=make_theta,
        default_u0=quadrotor.hover_control(mass, device=device).repeat(N, 1),
        ocp=ocp,
        settings=settings,
        kind="quadrotor",
        tags=("terminal_cost",),
    )
