"""The f64-oracle sweeps of ``tests/test_oracle_sweep.py`` for the PyTorch port.

The same seeded banks, scenario counts, bands and polish rules, with the
port's problems and engines in place of the JAX package's. Each family is
three steps, so that the solve can run on the card while the f64 polish
runs in another process:

* :func:`family_bank` draws the family's scenarios (numpy, the JAX file's
  ``np.random.default_rng`` seeds and draw order) and builds the port's
  problem and B-leading theta bank on ``device``;
* :func:`solve_family` solves the bank with the family's port engine and
  returns the controls as float64 numpy: K1 (point stabilization) and K2
  (tracking) through :class:`CudaBankSolver`, which runs the kernel on a
  CUDA bank and its plain version on a CPU bank; the legacy formulation
  through ``torch.func.vmap`` of the problem's ``make_solver`` (no kernel
  carries it, as in the JAX file); the bicycle and the quadrotor through the
  generic bank engine (``make_bank_solver_fast``), the port's bank path for
  the extra model families;
* :func:`check_family` polishes every scenario with ``tests/oracle.py`` and
  raises ``AssertionError`` under the JAX file's rule for that family; it
  returns the worst drift.

numpy, scipy and the port only: nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

import oracle
from ros2_mpc_tpu_torch.config import Params
from ros2_mpc_tpu_torch.solver import (
    SolverSettings,
    make_bank_solver_fast,
    make_bicycle_point_stabilization,
    make_legacy_point_stabilization,
    make_point_stabilization,
    make_quadrotor_hover,
    make_tracking,
    shift_controls,
)
from ros2_mpc_tpu_torch.solver.cuda_kernel import make_cuda_point_stab_solver, make_cuda_tracking_solver

PARAMS = Params()
N = 20
SWEEP = 32
SWEEP_EXT = 16
CONTROL_TOL = 1e-3  # BASELINE.md
COST_TOL = 1e-4
WARM_TICKS = 4
QUAD_DT = 0.05
TW = (10.0, 10.0, 1.0)

PS_LO = (PARAMS.pointstab_v_bounds[0], PARAMS.pointstab_w_bounds[0])
PS_HI = (PARAMS.pointstab_v_bounds[1], PARAMS.pointstab_w_bounds[1])
TR_LO = (PARAMS.tracking_v_bounds[0], PARAMS.tracking_w_bounds[0])
TR_HI = (PARAMS.tracking_v_bounds[1], PARAMS.tracking_w_bounds[1])

# family -> (seed, scenarios), as tests/test_oracle_sweep.py draws them
FAMILIES = {
    "point_stab": (42, SWEEP),
    "obstacles": (7, SWEEP),
    "tracking": (11, SWEEP),
    "legacy": (3, 8),
    "warm_realtime": (19, 8),
    "bicycle": (7, SWEEP_EXT),
    "quadrotor": (11, SWEEP_EXT),
    "terminal_tracking": (13, SWEEP_EXT),
}


def _sample_obstacles(rng, n_obs, x0, goal, clear=1.5 * PARAMS.inflation_radius):
    """A small cluster of real obstacles near (but not on) the straight line,
    the rest parked at the 100 m sentinel the nodes use, rejection-sampled
    off the start and goal discs (the JAX file's helper, draw for draw)."""
    obs_x = np.full(n_obs, 100.0)
    obs_y = np.full(n_obs, 100.0)
    k = int(rng.integers(1, 4))
    mid = (np.asarray(x0[:2]) + np.asarray(goal[:2])) / 2
    placed = 0
    while placed < k:
        pt = mid + rng.uniform(-0.4, 0.4, size=2)
        if min(np.linalg.norm(pt - x0[:2]), np.linalg.norm(pt - goal[:2])) < clear:
            continue
        obs_x[placed], obs_y[placed] = pt
        placed += 1
    return obs_x, obs_y


def _random_reference(rng):
    """Feasible arc reference: constant (v, w) rolled out from a random pose."""
    v = rng.uniform(0.05, PARAMS.tracking_v_bounds[1])
    w = rng.uniform(-0.15, 0.15)
    start = np.concatenate([rng.uniform(-0.1, 0.1, 2), rng.uniform(-0.3, 0.3, 1)])
    u_ref = np.tile([v, w], (N, 1))
    x_ref = oracle.rollout(start, u_ref, PARAMS.dt, "euler")[1:]
    return start, x_ref, u_ref


def _draw(name):
    """The family's scenarios as tuples of numpy arrays, in the JAX file's
    draw order."""
    seed, count = FAMILIES[name]
    rng = np.random.default_rng(seed)
    n_obs = PARAMS.n_obstacle_points
    if name == "point_stab":
        x0s = rng.uniform(-0.3, 0.3, size=(count, 3))
        goals = rng.uniform(-1.2, 1.2, size=(count, 3))
        return [(x0s[i], goals[i]) for i in range(count)]
    cases = []
    for _ in range(count):
        if name in ("obstacles", "legacy"):
            x0 = rng.uniform(-0.2, 0.2, 3)
            goal = rng.uniform(-1.0, 1.0, 3)
            cases.append((x0, goal, *_sample_obstacles(rng, n_obs, x0, goal)))
        elif name == "tracking":
            start, x_ref, u_ref = _random_reference(rng)
            cases.append((start + rng.uniform(-0.05, 0.05, 3), x_ref, u_ref))
        elif name == "warm_realtime":
            x0 = rng.uniform(-0.2, 0.2, 3)
            cases.append((x0, rng.uniform(-0.9, 0.9, 3)))
        elif name == "bicycle":
            x0 = np.concatenate([rng.uniform(-0.3, 0.3, 2), rng.uniform(-np.pi, np.pi, 1)])
            goal = np.concatenate([rng.uniform(-0.9, 0.9, 2), rng.uniform(-np.pi, np.pi, 1)])
            cases.append((x0, goal, *_sample_obstacles(rng, n_obs, x0, goal)))
        elif name == "quadrotor":
            x0 = np.zeros(12)
            x0[0:3] = rng.uniform(-0.4, 0.4, 3)
            x0[6:8] = rng.uniform(-0.15, 0.15, 2)
            x0[8] = rng.uniform(-0.5, 0.5)
            cases.append((x0, np.concatenate([rng.uniform(-0.3, 0.3, 3), rng.uniform(-0.4, 0.4, 1)])))
        else:  # terminal_tracking
            x0 = np.concatenate([rng.uniform(-0.1, 0.1, 2), rng.uniform(-np.pi, np.pi, 1)])
            speed = rng.uniform(0.05, 0.18)
            heading = rng.uniform(-np.pi, np.pi)
            ts = np.arange(1, N + 1) * PARAMS.dt
            x_ref = np.stack(
                [x0[0] + speed * ts * np.cos(heading), x0[1] + speed * ts * np.sin(heading), np.full(N, heading)],
                axis=1,
            )
            cases.append((x0, x_ref, np.tile([speed, 0.0], (N, 1))))
    return cases


def _problem(name, device):
    if name == "point_stab":
        return make_point_stabilization(PARAMS, horizon=N, device=device)
    if name == "obstacles":
        return make_point_stabilization(PARAMS, horizon=N, reference_parity=False, device=device)
    if name == "tracking":
        return make_tracking(PARAMS, horizon=N, device=device)
    if name == "legacy":
        return make_legacy_point_stabilization(PARAMS, horizon=N, device=device)
    if name == "warm_realtime":
        return make_point_stabilization(PARAMS, horizon=N, settings=SolverSettings.realtime(), device=device)
    if name == "bicycle":
        return make_bicycle_point_stabilization(PARAMS, horizon=N, device=device)
    if name == "quadrotor":
        return make_quadrotor_hover(horizon=N, dt=QUAD_DT, device=device)
    return make_tracking(PARAMS, horizon=N, reference_parity=False, terminal_weight=TW, device=device)


def family_bank(name: str, device, count=None) -> dict:
    """The family's first ``count`` scenarios (``None``: all) on ``device``:
    ``{"problem", "thetas", "U0s", "cases"}``. ``thetas`` is the B-leading
    stack of the problem's ``make_theta``; ``cases`` holds the numpy inputs
    the oracle polishes, with the theta weights it reads as float64."""
    cases = _draw(name)[:count]
    prob = _problem(name, device)
    dev = prob.default_u0.device
    ts = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    thetas = [prob.make_theta(*(ts(a) for a in c)) for c in cases]
    keys = {
        "bicycle": ("Q", "R", "inflation_radius", "obstacle_gain", "obstacle_weight"),
        "terminal_tracking": ("Q", "R", "reverse_factor"),
        "quadrotor": (),
    }.get(name)
    if keys is not None:  # the oracle reads the solver's own (float32) weights and box
        box = {"u_lo": np.asarray(prob.ocp.u_lo, dtype=float), "u_hi": np.asarray(prob.ocp.u_hi, dtype=float)}
        cases = [
            c + (dict(box, **{k: np.asarray(t[k].cpu(), dtype=float) for k in keys}),)
            for c, t in zip(cases, thetas)
        ]
    bank = {k: torch.stack([t[k] for t in thetas]).contiguous() for k in thetas[0]}
    U0s = torch.stack([prob.default_u0] * len(cases)).contiguous()
    return {"problem": prob, "thetas": bank, "U0s": U0s, "cases": cases}


def engine(name: str, prob):
    """The family's port engine: ``solve_bank(thetas, U0s) -> Solution``."""
    if name in ("point_stab", "obstacles", "warm_realtime"):
        return make_cuda_point_stab_solver(prob.ocp, prob.settings)
    if name in ("tracking", "terminal_tracking"):
        return make_cuda_tracking_solver(prob.ocp, prob.settings)
    if name == "legacy":
        return torch.func.vmap(prob.solve)
    return make_bank_solver_fast(prob.ocp, prob.settings)


def solve_family(name: str, bank: dict, solve_bank=None):
    """``(U, converged)`` of the bank as numpy, U (B, N, m) in float64,
    solved by ``solve_bank`` (``None``: :func:`engine`). The warm realtime
    family runs ``WARM_TICKS`` receding-horizon solves at a frozen state,
    each warm started from the last one's shifted controls, and returns the
    last."""
    solve_bank = solve_bank or engine(name, bank["problem"])
    U = bank["U0s"]
    for _ in range(WARM_TICKS if name == "warm_realtime" else 1):
        sol = solve_bank(bank["thetas"], U)
        U = torch.func.vmap(shift_controls)(sol.U)
    return sol.U.detach().cpu().numpy().astype(float), sol.converged.cpu().numpy()


def _polish_drift(cost_fn, U_ours, lo, hi, horizon=N, m=2):
    """(max |U_polished - U_ours|, J_polished, J_ours_f64, U_polished)."""
    U_ref, J_ref = oracle.solve_oracle(cost_fn, horizon, u_lo=lo, u_hi=hi, U0=U_ours, m=m)
    return float(np.max(np.abs(U_ours - U_ref))), J_ref, float(cost_fn(U_ours.reshape(-1))), U_ref


def _point_cost(x0, goal, obstacle=None):
    return lambda U: oracle.point_stab_cost(  # noqa: E731
        U, x0, goal, PARAMS.dt, N, Q=PARAMS.Q, R=(0.5, 0.5), reverse_factor=PARAMS.cost_factor,
        obstacle=obstacle,
    )


def check_family(name: str, cases: list, U: np.ndarray, converged: np.ndarray) -> float:
    """Polish every scenario from ``U`` (B, N, m) with the f64 oracle and
    raise ``AssertionError`` under ``tests/test_oracle_sweep.py``'s rule for
    the family; returns the worst drift (relative to the control box width
    for the quadrotor)."""
    count = len(cases)
    if name == "point_stab":
        assert float(np.mean(converged)) >= 0.9, float(np.mean(converged))
    if name in ("point_stab", "warm_realtime"):
        failures, worst = [], 0.0
        for i, (x0, goal) in enumerate(cases):
            drift, J_ref, J_ours, _ = _polish_drift(_point_cost(x0, goal), U[i], PS_LO, PS_HI)
            worst = max(worst, drift)
            if drift > CONTROL_TOL or J_ours > J_ref + COST_TOL:
                failures.append((i, drift, J_ours - J_ref))
        assert not failures, f"{len(failures)}/{count} {name} scenarios off-oracle: {failures[:5]}"
        if name == "point_stab":
            # cold-start guard on a subset: the obstacle-free objective is
            # unimodal, so an independent solve must not find a better optimum
            for i in range(0, count, 8):
                fn = _point_cost(*cases[i])
                _, J_cold = oracle.solve_oracle(fn, N, u_lo=PS_LO, u_hi=PS_HI)
                assert float(fn(U[i].reshape(-1))) <= J_cold + 1e-3, (i, float(fn(U[i].reshape(-1))), J_cold)
        return worst
    if name == "obstacles":
        failures, worst = [], 0.0
        gain = PARAMS.reverse_factor  # quirk #2 swap: obstacle gain = reverse_factor
        for i, (x0, goal, obs_x, obs_y) in enumerate(cases):
            def obstacle(xy, obs_x=obs_x, obs_y=obs_y):
                return oracle.gaussian_obstacle(xy, obs_x, obs_y, PARAMS.inflation_radius, gain)

            drift, J_ref, J_ours, _ = _polish_drift(_point_cost(x0, goal, obstacle), U[i], PS_LO, PS_HI)
            worst = max(worst, drift)
            # 2e-3 like test_solver's obstacle-active case: f32 gradient noise
            # on the Gaussian cliffs dominates near-flat directions
            if drift > 2e-3 or J_ours > J_ref + COST_TOL:
                failures.append((i, drift, J_ours - J_ref))
        assert not failures, f"{len(failures)}/{count} obstacle scenarios off-oracle: {failures[:5]}"
        return worst
    if name == "tracking":
        failures, worst = [], 0.0
        for i, (x0, x_ref, u_ref) in enumerate(cases):
            fn = lambda Uv, x0=x0, x_ref=x_ref, u_ref=u_ref: oracle.tracking_cost(  # noqa: E731
                Uv, x0, x_ref, u_ref, PARAMS.dt, N, Q=PARAMS.Q, R=PARAMS.R, reverse_factor=PARAMS.reverse_factor,
            )
            drift, J_ref, J_ours, _ = _polish_drift(fn, U[i], TR_LO, TR_HI)
            worst = max(worst, drift)
            if drift > CONTROL_TOL or J_ours > J_ref + COST_TOL:
                failures.append((i, drift, J_ours - J_ref))
        assert not failures, f"{len(failures)}/{count} tracking scenarios off-oracle: {failures[:5]}"
        return worst
    if name == "legacy":
        # Q_x=5e-5 makes the objective nearly flat in position: judged by the
        # cost gap, not the drift (the JAX file's rationale)
        lo = (PARAMS.legacy_v_bounds[0], PARAMS.legacy_w_bounds[0])
        hi = (PARAMS.legacy_v_bounds[1], PARAMS.legacy_w_bounds[1])
        failures, worst = [], 0.0
        for i, (x0, goal, obs_x, obs_y) in enumerate(cases):
            assert np.all(np.isfinite(U[i]))
            fn = lambda Uv, x0=x0, goal=goal, obs_x=obs_x, obs_y=obs_y: oracle.legacy_cost(  # noqa: E731
                Uv, x0, goal, PARAMS.dt, N, obs_x, obs_y,
                PARAMS.inflation_radius, PARAMS.reverse_factor, PARAMS.cost_factor,
            )
            drift, J_ref, J_ours, _ = _polish_drift(fn, U[i], lo, hi)
            worst = max(worst, drift)
            if J_ours > J_ref + 1e-3:
                failures.append((i, J_ours - J_ref))
        assert not failures, f"{len(failures)}/{count} legacy scenarios off-oracle: {failures}"
        return worst
    if name == "quadrotor":
        rel = []
        for i, (x0, goal, w) in enumerate(cases):
            width = w["u_hi"] - w["u_lo"]
            fn = lambda Uf, x0=x0, goal=goal: oracle.quadrotor_cost(Uf, x0, goal, QUAD_DT, N)  # noqa: E731
            U_ref, _ = oracle.solve_oracle(fn, N, u_lo=w["u_lo"], u_hi=w["u_hi"], U0=U[i], m=4)
            rel.append(np.max(np.abs(U[i] - U_ref) / width[None, :]))
        rel = np.asarray(rel)
        # per channel, relative to the control box width (thrust spans 9.81 N,
        # torques 0.04 N m); 5e-3 of width is the 12-state family's bound
        assert np.mean(rel <= 5e-3) >= 0.9, rel
        assert np.max(rel) <= 2e-2, rel
        return float(np.max(rel))
    # bicycle, terminal_tracking
    drifts = []
    for i, c in enumerate(cases):
        w = c[-1]
        if name == "bicycle":
            x0, goal, obs_x, obs_y = c[:4]
            fn = lambda Uf, x0=x0, goal=goal, obs_x=obs_x, obs_y=obs_y, w=w: oracle.bicycle_cost(  # noqa: E731
                Uf, x0, goal, PARAMS.dt, N, Q=w["Q"], R=w["R"], obs_x=obs_x, obs_y=obs_y,
                ir=float(w["inflation_radius"]), gain=float(w["obstacle_gain"]), weight=float(w["obstacle_weight"]),
            )
            drift, J_ref, J_ours, _ = _polish_drift(fn, U[i], w["u_lo"], w["u_hi"])
            assert J_ours <= J_ref + max(COST_TOL, 1e-6 * abs(J_ref)) or drift <= CONTROL_TOL, (i, drift, J_ours - J_ref)
        else:
            x0, x_ref, u_ref = c[:3]
            fn = lambda Uf, x0=x0, x_ref=x_ref, u_ref=u_ref, w=w: oracle.tracking_terminal_cost(  # noqa: E731
                Uf, x0, x_ref, u_ref, PARAMS.dt, N, Q=w["Q"], R=w["R"],
                reverse_factor=float(w["reverse_factor"]), terminal_weight=np.asarray(TW),
            )
            drift, _, _, _ = _polish_drift(fn, U[i], TR_LO, TR_HI)
        drifts.append(drift)
    drifts = np.asarray(drifts)
    assert np.mean(drifts <= CONTROL_TOL) >= 0.9, drifts
    assert np.max(drifts) <= 5 * CONTROL_TOL, drifts
    return float(np.max(drifts))

