"""Drop-in API compatibility layer — port of :mod:`ros2_mpc_tpu.compat`.

Each reference MPC module exposes a class named ``Mpc`` whose constructor
builds the NLP once and whose ``perform_mpc`` is the per-tick solve. These
wrappers reproduce those exact signatures and array conventions on top of
the port's problem solve (``problem.solve``, :func:`make_solver`), so a
reference user can migrate by changing one import:

* :class:`TrackingMpc` — ros2_mpc/planner/local_planner_tracking.py:11-80.
  ``perform_mpc(u0, x0, pf, puf, obstacles_x, obstacles_y)``
  -> ``(x_opt (n_states, N+1), u_opt_first (n_controls,))``.
* :class:`PointStabilizationMpc` —
  ros2_mpc/planner/local_planner_point_stabilization.py:11-87.
  ``perform_mpc(u0, initial_state, final_state, obstacles_x, obstacles_y)``
  -> ``u_opt_first (n_controls,)``.
* :class:`LegacyPointStabilizationMpc` — ros2_mpc/mpc_point_stabilization.py:9-68.
  ``perform_mpc(...)`` -> ``(x_opt (n_states, N+1), u_opt (n_controls, N))``.

Conventions preserved: ``u0`` arrives as ``(n_controls, N)`` (the reference's
``np.zeros((mpc.n_controls, mpc.N))``, path_follower:186); ``pf``/``puf``
arrive flattened column vectors (path_follower:52,72); state matrices return
``(n_states, N+1)`` like CasADi's ``sol.value(self.X)``. Exposed attributes
match what callers read: ``N``, ``n_states``, ``n_controls``, ``dt``
(path_follower:33-48,186).

Improvement over the reference: a non-convergent solve returns the best
iterate instead of raising through ``opti.solve()``; pass ``strict=True``
to restore raise-on-failure semantics.

``TrackingMpc`` and ``PointStabilizationMpc`` solve in reference-parity mode
(the reference's quirks, which a migrating caller expects) unless given
``reference_parity=False``, the corrected formulation. ``device`` (``None``:
the card; raises without one unless ``"cpu"`` is passed) holds the problem
and its solve; arrays come in and go out as NumPy in the reference's layouts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import Params
from .solver import (
    make_legacy_point_stabilization,
    make_point_stabilization,
    make_tracking,
)


class SolveError(RuntimeError):
    """Raised in strict mode when the solver fails to converge (the
    reference's IPOPT raise-through at local_planner_tracking.py:74)."""


class _MpcBase:
    def __init__(self, problem, params: Params, strict: bool):
        self._problem = problem
        self._solve = problem.solve
        self._device = problem.default_u0.device
        self._strict = strict
        self.N = problem.ocp.horizon
        self.n_states = problem.ocp.n_states
        self.n_controls = problem.ocp.n_controls
        self.dt = params.dt

    def _run(self, theta, u0):
        u0 = np.asarray(u0, dtype=float)
        if u0.shape == (self.n_controls, self.N):  # reference layout
            u0 = u0.T
        sol = self._solve(theta, torch.as_tensor(u0, dtype=torch.float32, device=self._device))
        if self._strict and not bool(sol.converged):
            raise SolveError(f"solver did not converge: kkt={float(sol.kkt_residual):.2e}")
        return sol


class TrackingMpc(_MpcBase):
    def __init__(self, params: Optional[Params] = None, *, reference_parity: bool = True,
                 horizon: Optional[int] = None, strict: bool = False, device=None):
        params = params or Params.load()
        self._params = params
        super().__init__(
            make_tracking(params, reference_parity=reference_parity, horizon=horizon,
                          device=device),
            params, strict,
        )

    def perform_mpc(self, u0, x0, pf, puf, obstacles_x=None, obstacles_y=None):
        pf = np.asarray(pf, dtype=float).reshape(self.N, self.n_states)
        puf = np.asarray(puf, dtype=float).reshape(self.N, self.n_controls)
        theta = self._problem.make_theta(np.asarray(x0, dtype=float), pf, puf,
                                         obstacles_x, obstacles_y)
        sol = self._run(theta, u0)
        x_opt = sol.X.cpu().numpy().T  # (n_states, N+1), CasADi layout
        u_opt = sol.U.cpu().numpy().T
        return x_opt, u_opt[:, 0]


class PointStabilizationMpc(_MpcBase):
    def __init__(self, params: Optional[Params] = None, *, reference_parity: bool = True,
                 horizon: Optional[int] = None, strict: bool = False, device=None):
        params = params or Params.load()
        self._params = params
        super().__init__(
            make_point_stabilization(
                params, reference_parity=reference_parity, horizon=horizon, device=device
            ),
            params, strict,
        )

    def perform_mpc(self, u0, initial_state=np.array([0, 0, 0]),
                    final_state=np.array([10, 10, 0]), obstacles_x=None, obstacles_y=None):
        theta = self._problem.make_theta(
            np.asarray(initial_state, dtype=float), np.asarray(final_state, dtype=float),
            obstacles_x, obstacles_y,
        )
        sol = self._run(theta, u0)
        return sol.U.cpu().numpy().T[:, 0]


class LegacyPointStabilizationMpc(_MpcBase):
    def __init__(self, params: Optional[Params] = None, *, horizon: Optional[int] = None,
                 strict: bool = False, device=None):
        params = params or Params.load()
        self._params = params
        super().__init__(
            make_legacy_point_stabilization(params, horizon=horizon, device=device), params, strict,
        )

    def perform_mpc(self, u0, initial_state=np.array([0, 0, 0]),
                    final_state=np.array([10, 10, 0]), obstacles_x=None, obstacles_y=None):
        theta = self._problem.make_theta(
            np.asarray(initial_state, dtype=float), np.asarray(final_state, dtype=float),
            obstacles_x, obstacles_y,
        )
        sol = self._run(theta, u0)
        return sol.X.cpu().numpy().T, sol.U.cpu().numpy().T


# Module-style aliases mirroring the reference import paths:
#   from ros2_mpc.planner.local_planner_tracking import Mpc
# becomes
#   from ros2_mpc_tpu_torch.compat import TrackingMpc as Mpc
Mpc = TrackingMpc
