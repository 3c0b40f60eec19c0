from .ilqr import OCP, Solution, SolverSettings, make_solver
from .problems import (
    Problem,
    make_legacy_point_stabilization,
    make_point_stabilization,
    make_tracking,
)
from .warmstart import shift_controls

__all__ = [
    "OCP",
    "Solution",
    "SolverSettings",
    "make_solver",
    "Problem",
    "make_point_stabilization",
    "make_tracking",
    "make_legacy_point_stabilization",
    "shift_controls",
]
