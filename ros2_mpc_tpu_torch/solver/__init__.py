from .batched import make_bank_kkt_polish, make_bank_solver_fast
from .ilqr import OCP, Solution, SolverSettings, make_solver
from .mppi import MppiSettings, make_hybrid_solver, make_mppi_solver, make_multistart_solver
from .multistart_bank import adversarial_saddle_bank, arc_seeds, make_bank_multistart_solver
from .problems import (
    Problem,
    make_legacy_point_stabilization,
    make_point_stabilization,
    make_tracking,
)
from .problems_ext import (
    make_bicycle_point_stabilization,
    make_quadrotor_hover,
    make_smooth_point_stabilization,
)
from .rescue import (
    make_cuda_two_pass_point_stab,
    make_cuda_two_pass_tracking,
    make_fast_polish_solver,
    make_multistart_two_pass_solver,
    make_two_pass_solver,
    rescue_schedule,
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
    "make_bicycle_point_stabilization",
    "make_quadrotor_hover",
    "make_smooth_point_stabilization",
    "make_two_pass_solver",
    "make_multistart_two_pass_solver",
    "make_bank_solver_fast",
    "make_bank_kkt_polish",
    "make_fast_polish_solver",
    "make_cuda_two_pass_point_stab",
    "make_cuda_two_pass_tracking",
    "rescue_schedule",
    "arc_seeds",
    "make_bank_multistart_solver",
    "adversarial_saddle_bank",
    "MppiSettings",
    "make_mppi_solver",
    "make_hybrid_solver",
    "make_multistart_solver",
]
