"""Fleet-scale closed loops, the scenario bank over a device mesh, sweeps
and multi-process runs (port of :mod:`ros2_mpc_tpu.parallel`)."""

from . import distributed
from .fleet import (
    FleetResult,
    SwarmResult,
    TrackingFleetResult,
    arc_path_fleet,
    circle_swarm,
    grid_swap_swarm,
    make_fleet_rollout,
    make_generic_fleet_rollout,
    make_sharded_fleet_rollout,
    make_sharded_swarm_rollout,
    make_sharded_tracking_fleet_rollout,
    make_swarm_rollout,
    make_tracking_fleet_rollout,
    random_fleet,
)
from .mesh import (
    SCENARIO_AXIS,
    Mesh,
    Sharded,
    bank_metrics,
    make_bank_solver,
    make_host_chip_mesh,
    make_mesh,
    shard_bank,
)
from .sweep import SweepSpec, build_sweep_thetas, run_sweep

__all__ = [
    "SCENARIO_AXIS",
    "Mesh",
    "Sharded",
    "bank_metrics",
    "make_bank_solver",
    "make_host_chip_mesh",
    "make_mesh",
    "shard_bank",
    "FleetResult",
    "SwarmResult",
    "TrackingFleetResult",
    "arc_path_fleet",
    "circle_swarm",
    "grid_swap_swarm",
    "make_fleet_rollout",
    "make_generic_fleet_rollout",
    "make_sharded_fleet_rollout",
    "make_sharded_swarm_rollout",
    "make_sharded_tracking_fleet_rollout",
    "make_swarm_rollout",
    "make_tracking_fleet_rollout",
    "random_fleet",
    "SweepSpec",
    "build_sweep_thetas",
    "run_sweep",
    "distributed",
]
