"""Fleet-scale closed loops on one card (port of :mod:`ros2_mpc_tpu.parallel`,
the unsharded fleets; the mesh, the sweeps and the distributed runs are not
ported yet)."""

from .fleet import (
    FleetResult,
    SwarmResult,
    TrackingFleetResult,
    arc_path_fleet,
    circle_swarm,
    grid_swap_swarm,
    make_fleet_rollout,
    make_generic_fleet_rollout,
    make_swarm_rollout,
    make_tracking_fleet_rollout,
    random_fleet,
)

__all__ = [
    "FleetResult",
    "SwarmResult",
    "TrackingFleetResult",
    "arc_path_fleet",
    "circle_swarm",
    "grid_swap_swarm",
    "make_fleet_rollout",
    "make_generic_fleet_rollout",
    "make_swarm_rollout",
    "make_tracking_fleet_rollout",
    "random_fleet",
]
