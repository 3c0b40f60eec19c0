from .global_planner import (
    AstarGlobalPlanner,
    AStarPlanner2,
    RRTGlobalPlanner,
    astar_path,
    get_points_on_lines,
)

__all__ = [
    "AstarGlobalPlanner",
    "AStarPlanner2",
    "RRTGlobalPlanner",
    "astar_path",
    "get_points_on_lines",
]
