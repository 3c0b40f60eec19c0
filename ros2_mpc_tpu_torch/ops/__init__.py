from . import costmap, costs, grid, integrators

__all__ = ["costmap", "costs", "grid", "integrators"]
