from . import costs, integrators

__all__ = ["costs", "integrators"]
