from . import bicycle, quadrotor, unicycle, unicycle_dyn

__all__ = ["unicycle", "bicycle", "quadrotor", "unicycle_dyn"]
