"""Configuration, shared with the JAX package.

:mod:`ros2_mpc_tpu.config` is framework-free (a frozen dataclass and a YAML
loader) and imports no jax, so the port re-exports it instead of keeping a
copy that could drift.
"""

from ros2_mpc_tpu.config import DEFAULT_PARAMS, Params

__all__ = ["Params", "DEFAULT_PARAMS"]
