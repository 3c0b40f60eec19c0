"""ros2_mpc_tpu_torch — the PyTorch/CUDA port of :mod:`ros2_mpc_tpu`.

The same nonlinear MPC framework, written in PyTorch for one NVIDIA H100.
Module names mirror the JAX package so each module's counterpart is easy to
find; the JAX package stays the reference the port is tested against. The
whole-solver TPU kernels become hand-written CUDA C++ kernels
(``csrc/*.cu``), built with nvcc at their first CUDA call
(:mod:`ros2_mpc_tpu_torch._build`).

This package imports ``torch`` and never ``jax``.
"""

from .config import DEFAULT_PARAMS, Params

__version__ = "0.1.0"
__all__ = ["Params", "DEFAULT_PARAMS", "__version__"]
