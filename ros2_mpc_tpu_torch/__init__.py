"""ros2_mpc_tpu_torch — the PyTorch/CUDA port of :mod:`ros2_mpc_tpu`.

The same nonlinear MPC framework, written in PyTorch for one NVIDIA H100.
Module names mirror the JAX package so each module's counterpart is easy to
find; the JAX package stays the reference the port is tested against. Every
TPU kernel becomes a hand-written CUDA C++ kernel (``csrc/*.cu``: the
whole-solver banks K1 and K2, and K3, the roofline's op chains), built with
nvcc at its first CUDA call (:mod:`ros2_mpc_tpu_torch._build`).

This package imports ``torch`` and never ``jax`` or any module of the JAX
package; its entry points run on the card unless given ``device="cpu"``.
"""

from .config import DEFAULT_PARAMS, Params

__version__ = "0.1.0"
__all__ = ["Params", "DEFAULT_PARAMS", "__version__"]
