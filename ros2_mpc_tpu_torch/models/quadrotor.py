"""12-state quadrotor rigid-body model on tensors.

Port of :mod:`ros2_mpc_tpu.models.quadrotor`. State (12): position p
(world), velocity v (world), attitude as ZYX Euler angles (roll phi, pitch
theta, yaw psi), body angular rate omega. Controls (4): total thrust T [N]
plus body torques tau [N m].

    pdot     = v
    vdot     = (T/m) * R(phi, theta, psi) e3 - g e3
    eulerdot = W(phi, theta) omega
    omegadot = J^-1 (tau - omega x J omega)

Hover is the fixed point u = (m g, 0, 0, 0) at any pose with zero v/omega
and level attitude. The Euler parameterization is singular at
|theta| = pi/2.
"""

from __future__ import annotations

import torch

from ..device import device_constant
from ..ops.grid import reciprocal_f32

N_STATES = 12
N_CONTROLS = 4
GRAVITY = 9.81


def make_f(
    mass: float = 0.5,
    inertia: tuple = (2.3e-3, 2.3e-3, 4.0e-3),
    g: float = GRAVITY,
):
    """Continuous-time dynamics ``f(x, u) -> xdot`` (diagonal inertia [kg m^2]).

    XLA divides by the constant mass and inertias as products with their
    float32 reciprocals, so the port multiplies by those reciprocals too
    (``models/bicycle.py`` explains why). The constants are tensors copied
    to the device once (``device_constant``), not Python floats, which would
    make ``torch.func.jacfwd``'s tangents float64."""
    Jx, Jy, Jz = inertia
    consts = device_constant(
        (reciprocal_f32(mass), g, Jz - Jy, Jx - Jz, Jy - Jx, reciprocal_f32(Jx), reciprocal_f32(Jy), reciprocal_f32(Jz))
    )

    def f(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        inv_m, g_, dzy, dxz, dyx, inv_jx, inv_jy, inv_jz = consts(x.device, x.dtype)
        v = x[..., 3:6]
        phi, th, psi = x[..., 6], x[..., 7], x[..., 8]
        wx, wy, wz = x[..., 9], x[..., 10], x[..., 11]
        T = u[..., 0]
        tx, ty, tz = u[..., 1], u[..., 2], u[..., 3]

        cphi, sphi = torch.cos(phi), torch.sin(phi)
        cth, sth = torch.cos(th), torch.sin(th)
        cpsi, spsi = torch.cos(psi), torch.sin(psi)

        # body z-axis in world frame (third column of R_zyx)
        ez_x = cpsi * sth * cphi + spsi * sphi
        ez_y = spsi * sth * cphi - cpsi * sphi
        ez_z = cth * cphi
        a = T * inv_m
        vdot = torch.stack([a * ez_x, a * ez_y, a * ez_z - g_], dim=-1)

        # Euler-rate kinematics (ZYX)
        tth = sth / cth
        phidot = wx + sphi * tth * wy + cphi * tth * wz
        thdot = cphi * wy - sphi * wz
        psidot = (sphi * wy + cphi * wz) / cth

        # rigid-body rotation with diagonal inertia
        wxdot = (tx - dzy * wy * wz) * inv_jx
        wydot = (ty - dxz * wz * wx) * inv_jy
        wzdot = (tz - dyx * wx * wy) * inv_jz

        return torch.cat(
            [
                v,
                vdot,
                torch.stack([phidot, thdot, psidot], dim=-1),
                torch.stack([wxdot, wydot, wzdot], dim=-1),
            ],
            dim=-1,
        )

    return f


def hover_control(mass: float = 0.5, g: float = GRAVITY, device=None) -> torch.Tensor:
    """The analytic hover input (m g, 0, 0, 0), float32."""
    return torch.tensor([mass * g, 0.0, 0.0, 0.0], dtype=torch.float32, device=device)
