"""Closed-loop simulator: unicycle plant + grid lidar + bus I/O, on a device.

Port of :mod:`ros2_mpc_tpu.nodes.sim`. The reference has no in-repo
simulation at all — multi-node behavior is only ever exercised against a
real robot or an externally-installed Gazebo/nav2 stack (install.sh:1-7,
SURVEY.md §4). This simulator closes the loop in one process: a unicycle
plant integrated with RK4, a ray-marched lidar over the occupancy map, and
publishers for the exact topics the node graph consumes (``/map``,
``/scan``, ``/robot_position``) with ``cmd_vel`` actuation.

The occupancy grid, the pose, the lidar's ray march and the plant step live
on ``device`` (``None``: the card); what goes on the bus is NumPy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Params
from ..device import resolve_device
from ..models import unicycle
from ..ops.grid import reciprocal_f32
from ..ops.integrators import rk4_step
from .bus import LaserScan, MessageBus, Odometry, Pose, Quaternion, Twist
from .topics import MapServer

_F32 = torch.float32


def lidar_scan(
    occupied,  # (H, W) bool tensor, pgm row order (row 0 = top)
    origin,  # (2,) tensor, world meters of the bottom-left map corner
    resolution: float,
    pose,  # (3,) tensor, x, y, yaw
    n_beams: int,
    angle_min: float,
    angle_max: float,
    max_range: float,
):
    """Ray-marched ranges in the robot frame (inf past max_range): every beam
    and every march step at once, one gather, on the grid's device. As in
    the JAX version, a beam's first hit is the first occupied sample, every
    resolution/2 along it; the divisions by the compile-time resolution and
    beam count are float32 reciprocal multiplications, as XLA makes them."""
    H, W = occupied.shape
    dev = occupied.device
    step = resolution / 2.0
    n_steps = int(max_range / step)
    a_min = torch.tensor(angle_min, dtype=_F32, device=dev)
    span = torch.tensor(angle_max, dtype=_F32, device=dev) - a_min
    beam_angles = pose[2] + a_min + torch.arange(n_beams, device=dev) * span * reciprocal_f32(n_beams)
    ts = (torch.arange(n_steps, dtype=_F32, device=dev) + 1.0) * step  # (T,)
    px = pose[0] + torch.cos(beam_angles)[:, None] * ts[None, :]
    py = pose[1] + torch.sin(beam_angles)[:, None] * ts[None, :]
    inv = reciprocal_f32(resolution)
    col = ((px - origin[0]) * inv).to(torch.int32)
    row = H - 1 - ((py - origin[1]) * inv).to(torch.int32)
    inside = (col >= 0) & (col < W) & (row >= 0) & (row < H)
    hit = inside & occupied[row.clamp(0, H - 1).long(), col.clamp(0, W - 1).long()]
    # argmax is the first maximum; CUDA has no argmax over bool
    first = torch.argmax(hit.to(torch.uint8), dim=1)  # (B,)
    return torch.where(hit.any(dim=1), ts[first], torch.inf)


def plant_step(x, u, dt):
    """One RK4 step of the unicycle from pose ``x`` (tensor) under ``u``."""
    return rk4_step(unicycle.f, x, torch.as_tensor(u, dtype=_F32, device=x.device), dt)


class Simulator:
    """Single-robot world wired onto a :class:`MessageBus`."""

    def __init__(
        self,
        bus: MessageBus,
        map_image: np.ndarray,  # trinary pgm convention: 254 free/0 occ/205 unknown
        map_info: dict,
        start_pose=(0.0, 0.0, 0.0),
        params: Params = Params(),
        n_beams: int = 360,
        max_range: float = 3.5,
        noise: dict | None = None,
        noise_seed: int = 0,
        device=None,
    ):
        """``noise`` keys (all std-devs, default 0 = the deterministic sim):
        ``odom_xy`` [m] and ``odom_yaw`` [rad] on the published/localized
        pose, ``scan`` (multiplicative, per beam) on lidar ranges, ``cmd``
        (multiplicative) on actuated velocities — a TurtleBot3-class error
        budget is ``{"odom_xy": 0.01, "odom_yaw": 0.01, "scan": 0.01,
        "cmd": 0.05}``. ``device``: where the grid, pose, lidar and plant
        live (``None``: the card)."""
        self.device = dev = resolve_device(device)
        self.bus = bus
        self.params = params
        self.map_image = np.asarray(map_image)
        self.map_info = map_info
        self.occupied = torch.as_tensor(self.map_image == 0, device=dev)
        self.origin = torch.tensor(np.asarray(map_info["origin"][:2], dtype=np.float32), device=dev)
        self.resolution = float(map_info["resolution"])
        self.pose = np.asarray(start_pose, dtype=np.float32)
        self.cmd = np.zeros(2)
        self.n_beams = n_beams
        self.max_range = max_range
        self.noise = dict(noise or {})
        self._rng = np.random.default_rng(noise_seed)
        # Dynamic (unmapped) obstacles: a callable returning world-XY centers
        # of moving discs the lidar must see — other robots in a shared world,
        # pedestrians, etc.
        self.moving_obstacles = None  # Optional[Callable[[], list[xy]]]
        self.obstacle_radius = 0.15
        self.map_server = MapServer(bus)
        bus.subscribe("cmd_vel", self._cmd_callback)
        self.publish_map()
        self.publish_state()
        self.publish_scan()

    @property
    def pose(self) -> torch.Tensor:
        """The true pose (x, y, yaw), float32 on the simulator's device."""
        return self._pose

    @pose.setter
    def pose(self, value):
        # a pose written from outside (a kidnap, a relocalization) may be a
        # list, a float64 array or a host tensor: it becomes float32 on the
        # device, as a jnp array is float32 in the JAX package
        self._pose = torch.as_tensor(value, dtype=_F32, device=self.device)

    def _cmd_callback(self, msg: Twist):
        self.cmd = np.array([msg.linear_x, msg.angular_z])

    def publish_map(self):
        """ROS-convention OccupancyGrid exactly as the reference map_server
        publishes it (core/map_server.py:16-20: 0 -> 100 occupied,
        254/205 -> 0 free, int8, flipud)."""
        img = self.map_image.copy().astype(np.int16)
        occ = np.where(img == 0, 100, 0).astype(np.int8)
        self.map_server.publish_map(np.flipud(occ), self.map_info)

    def measured_pose(self) -> np.ndarray:
        """Ground-truth pose corrupted by the localization error budget —
        what the tf chain / odometry consumers observe."""
        pose = self.pose.cpu().numpy().astype(float)
        if self.noise.get("odom_xy") or self.noise.get("odom_yaw"):
            pose = pose + np.array(
                [
                    self._rng.normal(0.0, self.noise.get("odom_xy", 0.0)),
                    self._rng.normal(0.0, self.noise.get("odom_xy", 0.0)),
                    self._rng.normal(0.0, self.noise.get("odom_yaw", 0.0)),
                ]
            )
        return pose

    def publish_state(self):
        x, y, yaw = (float(v) for v in self.measured_pose())
        self.bus.publish(
            "/robot_position",
            Odometry(
                pose=Pose(
                    x=x,
                    y=y,
                    orientation=Quaternion(z=float(np.sin(yaw / 2)), w=float(np.cos(yaw / 2))),
                ),
                twist=Twist(linear_x=float(self.cmd[0]), angular_z=float(self.cmd[1])),
            ),
        )

    def _circle_ranges(self, centers) -> np.ndarray:
        """Analytic ray-circle first-hit distances for the dynamic discs
        (inf where a beam misses every disc or the hit is out of range)."""
        pose = self.pose.cpu().numpy().astype(float)
        beams = pose[2] + (-np.pi) + np.arange(self.n_beams) * (2 * np.pi) / self.n_beams
        d = np.stack([np.cos(beams), np.sin(beams)], axis=1)  # (B, 2)
        out = np.full(self.n_beams, np.inf)
        r2 = self.obstacle_radius**2
        for c in centers:
            rel = np.asarray(c, dtype=float)[:2] - pose[:2]
            along = d @ rel
            perp2 = float(rel @ rel) - along**2
            t = along - np.sqrt(np.maximum(r2 - perp2, 0.0))
            hit = (perp2 < r2) & (t > 0) & (t <= self.max_range)
            out = np.where(hit, np.minimum(out, t), out)
        return out

    def publish_scan(self):
        ranges = (
            lidar_scan(
                self.occupied,
                self.origin,
                self.resolution,
                self.pose,
                self.n_beams,
                -np.pi,
                np.pi,
                self.max_range,
            )
            .cpu()
            .numpy()
        )
        if self.moving_obstacles is not None:
            centers = self.moving_obstacles()
            if centers:
                ranges = np.minimum(ranges, self._circle_ranges(centers))
        if self.noise.get("scan"):
            finite = np.isfinite(ranges)
            ranges = np.where(
                finite,
                ranges * (1.0 + self._rng.normal(0.0, self.noise["scan"], size=ranges.shape)),
                ranges,
            )
        self.bus.publish(
            "/scan",
            LaserScan(ranges=ranges, angle_min=-np.pi, angle_max=np.pi),
        )

    def step(self, dt=None, publish: bool = True):
        """Advance the plant one control period. ``publish=True`` republishes
        sensors immediately (the lock-step sim graph); the wall-clock live
        graph passes ``publish=False`` and paces state/scan on their own
        timers instead (nodes/live.py)."""
        dt = self.params.dt if dt is None else dt
        cmd = self.cmd
        if self.noise.get("cmd"):
            cmd = cmd * (1.0 + self._rng.normal(0.0, self.noise["cmd"], size=2))
        self.pose = plant_step(self.pose, cmd, dt)
        if publish:
            self.publish_state()
            self.publish_scan()
        return self.pose.cpu().numpy()

    def in_collision(self) -> bool:
        (x, y), (ox, oy) = self.pose[:2].tolist(), self.origin.tolist()
        col = int((x - ox) / self.resolution)
        row = self.map_image.shape[0] - 1 - int((y - oy) / self.resolution)
        if not (0 <= row < self.map_image.shape[0] and 0 <= col < self.map_image.shape[1]):
            return True
        return bool(self.map_image[row, col] == 0)
