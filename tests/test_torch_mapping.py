"""The port's occupancy mapping (``ros2_mpc_tpu_torch.ops.mapping`` and
``nodes.mapper``) held against the JAX package's (tests/test_mapper.py) on
the CPU, on the same seeded scans and poses.

Bands. ``logodds_update``: L within 1e-5 on every cell but at most
max(4, 0.05% of H*W) cells a scan, each scan folded into the same prior in
both packages. Those few cells are a march sample on a cell edge landing in
the neighbouring cell: XLA on the CPU contracts the beam angle
``(pose_yaw + angle_min) + i * span * (1/n)`` and the sample point
``x + cos(beam) * t`` into fused multiply-adds, which the port's plain
PyTorch does not, and the CPU's cos/sin may differ from XLA's by an ulp.
``occupancy_probability`` within 1e-6. A ``MapperNode`` fed the same
(scan, pose) pairs: the trinary grid equal on at least 99.9% of the cells.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros2_mpc_tpu.nodes.bus import LaserScan as JLaserScan
from ros2_mpc_tpu.nodes.bus import MessageBus as JBus
from ros2_mpc_tpu.nodes.bus import Odometry as JOdometry
from ros2_mpc_tpu.nodes.bus import Pose as JPose
from ros2_mpc_tpu.nodes.bus import Quaternion as JQuaternion
from ros2_mpc_tpu.nodes.mapper import MapperNode as JMapperNode
from ros2_mpc_tpu.ops import mapping as jmap
from ros2_mpc_tpu_torch.nodes.bus import LaserScan, MessageBus, Odometry, Pose, Quaternion
from ros2_mpc_tpu_torch.nodes.mapper import MapperNode
from ros2_mpc_tpu_torch.nodes.sim import Simulator
from ros2_mpc_tpu_torch.ops import mapping
from ros2_mpc_tpu_torch.utils import pgm

L_ATOL = 1e-5
P_ATOL = 1e-6
MIN_TRINARY_AGREEMENT = 0.999


def max_cells(shape):
    return max(4, int(0.0005 * shape[0] * shape[1]))


def fold_both(L, pose, ranges, n_beams, a_min, a_max, origin, res, max_range):
    """One scan into the same prior ``L`` (numpy) in both packages."""
    j = jmap.logodds_update(
        jnp.asarray(L), jnp.asarray(pose, jnp.float32), jnp.asarray(ranges, jnp.float32),
        n_beams, a_min, a_max, jnp.asarray(origin, jnp.float32), res, max_range,
    )
    t = mapping.logodds_update(
        torch.tensor(L), torch.tensor(pose, dtype=torch.float32), torch.tensor(ranges, dtype=torch.float32),
        n_beams, a_min, a_max, torch.tensor(origin, dtype=torch.float32), res, max_range,
    )
    return np.asarray(j), t.numpy()


def scans(case, rng, n_beams, n):
    """(pose, ranges) pairs of one kind on a 4 m x 4 m grid at (-2, -2)."""
    for _ in range(n):
        if case == "edges":  # near every edge, beams leave the grid
            side = rng.integers(4)
            xy = rng.uniform(-1.9, 1.9, 2)
            xy[side % 2] = (1.9 if side < 2 else -1.9)
        else:
            xy = rng.uniform(-1.5, 1.5, 2)
        pose = np.array([xy[0], xy[1], rng.uniform(-np.pi, np.pi)], np.float32)
        r = rng.uniform(0.2, 2.8, n_beams).astype(np.float32)
        if case == "no_returns":
            r[rng.random(n_beams) < 0.4] = np.inf
            r[rng.random(n_beams) < 0.05] = np.nan
        if case == "beyond_range":
            r[rng.random(n_beams) < 0.4] = rng.uniform(3.0, 6.0)  # past max_range 2.5
        yield pose, r


@pytest.mark.parametrize("case", ["returns", "no_returns", "beyond_range", "edges"])
def test_logodds_update_matches_jax(case):
    rng = np.random.default_rng(["returns", "no_returns", "beyond_range", "edges"].index(case))
    H, res, origin, n_beams, max_range = 80, 0.05, (-2.0, -2.0), 90, 2.5
    L = np.zeros((H, H), np.float32)
    worst = 0
    for pose, r in scans(case, rng, n_beams, 12):
        j, t = fold_both(L, pose, r, n_beams, -np.pi, np.pi, origin, res, max_range)
        off = int((np.abs(j - t) > L_ATOL).sum())
        worst = max(worst, off)
        assert off <= max_cells(L.shape), f"{off} cells apart on one scan"
        L = j  # both continue from the reference's grid
    print(f"{case}: at most {worst} of {H * H} cells apart by more than {L_ATOL} on one scan")
    assert np.abs(L).max() > 0.5  # evidence was deposited
    if case == "beyond_range":  # no phantom wall: nothing reaches the occupied threshold from one scan
        Lt = mapping.logodds_update(
            torch.zeros(H, H), torch.zeros(3), torch.full((n_beams,), 4.0), n_beams, -np.pi, np.pi,
            torch.tensor(origin), res, max_range,
        )
        assert float(Lt.max()) <= 0.0 and float(Lt.min()) < 0.0


def test_logodds_clamp_keeps_map_revisable():
    """tests/test_mapper.py's clamp test, both packages side by side: a wall
    seen 50 times then opened is re-learned; nothing claims occupancy."""
    n_beams, origin = 36, (-2.0, -2.0)
    pose = np.zeros(3, np.float32)
    Lj, Lt = jnp.zeros((80, 80), jnp.float32), torch.zeros(80, 80)

    def fold(ranges):
        j = jmap.logodds_update(Lj, jnp.asarray(pose), jnp.asarray(ranges), n_beams, -0.3, 0.3,
                                jnp.asarray(origin, jnp.float32), 0.05, 3.0)
        t = mapping.logodds_update(Lt, torch.from_numpy(pose), torch.from_numpy(ranges), n_beams, -0.3, 0.3,
                                   torch.tensor(origin), 0.05, 3.0)
        return j, t

    for _ in range(50):
        Lj, Lt = fold(np.full(n_beams, 1.0, np.float32))  # returns at 1 m
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), atol=L_ATOL)
    wall_cell = np.unravel_index(int(torch.argmax(Lt)), Lt.shape)
    assert float(mapping.occupancy_probability(Lt)[wall_cell]) > 0.95
    assert float(Lt.max()) == 8.0  # the clamp
    for _ in range(50):
        Lj, Lt = fold(np.full(n_beams, np.inf, np.float32))  # no returns
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), atol=L_ATOL)
    p = mapping.occupancy_probability(Lt)
    assert float(p[wall_cell]) < 0.35, "evidence not revisable"
    assert not bool((p > 0.5).any())


def test_occupancy_probability_matches_jax():
    L = np.random.default_rng(3).uniform(-8.0, 8.0, (64, 64)).astype(np.float32)
    np.testing.assert_allclose(
        mapping.occupancy_probability(torch.from_numpy(L)).numpy(),
        np.asarray(jmap.occupancy_probability(jnp.asarray(L))),
        atol=P_ATOL,
    )


def sim_scans(n=20):
    """(ranges, pose) from the port's simulator (360 beams, synthetic map)
    along a seeded walk through the lower room."""
    bus = MessageBus()
    sim = Simulator(bus, pgm.synthetic_indoor_map(), dict(pgm.DEFAULT_MAP_INFO), device="cpu")
    rng = np.random.default_rng(7)
    out = []
    for k in range(n):
        pose = np.array([-1.5 + 0.15 * k, -1.0 + rng.uniform(-0.3, 0.3), rng.uniform(-np.pi, np.pi)], np.float32)
        sim.pose = torch.from_numpy(pose)
        sim.publish_scan()
        out.append((np.asarray(bus.latest("/scan")[0].ranges), pose))
    return out


def publish(bus, scan_cls, odom_cls, pose_cls, quat_cls, ranges, pose):
    yaw = float(pose[2])
    bus.publish("/scan", scan_cls(ranges=ranges, angle_min=-np.pi, angle_max=np.pi))
    bus.publish(
        "/robot_position",
        odom_cls(pose=pose_cls(x=float(pose[0]), y=float(pose[1]),
                               orientation=quat_cls(z=float(np.sin(yaw / 2)), w=float(np.cos(yaw / 2))))),
    )


def test_mapper_node_matches_jax():
    bt, bj = MessageBus(), JBus()
    node = MapperNode(bt, size_m=6.0, resolution=0.05, device="cpu")
    jnode = JMapperNode(bj, size_m=6.0, resolution=0.05)
    assert node.tick()["status"] == "waiting_for_sensors"
    worst = 0
    for ranges, pose in sim_scans(20):
        publish(bt, LaserScan, Odometry, Pose, Quaternion, ranges, pose)
        publish(bj, JLaserScan, JOdometry, JPose, JQuaternion, ranges, pose)
        assert node.tick() == jnode.tick()
        worst = max(worst, int((np.abs(node.L.numpy() - np.asarray(jnode.L)) > L_ATOL).sum()))
    occ, jocc = node.occupancy(), jnode.occupancy()
    agree = float((occ == jocc).mean())
    print(f"trinary agreement {agree:.6f}; at most {worst} cells apart by more than {L_ATOL} after a scan")
    assert agree >= MIN_TRINARY_AGREEMENT
    assert (occ == 100).sum() > 50 and (occ == 0).sum() > 500  # walls and free space were mapped
    same = np.abs(node.L.numpy() - np.asarray(jnode.L)) <= L_ATOL
    np.testing.assert_allclose(node.probability()[same], jnode.probability()[same], atol=P_ATOL)
    node.publish()
    jnode.publish()
    msg, jmsg = bt.latest("mapped_map")[0], bj.latest("mapped_map")[0]
    assert msg.data.shape == jmsg.data.shape == (120, 120) and msg.data.dtype == jmsg.data.dtype
    assert msg.info == type(msg.info)(**vars(jmsg.info)) and msg.frame_id == jmsg.frame_id
    assert float((msg.data == jmsg.data).mean()) >= MIN_TRINARY_AGREEMENT


def test_mapper_needs_a_device_or_cpu():
    """``device=None`` is the card: without one the node refuses."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MapperNode(MessageBus())


def test_mapper_stack_with_an_offset_grid_matches_jax():
    """build_sim_stack(map_source='mapper', mapper_kwargs=...) with a grid
    that is not centered on the world origin and a shorter range, beside
    the JAX stack: the same grid and /map metadata, and the trinary grid
    equal on at least 99.9% of the cells after the same five scans. Only
    the map source ticks (no solve)."""
    from ros2_mpc_tpu.nodes.launch import build_sim_stack as jax_stack
    from ros2_mpc_tpu_torch.nodes.launch import build_sim_stack

    kw = dict(
        follower="point", start_pose=(-1.0, -1.0, 0.0), horizon=12, map_source="mapper",
        mapper_kwargs=dict(size_m=10.0, origin_xy=(-3.0, -6.5), max_range=3.0),
    )
    js, ts = jax_stack(**kw), build_sim_stack(device="cpu", **kw)
    assert ts.mapper.L.shape == tuple(js.mapper.L.shape) == (200, 200)
    assert ts.mapper.max_range == js.mapper.max_range == 3.0
    np.testing.assert_array_equal(ts.mapper.origin, js.mapper.origin)
    rng = np.random.default_rng(3)
    for _ in range(5):  # the fifth map-source tick publishes /map
        pose = np.array([-1.4 + rng.uniform(0, 2.4), -1.0 + rng.uniform(-0.3, 0.3), rng.uniform(-np.pi, np.pi)])
        js.sim.pose = jnp.asarray(pose, dtype=float)
        ts.sim.pose = torch.tensor(pose, dtype=torch.float32)
        for s in (js, ts):
            s.sim.publish_state()
            s.sim.publish_scan()
            s.map_server.tick()
    msg, jmsg = ts.bus.latest("/map")[0], js.bus.latest("/map")[0]
    assert msg.info == type(msg.info)(**vars(jmsg.info))
    assert (msg.info.origin_x, msg.info.origin_y, msg.info.width) == (-3.0, -6.5, 200)
    agree = float((msg.data == jmsg.data).mean())
    print(f"trinary agreement {agree:.6f}")
    assert agree >= MIN_TRINARY_AGREEMENT
    assert (msg.data == 100).sum() > 50 and (msg.data == 0).sum() > 500
