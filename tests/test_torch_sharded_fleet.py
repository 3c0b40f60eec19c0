"""The port's sharded fleets (``make_sharded_*`` of
``ros2_mpc_tpu_torch.parallel.fleet``) against the port's unsharded rollouts
and the JAX package's sharded ones (``tests/test_parallel.py:235-329``,
``test_swarm.py:68-90``, ``test_tracking_fleet.py:140-157``) on the CPU.

The mesh is eight CPU shards against the JAX suite's eight virtual devices,
and both packages build their fleets from one seed. Bands: sharded against
unsharded at the JAX suite's own 1e-5 (robots are independent, and the
swarm's gathered table holds the same numbers as the unsharded one);
against the JAX package's rollouts 2e-3 on the states, the band the JAX
suite holds its own engines to inside a closed loop
(``tests/test_tracking_fleet.py:107-112``), with equal reach fractions.
On the card the sharded and unsharded rollouts are bit-equal
(``chip_smoke.py``'s scale phase and the ``cuda`` test below).
"""

import numpy as np
import pytest
import torch

from ros2_mpc_tpu import solver as js
from ros2_mpc_tpu.config import Params as JParams
from ros2_mpc_tpu.parallel import fleet as jf
from ros2_mpc_tpu.parallel import mesh as jmesh
from ros2_mpc_tpu_torch import solver as ts
from ros2_mpc_tpu_torch.config import Params as TParams
from ros2_mpc_tpu_torch.parallel import fleet as tf
from ros2_mpc_tpu_torch.parallel import mesh as tmesh

J_PARAMS, T_PARAMS = JParams(), TParams()
DT = T_PARAMS.dt
FAST = dict(barrier_stages=3, iters_per_stage=3, n_alphas=6)
SWARM = dict(barrier_stages=4, iters_per_stage=3, n_alphas=6)
SHARD_ATOL, TRAJ_ATOL = 1e-5, 2e-3
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run small tensors through many ops; under the suite's
    parallel workers PyTorch's default thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


def _point(horizon, settings, corrected=False):
    kw = dict(horizon=horizon, reference_parity=not corrected)
    return (
        js.make_point_stabilization(J_PARAMS, settings=js.SolverSettings(**settings), **kw),
        ts.make_point_stabilization(T_PARAMS, settings=ts.SolverSettings(**settings), device=CPU, **kw),
    )


def _jshard(mesh, *trees):
    return [jmesh.shard_bank(t, mesh) for t in trees]


def test_sharded_fleet_rollout_matches_unsharded_and_jax():
    """test_sharded_fleet_rollout_matches_unsharded: the point fleet (K1's
    plain version a tick) on eight shards against one rollout of the whole
    fleet, and against the JAX package's sharded rollout."""
    jp, tp = _point(6, FAST)
    B, n_ticks = 32, 6
    jth, jU = jf.random_fleet(jp, B, seed=5, spread=0.8)
    tth, tU = tf.random_fleet(tp, B, seed=5, spread=0.8, device=CPU)
    plain = tf.make_fleet_rollout(tp, n_ticks, DT, device=CPU)(tth, tU)
    mesh = tmesh.make_mesh(device=CPU)
    roll = tf.make_sharded_fleet_rollout(tp, mesh, n_ticks, DT)
    res = roll(tmesh.shard_bank(tth, mesh), tmesh.shard_bank(tU, mesh))
    assert len(res.final_states.shards) == 8 and roll.engines[0].launches == 0  # plain versions on the CPU
    xs = res.final_states.gather(CPU)
    np.testing.assert_allclose(_np(xs), _np(plain.final_states), atol=SHARD_ATOL)
    np.testing.assert_allclose(float(res.reach_fraction), float(plain.reach_fraction), atol=1e-6)
    np.testing.assert_allclose(float(res.mean_dist), float(plain.mean_dist), atol=SHARD_ATOL)
    np.testing.assert_allclose(_np(res.goal_dist.gather(CPU)), _np(plain.goal_dist), atol=SHARD_ATOL)
    jm = jmesh.make_mesh()
    jres = jf.make_sharded_fleet_rollout(jp, jm, n_ticks, DT)(*_jshard(jm, jth, jU))
    np.testing.assert_allclose(_np(xs), np.asarray(jres.final_states), atol=TRAJ_ATOL)
    assert float(res.reach_fraction) == float(jres.reach_fraction)


def test_sharded_fleet_records_trajectories_fast_engine():
    """test_sharded_fleet_rollout_fast_engine_records_trajectories: the
    (T+1, B, 3) trace is sharded along the robot axis, gathers whole, and
    every robot moves; it equals the unsharded trace."""
    _, tp = _point(6, FAST)
    B = 64
    tth, tU = tf.random_fleet(tp, B, seed=6, spread=0.8, device=CPU)
    mesh = tmesh.make_mesh(device=CPU)
    res = tf.make_sharded_fleet_rollout(tp, mesh, n_ticks=4, dt=DT, record=True, engine="fast")(tth, tU)
    assert res.trajectories.dim == 1 and tuple(res.trajectories.shards[0].shape) == (5, 8, 3)
    traj = _np(res.trajectories.gather(CPU))
    assert traj.shape == (5, B, 3) and np.all(np.isfinite(traj))
    assert np.all(np.linalg.norm(traj[-1, :, :2] - traj[0, :, :2], axis=-1) > 1e-4)
    plain = tf.make_fleet_rollout(tp, 4, DT, record=True, engine="fast", device=CPU)(tth, tU)
    np.testing.assert_allclose(traj, _np(plain.trajectories), atol=SHARD_ATOL)


def test_sharded_swarm_matches_unsharded_and_jax():
    """test_swarm.py::test_sharded_swarm_matches_unsharded: every tick the
    eight shards gather the fleet's positions and velocities and search
    their robots' neighbors against the global table (self excluded by the
    global index); final states and minimum separation as the unsharded
    swarm and as the JAX package's sharded swarm."""
    jp, tp = _point(8, SWARM, corrected=True)
    B, n_ticks = 16, 8
    jth, jU = jf.circle_swarm(jp, B=B, radius=1.5)
    tth, tU = tf.circle_swarm(tp, B=B, radius=1.5, device=CPU)
    plain = tf.make_swarm_rollout(tp, n_ticks, DT, k_neighbors=3, device=CPU)(tth, tU)
    mesh = tmesh.make_mesh(device=CPU)
    res = tf.make_sharded_swarm_rollout(tp, mesh, n_ticks, DT, k_neighbors=3)(tth, tU)
    xs = res.final_states.gather(CPU)
    np.testing.assert_allclose(_np(xs), _np(plain.final_states), atol=SHARD_ATOL)
    np.testing.assert_allclose(float(res.min_separation), float(plain.min_separation), atol=SHARD_ATOL)
    np.testing.assert_allclose(float(res.mean_dist), float(plain.mean_dist), atol=SHARD_ATOL)
    jm = jmesh.make_mesh()
    jres = jf.make_sharded_swarm_rollout(jp, jm, n_ticks, DT, k_neighbors=3)(*_jshard(jm, jth, jU))
    np.testing.assert_allclose(_np(xs), np.asarray(jres.final_states), atol=TRAJ_ATOL)
    np.testing.assert_allclose(float(res.min_separation), float(jres.min_separation), atol=TRAJ_ATOL)


def test_sharded_tracking_fleet_matches_unsharded_and_jax():
    """test_tracking_fleet.py::test_sharded_tracking_fleet_matches_unsharded:
    the tracking fleet (K2's plain version a tick, handoff and latch on) on
    eight shards against the unsharded rollout and the JAX package's
    sharded rollout; the trajectories recorded on both."""
    N = 8
    kw = dict(horizon=N, reference_parity=False)
    jp = js.make_tracking(J_PARAMS, settings=js.SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6), **kw)
    tp = ts.make_tracking(T_PARAMS, settings=ts.SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6), device=CPU, **kw)
    B, n_ticks = 32, 6
    jth, jpaths, jU = jf.arc_path_fleet(jp, B=B, n_waypoints=32, seed=5)
    tth, tpaths, tU = tf.arc_path_fleet(tp, B=B, n_waypoints=32, seed=5, device=CPU)
    plain = tf.make_tracking_fleet_rollout(tp, n_ticks, DT, record=True, device=CPU)(tth, tpaths, tU)
    mesh = tmesh.make_mesh(device=CPU)
    res = tf.make_sharded_tracking_fleet_rollout(tp, mesh, n_ticks, DT, record=True)(tth, tpaths, tU)
    xs = res.final_states.gather(CPU)
    np.testing.assert_allclose(_np(xs), _np(plain.final_states), atol=SHARD_ATOL)
    np.testing.assert_allclose(_np(res.trajectories.gather(CPU)), _np(plain.trajectories), atol=SHARD_ATOL)
    np.testing.assert_allclose(float(res.mean_cross_track), float(plain.mean_cross_track), atol=SHARD_ATOL)
    assert float(res.max_cross_track) == float(plain.max_cross_track)
    assert float(res.reach_fraction) == float(plain.reach_fraction)
    jm = jmesh.make_mesh(8)
    jres = jf.make_sharded_tracking_fleet_rollout(jp, jm, n_ticks, DT)(*_jshard(jm, jth, jpaths, jU))
    np.testing.assert_allclose(_np(xs), np.asarray(jres.final_states), atol=TRAJ_ATOL)
    np.testing.assert_allclose(float(res.mean_cross_track), float(jres.mean_cross_track), atol=TRAJ_ATOL)


def test_sharded_fleets_validate_mesh_and_problem():
    """The sharded swarm takes a 1D mesh and a fleet larger than k; the
    sharded fleets refuse the other fleet's problems, as the unsharded do;
    a fleet that does not divide over the mesh raises."""
    _, tp = _point(4, FAST, corrected=True)
    trk = ts.make_tracking(T_PARAMS, horizon=4, device=CPU)
    mesh = tmesh.make_mesh(4, device=CPU)
    with pytest.raises(ValueError, match="1D mesh"):
        tf.make_sharded_swarm_rollout(tp, tmesh.make_host_chip_mesh(2, 2, device=CPU), 2, DT)
    with pytest.raises(ValueError, match="tracking"):
        tf.make_sharded_fleet_rollout(trk, mesh, 2, DT)
    with pytest.raises(ValueError, match="tracking problem"):
        tf.make_sharded_tracking_fleet_rollout(tp, mesh, 2, DT)
    tth, tU = tf.circle_swarm(tp, B=4, device=CPU)
    with pytest.raises(ValueError, match="must be < fleet size 4"):
        tf.make_sharded_swarm_rollout(tp, mesh, 2, DT, k_neighbors=4)(tth, tU)
    th6, U6 = tf.random_fleet(tp, 6, device=CPU)
    with pytest.raises(ValueError, match="B=6"):
        tf.make_sharded_fleet_rollout(tp, mesh, 2, DT)(th6, U6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card (python3 chip_smoke.py)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_sharded_fleets_bit_equal_to_unsharded_on_the_card(cuda_device):
    """On the card the per-scenario kernels and elementwise ticks give the
    sharded fleets, four shards of one card, the unsharded fleets' final
    states bit for bit, with no host sync inside the rollouts."""
    dev, rt = cuda_device, ts.SolverSettings.realtime()
    mesh = tmesh.make_mesh(4, device=dev)
    tp = ts.make_point_stabilization(T_PARAMS, horizon=20, settings=rt, reference_parity=False, device=dev)
    trk = ts.make_tracking(T_PARAMS, horizon=20, settings=rt, reference_parity=False, terminal_weight=(10.0, 10.0, 1.0), device=dev)
    th, U = tf.random_fleet(tp, 64, seed=0, device=dev)
    th_sw, U_sw = tf.grid_swap_swarm(tp, side=8, device=dev)
    th_t, paths, U_t = tf.arc_path_fleet(trk, 64, n_waypoints=64, seed=0, device=dev)
    for plain, sharded, args in (
        (tf.make_fleet_rollout(tp, 8, DT, device=dev), tf.make_sharded_fleet_rollout(tp, mesh, 8, DT), (th, U)),
        (tf.make_swarm_rollout(tp, 8, DT, device=dev), tf.make_sharded_swarm_rollout(tp, mesh, 8, DT), (th_sw, U_sw)),
        (tf.make_tracking_fleet_rollout(trk, 8, DT, device=dev), tf.make_sharded_tracking_fleet_rollout(trk, mesh, 8, DT), (th_t, paths, U_t)),
    ):
        ref = plain(*args)
        sharded(*args)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = sharded(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(out.final_states.gather(dev), ref.final_states)
