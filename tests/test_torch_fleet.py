"""The port's fleets (``ros2_mpc_tpu_torch.parallel.fleet``) against the JAX
package's (``tests/test_tracking_fleet.py``, ``test_swarm.py``,
``test_parallel.py``) on the CPU.

Both packages build their fleets from one seed (the scenario builders draw
the same numpy numbers), and the port's rollouts tick K1/K2's plain versions
(``engine="cuda"`` on CPU tensors) where the JAX package's tick
``vmap(make_solver)``. Bands: the reference windows within 1e-6 of both the
JAX window and the port's host helper; trajectories within 2e-3, the band the
JAX suite holds its own engines to inside a closed loop
(``tests/test_tracking_fleet.py:107-112``), and equal reach fractions.

``torch.topk`` and ``lax.top_k`` may order tied distances differently, and
the neighbor order sets the obstacle-slot order: the swarm cases use the
builders' jittered starts, which have no ties.
"""

import numpy as np
import pytest
import torch

from ros2_mpc_tpu import solver as js
from ros2_mpc_tpu.config import Params as JParams
from ros2_mpc_tpu.parallel import fleet as jf
from ros2_mpc_tpu_torch import solver as ts
from ros2_mpc_tpu_torch.config import Params as TParams
from ros2_mpc_tpu_torch.convert import theta_from_numpy
from ros2_mpc_tpu_torch.parallel import fleet as tf
from ros2_mpc_tpu_torch.solver import packed

J_PARAMS, T_PARAMS = JParams(), TParams()
DT = T_PARAMS.dt
J_FAST = js.SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6)
T_FAST = ts.SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6)
N = 8
TRAJ_ATOL = 2e-3
WINDOW_ATOL = 1e-6


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


def _point(corrected=True):
    return (
        js.make_point_stabilization(J_PARAMS, horizon=N, settings=J_FAST, reference_parity=not corrected),
        ts.make_point_stabilization(T_PARAMS, horizon=N, settings=T_FAST, reference_parity=not corrected, device="cpu"),
    )


def _tracking(**kw):
    return (
        js.make_tracking(J_PARAMS, horizon=N, settings=J_FAST, reference_parity=False, **kw),
        ts.make_tracking(T_PARAMS, horizon=N, settings=T_FAST, reference_parity=False, device="cpu", **kw),
    )


def _assert_same_bank(jbank, tbank):
    assert set(jbank) == set(tbank)
    for k in jbank:
        np.testing.assert_array_equal(_np(tbank[k]), np.asarray(jbank[k]), err_msg=k)


def test_tracking_window_matches_jax_and_host_reference_gen():
    """The device window generator against the JAX package's in-jit one and
    the port's host helper (anchor choice, clamping, the 0.5 m terminal
    latch), three robots on one path at once."""
    import jax
    import jax.numpy as jnp

    from ros2_mpc_tpu_torch.nodes.reference_gen import tracking_reference_window

    P = 20
    t = np.linspace(0, 2.0, P)
    wps = np.stack([t, 0.3 * np.sin(t)], axis=1)
    yaw = np.arctan2(np.gradient(wps[:, 1]), np.gradient(wps[:, 0]))
    speed = np.full(P, 0.15)
    omega = np.gradient(yaw) / 2
    goal = np.array([wps[-1, 0], wps[-1, 1], yaw[-1]])
    pos = np.stack([[0.3, 0.1], [1.4, -0.2], wps[-1] + 0.05])
    R = pos.shape[0]
    tile = lambda a: np.repeat(a[None], R, axis=0)  # noqa: E731
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    x_dev, u_dev, ct = tf._tracking_window(
        f32(pos), f32(tile(goal)), f32(tile(wps)), f32(tile(yaw)), f32(tile(speed)), f32(tile(omega)), N
    )
    jargs = [jnp.asarray(a, dtype=jnp.float32) for a in (goal, wps, yaw, speed, omega)]
    jx, ju, jct = jax.vmap(lambda p: jf._tracking_window(p, *jargs, N))(jnp.asarray(pos, dtype=jnp.float32))
    np.testing.assert_allclose(_np(x_dev), np.asarray(jx), atol=WINDOW_ATOL)
    np.testing.assert_allclose(_np(u_dev), np.asarray(ju), atol=WINDOW_ATOL)
    np.testing.assert_allclose(_np(ct), np.asarray(jct), atol=WINDOW_ATOL)
    for r in range(R):
        x_host, u_host = tracking_reference_window(
            np.array([pos[r, 0], pos[r, 1], 0.0]), goal, wps, yaw, speed, omega, horizon=N
        )
        np.testing.assert_allclose(_np(x_dev[r]).ravel(), x_host.ravel(), atol=WINDOW_ATOL)
        if np.linalg.norm(pos[r] - wps[-1]) < 0.5:
            # the corrected-mode deviation: park (zero u_ref) inside the latch
            np.testing.assert_allclose(_np(u_dev[r]), 0.0, atol=WINDOW_ATOL)
        else:
            np.testing.assert_allclose(_np(u_dev[r]).ravel(), u_host.ravel(), atol=WINDOW_ATOL)
        np.testing.assert_allclose(float(ct[r]), np.linalg.norm(wps - pos[r], axis=1).min(), atol=WINDOW_ATOL)


def test_point_fleet_matches_jax():
    jp, tp = _point()
    jth, jU = jf.random_fleet(jp, 12, seed=1)
    tth, tU = tf.random_fleet(tp, 12, seed=1, device="cpu")
    _assert_same_bank(jth, tth)
    jo = jf.make_fleet_rollout(jp, 6, DT, record=True)(jth, jU)
    to = tf.make_fleet_rollout(tp, 6, DT, record=True, device="cpu")(tth, tU)
    assert to.trajectories.shape == (7, 12, 3)
    np.testing.assert_allclose(_np(to.trajectories), np.asarray(jo.trajectories), atol=TRAJ_ATOL)
    assert float(to.reach_fraction) == float(jo.reach_fraction)
    np.testing.assert_allclose(float(to.mean_dist), float(jo.mean_dist), atol=TRAJ_ATOL)


def test_tracking_fleet_matches_jax_with_handoff_and_latch():
    """Robot 0 starts inside the 0.15 m goal latch (it must never move),
    robot 1 inside the 0.35 m parking handoff but outside the latch; the
    rest follow their arcs. The corrected OCP wraps the plant's yaw."""
    jt, tt = _tracking(terminal_weight=(10.0, 10.0, 1.0))
    B = 10
    jth, jpaths, jU = jf.arc_path_fleet(jt, B, n_waypoints=24, seed=2)
    tth, tpaths, tU = tf.arc_path_fleet(tt, B, n_waypoints=24, seed=2, device="cpu")
    _assert_same_bank(jth, tth)
    _assert_same_bank(jpaths, tpaths)
    paths = {k: np.asarray(v) for k, v in jpaths.items()}
    x0 = np.asarray(jth["x0"]).copy()
    x0[0, :2] = paths["wps"][0, -1] + [0.08, -0.05]  # 0.094 m from the goal
    x0[1, :2] = paths["wps"][1, -1] + [0.2, 0.15]  # 0.25 m
    jth = dict(jth, x0=x0)
    tth = dict(tth, **theta_from_numpy({"x0": x0}, device="cpu"))
    tpaths = theta_from_numpy(paths, device="cpu")
    jo = jf.make_tracking_fleet_rollout(jt, 8, DT, record=True, goal_threshold=0.25)(jth, jpaths, jU)
    to = tf.make_tracking_fleet_rollout(tt, 8, DT, record=True, goal_threshold=0.25, device="cpu")(tth, tpaths, tU)
    traj = _np(to.trajectories)
    np.testing.assert_allclose(traj, np.asarray(jo.trajectories), atol=TRAJ_ATOL)
    np.testing.assert_array_equal(traj[:, 0], np.repeat(x0[None, 0].astype(np.float32), 9, axis=0))  # latched
    assert np.abs(traj[-1, 1] - traj[0, 1]).max() > 1e-3  # the handoff robot drives
    assert float(to.reach_fraction) == float(jo.reach_fraction)
    for f in ("mean_cross_track", "max_cross_track"):
        np.testing.assert_allclose(float(getattr(to, f)), float(getattr(jo, f)), atol=TRAJ_ATOL)


def test_tracking_fleet_without_handoff_matches_jax():
    jt, tt = _tracking()
    jth, jpaths, jU = jf.arc_path_fleet(jt, 8, n_waypoints=32, seed=3)
    tth, tpaths, tU = tf.arc_path_fleet(tt, 8, n_waypoints=32, seed=3, device="cpu")
    jo = jf.make_tracking_fleet_rollout(jt, 6, DT, record=True, handoff_radius=None)(jth, jpaths, jU)
    to = tf.make_tracking_fleet_rollout(tt, 6, DT, record=True, handoff_radius=None, device="cpu")(tth, tpaths, tU)
    np.testing.assert_allclose(_np(to.trajectories), np.asarray(jo.trajectories), atol=TRAJ_ATOL)
    np.testing.assert_allclose(float(to.mean_cross_track), float(jo.mean_cross_track), atol=TRAJ_ATOL)


@pytest.mark.parametrize("builder", ["circle", "grid"])
def test_swarm_matches_jax(builder):
    jp, tp = _point()
    if builder == "circle":
        jth, jU = jf.circle_swarm(jp, 8, radius=1.5)
        tth, tU = tf.circle_swarm(tp, 8, radius=1.5, device="cpu")
    else:
        jth, jU = jf.grid_swap_swarm(jp, side=4, pitch=1.0)
        tth, tU = tf.grid_swap_swarm(tp, side=4, pitch=1.0, device="cpu")
    _assert_same_bank(jth, tth)
    jo = jf.make_swarm_rollout(jp, 6, DT, k_neighbors=3, record=True)(jth, jU)
    to = tf.make_swarm_rollout(tp, 6, DT, k_neighbors=3, record=True, device="cpu")(tth, tU)
    np.testing.assert_allclose(_np(to.trajectories), np.asarray(jo.trajectories), atol=TRAJ_ATOL)
    np.testing.assert_allclose(float(to.min_separation), float(jo.min_separation), atol=TRAJ_ATOL)
    assert float(to.reach_fraction) == float(jo.reach_fraction)


def test_generic_bicycle_fleet_matches_jax():
    """The generic fleet on the kinematic bicycle, the OCP's own transition
    as the plant: the port's generic bank engine against the JAX package's
    (8 lanes) over 6 ticks."""
    jb = js.make_bicycle_point_stabilization(J_PARAMS, horizon=N, settings=J_FAST)
    tb = ts.make_bicycle_point_stabilization(T_PARAMS, horizon=N, settings=T_FAST, device="cpu")
    rng = np.random.default_rng(4)
    x0 = np.c_[rng.uniform(-0.2, 0.2, (8, 2)), rng.uniform(-0.5, 0.5, (8, 1))]
    goal = np.c_[rng.uniform(-0.9, 0.9, (8, 2)), rng.uniform(-0.5, 0.5, (8, 1))]
    import jax

    jth = jax.vmap(jb.make_theta)(x0.astype(np.float32), goal.astype(np.float32))
    tth = theta_from_numpy({k: np.asarray(v) for k, v in jth.items()}, device="cpu")
    U0 = np.zeros((8, N, 2), np.float32)
    jo = jf.make_generic_fleet_rollout(jb, 6, record=True, engine="fast", lanes=8)(jth, U0)
    to = tf.make_generic_fleet_rollout(tb, 6, record=True, device="cpu")(tth, torch.zeros(8, N, 2))
    np.testing.assert_allclose(_np(to.trajectories), np.asarray(jo.trajectories), atol=TRAJ_ATOL)
    assert float(to.reach_fraction) == float(jo.reach_fraction)


def test_swarm_validates_slots_and_fleet_size():
    _, tp = _point()
    tp6 = ts.make_point_stabilization(T_PARAMS, horizon=6, settings=T_FAST, reference_parity=False, device="cpu")
    thetas, U0 = tf.circle_swarm(tp6, B=4, radius=1.0, device="cpu")
    with pytest.raises(ValueError, match="fleet size"):
        tf.make_swarm_rollout(tp6, n_ticks=2, dt=DT, k_neighbors=4, device="cpu")(thetas, U0)
    with pytest.raises(ValueError, match="obstacle slots"):
        tf.make_swarm_rollout(
            tp6, n_ticks=2, dt=DT, k_neighbors=2, predict_taus=tuple(0.1 * i for i in range(200)), device="cpu"
        )(thetas, U0)
    with pytest.raises(ValueError, match="k_neighbors"):
        tf.make_swarm_rollout(tp, n_ticks=2, dt=DT, k_neighbors=0, device="cpu")
    with pytest.raises(ValueError, match="predict_taus"):
        tf.make_swarm_rollout(tp, n_ticks=2, dt=DT, predict_taus=(), device="cpu")
    with pytest.raises(ValueError, match="even"):
        tf.grid_swap_swarm(tp, side=3, device="cpu")


def test_fleet_rollout_validates_engine_and_problem():
    """Mismatched engine and problem fail loudly, as the JAX
    package's (test_parallel.py:291-312), and nothing swaps "cuda" for
    another engine."""
    _, tp = _point()
    with pytest.raises(ValueError, match="pallas"):
        tf.make_fleet_rollout(tp, n_ticks=4, dt=DT, engine="pallas", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        tf.make_fleet_rollout(tp, n_ticks=4, dt=DT, engine="xla", device="cpu")
    trk = ts.make_tracking(T_PARAMS, horizon=6, device="cpu")
    with pytest.raises(ValueError, match="tracking"):
        tf.make_fleet_rollout(trk, n_ticks=4, dt=DT, device="cpu")
    with pytest.raises(ValueError, match="tracking"):
        tf.make_tracking_fleet_rollout(tp, n_ticks=4, dt=DT, device="cpu")
    with pytest.raises(ValueError, match="tracking"):
        tf.make_generic_fleet_rollout(trk, n_ticks=4, device="cpu")
    with pytest.raises(ValueError, match="generic fleet"):
        tf.make_generic_fleet_rollout(tp, n_ticks=4, engine="cuda", device="cpu")
    legacy = ts.make_legacy_point_stabilization(T_PARAMS, horizon=6, device="cpu")
    with pytest.raises(ValueError, match="K1"):
        tf.make_fleet_rollout(legacy, n_ticks=4, dt=DT, device="cpu")
    trk_term = ts.make_tracking(T_PARAMS, horizon=6, terminal_weight=(1.0, 1.0, 0.5), device="cpu")
    assert "terminal_cost" in trk_term.tags


def test_fleet_engines_and_launches_per_tick():
    """engine="cuda" is K1 (point fleet, swarm) and K2 (tracking fleet), one
    CudaBankSolver a rollout, called once a tick: on the card one launch a
    tick; on CPU tensors its plain version, so its launch counter stays 0."""
    from ros2_mpc_tpu_torch.solver.cuda_kernel import CudaBankSolver

    _, tp = _point()
    _, tt = _tracking()
    kinds = {
        "point_stab": tf.make_fleet_rollout(tp, 3, DT, device="cpu"),
        "tracking": tf.make_tracking_fleet_rollout(tt, 3, DT, device="cpu"),
    }
    kinds["point_stab swarm"] = tf.make_swarm_rollout(tp, 3, DT, device="cpu")
    for kind, roll in kinds.items():
        (engine,) = roll.engines
        assert isinstance(engine, CudaBankSolver) and engine.kind == kind.split()[0]
    k1, calls = kinds["point_stab"].engines[0], []

    def counting(ocp, settings):
        def solve(thetas, U0s):
            calls.append(thetas["x0"].shape[0])
            return k1(thetas, U0s)

        return solve

    th, U0 = tf.random_fleet(tp, 4, seed=0, device="cpu")
    out = tf.make_fleet_rollout(tp, 3, DT, engine=counting, device="cpu")(th, U0)
    ref = kinds["point_stab"](th, U0)
    assert calls == [4, 4, 4] and k1.launches == 0
    assert torch.equal(out.final_states, ref.final_states)


def test_fleet_loops_never_read_the_device_back(monkeypatch):
    """A fleet's tick loop makes no host read of a tensor: every rollout runs
    here with the generic bank engine (whose CPU path has no read back
    either) while Tensor.item, __bool__, __float__, __int__, tolist, numpy
    and nonzero raise. On the card chip_smoke.py holds the K1/K2 rollouts to
    the same under torch.cuda.set_sync_debug_mode("error")."""
    _, tp = _point()
    _, tt = _tracking(terminal_weight=(10.0, 10.0, 1.0))
    jobs = []
    th, U0 = tf.random_fleet(tp, 4, seed=0, device="cpu")
    jobs.append((tf.make_fleet_rollout(tp, 2, DT, engine="fast", record=True, device="cpu"), (th, U0)))
    th, U0 = tf.circle_swarm(tp, 6, radius=1.0, device="cpu")
    jobs.append((tf.make_swarm_rollout(tp, 2, DT, k_neighbors=2, engine="fast", device="cpu"), (th, U0)))
    th, paths, U0 = tf.arc_path_fleet(tt, 4, n_waypoints=16, seed=0, device="cpu")
    jobs.append((tf.make_tracking_fleet_rollout(tt, 2, DT, engine="fast", device="cpu"), (th, paths, U0)))
    q = ts.make_quadrotor_hover(horizon=4, settings=T_FAST, device="cpu")
    xq = torch.zeros(3, 12)
    xq[:, 0] = torch.tensor([0.1, -0.2, 0.3])
    th = torch.func.vmap(q.make_theta)(xq, torch.tensor([[0.3, 0.0, 0.1, 0.0]] * 3))
    jobs.append((tf.make_generic_fleet_rollout(q, 2, device="cpu"), (th, q.default_u0.repeat(3, 1, 1))))
    for roll, args in jobs:  # warm-up: build-time probes may read tensors
        roll(*args)

    def refuse(*a, **k):
        raise AssertionError("a fleet tick read a tensor back to the host")

    for name in ("item", "__bool__", "__float__", "__int__", "tolist", "numpy", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)
    outs = [roll(*args) for roll, args in jobs]
    monkeypatch.undo()
    for out in outs:
        assert torch.isfinite(out.final_states).all()


def test_entry_points_run_on_the_card_by_default(monkeypatch):
    """device=None is the card: without one the rollouts, the scenario
    builders and device_tick_rate raise rather than fall back."""
    _, tp = _point()
    _, tt = _tracking()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (
        lambda: tf.make_fleet_rollout(tp, 2, DT),
        lambda: tf.make_tracking_fleet_rollout(tt, 2, DT),
        lambda: tf.make_swarm_rollout(tp, 2, DT),
        lambda: tf.make_generic_fleet_rollout(tp, 2),
        lambda: tf.random_fleet(tp, 4),
        lambda: tf.circle_swarm(tp, 4),
        lambda: tf.grid_swap_swarm(tp, side=2),
        lambda: tf.arc_path_fleet(tt, 4),
        lambda: packed.device_tick_rate(tp, n_ticks=1),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_device_tick_rate_on_the_named_cpu():
    """device_tick_rate runs K1 on random_fleet(B=1024) and returns seconds a
    tick; on the CPU only where the caller names it (the plain version)."""
    _, tp = _point()
    s = packed.device_tick_rate(tp, n_ticks=1, dt=DT, device="cpu")
    assert 0.0 < s < 60.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card (python3 chip_smoke.py)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_fleet_kernel_calls_match_plain_on_the_card(cuda_device):
    """Every K1/K2 call of a swarm, a tracking fleet and a hybrid bank (N=20,
    the realtime schedule for the fleets, the default one for the hybrid)
    against the plain version on the same CUDA tensors: bit for bit. The
    same calls' plain versions on CPU copies are printed beside them and not
    asserted: the host's exp/log/sqrt round differently from CUDA's, so
    there the plain version is held to bands, not to bits."""
    from ros2_mpc_tpu_torch.solver.mppi import MppiSettings, make_hybrid_solver

    dev, rt = cuda_device, ts.SolverSettings.realtime()
    fields = ("U", "X", "cost", "kkt_residual", "converged", "n_iters")
    tp = ts.make_point_stabilization(T_PARAMS, horizon=20, settings=rt, reference_parity=False, device=dev)
    tt = ts.make_tracking(
        T_PARAMS, horizon=20, settings=rt, reference_parity=False, terminal_weight=(10.0, 10.0, 1.0), device=dev
    )
    swarm = tf.make_swarm_rollout(tp, 3, DT, device=dev)
    tracking = tf.make_tracking_fleet_rollout(tt, 3, DT, goal_threshold=0.25, device=dev)
    tpd = ts.make_point_stabilization(T_PARAMS, horizon=20, reference_parity=False, device=dev)
    hybrid = make_hybrid_solver(tpd.ocp, tpd.settings, MppiSettings(n_samples=32, n_iters=4), device=dev)
    th, U0 = tf.grid_swap_swarm(tp, side=8, device=dev)
    thp, paths, U0p = tf.arc_path_fleet(tt, 64, seed=0, device=dev)
    thh, U0h = tf.random_fleet(tpd, 32, seed=5, device=dev)
    mid = 0.5 * (thh["x0"][:, :2] + thh["goal"][:, :2])  # 3 live points a row, near each start-goal line
    for j, off in enumerate((-0.1, 0.0, 0.1)):
        thh["obs_x"][:, j], thh["obs_y"][:, j] = mid[:, 0] + off, mid[:, 1] - off
    runs = {
        "swarm": (swarm.engines[0], lambda: swarm(th, U0)),
        "tracking fleet": (tracking.engines[0], lambda: tracking(thp, paths, U0p)),
        "hybrid": (
            hybrid.engines[0],
            lambda: hybrid(thh, U0h, torch.Generator(device=dev).manual_seed(0)),
        ),
    }
    on_cpu = {}
    for name, (engine, run) in runs.items():
        engine.record = []
        run()
        calls, engine.record = engine.record, None
        assert len(calls) == (2 if name == "hybrid" else 3)
        for i, (thetas, U0s, got) in enumerate(calls):
            ref = engine.plain(thetas, U0s)
            for f in fields:
                assert torch.equal(getattr(got, f), getattr(ref, f)), f"{name} call {i}: {f}"
            cpu = engine.plain({k: v.cpu() for k, v in thetas.items()}, U0s.cpu())
            on_cpu[f"{name} call {i}"] = (
                [f for f in fields if not torch.equal(getattr(got, f).cpu(), getattr(cpu, f))],
                float((got.U.cpu() - cpu.U).abs().max()),
            )
    print(f"plain version on the CPU against the kernel (fields not bit-equal, max |dU|): {on_cpu}")
