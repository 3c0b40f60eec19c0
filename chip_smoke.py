"""Drive the PyTorch/H100 port's main path once on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``ros2_mpc_tpu_torch/csrc`` (nvcc), then
runs the main path through the entry points a user calls:

* the headline bank: 4096 unicycle point-stabilization NMPC solves at
  horizon N=20 (``Params()``, default ``SolverSettings``, reference parity),
  seeded with ``np.random.default_rng(0)`` exactly as ``bench.py`` builds
  it, through K1 (``make_cuda_point_stab_solver``);
* the obstacle-active bank (corrected mode, 3 live points near each
  start-goal line, ``bench.py``'s cluster recipe) through K1;
* a 4096 tracking bank (corrected mode, terminal weight (10, 10, 1),
  straight-line references, one live obstacle each) through K2;
* 5 warm-started ticks of the packed single-robot path
  (``make_packed_point_stab``) with K1 at B=1 as its engine.

Each kernel is held against its plain PyTorch version on the same inputs on
the card, and K1 against the port's algorithmic reference (``make_solver``,
on the CPU) at a small size. The kernels' launch counters are zeroed just
before the main path and read just after. Then kernel and plain version are
timed with CUDA events. Any failed check raises: the script exits nonzero
and prints no result line. Without a CUDA device it refuses to run.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches, deviation and times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

B = 4096  # bank size of the headline cell
N = 20  # horizon of the bank cells

# Bands, kernel against plain version (tests/test_pallas.py's engine bands):
# inert bank U atol 1e-4 / cost rtol 1e-4; live obstacles or tracking
# U atol 5e-4 / cost rtol 1e-3. At most 0.1% of a bank may leave the band
# (a line-search decision flipping near its threshold), and the converged
# fractions must agree within 0.002.
INERT, LIVE = (1e-4, 1e-4), (5e-4, 1e-3)
MAX_OUT_FRAC = 1e-3
MAX_CONV_GAP = 2e-3


def headline_bank(rng, B):
    """bench.py's headline inputs: starts, and goals with any heading."""
    x0 = rng.uniform(-0.3, 0.3, size=(B, 3))
    goal = np.concatenate(
        [rng.uniform(-1.5, 1.5, size=(B, 2)), rng.uniform(-np.pi, np.pi, size=(B, 1))], axis=1
    )
    return x0, goal


def obstacle_clusters(rng, x0, goal, n_obs):
    """bench.py's corrected-mode clusters: 3 live points near each start-goal
    midpoint, kept 0.3 m off start and goal, the rest at the 100 m sentinel."""
    Bn = x0.shape[0]
    obs_x = np.full((Bn, n_obs), 100.0)
    obs_y = np.full((Bn, n_obs), 100.0)
    mid = (x0[:, :2] + goal[:, :2]) / 2
    for j in range(3):
        pts = mid + rng.uniform(-0.4, 0.4, size=(Bn, 2))
        for _ in range(16):
            d = np.minimum(
                np.linalg.norm(pts - x0[:, :2], axis=1), np.linalg.norm(pts - goal[:, :2], axis=1)
            )
            bad = d < 0.3
            if not bad.any():
                break
            pts[bad] = mid[bad] + rng.uniform(-0.45, 0.45, size=(int(bad.sum()), 2))
        else:
            pts[bad] = 100.0
        obs_x[:, j] = pts[:, 0]
        obs_y[:, j] = pts[:, 1]
    return obs_x, obs_y


def tracking_bank(rng, B, N, dt, n_obs):
    """Straight-line references at 0.15 m/s from each start, one live
    obstacle near the line (tests/test_pallas.py's tracking recipe)."""
    x0 = rng.uniform(-0.2, 0.2, size=(B, 3))
    ts = np.arange(1, N + 1) * dt
    x_ref = np.stack([x0[:, 0:1] + 0.15 * ts[None], np.zeros((B, N)), np.zeros((B, N))], axis=2)
    u_ref = np.tile([0.15, 0.0], (B, N, 1))
    obs_x = np.full((B, n_obs), 100.0)
    obs_y = np.full((B, n_obs), 100.0)
    obs_x[:, 0] = rng.uniform(0.3, 0.6, size=B)
    obs_y[:, 0] = rng.uniform(-0.15, 0.15, size=B)
    return x0, x_ref, u_ref, obs_x, obs_y


def compare(name, sol, ref, band):
    """Hold a kernel Solution against its plain version; raise outside band."""
    import torch

    u_atol, c_rtol = band
    dU = (sol.U - ref.U).abs().amax(dim=(1, 2))
    dX = (sol.X - ref.X).abs().amax(dim=(1, 2))
    dc = (sol.cost - ref.cost).abs() / ref.cost.abs().clamp(min=1e-30)
    out = (dU > u_atol) | (dc > c_rtol)
    conv, conv_ref = float(sol.converged.float().mean()), float(ref.converged.float().mean())
    for t in sol.U, sol.X, sol.cost, sol.kkt_residual:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: non-finite kernel output")
    print(
        f"{name}: max|dU| {float(dU.max()):.3e}  max|dX| {float(dX.max()):.3e}  "
        f"max rel dcost {float(dc.max()):.3e}  outside band (U {u_atol:g}, cost {c_rtol:g}) "
        f"{int(out.sum())}/{out.numel()}  bit-equal U {int((dU == 0).sum())}/{dU.numel()}  "
        f"converged {conv:.4f} (plain {conv_ref:.4f})  mean n_iters "
        f"{float(sol.n_iters.float().mean()):.3f} (plain {float(ref.n_iters.float().mean()):.3f})",
        flush=True,
    )
    if float(out.float().mean()) > MAX_OUT_FRAC:
        raise AssertionError(f"{name}: {int(out.sum())} scenarios outside the band")
    if abs(conv - conv_ref) > MAX_CONV_GAP:
        raise AssertionError(f"{name}: converged fractions differ by {abs(conv - conv_ref)}")
    return float(dU.max())


def cuda_ms(fn, *args, reps=5):
    """Median over `reps` runs of fn(*args), in ms on CUDA events, after a
    warm-up run."""
    import torch

    fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 2

    from ros2_mpc_tpu_torch import _build
    from ros2_mpc_tpu_torch.config import Params
    from ros2_mpc_tpu_torch.solver import SolverSettings, make_point_stabilization, make_tracking
    from ros2_mpc_tpu_torch.solver.cuda_kernel import (
        BLOCK,
        make_cuda_point_stab_solver,
        make_cuda_tracking_solver,
        single_scenario,
    )
    from ros2_mpc_tpu_torch.solver.packed import make_packed_point_stab

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card and the build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]  # fmt: skip
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s, {_build.library_path().name}", flush=True)
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    params = Params()
    n_obs = params.n_obstacle_points
    f32 = torch.float32
    tens = lambda a: torch.as_tensor(a, dtype=f32, device=dev)  # noqa: E731

    # inputs of the main path, all from one seeded generator as bench.py
    rng = np.random.default_rng(0)
    x0, goal = headline_bank(rng, B)
    obs_x, obs_y = obstacle_clusters(rng, x0, goal, n_obs)
    trk = tracking_bank(np.random.default_rng(1), B, N, params.dt, n_obs)

    prob = make_point_stabilization(params, horizon=N, device=dev)
    prob_c = make_point_stabilization(params, horizon=N, reference_parity=False, device=dev)
    prob_t = make_tracking(
        params, horizon=N, reference_parity=False, terminal_weight=(10.0, 10.0, 1.0), device=dev
    )
    th_main = torch.func.vmap(prob.make_theta)(tens(x0), tens(goal))
    th_obs = torch.func.vmap(prob_c.make_theta)(tens(x0), tens(goal), tens(obs_x), tens(obs_y))
    th_trk = torch.func.vmap(prob_t.make_theta)(*map(tens, trk))
    U0 = torch.zeros(B, N, 2, dtype=f32, device=dev)

    k1 = make_cuda_point_stab_solver(prob.ocp, prob.settings)
    k2 = make_cuda_tracking_solver(prob_t.ocp, prob_t.settings)
    # the single-robot tick: corrected mode, realtime schedule, the
    # follower's horizon, K1 at B=1 as the engine
    prob_tick = make_point_stabilization(
        params, reference_parity=False, settings=SolverSettings.realtime(), device=dev
    )
    k1_tick = make_cuda_point_stab_solver(prob_tick.ocp, prob_tick.settings)
    solve_tick, pack = make_packed_point_stab(prob_tick, params, solve_fn=single_scenario(k1_tick))
    for name, s in (("K1", k1), ("K2", k2)):
        info = s.kernel_info()
        print(f"{name} at {BLOCK} threads/block: {info}", flush=True)

    # ---- main path, with the launch counters zeroed just before
    for s in (k1, k2, k1_tick):
        s.launches = 0
    sol_main = k1(th_main, U0)
    sol_obs = k1(th_obs, U0)
    sol_trk = k2(th_trk, U0)
    tick_obs_x, tick_obs_y = np.full(n_obs, 100.0), np.full(n_obs, 100.0)
    tick_obs_x[0], tick_obs_y[0] = 0.6, 0.05
    pose, tick_goal = np.zeros(3), np.array([1.0, 0.2, 0.3])
    U_warm = prob_tick.default_u0
    ticks = []
    for _ in range(5):
        vec = pack(pose, tick_goal, tick_obs_x, tick_obs_y)
        sol, U_next = solve_tick(vec, U_warm)
        ticks.append((vec, U_warm, sol))
        U_warm = U_next
        pose = sol.X[1].cpu().numpy()  # the robot follows the model
    torch.cuda.synchronize()
    launches = {"K1": k1.launches + k1_tick.launches, "K2": k2.launches}
    print(f"launch counters after the main path: {launches}", flush=True)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the main path")

    # ---- 2-5. the same inputs through the plain versions
    err1 = compare(f"K1 headline bank (parity, B={B}, N={N})", sol_main, k1.plain(th_main, U0), INERT)
    compare("K1 obstacle-active bank (corrected)", sol_obs, k1.plain(th_obs, U0), LIVE)
    err2 = compare("K2 tracking bank (corrected, terminal weight)", sol_trk, k2.plain(th_trk, U0), LIVE)
    plain_tick, _ = make_packed_point_stab(prob_tick, params, solve_fn=single_scenario(k1_tick.plain))
    tick_err = 0.0
    for vec, U_in, sol in ticks:
        ref, _ = plain_tick(vec, U_in)
        tick_err = max(tick_err, float((sol.U - ref.U).abs().max()))
    final = ticks[-1][2]
    if tick_err > LIVE[0] or not bool(torch.isfinite(final.U).all()):
        raise AssertionError(f"tick path: max|dU| {tick_err}")
    print(
        f"tick path (5 warm ticks, B=1, N={prob_tick.ocp.horizon}, realtime): max|dU| vs plain "
        f"{tick_err:.3e}, last tick converged {bool(final.converged)}, "
        f"pose after 5 ticks {np.round(pose, 4).tolist()}",
        flush=True,
    )
    conv = float(sol_main.converged.float().mean())
    if conv < 0.95:
        raise AssertionError(f"headline bank converged fraction {conv}")

    # ---- K1 against the algorithmic reference (make_solver, CPU), small
    fast = SolverSettings.fast()
    prob_ref = make_point_stabilization(params, horizon=N, reference_parity=False, settings=fast)
    th_small = {k: v[:4].cpu() for k, v in th_obs.items()}
    ref = torch.func.vmap(prob_ref.solve)(th_small, torch.zeros(4, N, 2))
    got = make_cuda_point_stab_solver(prob_ref.ocp, fast)(
        {k: v.to(dev) for k, v in th_small.items()}, torch.zeros(4, N, 2, device=dev)
    )
    dU_ref = float((got.U.cpu() - ref.U).abs().max())
    dc_ref = float(((got.cost.cpu() - ref.cost).abs() / ref.cost.abs()).max())
    print(f"K1 vs make_solver (B=4, N={N}, fast, obstacles): max|dU| {dU_ref:.3e}, rel dcost {dc_ref:.3e}")
    if dU_ref > LIVE[0] or dc_ref > LIVE[1]:
        raise AssertionError("K1 disagrees with make_solver")

    # ---- 6. timing, kernel and plain version alternating
    times = {}
    for name, s, th in (("K1", k1, th_main), ("K2", k2, th_trk)):
        times[name] = (cuda_ms(s, th, U0), cuda_ms(s.plain, th, U0))
        ms, plain_ms = times[name]
        print(
            f"timing {name} B={B} N={N}: kernel {ms:.3f} ms ({B / ms * 1e3:.0f} solves/s), "
            f"plain {plain_ms:.1f} ms ({B / plain_ms * 1e3:.0f} solves/s), median of 5 -- {card}",
            flush=True,
        )

    kernels = [
        {
            "name": "K1 point-stabilization bank solve",
            "route": "cuda",
            "source": "ros2_mpc_tpu_torch/csrc/point_stab.cu",
            "replaces": "ros2_mpc_tpu/solver/pallas_kernel.py:119",
            "launches": launches["K1"],
            "max_abs_err": err1,
            "ms": times["K1"][0],
            "plain_ms": times["K1"][1],
        },
        {
            "name": "K2 tracking bank solve",
            "route": "cuda",
            "source": "ros2_mpc_tpu_torch/csrc/tracking.cu",
            "replaces": "ros2_mpc_tpu/solver/pallas_kernel.py:769",
            "launches": launches["K2"],
            "max_abs_err": err2,
            "ms": times["K2"][0],
            "plain_ms": times["K2"][1],
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
