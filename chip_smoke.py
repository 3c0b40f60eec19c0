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
  straight-line references, one live obstacle each) through K2
  (``make_cuda_tracking_solver``);
* 5 warm-started ticks of the packed single-robot point path
  (``make_packed_point_stab``) with K1 at B=1 as its engine;
* 5 warm-started ticks of the packed path follower
  (``make_packed_tracking``: corrected mode, realtime schedule, N=30, a
  straight reference at 0.15 m/s advanced one step a tick) with K2 at B=1.

K1 and K2 run one scenario on a group of lanes; each geometry line is the
kernel's own, and the wrapper's pre-build mirror of it must agree. Each
kernel is held against its plain PyTorch version on the same inputs on the
card: bit for bit (``torch.equal`` on U, X, cost, KKT residual and
n_iters) on every bank and tick, with the deviation bands printed beside;
and K1 against the port's algorithmic reference (``make_solver``, on the
CPU) at a small size. The kernels' launch counters are zeroed just
before the main path and read just after. Then kernel and plain version are
timed with CUDA events, and both ticks on the host clock.

Then the roofline path (``ros2_mpc_tpu_torch.utils.roofline``), its own
counters zeroed just before it and read just after: K3 (``csrc/chain.cu``)
measures the card's per-op-class peaks and the loop overhead in 64-thread
blocks, K1 and K2 rerun the banks with their executed-work counters
(``iters`` and ``ls_rollouts``, which must equal the plain versions' element
by element), and the ledgers turn those into FLOP per solve, achieved
GFLOP/s, the bound (the larger of FLOP over 67 TFLOP/s and bytes over
3.35 TB/s, the H100's published FP32 and HBM rates) and each bank's share
of it, with K1's phase shares. K3 is held against its plain
version ``chain`` bit for bit, for all four op classes at both of the
path's geometries, and its SASS is read back (``cuobjdump``) to show the
trip loop was not unrolled away. ``profile_trace`` splits K1's and K2's
device time from their wrappers.

Any failed check raises: the script exits nonzero and prints no result
line. Without a CUDA device it refuses to run.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches, deviation, times and bound.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

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
# The H100 SXM's published rates (NVIDIA's H100 datasheet): float32
# outside the tensor cores, and HBM3.
FP32_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12
# K3 against its plain version `chain`: bit-equal (0 ulp apart) at both of
# the roofline path's geometries, (rows, cols, threads per block)
CHAIN_MAX_ULP = 0
CHAIN_GEOMETRIES = ((1056, 256, 256), (32, 128, 64))
MAX_SHARE = 1.05  # a share of a bound above this means a counting fault


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
    """Hold a kernel Solution against its plain version: raise unless U, X,
    cost, KKT residual and n_iters are bit-equal, or outside the band."""
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
    fields = ("U", "X", "cost", "kkt_residual", "n_iters")
    unequal = [f for f in fields if not torch.equal(getattr(sol, f), getattr(ref, f))]
    print(f"{name}: bit-equal to the plain version {'yes' if not unequal else 'no: ' + ', '.join(unequal)}")
    if unequal:
        raise AssertionError(f"{name}: {unequal} differ from the plain version")
    if float(out.float().mean()) > MAX_OUT_FRAC:
        raise AssertionError(f"{name}: {int(out.sum())} scenarios outside the band")
    if abs(conv - conv_ref) > MAX_CONV_GAP:
        raise AssertionError(f"{name}: converged fractions differ by {abs(conv - conv_ref)}")
    return float(dU.max())


def bound_ms(flops, nbytes):
    """The least time the card could take: (ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def chain_loop_bodies(lib_path, cuobjdump):
    """{(op code, unroll): opcodes of the trip loop} of K3's instantiations,
    from the library's SASS: the instructions from the target of the
    widest backward branch to that branch."""
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(lib_path)], capture_output=True, text=True, check=True
    ).stdout
    bodies = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"chain_kernelILi(\d)ELi(\d+)E", func.split("\n", 1)[0])
        if not m:
            continue
        instr = []
        for line in func.splitlines():
            mi = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if mi:
                text = re.sub(r"^@!?U?P\w+\s+", "", mi.group(2))
                instr.append((int(mi.group(1), 16), text.split()[0], text))
        loops = [
            (int(t.group(1), 16), a)
            for a, op, text in instr
            if op == "BRA" and (t := re.search(r"0x([0-9a-f]+)", text)) and int(t.group(1), 16) < a
        ]
        if loops:
            lo, hi = max(loops, key=lambda ab: ab[1] - ab[0])
            bodies[(int(m.group(1)), int(m.group(2)))] = [op for a, op, _ in instr if lo <= a <= hi]
    return bodies


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


def tracking_window(i, N, dt):
    """The path follower's reference at tick i: a straight line along x at
    0.15 m/s, its window advanced one step a tick."""
    ts = (np.arange(N) + i + 1) * dt
    x_ref = np.stack([0.15 * ts, np.zeros(N), np.zeros(N)], axis=1)
    return x_ref, np.tile([0.15, 0.0], (N, 1))


def run_ticks(solve_tick, pack_at, U_warm, n):
    """``n`` packed warm ticks at B=1 with the robot following the model
    from the origin; ``pack_at(i, pose)`` packs tick i. Returns [(vec, U_in,
    Solution)] and the pose after them."""
    pose, ticks = np.zeros(3), []
    for i in range(n):
        vec = pack_at(i, pose)
        sol, U_next = solve_tick(vec, U_warm)
        ticks.append((vec, U_warm, sol))
        U_warm, pose = U_next, sol.X[1].cpu().numpy()
    return ticks, pose


def tick_latency(solve_tick, pack_at, U_warm, warm=10, n=50):
    """Host-clock latency (ms) of ``n`` packed warm ticks at B=1 after
    ``warm`` more: pack, transfer, solve, and reading the first command
    back, with the robot following the model from the origin."""
    pose, times = np.zeros(3), []
    for i in range(warm + n):
        t0 = time.perf_counter()
        sol, U_next = solve_tick(pack_at(i, pose), U_warm)
        sol.U[0].cpu()
        times.append((time.perf_counter() - t0) * 1e3)
        U_warm, pose = U_next, sol.X[1].cpu().numpy()
    return np.asarray(times[warm:])


def tick_paths(inp, k1_tick, k2_tick):
    """The two packed tick paths of the main path, each with its engine at
    B=1: {name: (solve_tick, pack_at, U_warm)}."""
    from ros2_mpc_tpu_torch.solver.cuda_kernel import single_scenario
    from ros2_mpc_tpu_torch.solver.packed import make_packed_point_stab, make_packed_tracking

    solve_p, pack_p = make_packed_point_stab(inp.prob_tick, inp.params, solve_fn=single_scenario(k1_tick))
    solve_t, pack_t = make_packed_tracking(inp.prob_ttick, inp.params, solve_fn=single_scenario(k2_tick))
    N_t, dt = inp.prob_ttick.ocp.horizon, inp.params.dt
    return {
        "K1 tick": (
            solve_p,
            lambda i, pose: pack_p(pose, inp.tick_goal, inp.tick_obs_x, inp.tick_obs_y),
            inp.prob_tick.default_u0,
        ),
        "K2 tick": (
            solve_t,
            lambda i, pose: pack_t(pose, *tracking_window(i, N_t, dt), inp.tick_obs_x, inp.tick_obs_y),
            inp.prob_ttick.default_u0,
        ),
    }


def main_path_inputs(dev):
    """The main path's problems and inputs, all from seeded generators as
    bench.py builds them: the headline, obstacle-active and tracking banks
    (``prob``/``th_main``, ``prob_c``/``th_obs``, ``prob_t``/``th_trk``)
    and the single-robot ticks (``prob_tick`` with its goal, the path
    follower's ``prob_ttick``, and their obstacles)."""
    import torch

    from ros2_mpc_tpu_torch.config import Params
    from ros2_mpc_tpu_torch.solver import SolverSettings, make_point_stabilization, make_tracking

    params = Params()
    n_obs = params.n_obstacle_points
    tens = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    rng = np.random.default_rng(0)
    x0, goal = headline_bank(rng, B)
    obs_x, obs_y = obstacle_clusters(rng, x0, goal, n_obs)
    trk = tracking_bank(np.random.default_rng(1), B, N, params.dt, n_obs)

    prob = make_point_stabilization(params, horizon=N, device=dev)
    prob_c = make_point_stabilization(params, horizon=N, reference_parity=False, device=dev)
    prob_t = make_tracking(
        params, horizon=N, reference_parity=False, terminal_weight=(10.0, 10.0, 1.0), device=dev
    )
    # the single-robot tick: corrected mode, realtime schedule, the
    # follower's horizon, one live obstacle ahead of the robot
    prob_tick = make_point_stabilization(
        params, reference_parity=False, settings=SolverSettings.realtime(), device=dev
    )
    # the path follower's tick (nodes/path_follower.py): corrected mode,
    # realtime schedule, its horizon, no terminal weight
    prob_ttick = make_tracking(params, reference_parity=False, settings=SolverSettings.realtime(), device=dev)
    tick_obs_x, tick_obs_y = np.full(n_obs, 100.0), np.full(n_obs, 100.0)
    tick_obs_x[0], tick_obs_y[0] = 0.6, 0.05
    return SimpleNamespace(
        params=params,
        prob=prob,
        prob_c=prob_c,
        prob_t=prob_t,
        th_main=torch.func.vmap(prob.make_theta)(tens(x0), tens(goal)),
        th_obs=torch.func.vmap(prob_c.make_theta)(tens(x0), tens(goal), tens(obs_x), tens(obs_y)),
        th_trk=torch.func.vmap(prob_t.make_theta)(*map(tens, trk)),
        prob_tick=prob_tick,
        prob_ttick=prob_ttick,
        tick_obs_x=tick_obs_x,
        tick_obs_y=tick_obs_y,
        tick_goal=np.array([1.0, 0.2, 0.3]),
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 2

    from ros2_mpc_tpu_torch import _build
    from ros2_mpc_tpu_torch.solver import SolverSettings, make_point_stabilization
    from ros2_mpc_tpu_torch.solver.cuda_kernel import (
        group_geometry,
        make_cuda_point_stab_solver,
        make_cuda_tracking_solver,
    )
    from ros2_mpc_tpu_torch.utils import roofline as rl
    from ros2_mpc_tpu_torch.utils.telemetry import profile_trace

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
    # K3's trip loop must stay a loop: at unroll 1 one FFMA and the branch
    bodies = chain_loop_bodies(_build.library_path(), Path(_build._nvcc()).parent / "cuobjdump")
    names = {code: op for op, (code, *_) in rl.CHAIN_OPS.items()}
    for (code, unroll), body in sorted(bodies.items()):
        counts = {k: sum(o.startswith(k) for o in body) for k in ("FFMA", "MUFU", "BRA")}
        print(f"K3 SASS {names[code]} unroll {unroll}: trip loop of {len(body)} instructions {counts}", end="")
        print(f": {' '.join(body)}" if len(body) <= 8 else "")
    u1, u16 = bodies.get((0, 1), []), bodies.get((0, 16), [])
    if u1.count("FFMA") != 1 or not u1 or u1[-1] != "BRA" or u16.count("FFMA") != 16:
        raise AssertionError(f"K3's fma trip loop is not one FFMA and a branch: {u1} / {u16}")

    inp = main_path_inputs(dev)
    params, prob, prob_t = inp.params, inp.prob, inp.prob_t
    th_main, th_obs, th_trk = inp.th_main, inp.th_obs, inp.th_trk
    n_obs = params.n_obstacle_points
    tens = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    U0 = torch.zeros(B, N, 2, dtype=torch.float32, device=dev)

    k1 = make_cuda_point_stab_solver(prob.ocp, prob.settings)
    k2 = make_cuda_tracking_solver(prob_t.ocp, prob_t.settings)
    # the ticks' engines: K1 and K2 at B=1
    k1_tick = make_cuda_point_stab_solver(inp.prob_tick.ocp, inp.prob_tick.settings)
    k2_tick = make_cuda_tracking_solver(inp.prob_ttick.ocp, inp.prob_ttick.settings)
    paths = tick_paths(inp, k1_tick, k2_tick)
    # G lanes a scenario; group, scenarios and threads per block, blocks,
    # shared memory per block, registers, local bytes, resident blocks per
    # SM, ptxas's spill stores. The geometry is the kernel's own; the
    # wrapper's pre-build mirror of it must agree.
    geometry_lines = (("K1 headline", k1, B), ("K1 tick", k1_tick, 1), ("K2 tracking", k2, B), ("K2 tick", k2_tick, 1))
    for name, s, Bk in geometry_lines:
        info = s.kernel_info(Bk)
        print(f"{name} (B={Bk}, N={s.cfg.N}): {info}", flush=True)
        mirror = group_geometry(s.kind, Bk, s.cfg.N, s.cfg.n_alphas)
        if {k: info[k] for k in mirror} != mirror:
            raise AssertionError(f"{name}: group_geometry {mirror} is not the kernel's geometry")

    # ---- main path, with the launch counters zeroed just before
    for s in (k1, k2, k1_tick, k2_tick):
        s.launches = 0
    sol_main = k1(th_main, U0)
    sol_obs = k1(th_obs, U0)
    sol_trk = k2(th_trk, U0)
    ran = {name: run_ticks(solve, pack_at, U_warm, 5) for name, (solve, pack_at, U_warm) in paths.items()}
    torch.cuda.synchronize()
    launches = {"K1": k1.launches + k1_tick.launches, "K2": k2.launches + k2_tick.launches}
    print(f"launch counters after the main path: {launches}", flush=True)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the main path")

    # ---- 2-5. the same inputs through the plain versions (with their
    # counters, which the counted reruns of the roofline path must match)
    k1_cnt = make_cuda_point_stab_solver(prob.ocp, prob.settings, with_counters=True)
    k2_cnt = make_cuda_tracking_solver(prob_t.ocp, prob_t.settings, with_counters=True)
    plain = {
        "K1 headline": k1_cnt.plain(th_main, U0),
        "K1 obstacle-active": k1_cnt.plain(th_obs, U0),
        "K2 tracking": k2_cnt.plain(th_trk, U0),
    }
    err1 = compare(f"K1 headline bank (parity, B={B}, N={N})", sol_main, plain["K1 headline"][0], INERT)
    compare("K1 obstacle-active bank (corrected)", sol_obs, plain["K1 obstacle-active"][0], LIVE)
    err2 = compare("K2 tracking bank (corrected, terminal weight)", sol_trk, plain["K2 tracking"][0], LIVE)
    plain_paths = tick_paths(inp, k1_tick.plain, k2_tick.plain)
    tick_errs = {}
    for name, (ticks, pose) in ran.items():
        plain_tick, err, unequal = plain_paths[name][0], 0.0, []
        for i, (vec, U_in, sol) in enumerate(ticks):
            ref, _ = plain_tick(vec, U_in)
            err = max(err, float((sol.U - ref.U).abs().max()))
            fields = ("U", "X", "cost", "kkt_residual", "n_iters")
            unequal += [f"tick {i} {f}" for f in fields if not torch.equal(getattr(sol, f), getattr(ref, f))]
        final = ticks[-1][2]
        tick_errs[name] = err
        print(
            f"{name} path (5 warm ticks, B=1, N={final.U.shape[0]}, realtime): max|dU| vs plain "
            f"{err:.3e}, bit-equal to the plain version {'yes' if not unequal else unequal}, "
            f"last tick converged {bool(final.converged)}, pose after 5 ticks {np.round(pose, 4).tolist()}",
            flush=True,
        )
        if unequal or not bool(torch.isfinite(final.U).all()):
            raise AssertionError(f"{name} path: {unequal or 'non-finite U'}")
    for name, (solve, pack_at, U_warm) in paths.items():
        lat = tick_latency(solve, pack_at, U_warm)
        print(
            f"{name} latency (B=1, N={U_warm.shape[0]}, realtime; host clock, pack to first command, "
            f"{lat.size} ticks after 10): p50 {np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f} "
            f"ms -- {card}",
            flush=True,
        )
    conv = float(sol_main.converged.float().mean())
    if conv < 0.95:
        raise AssertionError(f"headline bank converged fraction {conv}")

    # ---- K1 against the algorithmic reference (make_solver, CPU), small
    fast = SolverSettings.fast()
    prob_ref = make_point_stabilization(params, horizon=N, reference_parity=False, settings=fast, device="cpu")
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
        times[name] = (cuda_ms(s, th, U0), cuda_ms(s.plain, th, U0, reps=3))
        ms, plain_ms = times[name]
        print(
            f"timing {name} B={B} N={N}: kernel {ms:.3f} ms ({B / ms * 1e3:.0f} solves/s, median "
            f"of 5), plain {plain_ms:.1f} ms ({B / plain_ms * 1e3:.0f} solves/s, median of 3) -- {card}",
            flush=True,
        )
    ms_obs = cuda_ms(k1, th_obs, U0)
    print(f"timing K1 obstacle-active bank: kernel {ms_obs:.3f} ms, median of 5 -- {card}", flush=True)

    # ---- 7. the roofline path, with its launch counters zeroed just before
    k3 = rl.chain_kernel
    for s in (k3, k1_cnt, k2_cnt):
        s.launches = 0
    t0 = time.perf_counter()
    peaks = rl.measure_vpu_peaks(device=dev)
    overhead = rl.measure_loop_overhead(device=dev)
    counted = {
        "K1 headline": (th_main, *k1_cnt(th_main, U0)),
        "K1 obstacle-active": (th_obs, *k1_cnt(th_obs, U0)),
        "K2 tracking": (th_trk, *k2_cnt(th_trk, U0)),
    }
    torch.cuda.synchronize()
    launches_rl = {"K3": k3.launches, "K1": k1_cnt.launches, "K2": k2_cnt.launches}
    print(f"launch counters after the roofline path ({time.perf_counter() - t0:.1f} s): {launches_rl}")
    for name, n in launches_rl.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the roofline path")
    for (name, (_, sol, cnt)), ref in zip(counted.items(), (sol_main, sol_obs, sol_trk)):
        if not torch.equal(sol.U, ref.U):  # the counters change no arithmetic
            raise AssertionError(f"{name}: the counted solve differs from the main path's")
        # the schedule's executed iterations and first-accept candidates,
        # whatever the lanes ran speculatively
        unequal = [k for k in ("iters", "ls_rollouts") if not torch.equal(cnt[k], plain[name][1][k])]
        print(f"{name} counters: iters and ls_rollouts equal to the plain version's {unequal or 'yes'}")
        if unequal:
            raise AssertionError(f"{name}: counters {unequal} differ from the plain version's")
    print(
        f"K3 peaks ({rl.PEAK_ROWS}x{rl.PEAK_COLS}, block {rl.CHAIN_BLOCK}): "
        f"FMA {peaks['fma_flops_per_s'] / 1e12:.3f} TFLOP/s ({peaks['fma_flops_per_s'] / FP32_FLOPS:.3f} "
        f"of 67), exp {peaks['exp_per_s'] / 1e9:.1f}, log {peaks['log_per_s'] / 1e9:.1f}, sincos "
        f"{peaks['sincos_per_s'] / 1e9:.1f} Gop/s; loop overhead {overhead * 1e9:.3f} ns per trip "
        f"(4096 elements, block {rl.LOOP_BLOCK}) -- {card}",
        flush=True,
    )
    if peaks["fma_flops_per_s"] > MAX_SHARE * FP32_FLOPS:
        raise AssertionError("K3's FMA rate is above the card's peak: the chain was folded")
    # the cycle model with every arith op one FP32 instruction (FMUL and FADD
    # take an FFMA's slot under -fmad=false): half the FMA peak's FLOP rate
    peaks_instr = dict(peaks, fma_flops_per_s=peaks["fma_flops_per_s"] / 2)

    # ledgers: each bank's executed work, the bound and the shares
    n_k2_bytes = 4.0 * (3 + 3 * N + 2 * N + 11 + 2 * n_obs + 2 * N + 2 * N + 3 * (N + 1) + 4)
    ledgers = {  # name: (ledger, bytes per scenario, kernel ms)
        "K1 headline": (rl.point_stab_solve_flops, rl.point_stab_hbm_bytes(N, n_obs), times["K1"][0]),
        "K1 obstacle-active": (rl.point_stab_solve_flops, rl.point_stab_hbm_bytes(N, n_obs), ms_obs),
        "K2 tracking": (
            lambda *a, **k: rl.tracking_solve_flops(*a, terminal_quad=True, **k), n_k2_bytes, times["K2"][0],
        ),
    }  # fmt: skip
    bounds = {}
    for name, (th, _, cnt) in counted.items():
        ledger, bytes_per, ms = ledgers[name]
        iters = cnt["iters"].cpu().numpy().astype(float)
        ls = cnt["ls_rollouts"].cpu().numpy().astype(float)
        obs = [th[k].cpu().numpy() for k in ("obs_x", "obs_y", "obstacle_weight")]
        P = rl.computed_obstacle_points(*obs, tile_s=1, tile_l=1, chunk=1)
        count = rl.bank_flops(ledger, N, P, iters, ls, fast_sincos=True)
        secs, nbytes = ms / 1e3, B * bytes_per
        rep = rl.roofline_report(count, secs, peaks, hbm_bytes=nbytes)
        util_instr = rl.roofline_report(count, secs, peaks_instr)["vpu_model_utilization"]
        b_ms, b_by = bound_ms(count.total_flops, nbytes)
        share = b_ms / ms
        bounds[name] = (b_ms, b_by, share)
        line = (
            f"roofline {name}: {count.total_flops / B:,.0f} FLOP/solve, {rep['achieved_gflops']:.1f} "
            f"GFLOP/s achieved; bound {b_ms:.4f} ms ({b_by}; FLOP {count.total_flops / FP32_FLOPS * 1e3:.4f} "
            f"ms, bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms), share of bound {share:.4f}; "
            f"vpu_model_utilization {rep['vpu_model_utilization']:.4f} (peak-rate model), "
            f"{util_instr:.4f} (arith one instruction per op); "
            # the lanes run speculative candidates and redundant sweeps, so a
            # recount of one thread per scenario says nothing about them
            "divergence and loop overhead: not modelled for a lane group per scenario"
        )
        if ledger is rl.point_stab_solve_flops:
            psec = rl.phase_model_seconds(rl.bank_phase_flops(N, P, iters, ls, fast_sincos=True), peaks)
            total = sum(psec.values())
            line += "; phases " + ", ".join(f"{k} {v / total:.3f}" for k, v in psec.items())
        print(f"{line} -- {card}", flush=True)
        if share > MAX_SHARE or rep["vpu_model_utilization"] > MAX_SHARE:
            raise AssertionError(f"{name}: a share of a bound above {MAX_SHARE}")

    # K3 against its plain version: four op classes at both of the path's
    # geometries; one step on inputs spread over each map's domain (where a
    # faster, less exact instruction would show), and chains of 64x16 and
    # 1024x1 steps, both trip-loop shapes, on inputs inside every map's basin
    rng3 = np.random.default_rng(2)
    one_step = {
        "fma": lambda n: rng3.uniform(0.05, 0.99, n),  # x * a + b exact in float64 below 1
        "exp": lambda n: rng3.uniform(-80.0, 80.0, n),
        "log": lambda n: np.exp(rng3.uniform(-80.0, 80.0, n)),
        "sincos": lambda n: rng3.uniform(-1000.0, 1000.0, n),
    }
    err3, bad3 = 0.0, []
    for rows, cols, block in CHAIN_GEOMETRIES:
        x_chain = tens(rng3.uniform(0.2, 0.99, size=(rows, cols)))
        for op in rl.CHAIN_OPS:
            x_step = tens(one_step[op](rows * cols).reshape(rows, cols))
            ulps = []
            for x, shape in ((x_step, (1, 1)), (x_chain, (64, 16)), (x_chain, (1024, 1))):
                got, ref = k3(x, op, *shape, block), rl.chain(x, op, *shape)
                if not bool(torch.isfinite(ref).all()):
                    raise AssertionError(f"chain {op}: non-finite reference")
                ulps.append(int(rl.ulp_distance(got, ref).max()))
                err3 = max(err3, float((got - ref).abs().max()))
            print(
                f"K3 {op} ({rows}x{cols}, block {block}) vs chain: max ulp apart {ulps} at 1x1, 64x16, "
                f"1024x1 steps (band {CHAIN_MAX_ULP})"
            )
            if max(ulps) > CHAIN_MAX_ULP:
                bad3.append(f"{op} {rows}x{cols}")
    if bad3:
        raise AssertionError(f"K3 outside its band against chain: {bad3}")
    # K3's time at the peaks' geometry, a chain long enough that the launch
    # is lost in it; the plain version at the short chain only
    xp = tens(rng3.uniform(0.2, 0.99, size=(rl.PEAK_ROWS, rl.PEAK_COLS)))
    steps3 = 65536  # ~10 ms a call
    ms3, ms3_short = cuda_ms(k3, xp, "fma", steps3, 16), cuda_ms(k3, xp, "fma", 64, 16)
    plain3 = cuda_ms(rl.chain, xp, "fma", 64, 16, reps=3)
    b3 = bound_ms(2.0 * xp.numel() * steps3 * 16, 2 * 4.0 * xp.numel())
    print(
        f"timing K3 fma {rl.PEAK_ROWS}x{rl.PEAK_COLS}, block {rl.CHAIN_BLOCK}: {steps3}x16 steps kernel "
        f"{ms3:.4f} ms, bound {b3[0]:.4f} ms ({b3[1]}), share of bound {b3[0] / ms3:.4f}; 64x16 steps "
        f"kernel {ms3_short:.4f} ms, plain {plain3:.1f} ms -- {card}"
    )
    if b3[0] / ms3 > MAX_SHARE:
        raise AssertionError("K3 faster than its bound")

    # the card through the port's profiler hook: each bank kernel's device
    # time, which splits it from its wrapper
    with profile_trace(str(Path(__file__).resolve().parent / "build" / "trace"), device=dev) as prof:
        k1(th_main, U0)
        k2(th_trk, U0)
    events = prof.key_averages()
    for name, bank, key in (("K1", "headline", "point_stab_kernel"), ("K2", "tracking", "tracking_kernel")):
        dev_us = sum(getattr(e, "device_time_total", 0) for e in events if key in e.key)
        print(
            f"profile_trace: {name} {bank} kernel {dev_us / 1e3:.3f} ms of device time (the call "
            f"{times[name][0]:.3f} ms), trace in build/trace"
        )
        if dev_us <= 0:
            raise AssertionError(f"profile_trace saw no device time for {name}")

    kernels = [
        {
            "name": "K1 point-stabilization bank solve",
            "route": "cuda",
            "source": "ros2_mpc_tpu_torch/csrc/point_stab.cu",
            "replaces": "ros2_mpc_tpu/solver/pallas_kernel.py:119",
            "launches": launches["K1"],
            "max_abs_err": max(err1, tick_errs["K1 tick"]),
            "ms": times["K1"][0],
            "plain_ms": times["K1"][1],
            "bound_ms": bounds["K1 headline"][0],
            "bound_by": bounds["K1 headline"][1],
            "library_ms": None,  # no one PyTorch call solves a bank
        },
        {
            "name": "K2 tracking bank solve",
            "route": "cuda",
            "source": "ros2_mpc_tpu_torch/csrc/tracking.cu",
            "replaces": "ros2_mpc_tpu/solver/pallas_kernel.py:769",
            "launches": launches["K2"],
            "max_abs_err": max(err2, tick_errs["K2 tick"]),
            "ms": times["K2"][0],
            "plain_ms": times["K2"][1],
            "bound_ms": bounds["K2 tracking"][0],
            "bound_by": bounds["K2 tracking"][1],
            "library_ms": None,
        },
        {
            "name": "K3 op chains (roofline peaks)",
            "route": "cuda",
            "source": "ros2_mpc_tpu_torch/csrc/chain.cu",
            "replaces": "ros2_mpc_tpu/utils/roofline.py:298",
            "launches": launches_rl["K3"],
            "max_abs_err": err3,
            "ms": ms3,  # fma at the peaks' geometry, 65536x16 steps
            "plain_ms": plain3,  # fma at the peaks' geometry, 64x16 steps
            "bound_ms": b3[0],
            "bound_by": b3[1],
            "library_ms": None,  # no one PyTorch call runs a dependency chain
            "fma_tflops": peaks["fma_flops_per_s"] / 1e12,
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
