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
  straight reference at 0.15 m/s advanced one step a tick) with K2 at B=1;
* the closed loop, ``run_sim_stack``'s scenario through
  ``nodes.launch.build_sim_stack`` and ``SimStack.run_to_goal`` for both
  followers (the synthetic 250x250 indoor map at 0.05 m, a 360-beam lidar,
  ``Params()``, horizon 20, start (-1, -1, 0), goal (1, -1), at most 200
  ticks): the point follower on K1 at B=1, the path follower on K2 at B=1
  and its goal handoff on K1 at B=1, N=40. Each must reach the goal within
  0.75-1.5x the JAX package's tick count, launch its kernel on every solve,
  and its first 5 solves of each path must be bit-equal to the plain
  versions; then a tick with a NaN goal must neither raise nor hang.

Then the conditions phase: the closed loop under the JAX suite's other
conditions, each run with its JAX test's settings on the synthetic map
with ``Params()`` through ``build_sim_stack``: a pillar at (0, -1) that only
the lidar sees (``planner_map_image``) in corrected mode (point follower,
horizon 20: reached, clearance above 0.3 m) and in parity mode (it must
collide, the reference's outcome), the tracking follower's handoff around
it, parity with the safety monitor (``safety_stop=0.3``: no collision in
300 ticks), odometry, scan and actuation noise (``noise_seed=3``), a kidnap
to (-1.6, -1.6, 0.3) after 30 ticks, a retask from (0.2, -1) to
(1.2, -1.4), and a 0.15 m pedestrian patrolling x=0.2 (horizon 16: no wall
hit, at least 0.3 m from it). Each run's engines count from 0 just before
it, launch once a solve, and keep their first 5 kernel calls (K1 and K2 at
B=1, N=16, 20 and 40) for the plain checks; its outcome and ticks must be
the JAX package's, the ticks within 0.75-1.5x of its count.

Then the deploy phase, the arguments of the JAX package's entry points
that the port restored, run on the card. P is ``Params.load`` of the
package's params.yaml with goal_threshold 0.25 (``Params()``: 0.2):

* the f64 oracle (``tests/oracle.py``, numpy and scipy) on the kernels' own
  outputs: the banks of tests/test_oracle_sweep.py (``tests/oracle_banks.py``:
  point stabilization, seed 42, 32 scenarios; corrected obstacles, seed 7,
  32; tracking, seed 11, 32; the warm realtime schedule, seed 19, 8
  scenarios x 4 ticks; terminal-weight tracking, seed 13, 16) through K1
  and K2, and the quadrotor's 16 scenarios (seed 11) through the generic
  engine, polished in two worker processes beside the later phases and
  judged by that file's rules; then the quadrotor's ``make_solver`` on the
  first of those scenarios, a short schedule: its ``Solution`` and its
  transition's Jacobians ``A`` and ``B`` must be float32 (``make_solver``
  casts no derivative);
* ``build_live_stack(params=P, map_image=, map_info=, start_pose=,
  global_costmap=True, viz_period=)`` on ``maps/map_home.pgm`` (314 x 224
  cells), from (-2.6, -3.4, 0) to (2.4, -3.4) under a 45 s budget: P in
  every node, the goal reached with no control miss;
* the home map's routes (tests/test_carto_map.py:57-80: three for the
  point follower, one for the tracking follower) through
  ``build_sim_stack(map_image=...)``, at most 700 ticks each: reached with
  no collision on any tick, the ticks beside the JAX package's;
* ``MultiRobotSim(starts, P, map_image=, map_info=)``: two point robots on
  the home map, at most 300 ticks, both reached, the minimum separation;
* ``make_multistart_solver(include_mppi=False)`` on the obstacle-active
  bank's first 512 rows (one K1 call of 2,560 rows) beside plain K1.

Every kernel call of those runs at a shape no earlier phase holds keeps
five calls (``CudaBankSolver.record``) for the plain checks below. The
autonomy phase's compat workers add one corrected ``perform_mpc`` of each
adapter, its multi-process run takes P, an explicit start pose and
explicit roles, and the scale phase runs ``multistart_rescue`` with the
harness's short rescue schedule beside the same engine on
``rescue_schedule()``.

Then the robustness composites (``solver/rescue.py``,
``solver/multistart_bank.py``, ``solver/batched.py``), each kernel
composite's launch counters zeroed just before its counted call and read
just after (the launches must equal what its structure implies):

* the corrected two-pass bank (the obstacle-active bank: a
  ``SolverSettings.fast()`` first pass on K1, capacity 512, a compacted
  cold+warm rescue bank of 1,024 rows on ``rescue_schedule()``) and its
  tracking twin on K2 over the tracking bank: converged fractions of the
  first pass and the two-pass, stragglers, time, and the rescue bank's
  geometry;
* the saddle bank (``adversarial_saddle_bank``, B=4096, N=40, corrected,
  default schedule) through three rungs: plain K1, bank multistart (K=3,
  12,288 K1 rows) and ``make_multistart_two_pass_solver`` (capacity 512,
  12 box-DDP polish iterations), whose converged fractions must not
  decrease, with K1's geometry at 12,288 rows and the polish's own time;
* the quadrotor ``make_fast_polish_solver`` bank (plain PyTorch, no
  kernel; B=4096, or 1024 where the full bank takes longer than 60 s).

Every K1/K2 call inside each composite's counted call is recorded with the
inputs it was given (``CudaBankSolver.record``) and held bit for bit
against the plain version on those inputs: the composites' checks run at
the widths the phase runs.

Then the fleets and the sampling engines (``parallel/fleet.py``,
``solver/mppi.py``) at ``bench.py``'s widths, 1024 robots: the tracking
fleet (64 ticks, K2), the swarm (the 32x32 grid swap, 128 ticks, K1),
``device_tick_rate`` and its rollout (64 ticks, K1), the generic quadrotor
fleet (plain PyTorch, the ticks that fit in 30 s), the hybrid bank (MPPI,
then two K1 calls) and the point follower's escape tick. Each K1/K2 rollout
runs once to warm up, then once with its counters zeroed, every kernel call
recorded and ``torch.cuda.set_sync_debug_mode("error")`` on: it must launch
its kernel once a tick and read nothing back inside the loop. The first and
last ticks' kernel calls and the hybrid's join the plain checks, and a
16-robot tracking fleet and swarm on the card must stay within 2e-3 of the
same rollouts on the CPU.

Then the autonomy phase (``ops/mapping.py``, ``nodes/mapper.py``,
``planner/wavefront.py``, ``nodes/explorer.py``, ``nodes/live.py``,
``nodes/multiproc.py``, ``compat.py``): 30 simulator scans folded into the
240x240 log-odds grid on the card and on the CPU (the trinary grids must
agree on 99.9% of the cells); navigate-while-mapping
(``build_sim_stack(map_source="mapper")``, point follower, horizon 12, from
(-1, -1, 0) to (3.5, -1.8), at most 500 ticks: reached without collision
within 1.25x the JAX package's 150 ticks, K1 launched on every solve); the
frontier exploration of tests/test_explorer.py (safety stop 0.22 m, at
most 2,500 ticks: complete, >= 3 goals, unknown < 0.6, free > 0.25, no
collision); in both runs five K1 solves (B=1, N=12), spread over the run,
re-solved through K1's plain version and bit-equal to it; the wavefront on
the planner's weights of the synthetic map (equal to the CPU's field, the
start's value the A* cost), one field and 64 goals at once; one
``PointStabilizationMpc`` and one ``TrackingMpc`` ``perform_mpc`` on the
card against CPU copies (U within 5e-4; both in worker processes beside
the runs above); then
``run_live`` (30 s budget: the goal reached, no control miss) and
``run_multiprocess`` with every role on the card (60 s budget: the goal
reached, no role failed). The K1 launches of the in-process runs join the
``kernels`` line.

Then the scale phase (``parallel/mesh.py``, the sharded fleets,
``parallel/sweep.py``, ``parallel/distributed.py``,
``parallel/scaling_bench.py``) on ``make_mesh(4, device="cuda:0")``, four
shards of the one card: the headline and tracking banks through
``make_bank_solver(engine="cuda")``, four shards of 1024 bit-equal to one
shard (U, X, cost, KKT residual, n_iters), with ``bank_metrics`` beside the
gathered bank's numbers; each engine of the menu through
``scaling_bench.run``, its throughput on one shard and on four (the ceiling
on one card is 1/4) and shard 0 equal to one shard, the K1-bearing engines
at 512 a shard, ``vmap`` and ``fast`` (plain PyTorch) at 16 and N=5 with
the short schedule, each no worse than K1 where the JAX suite says so; the sharded
point fleet, tracking fleet and swarm at the fleets phase's widths,
bit-equal to their unsharded runs and free of host syncs; BASELINE.json
config 5's sweep (25 configs x 4096 scenarios, 102,400 K1 solves, chunks of
16,384), resumed after two chunks are deleted from its checkpoint (the same
table, and exactly those chunks' K1 launches again); K2 at B=1, N=256. Five
K1 calls of the sharded swarm, five K2 calls of the sharded tracking fleet
and the N=256 call join the plain checks. Beside the plain workers, two gloo
ranks on the card (``scaling_bench.run_distributed``) each solve half of a
globally sharded 4096 bank through K1, bit-equal to one process's solve.

K1 and K2 run one scenario on a group of lanes; each geometry line is the
kernel's own, and the wrapper's pre-build mirror of it must agree. Each
kernel is held against its plain PyTorch version on the same inputs on the
card: bit for bit (``torch.equal`` on U, X, cost, KKT residual and
n_iters) on every bank and tick, with the deviation bands printed beside
(every kept kernel call's plain version in six worker processes on the
card, from CPU copies of the inputs the kernel was given: the banks, the
ticks, the loops' and graphs' kept calls, the composites and fleets);
and K1 against the port's algorithmic reference (``make_solver``, on the
CPU) at a small size. The kernels' launch counters are zeroed just
before the main path and read just after. Then kernel and plain version are
timed with CUDA events (the plain version one call), and both ticks on the
host clock. A ``phase`` line after each phase gives its wall time.

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
import multiprocessing
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

STARTED = time.monotonic()  # the phase lines say how far into the script each ends
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
# The closed loop: run_sim_stack's scenario. The JAX package's ticks to the
# goal in the same scenario (its nodes.launch.build_sim_stack on the CPU,
# make_solver as the followers' engine): point 62, tracking 53. The port's
# count must lie within LOOP_TICK_BAND of them.
LOOP_HORIZON, LOOP_START, LOOP_GOAL, LOOP_MAX_TICKS = 20, (-1.0, -1.0, 0.0), (1.0, -1.0), 200
JAX_LOOP_TICKS = {"point": 62, "tracking": 53}
LOOP_TICK_BAND = (0.75, 1.5)
LOOP_RECHECK = 5  # kernel calls of each run held against the plain version
NAN_TICK_S = 30.0  # a NaN-goal tick that takes longer has hung
# The conditions phase: the closed loop under the JAX suite's other
# conditions (tests/test_closed_loop.py:89-229, tests/test_safety.py:69,
# tests/test_dynamic_obstacles.py:17), each with its JAX test's settings,
# from (-1, -1, 0) toward (1, -1) on the synthetic map. COND_PILLAR is the
# cell block of a pillar at world (0, -1) that only the lidar sees (the
# planner gets the clean map). JAX_COND holds the JAX package's outcomes on
# these runs (its build_sim_stack with Params() on a 8-core AVX-512 x86
# CPU, one run each, ticks counted as SimStack.run_to_goal counts them):
# the corrected pillar reached in 98 ticks, clearance 0.6105 m; parity
# collides on tick 31; the tracking handoff reached in 133; the monitor
# stops parity short of the pillar, no collision in 300 ticks, clearance
# 0.364 m; the noisy run reached in 59; the kidnapped robot 80 ticks after
# the kidnap; the retask legs in 34 and 37; the pedestrian run reached in
# 179, min separation 0.511 m. Those counts move with the host's float32
# arithmetic (a run on another host read 97, 93, 90, 39 and the pedestrian not
# reached in 400 ticks, min separation 0.518 m), so the phase holds the
# outcome, the ticks within LOOP_TICK_BAND of these where a run reaches, and
# for the pedestrian only the wall and the separation, printing its reached
# flag beside the JAX package's.
COND_PILLAR = (slice(143, 147), slice(123, 127))
COND_PILLAR_XY, COND_MIN_CLEARANCE, COND_SAFETY_STOP, COND_HALT_CLEARANCE = (0.0, -1.0), 0.3, 0.3, 0.15
COND_NOISE = {"odom_xy": 0.01, "odom_yaw": 0.01, "scan": 0.01, "cmd": 0.05}
COND_NOISE_SEED, COND_KIDNAP_AFTER, COND_KIDNAP_POSE = 3, 30, (-1.6, -1.6, 0.3)
COND_RETASK = ((0.2, -1.0), (1.2, -1.4))
COND_PED_HORIZON, COND_PED_X, COND_PED_PERIOD_S, COND_MIN_SEPARATION = 16, 0.2, 12.0, 0.3
JAX_COND = {
    "pillar corrected": {"ticks": 98, "clearance": 0.6105},
    "pillar parity": {"collision tick": 31},
    "tracking handoff": {"ticks": 133, "clearance": 0.5782},
    "safety monitor": {"ticks": 300, "clearance": 0.364},
    "noise": {"ticks": 59},
    "kidnap": {"ticks": 80},
    "retask": {"ticks": (34, 37)},
    "pedestrian": {"ticks": 179, "reached": True, "separation": 0.511},
}
# The robustness composites (solver/rescue.py, multistart_bank.py,
# batched.py) at bench.py's shapes: two-pass capacity 512 for the corrected
# and tracking banks and the saddle composite, the saddle bank at N=40, the
# quadrotor composite's polish capacity 1536. The quadrotor composite
# (plain PyTorch, no kernel) runs at QUAD_B_CUT rows where the full bank
# takes longer than QUAD_MAX_S.
COMP_CAPACITY, SADDLE_N, QUAD_CAPACITY = 512, 40, 1536
QUAD_MAX_S, QUAD_B_CUT = 60.0, 1024
# Every kernel call of the main path's banks and of the composites' counted
# calls runs again through its plain version, on CPU copies of the inputs
# the kernel was given, in PLAIN_WORKERS processes side by side (the plain
# versions are bound by the host's launches, whatever the rows), all done
# within PLAIN_TIMEOUT_S.
PLAIN_WORKERS, PLAIN_TIMEOUT_S = 6, 600.0
# The fleets (parallel/fleet.py) at bench.py's widths (:416-441, :538-610):
# 1024 robots; the tracking fleet 64 ticks, the swarm 128, device_tick_rate
# 64, the quadrotor fleet as many of its 40 ticks as fit in QUAD_FLEET_MAX_S
# (plain PyTorch, launch-bound). Each K1/K2 rollout runs once to warm up,
# then once counted and recorded under torch.cuda.set_sync_debug_mode
# ("error"); its first and last ticks' kernel calls join the plain checks.
# A FLEET_SMALL_B-robot tracking fleet and swarm of FLEET_SMALL_TICKS ticks
# on the card must match the same rollouts on the CPU within FLEET_CPU_ATOL
# on the trajectories: the kernels equal their plain versions bit for bit,
# but the plant's RK4 and the reference windows run sin/cos in CUDA's libm
# on the card and in the CPU's libm on the host (the JAX suite's band
# between its engines inside a closed loop, tests/test_tracking_fleet.py:107-112).
FLEET_B, TRACK_FLEET_TICKS, SWARM_TICKS, TICK_RATE_TICKS = 1024, 64, 128, 64
SWARM_SIDE = 32  # the grid swap's side: SWARM_SIDE**2 = FLEET_B robots
QUAD_FLEET_TICKS, QUAD_FLEET_MAX_S = 40, 30.0
FLEET_SMALL_B, FLEET_SMALL_TICKS, FLEET_CPU_ATOL = 16, 8, 2e-3
# The hybrid bank (bench.py:257-290): the first 1024 rows of the
# obstacle-active bank, MPPI 128 samples x 8 iterations, the polish on K1.
# The escape tick (tests/test_mppi.py:137-166): the point follower with
# escape_after=3 at horizon 12, a forced stall, goal (0.4, -1.6), at most
# 250 ticks after it.
HYBRID_B, ESCAPE_GOAL, ESCAPE_MAX_TICKS = 1024, (0.4, -1.6), 250
# The autonomy phase. The JAX package's numbers on the same scenarios (its
# build_sim_stack and ExplorerNode on the CPU, the setups of
# tests/test_mapper.py::test_navigate_while_mapping and
# tests/test_explorer.py::test_autonomous_exploration_maps_the_room):
# navigate-while-mapping from (-1, -1, 0) to (3.5, -1.8), horizon 12, reaches
# the goal in 150 ticks with 0.6167 of the 240x240 map unknown and 339 wall
# cells on /map; the exploration (safety stop 0.22 m) completes after 1640
# ticks with 7 goals, unknown share 0.4524 and free share 0.5353.
JAX_NWM = {"ticks": 150, "unknown": 0.6167, "walls": 339}
JAX_EXPLORE = {"ticks": 1640, "goals": 7, "unknown": 0.4524, "free": 0.5353}
NWM_START, NWM_GOAL, NWM_HORIZON, NWM_MAX_TICKS, NWM_TICK_BAND = (-1.0, -1.0, 0.0), (3.5, -1.8), 12, 500, 1.25
EXPLORE_MAX_TICKS, EXPLORE_SAFETY_STOP = 2500, 0.22
# LOOP_RECHECK K1 solves of each run (B=1, N=12) re-solved through the plain
# version, one every NWM_RECHECK_EVERY / EXPLORE_RECHECK_EVERY, so that the
# kept solves spread over the run (obstacles from the mapped walls included)
NWM_RECHECK_EVERY, EXPLORE_RECHECK_EVERY = 30, 300
# the mapper on the card against the CPU: 30 (scan, pose) pairs of the
# simulator (360 beams) into the 240x240 grid; the scatter's accumulation
# order is not fixed on CUDA, so a cell may differ in its last bit, and the
# trinary grid must agree on MIN_TRINARY_AGREEMENT of the cells
MAPPER_SCANS, MIN_TRINARY_AGREEMENT = 30, 0.999
WAVE_GOALS = 64  # batched_distance_fields' goals on the synthetic map
LIVE_DURATION, MULTIPROC_DURATION = 30.0, 60.0  # run_live and run_multiprocess budgets [s]
COMPAT_N = 10  # tests/test_compat.py's horizon
# The scale phase (parallel/mesh.py, sharded fleets, sweep.py,
# distributed.py, scaling_bench.py) on SCALE_SHARDS shards of the one card
# (make_mesh(4, device="cuda:0")): the headline and tracking banks (B=4096,
# N=20) against one shard; scaling_bench.run for the K1-bearing engines at
# SCALE_PER_SHARD a shard and the bench's options, for "vmap" and "fast"
# (plain PyTorch, bound by the host's dispatch, whose cost grows with the
# horizon and not the rows) at SCALE_SMALL_PER_SHARD and SCALE_SMALL_N with
# its short schedule, one timed call after a warm-up each; the three sharded fleets at the fleets phase's widths against
# their unsharded runs; BASELINE.json config 5's sweep, 25 configs x
# SWEEP_PER_CONFIG scenarios in chunks of SWEEP_CHUNK, resumed after
# SWEEP_DROPPED chunks are deleted from its checkpoint; K2 at B=1,
# N=LONG_N (tests/test_scaling.py's schedule); two gloo ranks on the card.
# SCALE_KEEP K1 calls of the sharded swarm and SCALE_KEEP K2 calls of the
# sharded tracking fleet, spread over their ticks and shards, and the N=256
# call join the plain checks.
SCALE_SHARDS, SCALE_PER_SHARD, SCALE_REPS = 4, 512, 1
SCALE_SMALL_PER_SHARD, SCALE_SMALL_N = 16, 5
SWEEP_PER_CONFIG, SWEEP_CHUNK, SWEEP_DROPPED = 4096, 16384, (2, 5)
LONG_N, SCALE_KEEP = 256, 5
# The deploy phase: the arguments the port restored, on the card. P is
# Params.load of a YAML that differs from Params() in goal_threshold (the
# reference's params.yaml key): 0.25 m against 0.2 m. The home map
# (maps/map_home.pgm, 314 x 224 cells) and the routes of
# tests/test_carto_map.py:57-80 (three point routes, one tracking route),
# horizon 20, at most 700 ticks each. The JAX package's ticks on them (its
# build_sim_stack with Params() on the CPU, one run of those tests' routes):
# 159, 222 and 186 for the point follower, 126 for the tracking follower.
HOME_PGM, HOME_YAML = "maps/map_home.pgm", "maps/map_home.yaml"
HOME_PAIRS = (
    ((-2.6, -3.4, 0.0), (2.4, -3.4)),
    ((1.65, 3.85, -np.pi / 2), (2.4, -3.0)),
    ((-3.3, 3.0, 0.0), (1.0, 3.85)),
)
JAX_HOME_TICKS = {"point 0": 159, "point 1": 222, "point 2": 186, "tracking": 126}
HOME_HORIZON, HOME_MAX_TICKS, DEPLOY_GOAL_THRESHOLD = 20, 700, 0.25
# The live graph on the home map along the first route: the JAX package's
# lock-step run takes 159 control ticks there, 31.8 s at the 5 Hz control
# rate, so a 30 s budget cannot hold it; the budget is 45 s. One dashboard
# frame every DEPLOY_VIZ_PERIOD s (a value Params() does not set).
DEPLOY_LIVE_DURATION, DEPLOY_VIZ_PERIOD = 45.0, 2.0
# MultiRobotSim with P: two robots from the first and third routes' starts
MULTI_ROBOT_TICKS = 300
# Each K1/K2 solve at a shape no earlier phase held: LOOP_RECHECK calls of
# each run (one every DEPLOY_KEEP_EVERY, from the first) join the plain
# checks, on the inputs the kernel was given.
DEPLOY_KEEP_EVERY = 30
# make_multistart_solver(include_mppi=False) on the obstacle-active bank's
# first rows: the warm start and four arc seeds a scenario, one K1 call
INCLUDE_MPPI_ROWS = 512
# The f64 oracle (tests/oracle.py) on the kernels' own outputs: the five
# kernel banks of tests/test_oracle_sweep.py (tests/oracle_banks.py) and the
# quadrotor's 16 scenarios (the generic engine; the CPU test keeps 4),
# polished in ORACLE_WORKERS processes beside the later phases.
ORACLE_WORKERS, ORACLE_TIMEOUT_S = 2, 600.0
# Their verdicts are read only after the plain versions, so the polish runs
# at a lower priority and yields the host's cores to the phases that drive
# the card (the quadrotor's takes 200-300 s of one core)
ORACLE_NICE = 10
# The quadrotor's make_solver on the oracle's first scenario: two iterations
# of four step sizes, enough to run every derivative make_solver takes
QUAD_F32_SCHEDULE = dict(barrier_stages=1, iters_per_stage=2, n_alphas=4)


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


def cuda_ms(fn, *args, reps=5, warm=True):
    """Median over `reps` runs of fn(*args), in ms on CUDA events, after a
    warm-up run unless ``warm`` is False."""
    import torch

    if warm:
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


class KeptCalls(list):
    """A ``CudaBankSolver.record`` that keeps ``keep`` of the kernel calls,
    one every ``every`` from the first, with their inputs copied at the call
    (a follower reuses its buffers from tick to tick), counts them all and
    holds the last Solution."""

    def __init__(self, keep=LOOP_RECHECK, every=1):
        super().__init__()
        self.keep, self.every, self.calls, self.last = keep, every, 0, None

    def append(self, item):
        thetas, U0s, out = item
        if self.calls % self.every == 0 and len(self) < self.keep:
            super().append(({k: v.clone() for k, v in thetas.items()}, U0s.clone(), out))
        self.calls += 1
        self.last = out


def keep_calls(engines, every=1, keep=LOOP_RECHECK):
    """Zero each CUDA bank solver's launch counter and give it a KeptCalls."""
    for e in engines:
        e.launches = 0
        e.record = KeptCalls(keep, every)


def kept_checks(label, engines):
    """The plain-check entries ``(name, kernel, [(solver, thetas, U0s,
    Solution)])`` of each engine's kept calls (``{path name: engine}``);
    detaches the records. Raises for an engine that launched but kept none."""
    out = []
    for name, e in engines.items():
        calls, e.record = [(e, th, U, sol) for th, U, sol in e.record], None
        if e.launches and not calls:
            raise AssertionError(f"{label} {name}: {e.launches} launches and no call kept")
        if calls:
            kname = "K1" if e.kind == "point_stab" else "K2"
            out.append((f"{label} {name} (B={calls[0][2].shape[0]}, N={e.cfg.N})", kname, calls))
    return out



def stage_p50s(stack):
    """A SimStack's stage p50s in ms: map source and local costmap, planner,
    follower, plant and sensors."""
    return {k: round(stack.telemetry.percentiles(f"{k}_s")["p50"] * 1e3, 3) for k in ("costmap", "plan", "control", "plant")}


def closed_loop(dev, follower):
    """The flagship flow through ``build_sim_stack``: the synthetic indoor
    map, 360-beam lidar, ``Params()``, horizon 20 (the handoff 40), start
    (-1, -1, 0), goal (1, -1), at most 200 ticks; the follower's engines'
    launch counters zeroed just before the run and their first LOOP_RECHECK
    calls kept. Returns (stack, {path name: engine}, reached, ticks, pose)."""
    from ros2_mpc_tpu_torch.nodes.launch import build_sim_stack

    stack = build_sim_stack(follower=follower, horizon=LOOP_HORIZON, start_pose=LOOP_START, device=dev)
    f = stack.follower
    if follower == "point":
        engines = {"K1 point": f.engine}
    else:
        engines = {"K2 tracking": f.engine, "K1 handoff": f.handoff_engine}
    keep_calls(engines.values())
    reached, ticks, pose = stack.run_to_goal(LOOP_GOAL, max_ticks=LOOP_MAX_TICKS)
    return stack, engines, reached, ticks, pose


def closed_loop_phase(dev, card):
    """Both followers through ``closed_loop``, each follower's engines'
    counters zeroed just before its run and read just after; raises unless
    each reaches the goal within LOOP_TICK_BAND of the JAX package's ticks,
    launches its kernel on every solve and a NaN-goal tick degrades
    gracefully. Returns ({"K1": launches, "K2": launches}, plain-check
    entries of each path's first LOOP_RECHECK kernel calls)."""
    import torch

    from ros2_mpc_tpu_torch.planner import native

    loop_launches, checks = {"K1": 0, "K2": 0}, []
    for follower in ("point", "tracking"):
        t0 = time.perf_counter()
        stack, engines, reached, ticks, pose = closed_loop(dev, follower)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        f = stack.follower
        solves = len(f.telemetry.series["solve_s"])
        sp, tp = f.telemetry.percentiles("solve_s"), stack.telemetry.percentiles("tick_s")
        stages = stage_p50s(stack)
        launched = {name: e.launches for name, e in engines.items()}
        calls = {name: e.record.calls for name, e in engines.items()}
        print(
            f"closed loop {follower} (horizon {LOOP_HORIZON}, start {LOOP_START}, goal {LOOP_GOAL}): reached "
            f"{reached}, ticks {ticks} (JAX package {JAX_LOOP_TICKS[follower]}), final pose "
            f"{np.round(pose, 3).tolist()}; {solves} solves, solve p50 {sp['p50'] * 1e3:.3f} ms p99 "
            f"{sp['p99'] * 1e3:.3f} ms; stack tick p50 {tp['p50'] * 1e3:.3f} ms p99 {tp['p99'] * 1e3:.3f} ms "
            f"(host clock; stage p50 {stages}); launches {launched} for solves {calls}; wall {wall:.1f} s -- {card}",
            flush=True,
        )
        lo, hi = (b * JAX_LOOP_TICKS[follower] for b in LOOP_TICK_BAND)
        if not reached or not lo <= ticks <= hi:
            raise AssertionError(f"closed loop {follower}: reached {reached} in {ticks} ticks, band [{lo}, {hi}]")
        if sum(calls.values()) != solves or any(launched[n] < c or c == 0 for n, c in calls.items()):
            raise AssertionError(f"closed loop {follower}: launches {launched} for solves {calls} of {solves}")
        for name, engine in engines.items():
            loop_launches[name[:2]] += launched[name]
            if name == "K1 handoff":  # the 2N geometry at B=1
                check_geometry("K1 handoff", engine, 1)
        checks += kept_checks(f"closed loop {follower}", engines)
        # one tick with a NaN goal: no raise, no hang, a finite command, and
        # the last one where the solve came back non-finite
        keep_calls(engines.values(), keep=0)  # the tick's calls counted, none kept
        u_before = f.u_last.copy()
        stack.publish_goal(float("nan"), 0.0)
        t0 = time.perf_counter()
        out = f.tick()
        nan_s = time.perf_counter() - t0
        cmd = stack.bus.latest(f.cmd_vel_publisher.topic)[0]
        ran = [e.record for e in engines.values() if e.record.calls]
        for e in engines.values():
            e.record = None
        solve_finite = bool(torch.isfinite(ran[0].last.U[0]).all()) if ran else None
        command = np.array([cmd.linear_x, cmd.angular_z])
        print(
            f"closed loop {follower} NaN goal: tick {nan_s * 1e3:.1f} ms, status {out['status']}, solve U[0] "
            f"finite {solve_finite}, command {command.tolist()}, u {np.asarray(out.get('u')).tolist()}"
        )
        if nan_s > NAN_TICK_S or not np.isfinite(command).all() or not np.isfinite(out.get("u", np.nan)).all():
            raise AssertionError(f"closed loop {follower}: the NaN-goal tick did not degrade gracefully")
        if solve_finite is False and not np.array_equal(out["u"], u_before):
            raise AssertionError(f"closed loop {follower}: a non-finite solve did not fall back to the last command")
    print(f"closed loop: A* {'native (native/astar.cpp)' if native.load() is not None else 'Python (planner/astar_py.py)'}")
    return loop_launches, checks


def cond_drive(stack, n, stop_on_collision=True, stop_on_goal=True, watch=None, before=None):
    """Up to ``n`` stack ticks as the JAX tests run them: stop on a
    collision with the static map (if asked) or when the follower latches.
    ``watch(pose)`` is minimized over the ticks, ``before(i)`` runs ahead of
    tick i. Returns (reached, ticks, collided on any tick, min of watch)."""
    collided, low = False, np.inf
    for i in range(n):
        if before is not None:
            before(i)
        out = stack.tick()
        if watch is not None:
            low = min(low, watch(out["pose"]))
        if stack.sim.in_collision():
            collided = True
            if stop_on_collision:
                return False, i + 1, True, low
        if stop_on_goal and out["control"].get("status") == "goal_reached":
            return True, i + 1, collided, low
    return False, n, collided, low


def cond_run(dev, name):
    """One run of the conditions phase with its JAX test's settings; the
    follower's engines count from 0 and keep their first LOOP_RECHECK calls
    from just before it. Returns (stack, {path name: engine}, outcome)."""
    from ros2_mpc_tpu_torch.nodes.launch import build_sim_stack
    from ros2_mpc_tpu_torch.utils import pgm

    kw = dict(follower="point", start_pose=LOOP_START, horizon=LOOP_HORIZON, device=dev)
    if name in ("pillar corrected", "pillar parity", "tracking handoff", "safety monitor"):
        world = pgm.synthetic_indoor_map()
        clean = world.copy()
        world[COND_PILLAR] = 0
        kw.update(map_image=world, map_info=dict(pgm.DEFAULT_MAP_INFO), planner_map_image=clean)
        kw.update(reference_parity=name in ("pillar parity", "safety monitor"))
        if name == "tracking handoff":
            kw["follower"] = "tracking"
        if name == "safety monitor":
            kw["safety_stop"] = COND_SAFETY_STOP
    elif name == "noise":
        kw.update(noise=COND_NOISE, noise_seed=COND_NOISE_SEED)
    elif name == "pedestrian":
        kw["horizon"] = COND_PED_HORIZON
    stack = build_sim_stack(**kw)
    f = stack.follower
    engines = {"K1 point": f.engine} if kw["follower"] == "point" else {"K2 tracking": f.engine, "K1 handoff": f.handoff_engine}
    keep_calls(engines.values())
    clearance = lambda p: float(np.hypot(p[0] - COND_PILLAR_XY[0], p[1] - COND_PILLAR_XY[1]))  # noqa: E731
    out = {}
    if name == "retask":
        legs = []
        for goal in COND_RETASK:
            stack.publish_goal(*goal)
            legs.append(cond_drive(stack, 300, stop_on_collision=False))
        out.update(reached=all(r for r, *_ in legs), ticks=tuple(t for _, t, *_ in legs), collided=any(c for *_, c, _ in legs))
        out["goal distance"] = float(np.linalg.norm(stack.sim.pose[:2].cpu().numpy() - np.asarray(COND_RETASK[1])))
        return stack, engines, out
    stack.publish_goal(*LOOP_GOAL)
    if name == "kidnap":
        for _ in range(COND_KIDNAP_AFTER):
            stack.tick()
        stack.sim.pose = COND_KIDNAP_POSE  # float32 on the simulator's device
        reached, ticks, collided, _ = cond_drive(stack, 400, stop_on_collision=False)
    elif name == "noise":
        reached, ticks, collided, _ = cond_drive(stack, 300, stop_on_collision=False)
    elif name == "safety monitor":
        reached, ticks, collided, low = cond_drive(stack, 300, stop_on_goal=False, watch=clearance)
        out.update(clearance=low, blocked=stack.safety.n_blocked, halted_at=clearance(stack.sim.pose.cpu().numpy()))
    elif name == "pedestrian":
        tick = {"i": 0}

        def ped_pos():
            t = tick["i"] * stack.params.dt
            return [(COND_PED_X, -1.1 + 0.35 * np.sin(2 * np.pi * t / COND_PED_PERIOD_S))]

        stack.sim.moving_obstacles = ped_pos
        separation = lambda p: float(np.hypot(p[0] - ped_pos()[0][0], p[1] - ped_pos()[0][1]))  # noqa: E731
        reached, ticks, collided, low = cond_drive(
            stack, 400, stop_on_collision=False, watch=separation, before=lambda i: tick.update(i=i)
        )
        out["separation"] = low
    else:
        reached, ticks, collided, low = cond_drive(stack, 400, watch=clearance)
        out["clearance"] = low
    out.update(reached=reached, ticks=ticks, collided=collided)
    return stack, engines, out


def conditions_phase(dev, card):
    """The eight runs of the conditions phase (module docstring), each
    held to the JAX package's outcome (JAX_COND) and to launches equal to
    solves. Returns ({"K1": launches, "K2": launches}, plain-check entries
    of each run's first LOOP_RECHECK kernel calls)."""
    import torch

    launches, checks = {"K1": 0, "K2": 0}, []
    band = lambda t, ref: LOOP_TICK_BAND[0] * ref <= t <= LOOP_TICK_BAND[1] * ref  # noqa: E731
    for name, ref in JAX_COND.items():
        t0 = time.perf_counter()
        stack, engines, out = cond_run(dev, name)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        f = stack.follower
        solves = len(f.telemetry.series["solve_s"])
        sp, tp = f.telemetry.percentiles("solve_s"), stack.telemetry.percentiles("tick_s")
        counts = {n: (e.launches, e.record.calls) for n, e in engines.items()}
        extra = {k: round(v, 4) if isinstance(v, float) else v for k, v in out.items() if k not in ("reached", "ticks", "collided")}
        print(
            f"conditions {name}: reached {out['reached']}, collided {out['collided']}, ticks {out['ticks']} {extra} "
            f"(JAX package {ref}); {solves} solves, solve p50 {sp['p50'] * 1e3:.3f} ms p99 {sp['p99'] * 1e3:.3f} ms; "
            f"stack tick p50 {tp['p50'] * 1e3:.3f} ms (host clock); launches and solves {counts}; wall {wall:.1f} s "
            f"-- {card}",
            flush=True,
        )
        reached, ticks, collided = out["reached"], out["ticks"], out["collided"]
        if name == "pillar parity":
            ok = collided and not reached
        elif name == "safety monitor":
            ok = not collided and ticks == ref["ticks"] and out["blocked"] > 0 and out["halted_at"] > COND_HALT_CLEARANCE
        elif name == "pedestrian":
            ok = not collided and out["separation"] > COND_MIN_SEPARATION
        elif name == "retask":
            ok = reached and not collided and all(map(band, ticks, ref["ticks"]))
            ok = ok and out["goal distance"] <= stack.params.goal_threshold + 0.1
        else:
            ok = reached and not collided and band(ticks, ref["ticks"])
            if name == "pillar corrected":
                ok = ok and out["clearance"] > COND_MIN_CLEARANCE
        if not ok:
            raise AssertionError(f"conditions {name}: {out}, not the JAX package's outcome {ref}")
        if sum(c for _, c in counts.values()) != solves or any(n != c for n, c in counts.values()) or not solves:
            raise AssertionError(f"conditions {name}: launches and solves {counts} of {solves}")
        for n, (k, _) in counts.items():
            launches[n[:2]] += k
        checks += kept_checks(f"conditions {name}", engines)
    print(f"launch counters of the conditions phase: {launches}", flush=True)
    return launches, checks


def composite_kernels(comp):
    """The CUDA bank solvers a composite (or a bank solver) calls."""
    from ros2_mpc_tpu_torch.solver.cuda_kernel import CudaBankSolver

    return [e for e in getattr(comp, "engines", (comp,)) if isinstance(e, CudaBankSolver)]


def run_counted(name, comp, th, U0, expect):
    """One call of ``comp`` with its kernels' launch counters zeroed just
    before and read just after; raises unless they launched ``expect``
    times. Each kernel call of it is recorded with the inputs it was given.
    Returns (Solution, launches, [(kernel, thetas, U0s, result), ...])."""
    import torch

    kernels = composite_kernels(comp)
    for k in kernels:
        k.launches, k.record = 0, []
    sol = comp(th, U0)
    torch.cuda.synchronize()
    n = sum(k.launches for k in kernels)
    calls = [(k, *c) for k in kernels for c in k.record]
    for k in kernels:
        k.record = None
    if n != expect or len(calls) != n:
        raise AssertionError(f"{name}: {n} kernel launches, the composite's structure gives {expect}")
    for t in sol.U, sol.X, sol.cost:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: non-finite output")
    return sol, n, calls


def plain_job(solver, thetas, U0s, with_counters=False):
    """The arguments of ``plain_call`` for one kernel call: the solver's
    build-time configuration and CPU (numpy) copies of the very inputs the
    kernel was given."""
    return (
        solver.kind,
        solver.cfg,
        with_counters,
        {k: v.cpu().numpy() for k, v in thetas.items()},
        U0s.cpu().numpy(),
    )


def plain_call(kind, cfg, with_counters, thetas, U0s, device):
    """``CudaBankSolver.plain`` on ``device`` in a worker process, on the
    inputs of ``plain_job``. Returns (the Solution's fields, the counters,
    seconds), as numpy arrays."""
    import torch

    from ros2_mpc_tpu_torch.solver.cuda_kernel import CudaBankSolver

    t0 = time.perf_counter()
    dev = torch.device(device)
    out = CudaBankSolver(kind, cfg, with_counters).plain(
        {k: torch.from_numpy(v).to(dev) for k, v in thetas.items()}, torch.from_numpy(U0s).to(dev)
    )
    sol, cnt = out if with_counters else (out, {})
    return [t.cpu().numpy() for t in sol], {k: v.cpu().numpy() for k, v in cnt.items()}, time.perf_counter() - t0


def plain_cost(job):
    """A plain call's expected cost: schedule iterations x horizon x
    line-search candidates (the plain versions are bound by the host's
    launches, whatever the rows)."""
    cfg = job[1]
    return len(cfg.mus) * cfg.N * cfg.n_alphas


def check_geometry(name, solver, Bk):
    """Print a kernel's geometry for a bank of Bk and raise unless the
    wrapper's pre-build mirror agrees."""
    from ros2_mpc_tpu_torch.solver.cuda_kernel import group_geometry

    info = solver.kernel_info(Bk)
    print(f"{name} (B={Bk}, N={solver.cfg.N}, n_alphas={solver.cfg.n_alphas}): {info}", flush=True)
    mirror = group_geometry(solver.kind, Bk, solver.cfg.N, solver.cfg.n_alphas)
    if {k: info[k] for k in mirror} != mirror:
        raise AssertionError(f"{name}: group_geometry {mirror} is not the kernel's geometry")
    return info


def composites_phase(dev, card, inp):
    """The robustness composites through the port's entry points: the
    corrected and tracking two-pass banks (K1, K2), the saddle bank's three
    rungs at N=40 (plain K1, bank multistart, multistart two-pass with the
    KKT polish) and the quadrotor fast-polish bank (plain PyTorch). Each
    K1/K2 composite's counters are zeroed just before its counted call and
    read just after. Returns ({"K1": launches, "K2": launches}, [(name,
    kernel name, kernel calls of its counted call), ...]); the caller holds
    each of those calls against the plain version on its inputs."""
    import torch

    from ros2_mpc_tpu_torch.solver import (
        SolverSettings,
        adversarial_saddle_bank,
        make_bank_multistart_solver,
        make_cuda_two_pass_point_stab,
        make_cuda_two_pass_tracking,
        make_fast_polish_solver,
        make_multistart_two_pass_solver,
        make_point_stabilization,
        make_quadrotor_hover,
    )
    from ros2_mpc_tpu_torch.solver.cuda_kernel import make_cuda_point_stab_solver

    fast = SolverSettings.fast()
    launches, checks = {"K1": 0, "K2": 0}, []
    U0 = torch.zeros(B, N, 2, dtype=torch.float32, device=dev)
    conv = lambda sol: float(sol.converged.float().mean())  # noqa: E731

    # A/B: fast first pass + compacted cold/warm rescue (bench.py:235-240, :491-498)
    for name, kname, make, prob, th in (
        ("corrected two-pass", "K1", make_cuda_two_pass_point_stab, inp.prob_c, inp.th_obs),
        ("tracking two-pass", "K2", make_cuda_two_pass_tracking, inp.prob_t, inp.th_trk),
    ):
        comp = make(prob.ocp, fast, capacity=COMP_CAPACITY)
        sol, n, calls = run_counted(name, comp, th, U0, expect=2)
        launches[kname] += n
        checks.append((f"composites {name}", kname, calls))
        first = calls[0][3]  # the first pass's Solution
        fails = int((~first.converged).sum())
        ms = cuda_ms(comp, th, U0)
        print(
            f"composites {name} (B={B}, N={N}, first pass fast, capacity {COMP_CAPACITY}, rescue 16x10 iterations "
            f"x 12 alphas): converged first pass {conv(first):.4f}, two-pass {conv(sol):.4f}; stragglers {fails} "
            f"({max(0, fails - COMP_CAPACITY)} beyond capacity); {ms:.3f} ms median of 5 ({B / ms * 1e3:,.0f} "
            f"solves/s); {kname} launches per call {n} -- {card}",
            flush=True,
        )
        if conv(sol) < conv(first) or bool((sol.kkt_residual > first.kkt_residual).any()):
            raise AssertionError(f"{name}: the two-pass is worse than its first pass")
        check_geometry(f"{kname} {name} rescue bank", comp.engines[1], 2 * COMP_CAPACITY)

    # C: the saddle bank's three rungs (bench.py:292-352)
    prob_s = make_point_stabilization(inp.params, horizon=SADDLE_N, reference_parity=False, device=dev)
    th_s, U0_s = adversarial_saddle_bank(prob_s, B, seed=0)
    rungs = (
        ("plain single-start K1", make_cuda_point_stab_solver(prob_s.ocp, prob_s.settings), 1),
        ("bank multistart (K=3)", make_bank_multistart_solver(prob_s.ocp, prob_s.settings, swing_fracs=(1.0,)), 1),
        (
            "multistart two-pass + polish",
            make_multistart_two_pass_solver(prob_s.ocp, prob_s.settings, capacity=COMP_CAPACITY, swing_fracs=(1.0,)),
            2,
        ),
    )
    sols = []
    for name, solve, expect in rungs:
        sol, n, calls = run_counted(f"saddle {name}", solve, th_s, U0_s, expect)
        launches["K1"] += n
        checks.append((f"composites saddle {name}", "K1", calls))
        # the composite's seconds-long calls (the polish is launch-bound
        # plain PyTorch): one timed call after the counted one
        reps = 1 if expect == 2 else 3
        ms = cuda_ms(solve, th_s, U0_s, reps=reps, warm=reps > 1)
        sols.append(sol)
        print(
            f"composites saddle {name} (B={B}, N={SADDLE_N}, corrected, default schedule): converged "
            f"{conv(sol):.4f}; {ms:.3f} ms {'median of 3' if reps > 1 else 'one call'} ({B / ms * 1e3:,.0f} "
            f"solves/s); K1 launches per call {n} -- {card}",
            flush=True,
        )
    if not conv(sols[0]) <= conv(sols[1]) <= conv(sols[2]):
        raise AssertionError(f"saddle rungs: converged fractions {[conv(s) for s in sols]} decrease")
    if bool((sols[2].kkt_residual > sols[1].kkt_residual).any()):
        raise AssertionError("saddle composite worse than its multistart first pass on some row")
    comp_s = rungs[2][1]
    polish = comp_s.engines[-1]
    rows = {k: v[:COMP_CAPACITY].contiguous() for k, v in th_s.items()}
    ms_polish = cuda_ms(polish, rows, sols[1].U[:COMP_CAPACITY].contiguous(), reps=1, warm=False)
    print(
        f"composites saddle polish alone (12 box-DDP iterations on {COMP_CAPACITY} rows, N={SADDLE_N}, plain "
        f"PyTorch): {ms_polish:.3f} ms, one call -- {card}",
        flush=True,
    )
    check_geometry("K1 saddle multistart", comp_s.engines[0], 3 * B)

    # D: the quadrotor fast-polish composite (bench.py:378-414's recipe,
    # seeded here), plain PyTorch on the card
    prob_q = make_quadrotor_hover(horizon=N, settings=fast, device=dev)
    comp_q = make_fast_polish_solver(prob_q.ocp, prob_q.settings, capacity=QUAD_CAPACITY)
    for Bq in (B, QUAD_B_CUT):
        th_q = quadrotor_bank(prob_q, Bq, dev)
        U0_q = prob_q.default_u0.repeat(Bq, 1, 1)
        t0 = time.perf_counter()
        sol_q = comp_q(th_q, U0_q)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if secs <= QUAD_MAX_S or Bq == QUAD_B_CUT:
            break
        print(f"composites quadrotor fast-polish at B={Bq} took {secs:.1f} s, above {QUAD_MAX_S:.0f} s: cut to B={QUAD_B_CUT}")
    first_q = comp_q.engines[0](th_q, U0_q)
    print(
        f"composites quadrotor fast-polish (B={Bq}{'' if Bq == B else ', cut from ' + str(B)}, N={N}, fast first "
        f"pass, polish capacity {min(QUAD_CAPACITY, Bq)}, 12 iterations; plain PyTorch, no kernel): converged first "
        f"pass {conv(first_q):.4f}, composite {conv(sol_q):.4f}; {secs * 1e3:.1f} ms (host clock, one call) "
        f"({Bq / secs:,.0f} solves/s) -- {card}",
        flush=True,
    )
    if not bool(torch.isfinite(sol_q.U).all()) or conv(sol_q) < conv(first_q):
        raise AssertionError("quadrotor fast-polish: non-finite, or worse than its first pass")
    print(f"launch counters of the composites: {launches}", flush=True)
    return launches, checks


def quadrotor_bank(prob_q, Bq, dev):
    """bench.py:378-414's quadrotor recipe, drawn from np.random.default_rng(3):
    starts near hover with tilt and yaw, goal poses within 0.3 m."""
    import torch

    rng = np.random.default_rng(3)
    xq = np.zeros((Bq, 12))
    xq[:, 0:3] = rng.uniform(-0.4, 0.4, size=(Bq, 3))
    xq[:, 6:8] = rng.uniform(-0.15, 0.15, size=(Bq, 2))
    xq[:, 8] = rng.uniform(-0.5, 0.5, size=Bq)
    gq = np.concatenate([rng.uniform(-0.3, 0.3, size=(Bq, 3)), rng.uniform(-0.4, 0.4, size=(Bq, 1))], axis=1)
    tens = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    return torch.func.vmap(prob_q.make_theta)(tens(xq), tens(gq))


def run_rollout(name, roll, args, ticks, per_tick=1):
    """One rollout through ``roll`` after a warm-up call: its kernels'
    launch counters zeroed just before and read just after, every kernel
    call recorded, all of it under ``torch.cuda.set_sync_debug_mode("error")``
    up to the result (a read back, ``nonzero`` or pageable copy inside a
    tick raises there), timed with CUDA events. Raises unless the kernels
    launched ``per_tick`` times a tick (once a shard). Returns (result, ms,
    launches, recorded calls)."""
    import torch

    from ros2_mpc_tpu_torch.parallel.mesh import Sharded

    roll(*args)  # warm-up: the kernels' schedules reach the card here
    torch.cuda.synchronize()
    kernels = composite_kernels(roll)
    for k in kernels:
        k.launches, k.record = 0, []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        out = roll(*args)
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    end.synchronize()
    launches = sum(k.launches for k in kernels)
    calls = [(k, *c) for k in kernels for c in k.record]
    for k in kernels:
        k.record = None
    if launches != ticks * per_tick or len(calls) != launches:
        raise AssertionError(f"{name}: {launches} kernel launches in {ticks} ticks of {per_tick} shard(s)")
    final = out.final_states.gather() if isinstance(out.final_states, Sharded) else out.final_states
    if not bool(torch.isfinite(final).all()):
        raise AssertionError(f"{name}: non-finite final states")
    return out, start.elapsed_time(end), launches, calls


def fleets_phase(dev, card, inp):
    """The fleets and the sampling engines through the port's entry points:
    the tracking fleet (K2), the swarm (K1), device_tick_rate and its
    rollout (K1), the generic quadrotor fleet (plain PyTorch), the hybrid
    bank (MPPI, then K1) and the point follower's escape tick (the multistart
    engine on K1). Each K1/K2 rollout is counted, recorded and run without a
    host sync (``run_rollout``). Returns ({"K1": launches, "K2": launches},
    [(name, kernel name, kernel calls), ...] for the plain checks, and a
    function that runs the card-against-CPU fleets)."""
    import torch

    from ros2_mpc_tpu_torch.nodes.launch import build_sim_stack
    from ros2_mpc_tpu_torch.parallel import (
        arc_path_fleet,
        grid_swap_swarm,
        make_fleet_rollout,
        make_generic_fleet_rollout,
        make_swarm_rollout,
        make_tracking_fleet_rollout,
        random_fleet,
    )
    from ros2_mpc_tpu_torch.solver import (
        SolverSettings,
        make_bank_solver_fast,
        make_hybrid_solver,
        make_point_stabilization,
        make_quadrotor_hover,
        make_tracking,
    )
    from ros2_mpc_tpu_torch.solver.packed import device_tick_rate

    params, dt, rt = inp.params, inp.params.dt, SolverSettings.realtime()
    launches, checks = {"K1": 0, "K2": 0}, []

    def report(name, out, ms, n, ticks, Bf, quality, kname, calls):
        # the tick's kernel call alone on the first and the last tick's
        # inputs splits a tick into the bank solve (wrapper and kernel) and
        # the rest (host-issued tensor ops)
        k_ms = [cuda_ms(c[0], *c[1:3]) for c in (calls[0], calls[-1])]
        print(
            f"fleets {name} (B={Bf}, N={N}, realtime, {ticks} ticks): reach {float(out.reach_fraction):.4f}, "
            f"{quality}; {ms / ticks:.3f} ms a tick, {Bf * ticks / ms * 1e3:,.0f} robot-ticks/s (CUDA events, "
            f"one rollout), the {kname} call alone {k_ms[0]:.3f} ms on tick 0's inputs and {k_ms[1]:.3f} ms on the "
            f"last tick's (median of 5); launches {n} for {ticks} ticks; no host sync inside the rollout -- {card}",
            flush=True,
        )

    # the tracking fleet: corrected, terminal weight (10, 10, 1), arc paths
    def tracking_problem(d):
        return make_tracking(params, horizon=N, reference_parity=False, settings=rt, terminal_weight=(10.0, 10.0, 1.0), device=d)

    prob_tf = tracking_problem(dev)
    th_tf, paths_tf, U0_tf = arc_path_fleet(prob_tf, FLEET_B, n_waypoints=64, seed=0, device=dev)
    roll_tf = make_tracking_fleet_rollout(prob_tf, TRACK_FLEET_TICKS, dt, goal_threshold=0.25, device=dev)
    out, ms, n, calls = run_rollout("tracking fleet", roll_tf, (th_tf, paths_tf, U0_tf), TRACK_FLEET_TICKS)
    report(
        "tracking fleet", out, ms, n, TRACK_FLEET_TICKS, FLEET_B,
        f"mean cross-track {float(out.mean_cross_track):.4f} m, max {float(out.max_cross_track):.4f} m", "K2", calls,
    )  # fmt: skip
    launches["K2"] += n
    checks.append((f"fleets tracking fleet ticks 0 and {TRACK_FLEET_TICKS - 1}", "K2", [calls[0], calls[-1]]))

    # the swarm: the grid swap, 32 x 32 robots 2 m apart, k = 4 neighbors
    def swarm_problem(d):
        return make_point_stabilization(params, horizon=N, reference_parity=False, settings=rt, device=d)

    prob_sw = swarm_problem(dev)
    th_sw, U0_sw = grid_swap_swarm(prob_sw, side=SWARM_SIDE, pitch=2.0, device=dev)
    roll_sw = make_swarm_rollout(prob_sw, SWARM_TICKS, dt, k_neighbors=4, device=dev)
    out, ms, n, calls = run_rollout("swarm", roll_sw, (th_sw, U0_sw), SWARM_TICKS)
    report(
        f"swarm (grid swap {SWARM_SIDE}x{SWARM_SIDE}, pitch 2 m, k=4)", out, ms, n, SWARM_TICKS, SWARM_SIDE**2,
        f"mean distance {float(out.mean_dist):.4f} m, min separation {float(out.min_separation):.4f} m", "K1", calls,
    )  # fmt: skip
    launches["K1"] += n
    checks.append((f"fleets swarm ticks 0 and {SWARM_TICKS - 1}", "K1", [calls[0], calls[-1]]))

    # device_tick_rate (parity, realtime, N=20: bench.py's prob_rt), and its
    # rollout counted and checked for host syncs
    prob_rt = make_point_stabilization(params, horizon=N, settings=rt, device=dev)
    tick_s = device_tick_rate(prob_rt, n_ticks=TICK_RATE_TICKS, dt=dt, device=dev)
    th_rt, U0_rt = random_fleet(prob_rt, FLEET_B, seed=0, device=dev)
    roll_rt = make_fleet_rollout(prob_rt, TICK_RATE_TICKS, dt, device=dev)
    out, ms, n, _ = run_rollout("device_tick_rate rollout", roll_rt, (th_rt, U0_rt), TICK_RATE_TICKS)
    print(
        f"fleets device_tick_rate (random_fleet B={FLEET_B}, N={N}, parity, realtime, {TICK_RATE_TICKS} ticks): "
        f"{tick_s * 1e3:.4f} ms a tick (best of 5, CUDA events), {FLEET_B / tick_s:,.0f} robot-ticks/s; its rollout "
        f"once more: {ms / TICK_RATE_TICKS:.4f} ms a tick, reach {float(out.reach_fraction):.4f}, mean distance "
        f"{float(out.mean_dist):.4f} m, launches {n} for {TICK_RATE_TICKS} ticks; no host sync inside the rollout "
        f"-- {card}",
        flush=True,
    )
    launches["K1"] += n

    # the generic quadrotor fleet (bench.py:416-441): plain PyTorch, as many
    # of its ticks as fit in QUAD_FLEET_MAX_S, one tick timed first (after
    # one that warms up: the first call takes ~4x a later one)
    prob_qf = make_quadrotor_hover(horizon=N, settings=rt, device=dev)
    th_qf = {k: v[:FLEET_B].contiguous() for k, v in quadrotor_bank(prob_qf, B, dev).items()}
    U0_qf = prob_qf.default_u0.repeat(FLEET_B, 1, 1)
    fast_q = make_bank_solver_fast(prob_qf.ocp, prob_qf.settings)
    one = make_generic_fleet_rollout(prob_qf, 1, goal_threshold=0.1, engine=lambda o, st: fast_q, device=dev)
    for _ in range(2):
        t0 = time.perf_counter()
        one(th_qf, U0_qf)
        torch.cuda.synchronize()
        tick_q = time.perf_counter() - t0
    T_q = int(min(QUAD_FLEET_TICKS, max(1, QUAD_FLEET_MAX_S // tick_q)))
    roll_qf = make_generic_fleet_rollout(prob_qf, T_q, goal_threshold=0.1, engine=lambda o, st: fast_q, device=dev)
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = roll_qf(th_qf, U0_qf)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cut = f", cut from {QUAD_FLEET_TICKS}: one tick took {tick_q:.2f} s" if T_q < QUAD_FLEET_TICKS else ""
    print(
        f"fleets quadrotor generic fleet (B={FLEET_B}, N={N}, realtime, goal threshold 0.1, {T_q} ticks{cut}; plain "
        f"PyTorch, no kernel): reach {float(out.reach_fraction):.4f}, mean distance {float(out.mean_dist):.4f} m; "
        f"{secs / T_q * 1e3:.1f} ms a tick (host clock), {FLEET_B * T_q / secs:,.0f} robot-ticks/s; no host sync "
        f"inside the rollout -- {card}",
        flush=True,
    )
    if not bool(torch.isfinite(out.final_states).all()):
        raise AssertionError("quadrotor fleet: non-finite final states")

    # the hybrid bank: MPPI 128 x 8, the polish and the plain solve on K1
    th_h = {k: v[:HYBRID_B].contiguous() for k, v in inp.th_obs.items()}
    U0_h = torch.zeros(HYBRID_B, N, 2, dtype=torch.float32, device=dev)
    hybrid = make_hybrid_solver(inp.prob_c.ocp, inp.prob_c.settings, device=dev)
    gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
    hybrid(th_h, U0_h, gen())  # warm-up
    torch.cuda.synchronize()
    (k1_h,) = hybrid.engines
    k1_h.launches, k1_h.record = 0, []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        sol_h = hybrid(th_h, U0_h, gen())
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    end.synchronize()
    ms_h, n = start.elapsed_time(end), k1_h.launches
    calls = [(k1_h, *c) for c in k1_h.record]
    k1_h.record = None
    plain_k1 = calls[1][3]  # the hybrid's second K1 call: plain K1 from U0
    conv_h, conv_p = float(sol_h.converged.float().mean()), float(plain_k1.converged.float().mean())
    print(
        f"fleets hybrid bank (obstacle-active rows 0-{HYBRID_B - 1}, N={N}, corrected, default schedule, MPPI 128 "
        f"samples x 8 iterations): converged hybrid {conv_h:.4f}, plain K1 {conv_p:.4f}; {ms_h:.3f} ms one call "
        f"({HYBRID_B / ms_h * 1e3:,.0f} solves/s), K1 launches {n}; no host sync inside -- {card}",
        flush=True,
    )
    if n != 2 or len(calls) != 2:
        raise AssertionError(f"hybrid: {n} K1 launches, its structure gives 2")
    both = sol_h.converged & plain_k1.converged
    if conv_h < conv_p or bool((sol_h.cost[both] > plain_k1.cost[both] + 1e-5).any()):
        raise AssertionError("hybrid: worse than plain K1")
    launches["K1"] += n
    checks.append(("fleets hybrid bank", "K1", calls))

    # the escape tick: the point follower's multistart on K1
    stack = build_sim_stack(
        follower="point", start_pose=LOOP_START, horizon=12, follower_kwargs=dict(escape_after=3), device=dev
    )
    f = stack.follower
    f.engine.launches = f.escape_engine.launches = 0
    stack.publish_goal(*ESCAPE_GOAL)
    stack.global_planner.tick()
    first = stack.tick()["control"].get("escaped")
    f._stall = 99  # force the stall detector past the threshold
    t0 = time.perf_counter()
    out = stack.tick()["control"]
    esc_ms = (time.perf_counter() - t0) * 1e3
    ticks, reached = 2, False
    for _ in range(ESCAPE_MAX_TICKS):
        ticks += 1
        if stack.tick()["control"].get("status") == "goal_reached":
            reached = True
            break
    print(
        f"fleets escape tick (point follower, horizon 12, escape_after 3, forced stall, goal {ESCAPE_GOAL}): escaped "
        f"{out['escaped']} (tick before {first}), escapes {f.n_escapes}, command finite {bool(np.isfinite(out['u']).all())}, "
        f"escape tick {esc_ms:.1f} ms (host clock, the whole stack tick), goal reached {reached} in {ticks} ticks; "
        f"launches: escape K1 {f.escape_engine.launches}, tick K1 {f.engine.launches} -- {card}",
        flush=True,
    )
    if first is not False or out["escaped"] is not True or f.n_escapes != 1 or not np.isfinite(out["u"]).all():
        raise AssertionError("escape tick: the forced stall did not escape exactly once with a finite command")
    if not reached or f.escape_engine.launches != 1:
        raise AssertionError(f"escape tick: reached {reached}, escape launches {f.escape_engine.launches}")
    launches["K1"] += f.escape_engine.launches + f.engine.launches
    print(f"launch counters of the fleets: {launches}", flush=True)

    def card_against_cpu():
        """The small tracking fleet and swarm on the card and on the CPU
        (the plain versions): max |trajectory difference| per fleet."""
        out = {}
        for name, make_prob, build, make_roll in (
            (
                "tracking fleet",
                tracking_problem,
                lambda p, d: arc_path_fleet(p, FLEET_SMALL_B, n_waypoints=64, seed=0, device=d),
                lambda p, d: make_tracking_fleet_rollout(p, FLEET_SMALL_TICKS, dt, record=True, device=d),
            ),
            (
                "swarm",
                swarm_problem,
                lambda p, d: grid_swap_swarm(p, side=4, pitch=2.0, device=d),
                lambda p, d: make_swarm_rollout(p, FLEET_SMALL_TICKS, dt, k_neighbors=4, record=True, device=d),
            ),
        ):
            trajs = []
            for d in (dev, torch.device("cpu")):
                p = make_prob(d)
                trajs.append(make_roll(p, d)(*build(p, d)).trajectories.cpu())
            out[name] = float((trajs[0] - trajs[1]).abs().max())
        return out

    return launches, checks, card_against_cpu


def compat_calls(device, reference_parity=True):
    """One ``PointStabilizationMpc.perform_mpc`` and one
    ``TrackingMpc.perform_mpc`` (tests/test_compat.py's inputs, N=10) on
    ``device``, in parity or corrected mode: ({name: outputs}, {name: host
    ms})."""
    import torch

    from ros2_mpc_tpu_torch import compat
    from ros2_mpc_tpu_torch.config import Params

    if torch.device(device).type == "cpu":
        torch.set_num_threads(4)  # a worker beside the card's phase
    ts = np.arange(1, COMPAT_N + 1) * 0.2
    pf = np.stack([0.15 * ts, np.zeros(COMPAT_N), np.zeros(COMPAT_N)], axis=1).reshape(-1, 1)
    puf = np.tile([0.15, 0.0], (COMPAT_N, 1)).reshape(-1, 1)
    calls = {
        "PointStabilizationMpc": (np.array([0.0, 0.0, 0.0]), np.array([1.0, 0.0, 0.0])),
        "TrackingMpc": (np.zeros(3), pf, puf),
    }
    out, ms = {}, {}
    for name, args in calls.items():
        mpc = getattr(compat, name)(Params(), reference_parity=reference_parity, horizon=COMPAT_N, device=device)
        t0 = time.perf_counter()
        res = mpc.perform_mpc(np.zeros((2, COMPAT_N)), *args)  # ends on a read back
        ms[name] = (time.perf_counter() - t0) * 1e3
        out[name] = res if isinstance(res, tuple) else (res,)
    return out, ms


def autonomy_phase(dev, card):
    """Navigate-while-mapping, frontier exploration, the wavefront planner,
    the live and the multi-process graphs and the compat adapters through
    the port's entry points on the card (module docstring). Raises on any
    failed check. Returns ({"K1": launches, "K2": launches} of the in-process
    runs, plain-check entries of K1's kept calls in the two mapping runs)."""
    import torch

    from ros2_mpc_tpu_torch.config import Params
    from ros2_mpc_tpu_torch.nodes import live
    from ros2_mpc_tpu_torch.nodes.bus import MessageBus
    from ros2_mpc_tpu_torch.nodes.explorer import ExplorerNode
    from ros2_mpc_tpu_torch.nodes.launch import build_sim_stack
    from ros2_mpc_tpu_torch.nodes.multiproc import run_multiprocess
    from ros2_mpc_tpu_torch.nodes.sim import Simulator
    from ros2_mpc_tpu_torch.nodes.topics import MapSubscriber
    from ros2_mpc_tpu_torch.ops import costmap as costmapops
    from ros2_mpc_tpu_torch.ops import grid as gridops
    from ros2_mpc_tpu_torch.ops.mapping import logodds_update, occupancy_probability
    from ros2_mpc_tpu_torch.planner import astar_path, wavefront
    from ros2_mpc_tpu_torch.utils import pgm

    launches, checks = {"K1": 0, "K2": 0}, []
    cpu = torch.device("cpu")
    # the compat adapters run in four workers meanwhile, parity and corrected
    # mode, on the card and on CPU copies (make_solver is bound by its
    # dispatch on the host: ~10-35 s a call on either); collected before the
    # wall-clock graphs
    with multiprocessing.get_context("spawn").Pool(4) as pool:  # terminated on exit
        compat_runs = {
            (mode, d): pool.apply_async(compat_calls, (d, mode == "parity"))
            for mode in ("parity", "corrected") for d in (str(dev), "cpu")
        }
        # ---- the mapper: the same scans folded on the card and on the CPU
        sim = Simulator(MessageBus(), pgm.synthetic_indoor_map(), dict(pgm.DEFAULT_MAP_INFO), device=dev)
        rng = np.random.default_rng(9)
        pairs = []
        for k in range(MAPPER_SCANS):
            pose = np.array([-1.6 + 0.17 * k, -1.0 + rng.uniform(-0.4, 0.4), rng.uniform(-np.pi, np.pi)], np.float32)
            sim.pose = torch.from_numpy(pose).to(dev)
            sim.publish_scan()
            pairs.append((np.asarray(sim.bus.latest("/scan")[0].ranges, dtype=np.float32), pose))
        grids = []  # the card's, then the CPU's
        for d in (dev, cpu):
            L, origin = torch.zeros(240, 240, device=d), torch.tensor([-6.0, -6.0], device=d)
            on = [(torch.from_numpy(r).to(d), torch.from_numpy(p).to(d)) for r, p in pairs]
            logodds_update(L, *on[0][::-1], 360, -np.pi, np.pi, origin, 0.05, 3.5)  # warm-up, discarded
            if d.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for r, p in on:
                L = logodds_update(L, p, r, 360, -np.pi, np.pi, origin, 0.05, 3.5)
            if d.type == "cuda":
                torch.cuda.synchronize()
            fold_ms = (time.perf_counter() - t0) * 1e3 / MAPPER_SCANS
            p = occupancy_probability(L).cpu().numpy()
            grids.append((L.cpu(), np.where(p >= 0.65, 100, np.where(p <= 0.35, 0, -1)), fold_ms))
        (Lg, occ_g, ms_g), (Lc, occ_c, ms_c) = grids
        n_apart = int(((Lg - Lc).abs() > 1e-5).sum())
        agree = float((occ_g == occ_c).mean())
        print(
            f"autonomy mapper ({MAPPER_SCANS} scans of 360 beams into 240x240, card against CPU): {n_apart} cells apart "
            f"by more than 1e-5, max |dL| {float((Lg - Lc).abs().max()):.3e}, trinary agreement {agree:.6f} (band "
            f"{MIN_TRINARY_AGREEMENT}); {(occ_g == 100).sum()} wall and {(occ_g == 0).sum()} free cells; "
            f"{ms_g:.3f} ms a fold on the card (host clock to a sync), {ms_c:.3f} ms on the CPU -- {card}",
            flush=True,
        )
        if agree < MIN_TRINARY_AGREEMENT:
            raise AssertionError(f"mapper: the card and the CPU agree on {agree} of the trinary grid")

        # ---- navigate-while-mapping: /map built live by the mapper on the card
        t0 = time.perf_counter()
        stack = build_sim_stack(
            follower="point", horizon=NWM_HORIZON, map_source="mapper", start_pose=NWM_START, device=dev
        )
        unknown0 = float((stack.mapper.occupancy() == -1).mean())
        mapper_s, fold = [], stack.mapper.tick

        def timed_fold():
            t = time.perf_counter()
            out = fold()
            torch.cuda.synchronize()
            mapper_s.append(time.perf_counter() - t)
            return out

        stack.mapper.tick = timed_fold
        f = stack.follower
        keep_calls([f.engine], every=NWM_RECHECK_EVERY)
        reached, ticks, pose = stack.run_to_goal(NWM_GOAL, max_ticks=NWM_MAX_TICKS)
        torch.cuda.synchronize()
        solves, n_k1 = len(f.telemetry.series["solve_s"]), f.engine.launches
        collided = stack.sim.in_collision()
        occ = stack.mapper.occupancy()
        walls = int((np.asarray(stack.bus.latest("/map")[0].data) == 100).sum())
        unknown = float((occ == -1).mean())
        tp, stages = stack.telemetry.percentiles("tick_s"), stage_p50s(stack)
        print(
            f"autonomy navigate-while-mapping (point, horizon {NWM_HORIZON}, {NWM_START} to {NWM_GOAL}, /map from the "
            f"mapper): reached {reached}, ticks {ticks} (JAX package {JAX_NWM['ticks']}), final pose "
            f"{np.round(pose, 3).tolist()}, collided {collided}; unknown share {unknown:.4f} (at the start {unknown0:.4f}; "
            f"JAX package {JAX_NWM['unknown']}), wall cells on /map {walls} (JAX package {JAX_NWM['walls']}); K1 launches "
            f"{n_k1} for {solves} solves; mapper {np.median(mapper_s) * 1e3:.3f} ms a tick (p50, host clock to a sync), "
            f"stack tick p50 {tp['p50'] * 1e3:.3f} ms (stage p50 {stages}); wall {time.perf_counter() - t0:.1f} s -- {card}",
            flush=True,
        )
        if not reached or collided or ticks > NWM_TICK_BAND * JAX_NWM["ticks"]:
            raise AssertionError(f"navigate-while-mapping: reached {reached} in {ticks} ticks, collided {collided}")
        if n_k1 != solves or f.engine.record.calls != solves or solves == 0:
            raise AssertionError(f"navigate-while-mapping: K1 launches {n_k1} for {solves} solves")
        launches["K1"] += n_k1
        checks += kept_checks("autonomy navigate-while-mapping", {"K1": f.engine})

        # ---- frontier exploration: no goal, no map (tests/test_explorer.py's setup)
        t0 = time.perf_counter()
        stack = build_sim_stack(
            follower="point", start_pose=NWM_START, horizon=NWM_HORIZON, map_source="mapper",
            safety_stop=EXPLORE_SAFETY_STOP, device=dev,
        )
        explorer = ExplorerNode(stack.bus, stack.mapper, stack.params)
        f = stack.follower
        keep_calls([f.engine], every=EXPLORE_RECHECK_EVERY)
        complete, collisions, ticks = False, 0, 0
        for ticks in range(EXPLORE_MAX_TICKS):
            if explorer.tick()["status"] == "complete":
                complete = True
                break
            stack.tick()
            collisions += stack.sim.in_collision()
        torch.cuda.synchronize()
        solves, n_k1 = len(f.telemetry.series["solve_s"]), f.engine.launches
        occ = stack.mapper.occupancy()
        unknown, free = float((occ == -1).mean()), float((occ == 0).mean())
        tp, summary, stages = stack.telemetry.percentiles("tick_s"), explorer.summary(), stage_p50s(stack)
        print(
            f"autonomy exploration (safety stop {EXPLORE_SAFETY_STOP} m, at most {EXPLORE_MAX_TICKS} ticks): complete "
            f"{complete}, ticks {ticks} (JAX package {JAX_EXPLORE['ticks']}), goals {explorer.n_goals} (JAX package "
            f"{JAX_EXPLORE['goals']}, abandoned {summary['n_abandoned']}), unknown share {unknown:.4f} (JAX package "
            f"{JAX_EXPLORE['unknown']}), free share {free:.4f} (JAX package {JAX_EXPLORE['free']}), coverage "
            f"{summary['coverage_m2']:.2f} m^2, collisions {collisions}; K1 launches {n_k1} for {solves} solves; stack "
            f"tick p50 {tp['p50'] * 1e3:.3f} ms p99 {tp['p99'] * 1e3:.3f} ms (host clock; stage p50 {stages}); wall "
            f"{time.perf_counter() - t0:.1f} s -- {card}",
            flush=True,
        )
        if not complete or explorer.n_goals < 3 or unknown >= 0.6 or free <= 0.25 or collisions:
            raise AssertionError("exploration: outside tests/test_explorer.py's bounds")
        if n_k1 != solves or f.engine.record.calls != solves or solves == 0:
            raise AssertionError(f"exploration: K1 launches {n_k1} for {solves} solves")
        launches["K1"] += n_k1
        checks += kept_checks("autonomy exploration", {"K1": f.engine})

        # ---- the wavefront on the global planner's weights of the synthetic map
        sub = MapSubscriber(sim.bus)
        sim.publish_map()
        image, info = sub.get_map()
        # GlobalPathPublisherNode.tick's dilation and AStarPlanner2.get_path's weights
        kernel = Params().map_dilation_kernel
        occ = costmapops.erode_image(torch.as_tensor(np.ascontiguousarray(image, dtype=np.float32), device=dev), kernel).cpu().numpy()
        weights = np.select([occ == 1, occ == 0], [255.0, 1.0], occ).astype(np.float32)
        H, W = weights.shape
        cell = lambda xy: tuple(int(v) for v in gridops.world_to_map(xy[0], xy[1], (H, W), info["origin"], info["resolution"])[::-1])  # noqa: E731,E501
        start_rc, goal_rc = cell(NWM_START), cell(NWM_GOAL)
        w_dev = torch.from_numpy(weights).to(dev)
        # the field and the sweep count of one relaxation, held equal to
        # distance_field's and to the CPU's below
        field, sweeps = wavefront.relax(wavefront.goal_fields((H, W), goal_rc, dev)[0], w_dev, H + W)
        sweeps = int(sweeps)
        field_ms = cuda_ms(wavefront.distance_field, w_dev, goal_rc, reps=3)
        field_cpu = wavefront.distance_field(torch.from_numpy(weights), goal_rc)
        # a field value charges the weight of each cell a step leaves, A* the
        # weight of each cell it enters: so the A* search runs from the goal
        path = astar_path(weights, goal_rc, start_rc)
        astar_cost = float(sum(weights[r, c] for r, c in path[1:]))
        free_cells = np.argwhere(weights == 1.0)
        goals = np.vstack([goal_rc, free_cells[np.random.default_rng(4).choice(len(free_cells), WAVE_GOALS - 1)]])
        goals_dev = torch.from_numpy(goals).to(dev)
        fields = wavefront.batched_distance_fields(w_dev, goals_dev)
        batch_ms = cuda_ms(wavefront.batched_distance_fields, w_dev, goals_dev, reps=3)
        last_cpu = wavefront.distance_field(torch.from_numpy(weights), tuple(goals[-1]))
        exact = (
            torch.equal(field, wavefront.distance_field(w_dev, goal_rc)) and torch.equal(field.cpu(), field_cpu)
            and torch.equal(fields[0], field) and torch.equal(fields[-1].cpu(), last_cpu)
        )  # fmt: skip
        print(
            f"autonomy wavefront ({H}x{W}, the planner's dilated weights, goal {goal_rc}): {sweeps} sweeps, "
            f"distance_field {field_ms:.3f} ms, batched_distance_fields of {WAVE_GOALS} goals {batch_ms:.3f} ms (CUDA "
            f"events, median of 3); equal to the CPU's {exact}; start {start_rc} at {float(field[start_rc]):.1f} against "
            f"the A* path cost {astar_cost:.1f} (goal to start) -- {card}",
            flush=True,
        )
        if not exact or not np.isclose(float(field[start_rc]), astar_cost, rtol=1e-5):
            raise AssertionError("wavefront: not the CPU's field or not the A* cost")

        # ---- the compat adapters on the card against their CPU copies
        compat_out = {key: r.get(timeout=600) for key, r in compat_runs.items()}
    for mode in ("parity", "corrected"):
        (card_out, card_ms), (cpu_out, cpu_ms) = compat_out[mode, str(dev)], compat_out[mode, "cpu"]
        for name in card_out:
            dU = float(np.abs(card_out[name][-1] - cpu_out[name][-1]).max())
            print(
                f"autonomy compat {name}.perform_mpc ({mode}, N={COMPAT_N}, make_solver): card {card_ms[name]:.1f} "
                f"ms, CPU {cpu_ms[name]:.1f} ms (host clock, one call each), max |dU| card against CPU {dU:.3e} "
                f"(band {LIVE[0]}) -- {card}",
                flush=True,
            )
            if not dU <= LIVE[0]:
                raise AssertionError(f"compat {name} ({mode}): the card and the CPU apart by {dU}")

    # ---- the wall-clock live graph through run_live (the stack it builds kept)
    built, build = [], live.build_live_stack

    def keep(*a, **k):
        built.append(build(*a, **k))
        return built[-1]

    live.build_live_stack = keep
    try:
        t0 = time.perf_counter()
        stats = live.run_live(follower="point", duration=LIVE_DURATION, device=dev)
    finally:
        live.build_live_stack = build
    n_k1 = built[0].follower.engine.launches
    tasks = stats["tasks"]
    rates = {n: f"{t['rate_hz']:.2f} Hz, misses {t['misses']}, max late {t['max_lateness_s'] * 1e3:.1f} ms" for n, t in tasks.items()}
    print(
        f"autonomy live graph (run_live, point, goal {LOOP_GOAL}): goal reached {stats['goal_reached']} after "
        f"{stats['elapsed_s']:.2f} s (wall {time.perf_counter() - t0:.1f} s with the warm-up), final pose "
        f"{np.round(stats['final_pose'], 3).tolist()}; K1 launches {n_k1} (control runs {tasks['control']['runs']} "
        f"and the warm-up); tasks {rates} -- {card}",
        flush=True,
    )
    if not stats["goal_reached"] or tasks["control"]["misses"]:
        raise AssertionError(f"live graph: goal reached {stats['goal_reached']}, control {tasks['control']}")
    launches["K1"] += n_k1

    # ---- the multi-process graph, every role on the card; the world role
    # (here) with the deploy phase's P, as the JAX package hands params
    # to the world role only
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        P = deploy_params(tmp)
    roles = ("planner", "costmaps", "follower")
    t0 = time.perf_counter()
    stats = run_multiprocess(
        follower="point", duration=MULTIPROC_DURATION, start_pose=LOOP_START, params=P, roles=roles, role_device=dev
    )
    roles = {"world": stats["tasks"], **{r: (s or {}).get("tasks") for r, s in stats["roles"].items()}}
    rates = {r: {n: round(t["rate_hz"], 2) for n, t in ts.items()} if ts else None for r, ts in roles.items()}
    print(
        f"autonomy multi-process graph (run_multiprocess, point, from {LOOP_START}, world role with P "
        f"(goal_threshold {P.goal_threshold}), roles {roles} on {dev}): goal reached "
        f"{stats['goal_reached']} after {stats['elapsed_s']:.2f} s (wall {time.perf_counter() - t0:.1f} s), final "
        f"pose {np.round(stats['final_pose'], 3).tolist()}, failed roles {stats['failed_roles']}; rates [Hz] {rates} "
        f"(the follower role's K1 launches are in its own process, not counted here) -- {card}",
        flush=True,
    )
    if not stats["goal_reached"] or stats["failed_roles"]:
        raise AssertionError(f"multi-process graph: goal reached {stats['goal_reached']}, failed {stats['failed_roles']}")
    print(f"launch counters of the autonomy phase: {launches}", flush=True)
    return launches, checks


def deploy_params(tmp):
    """``Params.load`` of the package's params.yaml (the reference's keys)
    with goal_threshold set to DEPLOY_GOAL_THRESHOLD, written under ``tmp``."""
    import ros2_mpc_tpu_torch
    from ros2_mpc_tpu_torch.config import Params

    text = (Path(ros2_mpc_tpu_torch.__file__).parent / "assets" / "params.yaml").read_text()
    line = f"goal_threshold: {Params().goal_threshold}"
    if text.count(line) != 1:
        raise AssertionError(f"params.yaml has no single '{line}'")
    path = Path(tmp) / "params.yaml"
    path.write_text(text.replace(line, f"goal_threshold: {DEPLOY_GOAL_THRESHOLD}"))
    P = Params.load(str(path))
    if P.goal_threshold != DEPLOY_GOAL_THRESHOLD or P == Params():
        raise AssertionError(f"Params.load did not read {path}")
    return P


def oracle_worker():
    """The oracle workers' initializer: a lower priority (``ORACLE_NICE``)."""
    os.nice(ORACLE_NICE)


def oracle_check(name, cases, U, converged):
    """``oracle_banks.check_family`` in a worker beside the card (raises
    under the JAX file's rule). Returns (worst drift, seconds, the monotonic
    clock at the end)."""
    import oracle_banks

    t0 = time.perf_counter()
    worst = oracle_banks.check_family(name, cases, U, converged)
    return worst, time.perf_counter() - t0, time.monotonic()


def quadrotor_float32(dev, card, oracle_banks):
    """The quadrotor's ``make_solver`` on the card on the oracle's first
    scenario: the Solution and the transition's Jacobians at the start must
    be float32, with no cast in ``make_solver`` to hide a float64 tangent."""
    import torch
    from torch.func import jacfwd

    from ros2_mpc_tpu_torch.solver import SolverSettings, make_solver

    q = oracle_banks.family_bank("quadrotor", dev, count=1)
    ocp = q["problem"].ocp
    theta, U0 = {k: v[0] for k, v in q["thetas"].items()}, q["U0s"][0]
    t0 = time.perf_counter()
    sol = make_solver(ocp, SolverSettings(**QUAD_F32_SCHEDULE))(theta, U0)
    A, B = jacfwd(ocp.transition, argnums=(0, 1))(theta["x0"], U0[0])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    dtypes = {k: getattr(sol, k).dtype for k in ("U", "X", "cost", "kkt_residual", "reg")} | {"A": A.dtype, "B": B.dtype}
    print(
        f"deploy quadrotor make_solver float32 (oracle scenario 0, seed {oracle_banks.FAMILIES['quadrotor'][0]}, "
        f"N={oracle_banks.N}, {QUAD_F32_SCHEDULE}): "
        + ", ".join(f"{k} {str(v).removeprefix('torch.')}" for k, v in dtypes.items())
        + f"; cost {float(sol.cost):.6f}, kkt {float(sol.kkt_residual):.3e}, {secs:.2f} s (host clock) -- {card}",
        flush=True,
    )
    if any(v != torch.float32 for v in dtypes.values()):
        raise AssertionError(f"quadrotor make_solver: not float32: {dtypes}")
    if not bool(torch.isfinite(sol.U).all()) or not bool(torch.isfinite(A).all() & torch.isfinite(B).all()):
        raise AssertionError("quadrotor make_solver: non-finite controls or Jacobians")


def deploy_phase(dev, card, inp):
    """The restored arguments on the card (module docstring): the oracle
    banks (their f64 polish left running in worker processes), the live
    graph on the home map with P, the home routes, MultiRobotSim with P and
    ``include_mppi=False``. Raises on any failed check. Returns
    ({"K1": launches, "K2": launches}, plain-check entries of the kept
    kernel calls, a function that waits for the oracle's verdicts)."""
    import tempfile

    import torch

    from ros2_mpc_tpu_torch.nodes import live
    from ros2_mpc_tpu_torch.nodes.launch import build_sim_stack
    from ros2_mpc_tpu_torch.nodes.multi_robot import MultiRobotSim
    from ros2_mpc_tpu_torch.solver.cuda_kernel import CudaBankSolver, make_cuda_point_stab_solver
    from ros2_mpc_tpu_torch.solver.mppi import make_multistart_solver
    from ros2_mpc_tpu_torch.utils import pgm

    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "tests"))  # the workers get the same path
    import oracle_banks

    launches, checks = {"K1": 0, "K2": 0}, []
    # ---- the oracle banks on the card, polished beside the later phases
    # (the quadrotor's 16 first: its polish is the longest)
    pool = multiprocessing.get_context("spawn").Pool(ORACLE_WORKERS, oracle_worker)  # terminated by collect or at exit
    families = ("quadrotor", "obstacles", "point_stab", "tracking", "terminal_tracking", "warm_realtime")
    pending = {}
    for name in families:
        bank = oracle_banks.family_bank(name, dev)
        solver = oracle_banks.engine(name, bank["problem"])
        on_kernel = isinstance(solver, CudaBankSolver)
        if on_kernel:
            keep_calls([solver], every=1)
        t0 = time.perf_counter()
        U, converged = oracle_banks.solve_family(name, bank, solver)
        secs = time.perf_counter() - t0
        pending[name] = pool.apply_async(oracle_check, (name, bank["cases"], U, converged))
        what = f"{'K1' if solver.kind == 'point_stab' else 'K2'}, {solver.launches} launches" if on_kernel else "the generic engine"
        print(
            f"deploy oracle bank {name} (seed {oracle_banks.FAMILIES[name][0]}, {len(bank['cases'])} scenarios, "
            f"N={oracle_banks.N}): {what}, converged {float(np.mean(converged)):.4f}, {secs:.2f} s (host clock) -- {card}",
            flush=True,
        )
        if not np.isfinite(U).all():
            raise AssertionError(f"deploy oracle bank {name}: non-finite controls")
        if on_kernel:
            launches["K1" if solver.kind == "point_stab" else "K2"] += solver.launches
            checks += kept_checks(f"deploy oracle {name}", {"bank": solver})
    quadrotor_float32(dev, card, oracle_banks)

    with tempfile.TemporaryDirectory() as tmp:
        P = deploy_params(tmp)
        img = pgm.read_pgm(str(root / HOME_PGM))
        meta = pgm.load_map_yaml(str(root / HOME_YAML))
        info = {"resolution": meta["resolution"], "origin": meta["origin"]}
        # ---- 1. the live graph on the home map with P
        start, goal = HOME_PAIRS[0]
        stack = live.build_live_stack(
            follower="point", params=P, map_image=img, map_info=info, start_pose=start, horizon=HOME_HORIZON,
            global_costmap=True, viz_dir=tmp, viz_period=DEPLOY_VIZ_PERIOD, device=dev,
        )
        nodes = [stack.sim, stack.follower, stack.global_planner]
        nodes += [t.fn.__self__ for t in stack.scheduler.tasks if hasattr(getattr(t.fn, "__self__", None), "params")]
        if any(n.params is not P for n in nodes) or stack.sim.occupied.shape != img.shape:
            raise AssertionError("deploy live graph: P or the home map did not reach every node")
        f = stack.follower
        keep_calls([f.engine], every=DEPLOY_KEEP_EVERY)
        stack.publish_goal(*goal)
        t0 = time.perf_counter()
        stats = stack.run(DEPLOY_LIVE_DURATION)
        torch.cuda.synchronize()
        tasks = stats["tasks"]
        dist = float(np.linalg.norm(np.asarray(stats["final_pose"][:2]) - np.asarray(goal)))
        rates = {n: f"{t['rate_hz']:.2f} Hz, misses {t['misses']}" for n, t in tasks.items()}
        print(
            f"deploy live graph (home map {img.shape[0]}x{img.shape[1]}, point, horizon {HOME_HORIZON}, P with "
            f"goal_threshold {P.goal_threshold}, {start} to {goal}, viz every {DEPLOY_VIZ_PERIOD} s): goal reached "
            f"{stats['goal_reached']} after {stats['elapsed_s']:.2f} s (budget {DEPLOY_LIVE_DURATION} s; wall "
            f"{time.perf_counter() - t0:.1f} s with the warm-up), {dist:.4f} m from the goal, control misses "
            f"{tasks['control']['misses']}, max late {tasks['control']['max_lateness_s'] * 1e3:.1f} ms; K1 launches "
            f"{f.engine.launches} for {f.engine.record.calls} solves; tasks {rates} -- {card}",
            flush=True,
        )
        if not stats["goal_reached"] or tasks["control"]["misses"] or dist > P.goal_threshold + 0.02:
            raise AssertionError(f"deploy live graph: reached {stats['goal_reached']}, {dist} m, {tasks['control']}")
        if f.engine.launches != f.engine.record.calls or tasks["viz"]["runs"] < 1:
            raise AssertionError("deploy live graph: launches or viz frames")
        launches["K1"] += f.engine.launches
        checks += kept_checks("deploy live graph", {"K1": f.engine})

        # ---- 2. the home routes through build_sim_stack
        routes = [(f"point {i}", "point", s, g) for i, (s, g) in enumerate(HOME_PAIRS)]
        routes.append(("tracking", "tracking", *HOME_PAIRS[0]))
        for label, follower, start, goal in routes:
            t0 = time.perf_counter()
            stack = build_sim_stack(
                follower=follower, map_image=img, map_info=info, start_pose=start, horizon=HOME_HORIZON, device=dev
            )
            f = stack.follower
            engines = {"K1": f.engine} if follower == "point" else {"K2": f.engine, "K1 handoff": f.handoff_engine}
            keep_calls(engines.values(), every=DEPLOY_KEEP_EVERY)
            collided, tick = [], stack.tick

            def tick_and_check(tick=tick, stack=stack, collided=collided):
                out = tick()
                collided.append(stack.sim.in_collision())
                return out

            stack.tick = tick_and_check
            reached, ticks, pose = stack.run_to_goal(goal, max_ticks=HOME_MAX_TICKS)
            torch.cuda.synchronize()
            solves = len(f.telemetry.series["solve_s"])
            sp, tp = f.telemetry.percentiles("solve_s"), stack.telemetry.percentiles("tick_s")
            counts = {n: (e.launches, e.record.calls) for n, e in engines.items()}
            print(
                f"deploy home route {label} ({follower}, {[round(float(v), 3) for v in start]} to {goal}): reached {reached}, "
                f"ticks {ticks} (JAX package {JAX_HOME_TICKS[label]}, ratio {ticks / JAX_HOME_TICKS[label]:.3f}), "
                f"final pose {np.round(pose, 3).tolist()}, collided {any(collided)}; launches and solves {counts}; "
                f"solve p50 {sp['p50'] * 1e3:.3f} ms, stack tick p50 {tp['p50'] * 1e3:.3f} ms (stage p50 "
                f"{stage_p50s(stack)}); wall {time.perf_counter() - t0:.1f} s -- {card}",
                flush=True,
            )
            if not reached or any(collided):
                raise AssertionError(f"deploy home route {label}: reached {reached}, collided {any(collided)}")
            if sum(c for _, c in counts.values()) != solves or any(n != c for n, c in counts.values()):
                raise AssertionError(f"deploy home route {label}: launches and solves {counts} of {solves}")
            for n, (k, _) in counts.items():
                launches[n[:2]] += k
            checks += kept_checks(f"deploy home route {label}", engines)

        # ---- 3. MultiRobotSim on the home map with P
        starts, goals = [HOME_PAIRS[0][0], HOME_PAIRS[2][0]], [HOME_PAIRS[0][1], HOME_PAIRS[2][1]]
        t0 = time.perf_counter()
        sim = MultiRobotSim(starts, P, follower="point", map_image=img, map_info=info, horizon=HOME_HORIZON, device=dev)
        if any(st.params is not P or st.follower.params is not P for st in sim.stacks):
            raise AssertionError("deploy multi-robot: P did not reach every robot's graph")
        engines = {f"robot {i} K1": st.follower.engine for i, st in enumerate(sim.stacks)}
        keep_calls(engines.values(), every=50)
        res = sim.run_to_goals(goals, max_ticks=MULTI_ROBOT_TICKS)
        torch.cuda.synchronize()
        counts = {n: (e.launches, e.record.calls) for n, e in engines.items()}
        print(
            f"deploy multi-robot (home map, P, two point robots from {starts} to {goals}, at most "
            f"{MULTI_ROBOT_TICKS} ticks): reached {res.reached} after {res.ticks} ticks, min separation "
            f"{res.min_separation:.4f} m, static collision {res.collided_static}; launches and solves {counts}; wall "
            f"{time.perf_counter() - t0:.1f} s -- {card}",
            flush=True,
        )
        if not all(res.reached) or res.collided_static or any(n != c or c == 0 for n, c in counts.values()):
            raise AssertionError(f"deploy multi-robot: {res.reached}, {res.collided_static}, {counts}")
        launches["K1"] += sum(n for n, _ in counts.values())
        checks += kept_checks("deploy multi-robot", engines)

    # ---- 7. make_multistart_solver(include_mppi=False) beside plain K1
    prob = inp.prob_c
    th = {k: v[:INCLUDE_MPPI_ROWS].contiguous() for k, v in inp.th_obs.items()}
    U0 = torch.zeros(INCLUDE_MPPI_ROWS, N, 2, device=dev)
    ms = make_multistart_solver(prob.ocp, prob.settings, include_mppi=False, device=dev)
    (k1_ms,) = ms.engines
    keep_calls([k1_ms], every=1)
    sol_ms = ms(th, U0, None)
    torch.cuda.synchronize()
    checks += kept_checks("deploy multistart without MPPI", {"K1": k1_ms})
    n_ms = k1_ms.launches
    launches["K1"] += n_ms
    k1_plain = make_cuda_point_stab_solver(prob.ocp, prob.settings)
    sol_k1 = k1_plain(th, U0)
    launches["K1"] += k1_plain.launches
    ms_ms, ms_k1 = cuda_ms(ms, th, U0, None, reps=3), cuda_ms(k1_plain, th, U0, reps=3)
    conv_ms, conv_k1 = float(sol_ms.converged.float().mean()), float(sol_k1.converged.float().mean())
    print(
        f"deploy multistart without MPPI (make_multistart_solver(include_mppi=False), the obstacle-active bank's "
        f"first {INCLUDE_MPPI_ROWS} rows, warm start + 4 arc seeds, one K1 call of {INCLUDE_MPPI_ROWS * 5} rows): "
        f"converged {conv_ms:.4f} at {INCLUDE_MPPI_ROWS / ms_ms * 1e3:,.0f} solves/s ({ms_ms:.3f} ms), beside plain "
        f"K1 on the same rows {conv_k1:.4f} at {INCLUDE_MPPI_ROWS / ms_k1 * 1e3:,.0f} solves/s ({ms_k1:.3f} ms) "
        f"(CUDA events, median of 3); K1 launches {n_ms} -- {card}",
        flush=True,
    )
    if n_ms != 1 or conv_ms < conv_k1 or not bool(torch.isfinite(sol_ms.U).all()):
        raise AssertionError(f"deploy multistart without MPPI: launches {n_ms}, converged {conv_ms} < {conv_k1}")

    def collect():
        """Wait for each oracle polish (raises on a family off the oracle),
        print the worst drifts, stop the workers."""
        deadline = time.perf_counter() + ORACLE_TIMEOUT_S
        try:
            for name in families:
                worst, secs, ended = pending[name].get(timeout=max(1.0, deadline - time.perf_counter()))
                band = {"obstacles": "2e-3", "quadrotor": "5e-3 of the box width for 0.9 of them, 2e-2 for all"}
                print(
                    f"deploy oracle {name}: the kernels' outputs within the f64 oracle's band, worst drift "
                    f"{worst:.3e} (band {band.get(name, '1e-3')}; polished in {secs:.1f} s in its worker, "
                    f"ending {ended - STARTED:.1f} s into the script)",
                    flush=True,
                )
        finally:
            pool.terminate()

    print(f"launch counters of the deploy phase: {launches}", flush=True)
    return launches, checks, collect


def scale_phase(dev, card, inp):
    """The mesh, the sharded fleets, the checkpointed sweep and the scaling
    harness through the port's entry points, on SCALE_SHARDS shards of the
    card: the headline and tracking banks bit-equal to one shard, each
    engine's throughput on one shard and on the mesh, the sharded fleets
    bit-equal to the unsharded ones with no host sync inside, the sweep
    resumed exactly, and K2 at B=1, N=LONG_N. Returns ({"K1": launches,
    "K2": launches}, [(name, kernel name, kernel calls), ...] for the plain
    checks, and a function that runs the two gloo ranks on the card)."""
    import torch

    from ros2_mpc_tpu_torch.parallel import (
        SweepSpec,
        arc_path_fleet,
        grid_swap_swarm,
        make_bank_solver,
        make_fleet_rollout,
        make_mesh,
        make_sharded_fleet_rollout,
        make_sharded_swarm_rollout,
        make_sharded_tracking_fleet_rollout,
        make_swarm_rollout,
        make_tracking_fleet_rollout,
        random_fleet,
        run_sweep,
        scaling_bench,
    )
    from ros2_mpc_tpu_torch.solver import SolverSettings, make_point_stabilization, make_tracking
    from ros2_mpc_tpu_torch.solver.cuda_kernel import make_cuda_point_stab_solver, make_cuda_tracking_solver

    params, dt, rt = inp.params, inp.params.dt, SolverSettings.realtime()
    launches, checks = {"K1": 0, "K2": 0}, []
    mesh, one = make_mesh(SCALE_SHARDS, device=dev), make_mesh(1, device=dev)
    fields = ("U", "X", "cost", "kkt_residual", "n_iters")
    U0 = torch.zeros(B, N, 2, dtype=torch.float32, device=dev)

    # ---- the headline and tracking banks: four shards of 1024 against one
    for name, prob, th, kname in (("headline", inp.prob, inp.th_main, "K1"), ("tracking", inp.prob_t, inp.th_trk, "K2")):
        step, step1 = make_bank_solver(prob, mesh), make_bank_solver(prob, one)
        (k,), (k1,) = step.engines, step1.engines
        k.launches = k1.launches = 0
        sols, met = step(th, U0)
        ref, _ = step1(th, U0)
        torch.cuda.synchronize()
        n, n1 = k.launches, k1.launches
        got, ref = sols.gather(dev), ref.gather(dev)
        unequal = [f for f in fields if not torch.equal(getattr(got, f), getattr(ref, f))]
        ms, ms1 = cuda_ms(step, th, U0), cuda_ms(step1, th, U0)
        print(
            f"scale {name} bank (B={B}, N={N}, {SCALE_SHARDS} shards of {B // SCALE_SHARDS} on one card): bit-equal "
            f"to one shard on {', '.join(fields)} {'yes' if not unequal else 'no: ' + ', '.join(unequal)}; "
            f"{kname} launches {n} (one shard {n1}); bank_metrics mean cost {float(met['mean_cost']):.6f}, max KKT "
            f"{float(met['max_kkt']):.3e}, converged {float(met['frac_converged']):.4f}; on the gathered bank "
            f"{float(got.cost.mean()):.6f}, {float(got.kkt_residual.max()):.3e}, "
            f"{float(got.converged.float().mean()):.4f}; step {ms:.3f} ms on {SCALE_SHARDS} shards, {ms1:.3f} ms on "
            f"one (CUDA events, median of 5) -- {card}",
            flush=True,
        )
        if unequal or n != SCALE_SHARDS or n1 != 1:
            raise AssertionError(f"scale {name} bank: {unequal or 'launches'} against one shard")
        if float(met["max_kkt"]) != float(got.kkt_residual.max()) or float(met["frac_converged"]) != float(got.converged.float().mean()):
            raise AssertionError(f"scale {name} bank: bank_metrics differ from the gathered bank's")
        launches[kname] += n + n1

    # ---- the engine menu through the scaling harness, one shard against four
    opts = scaling_bench.engine_options(SCALE_PER_SHARD)
    short = opts["two_pass"]["solver_settings"]
    runs = {}
    for label, engine, per, n_hor, kw in (
        ("cuda", "cuda", SCALE_PER_SHARD, N, {}),
        ("cuda (short schedule)", "cuda", SCALE_PER_SHARD, N, {"solver_settings": short}),
        *((e, e, SCALE_PER_SHARD, N, opts[e]) for e in ("mppi", "hybrid", "multistart", "two_pass", "multistart_bank", "multistart_rescue")),
        # the same engine with its rescue pass on rescue_schedule(), the
        # workload the harness ran before its options carried the short one
        ("multistart_rescue (full rescue schedule)", "multistart_rescue", SCALE_PER_SHARD, N,
         {k: v for k, v in opts["multistart_rescue"].items() if k != "rescue_settings"}),
        *((e, e, SCALE_SMALL_PER_SHARD, SCALE_SMALL_N, opts[e]) for e in ("vmap", "fast")),
    ):
        t0 = time.perf_counter()
        r = runs[label] = scaling_bench.run(per, n_hor, SCALE_REPS, engine=engine, device=dev, n_devices=SCALE_SHARDS, **kw)
        m1, mn = r["metrics_1dev"], r["metrics_ndev"]
        print(
            f"scale engine {label} ({per} a shard, N={n_hor}): one shard {r['solves_per_s_1dev']:,.0f} solves/s, "
            f"{SCALE_SHARDS} shards {r['solves_per_s_ndev']:,.0f} solves/s, efficiency {r['scaling_efficiency']:.4f} "
            f"(ceiling {r['contention_ceiling']:.2f}: one card); metrics one shard {m1}, {SCALE_SHARDS} shards {mn}; "
            f"shard 0 equal to one shard {r['first_shard_equal']}; K1 launches {r['kernel_launches']} "
            f"({time.perf_counter() - t0:.1f} s, host clock, best of {SCALE_REPS} after a warm-up) -- {card}",
            flush=True,
        )
        if not r["first_shard_equal"] or not np.isfinite(mn["mean_cost"]) or r["solves_per_s_ndev"] <= 0:
            raise AssertionError(f"scale engine {label}: shard 0 differs from one shard, or no result")
        launches["K1"] += r["kernel_launches"]
    # where the JAX suite says an engine never loses to the plain one
    # (test_parallel.py: hybrid and multistart against vmap, two-pass's KKT
    # and bank multistart's cost against pallas), on the same 2048 rows
    base, base_s = runs["cuda"]["metrics_ndev"], runs["cuda (short schedule)"]["metrics_ndev"]
    worse = [e for e in ("hybrid", "multistart") if runs[e]["metrics_ndev"]["frac_converged"] < base["frac_converged"] - 1e-6]
    worse += [e for e in ("two_pass", "multistart_rescue") if runs[e]["metrics_ndev"]["frac_converged"] < base_s["frac_converged"] - 1e-6]
    worse += ["two_pass"] * (runs["two_pass"]["metrics_ndev"]["max_kkt"] > base_s["max_kkt"] + 1e-6)
    worse += ["multistart_bank"] * (runs["multistart_bank"]["metrics_ndev"]["mean_cost"] > base_s["mean_cost"] + 1e-4)
    print(f"scale engines no worse than K1 where the JAX suite says so: {'yes' if not worse else worse}", flush=True)
    if worse:
        raise AssertionError(f"scale engines worse than K1: {worse}")

    # ---- the sharded fleets against the unsharded ones, bit for bit
    prob_p = make_point_stabilization(params, horizon=N, settings=rt, device=dev)
    prob_c = make_point_stabilization(params, horizon=N, reference_parity=False, settings=rt, device=dev)
    prob_tf = make_tracking(params, horizon=N, reference_parity=False, settings=rt, terminal_weight=(10.0, 10.0, 1.0), device=dev)
    fleets = (
        ("point fleet", "K1", TRACK_FLEET_TICKS, random_fleet(prob_p, FLEET_B, seed=0, device=dev),
         make_fleet_rollout(prob_p, TRACK_FLEET_TICKS, dt, device=dev),
         make_sharded_fleet_rollout(prob_p, mesh, TRACK_FLEET_TICKS, dt)),
        ("tracking fleet", "K2", TRACK_FLEET_TICKS, arc_path_fleet(prob_tf, FLEET_B, n_waypoints=64, seed=0, device=dev),
         make_tracking_fleet_rollout(prob_tf, TRACK_FLEET_TICKS, dt, goal_threshold=0.25, device=dev),
         make_sharded_tracking_fleet_rollout(prob_tf, mesh, TRACK_FLEET_TICKS, dt, goal_threshold=0.25)),
        (f"swarm (grid swap {SWARM_SIDE}x{SWARM_SIDE}, k=4)", "K1", SWARM_TICKS, grid_swap_swarm(prob_c, side=SWARM_SIDE, pitch=2.0, device=dev),
         make_swarm_rollout(prob_c, SWARM_TICKS, dt, k_neighbors=4, device=dev),
         make_sharded_swarm_rollout(prob_c, mesh, SWARM_TICKS, dt, k_neighbors=4)),
    )  # fmt: skip
    for name, kname, ticks, args, plain, sharded in fleets:
        ref, ms1, n1, _ = run_rollout(f"scale {name}", plain, args, ticks)
        out, ms, n, calls = run_rollout(f"scale sharded {name}", sharded, args, ticks, per_tick=SCALE_SHARDS)
        final = out.final_states.gather(dev)
        equal = torch.equal(final, ref.final_states)
        extra = f", min separation {float(out.min_separation):.4f} m (unsharded {float(ref.min_separation):.4f})" if "swarm" in name else ""
        print(
            f"scale sharded {name} (B={FLEET_B}, N={N}, realtime, {ticks} ticks, {SCALE_SHARDS} shards): final states "
            f"bit-equal to the unsharded rollout {'yes' if equal else 'no'}; reach {float(out.reach_fraction):.4f} "
            f"(unsharded {float(ref.reach_fraction):.4f}){extra}; {ms / ticks:.3f} ms a tick ({ms1 / ticks:.3f} "
            f"unsharded, CUDA events); launches {n} for {ticks} ticks ({n1} unsharded); no host sync inside -- {card}",
            flush=True,
        )
        if not equal:
            raise AssertionError(f"scale sharded {name}: final states differ from the unsharded rollout")
        launches[kname] += n + n1
        if name != "point fleet":
            kept = [calls[i] for i in np.linspace(0, len(calls) - 1, SCALE_KEEP).astype(int)]
            checks.append((f"scale sharded {name} ({SCALE_KEEP} shard calls over its ticks)", kname, kept))

    # ---- the sweep: BASELINE config 5's 102,400 solves, resumed after two
    # chunks are deleted from its checkpoint
    prob_sw = make_point_stabilization(params, horizon=N, device=dev)
    k1_sw = make_cuda_point_stab_solver(prob_sw.ocp, prob_sw.settings)
    spec = SweepSpec(scenarios_per_config=SWEEP_PER_CONFIG)
    ck = Path(__file__).resolve().parent / "build" / "scale_sweep.npz"
    ck.parent.mkdir(parents=True, exist_ok=True)
    ck.unlink(missing_ok=True)
    t0 = time.perf_counter()
    out1 = run_sweep(prob_sw, spec, mesh=mesh, checkpoint_path=str(ck), chunk_size=SWEEP_CHUNK, engine=lambda o, st: k1_sw)
    torch.cuda.synchronize()
    secs, n_first = time.perf_counter() - t0, k1_sw.launches
    with np.load(ck) as f:
        before = {k: f[k] for k in f.files}
    np.savez(ck, **{k: v for k, v in before.items() if int(k) not in SWEEP_DROPPED})
    k1_sw.launches = 0
    out2 = run_sweep(prob_sw, spec, mesh=mesh, checkpoint_path=str(ck), chunk_size=SWEEP_CHUNK, engine=lambda o, st: k1_sw)
    with np.load(ck) as f:
        after = {k: f[k] for k in f.files}
    n_total, n_chunks = 25 * SWEEP_PER_CONFIG, -(-25 * SWEEP_PER_CONFIG // SWEEP_CHUNK)
    same = sorted(after) == sorted(before) and all(np.array_equal(after[k], before[k]) for k in before)
    same = same and np.array_equal(out1["mean_goal_error"], out2["mean_goal_error"])
    print(
        f"scale sweep (BASELINE config 5: 25 configs x {SWEEP_PER_CONFIG} = {n_total:,} K1 solves, N={N}, chunks of "
        f"{SWEEP_CHUNK}, {SCALE_SHARDS} shards): {secs:.2f} s ({n_total / secs:,.0f} solves/s, host clock with the "
        f"checkpoint writes), K1 launches {n_first} for {n_chunks} chunks; best (Q, R) scales "
        f"{tuple(float(x) for x in out1['best_config'])}, mean goal error {float(out1['mean_goal_error'].min()):.4f} m; "
        f"after deleting chunks {SWEEP_DROPPED} the resume solved {out2['chunks_solved']} with {k1_sw.launches} K1 "
        f"launches, checkpoint and table equal {'yes' if same else 'no'} -- {card}",
        flush=True,
    )
    if n_first != n_chunks * SCALE_SHARDS or k1_sw.launches != len(SWEEP_DROPPED) * SCALE_SHARDS:
        raise AssertionError("scale sweep: the launches are not a shard's per chunk solved")
    if not same or out2["chunks_solved"] != list(SWEEP_DROPPED):
        raise AssertionError("scale sweep: the resumed sweep differs")
    launches["K1"] += n_first + k1_sw.launches
    ck.unlink()

    # ---- K2 at B=1, N=LONG_N (tests/test_scaling.py::test_long_horizon_tracking_N256)
    prob_l = make_tracking(params, horizon=LONG_N, settings=SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6), device=dev)
    k2_l = make_cuda_tracking_solver(prob_l.ocp, prob_l.settings)
    check_geometry("K2 long horizon", k2_l, 1)
    check_geometry("K2 long horizon", k2_l, 16)
    ts_ = np.arange(1, LONG_N + 1) * dt
    x_ref = np.stack([0.15 * ts_, np.zeros(LONG_N), np.zeros(LONG_N)], axis=1)
    tens = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    th_l = {k: v[None] for k, v in prob_l.make_theta(tens(np.zeros(3)), tens(x_ref), tens(np.tile([0.15, 0.0], (LONG_N, 1)))).items()}
    U_l = prob_l.default_u0[None]
    k2_l.launches, k2_l.record = 0, []
    sol_l = k2_l(th_l, U_l)
    torch.cuda.synchronize()
    calls, n = [(k2_l, *c) for c in k2_l.record], k2_l.launches
    k2_l.record = None
    ms_l = cuda_ms(k2_l, th_l, U_l)
    U = sol_l.U[0].cpu().numpy()
    end_x = float(sol_l.X[0, -1, 0])
    print(
        f"scale K2 long horizon (B=1, N={LONG_N}, 4x3 iterations, 6 alphas): converged {bool(sol_l.converged[0])}, "
        f"cruise v min {U[5:-5, 0].min():.4f} m/s, terminal x {end_x:.3f} m (reference {0.15 * LONG_N * dt:.2f}); "
        f"{ms_l:.3f} ms (CUDA events, median of 5); launches {n} -- {card}",
        flush=True,
    )
    if n != 1 or not np.isfinite(U).all() or not (U[5:-5, 0] > 0.12).all() or abs(end_x - 0.15 * LONG_N * dt) >= 1.5:
        raise AssertionError("scale K2 long horizon: no solve, or it does not track")
    launches["K2"] += n
    checks.append((f"scale K2 long horizon (B=1, N={LONG_N})", "K2", calls))
    print(f"launch counters of the scale phase: {launches}", flush=True)

    def distributed_run():
        """scaling_bench.run_distributed on the card: two gloo ranks on
        cuda:0, each solving its half of a 4096 bank through K1, against one
        process's solve of the whole bank. The ranks stage the collectives
        through the host (gloo has no CUDA collectives; NCCL refuses two
        ranks on one card), so this path is outside the sync check. Returns
        the ranks' K1 launches."""
        t0 = time.perf_counter()
        out = scaling_bench.run_distributed(
            timeout=300.0, device=str(dev), per_device_batch=B // 2, horizon=N, reps=1, engines=("cuda",)
        )
        res = {r["engine"]: r for r in out["results"]}
        print(
            f"scale two gloo ranks on the card ({out['global_devices']} shards of {out['per_device_batch']}, N={N}, K1): gathered bank "
            f"bit-equal to one process's solve {'yes' if out['bit_equal_vs_local'] else 'no'} (max |dU| "
            f"{out['max_err_vs_local']:.3e}); all-reduced metrics mean cost {out['mean_cost']:.6f}, converged "
            f"{out['frac_converged']:.4f} (one process {out['metrics_local']['mean_cost']:.6f}, "
            f"{out['metrics_local']['frac_converged']:.4f}); swarm across the ranks |dx| {out['swarm_err_vs_local']:.3e}, "
            f"min separation {out['swarm_min_separation']:.4f} m; K1 one shard {res['cuda']['solves_per_s_1dev']:,.0f} "
            f"solves/s, two ranks {res['cuda']['solves_per_s_ndev']:,.0f}; K1 launches in the ranks {out['launches']} "
            f"({time.perf_counter() - t0:.1f} s with the spawn) -- {card}",
            flush=True,
        )
        if not out["bit_equal_vs_local"] or out["swarm_err_vs_local"] != 0.0:
            raise AssertionError("scale two ranks: the globally sharded solve differs from one process's")
        return out["launches"]

    return launches, checks, distributed_run


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
    from ros2_mpc_tpu_torch.solver import Solution, SolverSettings, make_point_stabilization
    from ros2_mpc_tpu_torch.solver.cuda_kernel import make_cuda_point_stab_solver, make_cuda_tracking_solver
    from ros2_mpc_tpu_torch.utils import roofline as rl
    from ros2_mpc_tpu_torch.utils.telemetry import profile_trace

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    clock = [time.perf_counter()]

    def lap(name):
        """Print the wall time since the last lap and since the script
        started: where the script's time goes."""
        now = time.perf_counter()
        into = time.monotonic() - STARTED
        print(f"phase {name}: {now - clock[0]:.1f} s (ending {into:.1f} s into the script)", flush=True)
        clock[0] = now

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

    lap("build and SASS")
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
        check_geometry(name, s, Bk)

    lap("inputs and geometry")
    # ---- main path, with the launch counters zeroed just before
    for s in (k1, k2, k1_tick, k2_tick):
        s.launches = 0
    keep_calls((k1_tick, k2_tick))  # the ticks' kernel calls, for the plain checks
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

    lap("main path")
    # ---- 2-5. the ticks (their kernel calls join the plain checks in the
    # worker processes after the scale phase, below)
    k1_cnt = make_cuda_point_stab_solver(prob.ocp, prob.settings, with_counters=True)
    k2_cnt = make_cuda_tracking_solver(prob_t.ocp, prob_t.settings, with_counters=True)
    tick_checks = kept_checks("main path 5 warm ticks, realtime,", {"K1 tick": k1_tick, "K2 tick": k2_tick})
    for name, (ticks, pose) in ran.items():
        final = ticks[-1][2]
        print(
            f"{name} path (5 warm ticks, B=1, N={final.U.shape[0]}, realtime): last tick converged "
            f"{bool(final.converged)}, pose after 5 ticks {np.round(pose, 4).tolist()}",
            flush=True,
        )
        if not bool(torch.isfinite(final.U).all()):
            raise AssertionError(f"{name} path: non-finite U")
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

    lap("plain ticks and tick latency")
    # ---- the closed loop, run_sim_stack's scenario, for both followers
    loop_launches, loop_checks = closed_loop_phase(dev, card)

    lap("closed loop")
    # ---- the closed loop under the JAX suite's other conditions; their
    # kept kernel calls join the plain checks
    cond_launches, cond_checks = conditions_phase(dev, card)
    loop_checks += cond_checks
    lap("conditions")
    # ---- the restored arguments: the oracle banks (their f64 polish beside
    # the later phases), the live graph, the home routes, the multi-robot
    # sim, include_mppi=False; their kept kernel calls join the plain checks
    deploy_launches, deploy_checks, oracle_verdicts = deploy_phase(dev, card, inp)
    lap("deploy")
    # ---- the robustness composites, each counted on its own call; then
    # every kernel call of the main path's banks and of those counted calls
    # through its plain version on CPU copies of the inputs the kernel was
    # given, in worker processes, side by side with the CPU check below
    # (nothing is timed on the card meanwhile), costliest first
    comp_launches, comp_checks = composites_phase(dev, card, inp)
    comp_checks += tick_checks + loop_checks + deploy_checks
    lap("composites")
    # ---- the fleets and the sampling engines, each rollout counted on its
    # own run; their first and last ticks' kernel calls and the hybrid's
    # join the composites' in the plain checks
    fleet_launches, fleet_checks, card_against_cpu = fleets_phase(dev, card, inp)
    comp_checks += fleet_checks
    lap("fleets")
    # ---- navigate-while-mapping, exploration, the wavefront, the live and
    # multi-process graphs and the compat adapters
    auto_launches, auto_checks = autonomy_phase(dev, card)
    comp_checks += auto_checks
    lap("autonomy")
    # ---- the mesh, the sharded fleets, the sweep and the scaling harness on
    # four shards of the card; their kept shard calls join the plain checks
    scale_launches, scale_checks, distributed_run = scale_phase(dev, card, inp)
    comp_checks += scale_checks
    lap("scale")
    bank_jobs = {
        "K1 headline": plain_job(k1, th_main, U0, with_counters=True),
        "K1 obstacle-active": plain_job(k1, th_obs, U0, with_counters=True),
        "K2 tracking": plain_job(k2, th_trk, U0, with_counters=True),
    }
    jobs = list(bank_jobs.values()) + [plain_job(k, th, U) for _, _, calls in comp_checks for k, th, U, _ in calls]
    order = sorted(range(len(jobs)), key=lambda i: -plain_cost(jobs[i]))
    with multiprocessing.get_context("spawn").Pool(PLAIN_WORKERS) as pool:  # terminated on exit
        pending = {i: pool.apply_async(plain_call, (*jobs[i], str(dev))) for i in order}
        deadline = time.perf_counter() + PLAIN_TIMEOUT_S
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
        lap("K1 against make_solver")
        # ---- the small fleets on the card against the same on the CPU
        apart = card_against_cpu()
        print(
            f"fleets on the card against the CPU (B={FLEET_SMALL_B}, {FLEET_SMALL_TICKS} ticks, plain versions on "
            f"the CPU): max |trajectory difference| {apart} (band {FLEET_CPU_ATOL}; not bit-equality: the plant's "
            "RK4 and the reference windows run sin/cos in CUDA's libm on the card and the CPU's libm on the host)",
            flush=True,
        )
        if max(apart.values()) > FLEET_CPU_ATOL:
            raise AssertionError(f"fleets: the card and the CPU apart by {apart}")
        lap("fleets against the CPU")
        # ---- two gloo ranks on the card, one globally sharded bank
        dist_launches = distributed_run()
        lap("scale: two gloo ranks")
        results = [pending[i].get(timeout=max(1.0, deadline - time.perf_counter())) for i in range(len(jobs))]
    plain = {}  # the main path's banks (with their counters, which the
    # counted reruns of the roofline path must match)
    for name, (sol, cnt, secs) in zip(bank_jobs, results):
        plain[name] = (
            Solution(*(torch.from_numpy(t).to(dev) for t in sol)),
            {k: torch.from_numpy(v).to(dev) for k, v in cnt.items()},
        )
        print(f"{name} bank's plain version: {secs:.1f} s in its worker", flush=True)
    err1 = compare(f"K1 headline bank (parity, B={B}, N={N})", sol_main, plain["K1 headline"][0], INERT)
    compare("K1 obstacle-active bank (corrected)", sol_obs, plain["K1 obstacle-active"][0], LIVE)
    err2 = compare("K2 tracking bank (corrected, terminal weight)", sol_trk, plain["K2 tracking"][0], LIVE)
    # each composite's kernel calls, at the shapes its counted call gave them
    comp_err, done = {"K1": 0.0, "K2": 0.0}, iter(results[len(bank_jobs) :])
    fields = ("U", "X", "cost", "kkt_residual", "converged", "n_iters")
    for name, kname, calls in comp_checks:
        unequal, rows, secs = [], [], []
        for i, (_, th, _, got) in enumerate(calls):
            sol, _, sec = next(done)
            ref = Solution(*(torch.from_numpy(t).to(dev) for t in sol))
            unequal += [f"call {i} {f}" for f in fields if not torch.equal(getattr(got, f), getattr(ref, f))]
            comp_err[kname] = max(comp_err[kname], float((got.U - ref.U).abs().max()))
            rows.append(str(th["x0"].shape[0]))
            secs.append(f"{sec:.1f}")
        line = (
            f"{name}: its {len(calls)} {kname} call(s) of {', '.join(rows)} rows bit-equal to the plain "
            f"version on the same inputs {'yes' if not unequal else 'no: ' + ', '.join(unequal)} "
            f"({', '.join(secs)} s in their workers)"
        )
        print(line, flush=True)
        if unequal:
            raise AssertionError(f"{line}: differs from the plain version")
    lap("plain versions of the banks, composites and fleets")
    oracle_verdicts()
    lap("the oracle's verdicts")
    # ---- 6. timing, kernel and plain version alternating
    times = {}
    for name, s, th in (("K1", k1, th_main), ("K2", k2, th_trk)):
        times[name] = (cuda_ms(s, th, U0), cuda_ms(s.plain, th, U0, reps=1, warm=False))
        ms, plain_ms = times[name]
        print(
            f"timing {name} B={B} N={N}: kernel {ms:.3f} ms ({B / ms * 1e3:.0f} solves/s, median "
            f"of 5), plain {plain_ms:.1f} ms ({B / plain_ms * 1e3:.0f} solves/s, one call) -- {card}",
            flush=True,
        )
    ms_obs = cuda_ms(k1, th_obs, U0)
    print(f"timing K1 obstacle-active bank: kernel {ms_obs:.3f} ms, median of 5 -- {card}", flush=True)

    lap("timing")
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
        # which the kernels' line search costs one cost pass each
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
            # the lanes run the candidates' state passes and redundant sweeps,
            # so a recount of one thread per scenario says nothing about them
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
            "launches": launches["K1"] + loop_launches["K1"] + comp_launches["K1"] + fleet_launches["K1"]
            + auto_launches["K1"] + scale_launches["K1"] + dist_launches + deploy_launches["K1"] + cond_launches["K1"],
            "max_abs_err": max(err1, comp_err["K1"]),
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
            "launches": launches["K2"] + loop_launches["K2"] + comp_launches["K2"] + fleet_launches["K2"]
            + auto_launches["K2"] + scale_launches["K2"] + deploy_launches["K2"] + cond_launches["K2"],
            "max_abs_err": max(err2, comp_err["K2"]),
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
    lap("roofline and profile")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
