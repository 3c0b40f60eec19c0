"""The port's first slice end to end on the CPU: the headline bank recipe,
the packed single-robot tick, the import boundary and chip_smoke.py's
refusal to run without a card.

Bands: the inert headline bank U atol 1e-4 / cost rtol 1e-4; the
obstacle-active ticks U atol 5e-4 / cost rtol 1e-3 (tests/test_pallas.py).
"""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros2_mpc_tpu import solver as js
from ros2_mpc_tpu.config import Params as JParams
from ros2_mpc_tpu.solver import packed as j_packed
from ros2_mpc_tpu.solver.pallas_kernel import make_pallas_point_stab_solver
from ros2_mpc_tpu_torch import solver as ts
from ros2_mpc_tpu_torch.config import Params as TParams
from ros2_mpc_tpu_torch.convert import solution_to_numpy, theta_from_numpy
from ros2_mpc_tpu_torch.solver import cuda_kernel as ck
from ros2_mpc_tpu_torch.solver import packed as t_packed

ROOT = Path(__file__).resolve().parent.parent
PARAMS = JParams()
T_PARAMS = TParams()
J_FAST = js.SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6)
T_FAST = ts.SolverSettings(barrier_stages=4, iters_per_stage=3, n_alphas=6)


def test_headline_bank_recipe_matches_jax():
    """bench.py's headline bank (rng 0, parity, goals with any heading) at
    B=32, N=20 under the fast test schedule: the port's K1 path (its plain
    version on the CPU) against the JAX Pallas kernel in interpret mode and
    against the JAX make_solver.

    Under the short schedule fewer than half of this bank reach the KKT
    tolerance, and on unconverged scenarios the engines' rounding
    differences grow: the JAX Pallas kernel itself sits 1.7e-3 from the JAX
    make_solver on two of them, while the port stays within 1e-4 of
    make_solver on every scenario. So the make_solver band holds on all
    scenarios, the Pallas band on those Pallas certifies converged."""
    B, N = 32, 20
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-0.3, 0.3, size=(B, 3))
    goal = np.concatenate(
        [rng.uniform(-1.5, 1.5, size=(B, 2)), rng.uniform(-np.pi, np.pi, size=(B, 1))], axis=1
    )
    jprob = js.make_point_stabilization(PARAMS, horizon=N, settings=J_FAST)
    thetas = jax.vmap(jprob.make_theta)(jnp.asarray(x0), jnp.asarray(goal))
    U0 = jnp.zeros((B, N, 2))
    pallas = make_pallas_point_stab_solver(jprob.ocp, J_FAST, interpret=True, tile_s=4, tile_l=8)(thetas, U0)
    reference = jax.jit(jax.vmap(jprob.solve))(thetas, U0)
    tprob = ts.make_point_stabilization(T_PARAMS, horizon=N, settings=T_FAST, device="cpu")
    tthetas = torch.func.vmap(tprob.make_theta)(torch.tensor(x0), torch.tensor(goal))
    got = solution_to_numpy(ck.make_cuda_point_stab_solver(tprob.ocp, T_FAST)(tthetas, torch.zeros(B, N, 2)))
    assert got.U.shape == (B, N, 2) and np.isfinite(got.U).all()

    np.testing.assert_allclose(got.U, np.asarray(reference.U), atol=1e-4)
    np.testing.assert_allclose(got.X, np.asarray(reference.X), atol=1e-4)
    np.testing.assert_allclose(got.cost, np.asarray(reference.cost), rtol=1e-4)

    ok = np.asarray(pallas.converged)
    assert ok.sum() >= 8
    np.testing.assert_allclose(got.U[ok], np.asarray(pallas.U)[ok], atol=1e-4)
    np.testing.assert_allclose(got.cost[ok], np.asarray(pallas.cost)[ok], rtol=1e-4)
    assert abs(got.converged.mean() - ok.mean()) <= 2 / B


@pytest.mark.parametrize("engine", ["make_solver", "k1_plain"])
def test_packed_warm_ticks_match_jax(engine):
    """3 warm-started ticks of the packed point-stabilization path
    (corrected mode, one live obstacle), driven by the JAX package's loop;
    each tick hands both packages the same packed vector and warm start."""
    N = 10
    n = PARAMS.n_obstacle_points
    jprob = js.make_point_stabilization(PARAMS, horizon=N, settings=J_FAST, reference_parity=False)
    tprob = ts.make_point_stabilization(T_PARAMS, horizon=N, settings=T_FAST, reference_parity=False, device="cpu")
    j_solve, j_pack = j_packed.make_packed_point_stab(jprob, PARAMS)
    j_solve = jax.jit(j_solve)
    solve_fn = None
    if engine == "k1_plain":
        solve_fn = ck.single_scenario(ck.make_cuda_point_stab_solver(tprob.ocp, T_FAST))
    t_solve, t_pack = t_packed.make_packed_point_stab(tprob, T_PARAMS, solve_fn=solve_fn)
    obs_x, obs_y = np.full(n, 100.0), np.full(n, 100.0)
    obs_x[0], obs_y[0] = 0.6, 0.05
    pose, goal = np.zeros(3), np.array([1.0, 0.2, 0.3])
    U_warm = np.zeros((N, 2), np.float32)
    for _ in range(3):
        vec = j_pack(pose, goal, obs_x, obs_y)
        np.testing.assert_array_equal(t_pack(pose, goal, obs_x, obs_y).numpy(), vec)
        ref, ref_next = j_solve(jnp.asarray(vec), jnp.asarray(U_warm))
        got, got_next = t_solve(torch.tensor(vec), torch.tensor(U_warm))
        np.testing.assert_allclose(got.U.numpy(), np.asarray(ref.U), atol=5e-4)
        np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-3)
        np.testing.assert_allclose(got_next.numpy(), np.asarray(ref_next), atol=5e-4)
        U_warm = np.asarray(ref_next)
        pose = np.asarray(ref.X[1])
    assert np.linalg.norm(pose[:2]) > 0.05  # the robot moved toward the goal


def test_packed_tracking_layout_matches_jax():
    N = 10
    jprob = js.make_tracking(PARAMS, horizon=N, settings=J_FAST)
    tprob = ts.make_tracking(T_PARAMS, horizon=N, settings=T_FAST, device="cpu")
    rng = np.random.default_rng(3)
    args = (rng.standard_normal(3), rng.standard_normal((N, 3)), rng.standard_normal((N, 2)))
    obs = (np.full(PARAMS.n_obstacle_points, 100.0),) * 2
    vec_j = j_packed.make_packed_tracking(jprob, PARAMS)[1](*args, *obs)
    vec = t_packed.make_packed_tracking(tprob, T_PARAMS)[1](*args, *obs)
    np.testing.assert_array_equal(vec.numpy(), vec_j)
    seen = {}

    def capture(theta, U0):
        seen.update(theta)
        return ts.Solution(U0, None, None, None, None, None, None)

    t_packed.make_packed_tracking(tprob, T_PARAMS, solve_fn=capture)[0](vec, torch.zeros(N, 2))
    np.testing.assert_allclose(seen["x_ref"].numpy(), args[1].astype(np.float32))
    np.testing.assert_allclose(seen["u_ref"].numpy(), args[2].astype(np.float32))
    assert seen["Q"].shape == (3,)  # constant leaves come from make_theta


def test_theta_conversion_round_trip():
    jprob = js.make_point_stabilization(PARAMS, horizon=5)
    th = jax.vmap(jprob.make_theta)(jnp.zeros((2, 3)), jnp.ones((2, 3)))
    tth = theta_from_numpy(th, "cpu")
    assert set(tth) == set(th)
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in tth.values())
    sol = ts.Solution(torch.ones(2, 5, 2), torch.zeros(2, 6, 3), torch.ones(2), torch.zeros(2), torch.ones(2, dtype=torch.bool), torch.tensor([3, 4]), torch.zeros(2))
    back = solution_to_numpy(sol)
    assert isinstance(back.U, np.ndarray) and back.converged.dtype == np.bool_


def _run(args, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT) if cwd == ROOT else "")
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout
    )


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ros2_mpc_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for mod in ('solver.cuda_kernel', 'utils.roofline', 'utils.telemetry', 'config'):\n"
        "    assert 'ros2_mpc_tpu_torch.' + mod in sys.modules, names\n"
        "leaked = sorted(m for m in sys.modules if m in ('jax', 'ros2_mpc_tpu')\n"
        "                or m.startswith(('jax.', 'ros2_mpc_tpu.')))\n"
        "assert not leaked, leaked\n"
        "print(len(names))\n"
    )
    proc = _run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 16


def _imported_roots(path):
    """Top-level packages a source file imports, wherever the import sits."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_import_nothing_of_jax():
    """No module of the port and not chip_smoke.py imports jax or the JAX
    package, not even lazily inside a function."""
    files = sorted((ROOT / "ros2_mpc_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    for path in files:
        assert not _imported_roots(path) & {"jax", "jaxlib", "ros2_mpc_tpu"}, path


def test_port_params_match_jax():
    """The port's own Params: every field and property equal to the JAX
    package's, and Params.load reads the port's own params.yaml."""
    got, ref = T_PARAMS, PARAMS
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert (got.n_obstacle_points, got.costmap_cells) == (ref.n_obstacle_points, ref.costmap_cells)
    assert got.to_yaml_dict() == ref.to_yaml_dict()
    yaml_path = ROOT / "ros2_mpc_tpu_torch" / "assets" / "params.yaml"
    assert yaml_path.read_text() == (ROOT / "ros2_mpc_tpu" / "assets" / "params.yaml").read_text()
    assert dataclasses.asdict(TParams.load()) == dataclasses.asdict(JParams.load())
    assert TParams.load(N=20).N == 20 and TParams.load(str(yaml_path)) == TParams()
    assert TParams.from_yaml_dict({"Q": [2.0, 2.0, 0.1], "bogus": 1}).Q == (2.0, 2.0, 0.1)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run for real")
    proc = _run([str(ROOT / "chip_smoke.py")], ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    # alone in a directory, without the rest of the repository
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
