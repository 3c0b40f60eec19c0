"""The port's checkpointed sweeps (``ros2_mpc_tpu_torch.parallel.sweep``)
against the JAX package's (``tests/test_parallel.py:136-146``,
``tests/test_scaling.py:77-127``) on the CPU.

Both packages draw the sweep's bank from ``np.random.default_rng(spec.seed)``
call for call, so the theta banks are equal; the sweeps run on eight CPU
shards (K1's plain version for ``engine="cuda"``). Bands: the per-config
mean goal errors of K1 against the vmap engine and against the JAX
package's vmap sweep within 2e-4, the JAX suite's own band between its
engines (``test_scaling.py:127``).
"""

import os

import numpy as np
import pytest
import torch

from ros2_mpc_tpu import solver as js
from ros2_mpc_tpu.config import Params as JParams
from ros2_mpc_tpu.parallel import sweep as jsw
from ros2_mpc_tpu_torch import solver as ts
from ros2_mpc_tpu_torch.config import Params as TParams
from ros2_mpc_tpu_torch.parallel import mesh as tmesh
from ros2_mpc_tpu_torch.parallel import sweep as tsw
from ros2_mpc_tpu_torch.solver.cuda_kernel import make_cuda_point_stab_solver

J_PARAMS, T_PARAMS = JParams(), TParams()
SHORT = dict(barrier_stages=2, iters_per_stage=2, n_alphas=4)
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run small tensors through many ops; under the suite's
    parallel workers PyTorch's default thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problems(horizon=5, settings=SHORT):
    return (
        js.make_point_stabilization(J_PARAMS, horizon=horizon, settings=js.SolverSettings(**settings)),
        ts.make_point_stabilization(T_PARAMS, horizon=horizon, settings=ts.SolverSettings(**settings), device=CPU),
    )


@pytest.mark.parametrize("seed", [0, 2])
def test_build_sweep_thetas_equal_to_jax(seed):
    """One seed, one bank: every theta leaf and the (Q, R) grid equal to the
    JAX package's."""
    jp, tp = _problems()
    spec = dict(q_scales=(0.5, 1.0, 2.0), r_scales=(0.25, 1.0), scenarios_per_config=4, seed=seed)
    jth, jcfg = jsw.build_sweep_thetas(jp, jsw.SweepSpec(**spec), J_PARAMS)
    tth, tcfg = tsw.build_sweep_thetas(tp, tsw.SweepSpec(**spec), T_PARAMS)
    np.testing.assert_array_equal(tcfg, jcfg)
    assert set(tth) == set(jth)
    for k in jth:
        np.testing.assert_array_equal(tth[k].numpy(), np.asarray(jth[k]), err_msg=k)


def _counting_k1(calls):
    """A callable engine: K1 (its plain version here) counting its calls."""

    def engine(ocp, settings):
        k1 = make_cuda_point_stab_solver(ocp, settings)

        def solve(thetas, U0s):
            calls.append(U0s.shape[0])
            return k1(thetas, U0s)

        return solve

    return engine


def test_sweep_checkpoint_resume(tmp_path):
    """test_sweep_checkpoint_resume: a finished sweep resumes from its
    checkpoint without a solve; with two chunks deleted from the file, the
    resume solves exactly those two chunks again (a bank call per shard
    each) and gives the same table."""
    _, tp = _problems()
    spec = tsw.SweepSpec(q_scales=(0.5, 1.0), r_scales=(1.0,), scenarios_per_config=8, seed=2)
    mesh = tmesh.make_mesh(4, device=CPU)
    ck = str(tmp_path / "sweep.npz")
    calls = []
    out1 = tsw.run_sweep(tp, spec, mesh=mesh, checkpoint_path=ck, chunk_size=4, engine=_counting_k1(calls))
    assert out1["mean_goal_error"].shape == (2,) and out1["chunks_solved"] == [0, 1, 2, 3]
    assert calls == [1] * 16  # 4 chunks x 4 shards of one scenario
    assert tuple(out1["best_config"]) in {(0.5, 1.0), (1.0, 1.0)}
    calls.clear()
    out2 = tsw.run_sweep(tp, spec, mesh=mesh, checkpoint_path=ck, chunk_size=4, engine=_counting_k1(calls))
    assert out2["chunks_solved"] == [] and calls == []
    np.testing.assert_array_equal(out2["mean_goal_error"], out1["mean_goal_error"])
    with np.load(ck) as f:
        kept = {k: f[k] for k in f.files if k not in ("1", "3")}
    np.savez(ck, **kept)
    out3 = tsw.run_sweep(tp, spec, mesh=mesh, checkpoint_path=ck, chunk_size=4, engine=_counting_k1(calls))
    assert out3["chunks_solved"] == [1, 3] and calls == [1] * 8
    np.testing.assert_array_equal(out3["mean_goal_error"], out1["mean_goal_error"])
    with np.load(ck) as f:
        assert sorted(f.files) == ["0", "1", "2", "3"]


def test_sweep_cuda_engine_matches_vmap_and_jax():
    """test_sweep_engine_option_matches_vmap: the K1 sweep (2 configs x 512
    scenarios over eight shards) against the port's vmap sweep and the JAX
    package's vmap sweep of the same bank."""
    jp, tp = _problems()
    spec = dict(q_scales=(0.5, 1.0), r_scales=(1.0,), scenarios_per_config=512)
    mesh = tmesh.make_mesh(device=CPU)
    out_k1 = tsw.run_sweep(tp, tsw.SweepSpec(**spec), mesh=mesh)
    out_v = tsw.run_sweep(tp, tsw.SweepSpec(**spec), mesh=mesh, engine="vmap")
    out_j = jsw.run_sweep(jp, jsw.SweepSpec(**spec), engine="vmap")
    np.testing.assert_allclose(out_k1["mean_goal_error"], out_v["mean_goal_error"], atol=2e-4)
    np.testing.assert_allclose(out_k1["mean_goal_error"], out_j["mean_goal_error"], atol=2e-4)


def test_sweep_cli_prints_table(capsys):
    """test_sweep_cli_prints_table, and the console main (``cuda-mpc-sweep
    --device cpu``): a finite table and its best config."""
    _, tp = _problems()
    out = tsw.run_sweep(tp, tsw.SweepSpec(q_scales=(1.0,), r_scales=(0.5, 1.0), scenarios_per_config=8), mesh=tmesh.make_mesh(device=CPU))
    assert out["mean_goal_error"].shape == (2,) and np.all(np.isfinite(out["mean_goal_error"]))
    res = tsw.main(["--device", "cpu", "--scenarios-per-config", "8", "--horizon", "5", "--chunk-size", "104"])
    text = capsys.readouterr().out
    assert "mean goal err [m]" in text and "best config (Q, R scales)" in text
    assert len([ln for ln in text.splitlines() if ln.strip() and ln.split()[0].replace(".", "").isdigit()]) == 25
    assert res["chunks_solved"] == [0, 1] and np.all(np.isfinite(res["mean_goal_error"]))


def test_sweep_runs_on_the_card_by_default(monkeypatch, tmp_path):
    """run_sweep's default mesh and the console main name the cards and
    refuse without one; no checkpoint is written then."""
    _, tp = _problems()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ck = str(tmp_path / "ck.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsw.run_sweep(tp, tsw.SweepSpec(scenarios_per_config=1), checkpoint_path=ck)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsw.main([])
    assert not os.path.exists(ck)
