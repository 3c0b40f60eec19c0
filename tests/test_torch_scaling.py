"""The port's scaling harness (``ros2_mpc_tpu_torch.parallel.scaling_bench``)
and the long horizon (``tests/test_scaling.py``) on the CPU.

No test here bounds a time or an efficiency: the harness's rates come from
the host clock, so only their positivity, the artifact's schema, and what
the mesh must get right are asserted: shard 0 of the n-shard mesh solves
exactly what one shard alone solves (every engine is per scenario, and the
sampling engines draw by global scenario index). The N=256 tracking solve
runs through K2's plain version at B=1 against the JAX package's
``make_solver`` in the live band (U atol 5e-4, cost rtol 1e-3).
"""

import json

import jax
import numpy as np
import pytest
import torch

from ros2_mpc_tpu import solver as js
from ros2_mpc_tpu.config import Params as JParams
from ros2_mpc_tpu_torch import solver as ts
from ros2_mpc_tpu_torch.config import Params as TParams
from ros2_mpc_tpu_torch.parallel import scaling_bench
from ros2_mpc_tpu_torch.solver.cuda_kernel import make_cuda_tracking_solver

J_PARAMS, T_PARAMS = JParams(), TParams()
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run small tensors through many ops; under the suite's
    parallel workers PyTorch's default thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _n256():
    N = 256
    settings = dict(barrier_stages=4, iters_per_stage=3, n_alphas=6)
    ts_ = np.arange(1, N + 1) * J_PARAMS.dt
    x_ref = np.stack([0.15 * ts_, np.zeros(N), np.zeros(N)], axis=1)
    u_ref = np.tile([0.15, 0.0], (N, 1))
    jp = js.make_tracking(J_PARAMS, horizon=N, settings=js.SolverSettings(**settings))
    tp = ts.make_tracking(T_PARAMS, horizon=N, settings=ts.SolverSettings(**settings), device=CPU)
    return N, jp, tp, x_ref, u_ref


def test_long_horizon_tracking_N256_through_plain_k2():
    """test_long_horizon_tracking_N256: N=256 (51 s lookahead) solves and
    tracks through K2 at B=1 (its plain version; on the card the kernel,
    whose shared memory holds four such scenarios a block), within the
    live band of the JAX package's make_solver."""
    N, jp, tp, x_ref, u_ref = _n256()
    jtheta = jp.make_theta(np.zeros(3), x_ref, u_ref)
    sol_j = jax.jit(jp.solve)(jtheta, jp.default_u0)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    theta = tp.make_theta(f32(np.zeros(3)), f32(x_ref), f32(u_ref))
    k2 = make_cuda_tracking_solver(tp.ocp, tp.settings)
    sol = k2({k: v[None] for k, v in theta.items()}, tp.default_u0[None])
    U = sol.U[0].numpy()
    assert np.all(np.isfinite(U))
    assert np.all(U[5:-5, 0] > 0.12)  # cruises at the bounded reference speed
    assert abs(float(sol.X[0, -1, 0]) - 0.15 * N * T_PARAMS.dt) < 1.5
    np.testing.assert_allclose(U, np.asarray(sol_j.U), atol=5e-4)
    np.testing.assert_allclose(float(sol.cost[0]), float(sol_j.cost), rtol=1e-3)
    from ros2_mpc_tpu_torch.solver.cuda_kernel import group_geometry

    assert group_geometry("tracking", 16, N, 6)["scenarios_per_block"] == 4


def test_scaling_bench_all_engines(tmp_path):
    """test_scaling_bench_all_engines: every engine of the harness through
    run_all_engines at the JAX test's size (8 a shard, N=5, one rep), here
    on two CPU shards; the artifact's schema, positive rates and ceiling,
    shard 0 equal to one shard, and a JSON round trip."""
    out = scaling_bench.run_all_engines(per_device_batch=8, horizon=5, reps=1, device=CPU, n_devices=2)
    assert {r["engine"] for r in out["results"]} == set(scaling_bench.BENCH_ENGINES) == {
        "vmap", "fast", "cuda", "mppi", "two_pass", "multistart_bank", "multistart_rescue",
    }  # fmt: skip
    assert out["devices"] == 2 and 0.0 < out["contention_ceiling"] <= 1.0
    keys = {"engine", "devices", "per_device_batch", "horizon", "solves_per_s_1dev", "solves_per_s_ndev",
            "scaling_efficiency", "efficiency_vs_ceiling", "metrics_1dev", "metrics_ndev", "first_shard_equal"}  # fmt: skip
    for r in out["results"]:
        assert keys <= set(r), r
        assert r["solves_per_s_1dev"] > 0 and r["solves_per_s_ndev"] > 0 and r["scaling_efficiency"] > 0, r
        assert r["first_shard_equal"] is True, r
        assert r["kernel_launches"] == 0  # the plain versions on the CPU
        assert np.isfinite(r["metrics_ndev"]["mean_cost"]) and 0.0 <= r["metrics_ndev"]["frac_converged"] <= 1.0
    p = tmp_path / "scaling.json"
    p.write_text(json.dumps(out))
    assert json.loads(p.read_text())["devices"] == 2


@pytest.mark.parametrize("engine", ["hybrid", "multistart"])
def test_scaling_run_sampling_polish_engines(engine):
    """The two engines the harness's default list leaves out (the MPPI
    polishes, which chip_smoke.py times) through run() on two CPU shards:
    shard 0 equal to one shard, finite metrics."""
    opts = scaling_bench.engine_options(4)[engine]
    r = scaling_bench.run(4, 5, 1, engine=engine, device=CPU, n_devices=2, **opts)
    assert r["devices"] == 2 and r["first_shard_equal"] is True
    assert r["solves_per_s_ndev"] > 0 and np.isfinite(r["metrics_ndev"]["mean_cost"])


def test_scaling_main_writes_under_build(monkeypatch, tmp_path, capsys):
    """The console main (``cuda-mpc-scaling-bench``) writes its artifact
    under build/ of the working directory by default, never the root; it
    refuses without a card unless --device names the CPU."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(scaling_bench, "BENCH_ENGINES", ("cuda",))
    out = scaling_bench.main(["--device", "cpu", "--n-devices", "2", "--per-device-batch", "2", "--horizon", "4", "--reps", "1"])
    written = json.loads((tmp_path / "build" / "SCALING.json").read_text())
    assert written["results"][0]["engine"] == "cuda" == out["results"][0]["engine"]
    assert [p.name for p in tmp_path.iterdir()] == ["build"]
    assert "cuda: shards=2" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaling_bench.main([])
