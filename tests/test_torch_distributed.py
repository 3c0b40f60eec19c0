"""The port's multi-process runtime (``ros2_mpc_tpu_torch.parallel.distributed``)
and the mesh across processes, on the CPU: the single-host no-op
(``tests/test_utils.py:77``), the resolution order of ``initialize``, and two
gloo ranks x 4 CPU shards solving one globally sharded bank, held against a
one-process solve of the whole bank as ``tests/dist_worker.py`` holds the
JAX package's (1e-5), with the sharded swarm's per-tick gather crossing the
ranks (``scaling_bench.run_distributed``, which kills its ranks if they
outlive its timeout).
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ros2_mpc_tpu_torch.parallel import distributed, scaling_bench
from ros2_mpc_tpu_torch.parallel import mesh as tmesh

CPU = "cpu"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_distributed_noop_single_host():
    """test_utils.py::test_distributed_noop_single_host: no address, no
    torchrun variables: nothing is initialized; the CPU mesh's eight slots."""
    info = distributed.initialize(device=CPU)
    assert info["initialized"] is False
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert info["global_devices"] == 8 and info["backend"] is None
    assert not dist.is_initialized()


def test_initialize_resolves_explicit_then_torchrun_then_noop(monkeypatch, capsys):
    """An explicit init_method wins over torchrun's variables; the backend
    (gloo on the CPU) is printed; the mesh then spans the process group;
    without a card the default device refuses."""
    port = _free_port()
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")  # would fail if it were used
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    try:
        info = distributed.initialize(f"tcp://127.0.0.1:{port}", world_size=1, rank=0, device=CPU)
        assert info["initialized"] and info["backend"] == "gloo" and info["process_count"] == 1
        assert f"backend gloo, rank 0 of 1, tcp://127.0.0.1:{port}" in capsys.readouterr().out
        mesh = tmesh.make_mesh(device=CPU)
        assert (mesh.world, mesh.rank, mesh.size) == (1, 0, 8)
        sols = tmesh.shard_bank({"x": torch.arange(8.0)}, mesh)
        assert torch.equal(sols.gather(CPU)["x"], torch.arange(8.0))  # through all_gather of one rank
    finally:
        dist.destroy_process_group()
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    try:
        info = distributed.initialize(device=CPU)  # torchrun's variables
        assert info["initialized"] and info["process_count"] == 1
        assert "env://" in capsys.readouterr().out
    finally:
        dist.destroy_process_group()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize()


def test_two_gloo_ranks_solve_one_globally_sharded_bank():
    """tests/dist_worker.py's check in the port: two spawned ranks x 4 CPU
    shards, one global mesh of 8; each rank solves its half of the bank
    through K1 (its plain version here); the gathered bank equals one
    process's solve of the whole bank within 1e-5, the metrics all-reduced
    across the ranks equal that solve's, and the sharded swarm, whose
    positions and velocities cross the ranks every tick, equals the
    unsharded swarm."""
    out = scaling_bench.run_distributed(
        timeout=120.0, device=CPU, n_devices=4, per_device_batch=2, horizon=6, reps=1, engines=("cuda",), swarm_ticks=3
    )
    assert out["processes"] == 2 and out["global_devices"] == 8 and out["backend"] == "gloo"
    assert out["max_err_vs_local"] <= 1e-5
    assert out["swarm_err_vs_local"] <= 1e-5
    local = out["metrics_local"]
    np.testing.assert_allclose(out["mean_cost"], local["mean_cost"], rtol=1e-6)
    assert out["max_kkt"] == local["max_kkt"] and out["frac_converged"] == local["frac_converged"]
    assert np.isfinite(out["swarm_min_separation"]) and out["swarm_min_separation"] > 0
    assert {r["engine"] for r in out["results"]} == {"cuda", "swarm_allgather"}
    for r in out["results"]:
        assert r["solves_per_s_1dev"] > 0 and r["solves_per_s_ndev"] > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card (python3 chip_smoke.py)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_bit_equal(cuda_device):
    """On the card: two gloo ranks on cuda:0 (NCCL refuses two ranks on one
    card), each solving its half of the bank through K1, gather a bank
    bit-equal to one process's solve."""
    out = scaling_bench.run_distributed(timeout=300.0, device=str(cuda_device), per_device_batch=256, horizon=20, reps=1, engines=("cuda",))
    assert out["bit_equal_vs_local"] and out["max_err_vs_local"] == 0.0 and out["swarm_err_vs_local"] == 0.0
    assert out["launches"] > 0
