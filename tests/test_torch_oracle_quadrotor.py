"""The port against the f64 oracle (BASELINE.md: control error <= 1e-3):
the 12-state quadrotor fly-to-pose sweep (seed 11) through the generic
bank engine, on the first ``QUAD_CPU_COUNT`` of its 16 scenarios, because
the f64 polish of one 12-state scenario is 9-15 s of single-threaded
Python. ``chip_smoke.py``'s deploy phase solves all 16 on the card and
polishes them in a worker process.

Seeds, counts, bands and polish rules are ``tests/test_oracle_sweep.py``'s,
through ``tests/oracle_banks.py``; every tensor is on the CPU."""

import pytest
import torch

import oracle_banks as ob

QUAD_CPU_COUNT = 4  # the first scenarios of seed 11; all 16 on the card


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The polish is host Python; PyTorch's thread pool only adds contention
    under the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sweep(name, count=None):
    bank = ob.family_bank(name, "cpu", count)
    U, converged = ob.solve_family(name, bank)
    return ob.check_family(name, bank["cases"], U, converged)


def test_quadrotor_oracle_sweep():
    _sweep("quadrotor", QUAD_CPU_COUNT)
