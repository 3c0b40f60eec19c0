"""The port against the f64 oracle (BASELINE.md: control error <= 1e-3):
the obstacle-active bicycle sweep (seed 7, 16 scenarios) through the
generic bank engine.

Seeds, counts, bands and polish rules are ``tests/test_oracle_sweep.py``'s,
through ``tests/oracle_banks.py``; every tensor is on the CPU."""

import pytest
import torch

import oracle_banks as ob


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


def test_bicycle_oracle_sweep():
    _sweep("bicycle")
