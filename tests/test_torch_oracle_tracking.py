"""The port against the f64 oracle (BASELINE.md: control error <= 1e-3):
the parity tracking sweep (seed 11, 32 scenarios) and the corrected
terminal-weight tracking sweep (seed 13, 16) on K2's plain version, and the
warm-started realtime schedule (seed 19, 8 scenarios x 4 ticks) on K1's.

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


def test_tracking_sweep():
    _sweep("tracking")


def test_tracking_terminal_weight_oracle_sweep():
    _sweep("terminal_tracking")


def test_warm_started_realtime_schedule_sweep():
    _sweep("warm_realtime")
