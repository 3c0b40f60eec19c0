"""The frozen roofline yardstick: a hand-worked count, and the copy equal
to the program's ledger it was taken from."""

from __future__ import annotations

import numpy as np
import pytest

from yardstick import ledger


def test_point_stab_ledger_by_hand():
    # N=1, P=0, one iteration and one line-search rollout:
    # arith 409 + 4 + (72 + 13) + 114 = 612; exp (2+1+2) * 1 = 5;
    # log 4 * (1 + 1) = 8; sincos 6 * (2 + 1 + 2) = 30
    assert ledger.point_stab_flops(1, 0, 1, 1) == 612 + 5 + 8 + 30
    # one live point adds P*N*(I*48 + R*9 + 48) arith and (2I+R+2)*N exp
    assert ledger.point_stab_flops(1, 1, 1, 1) - ledger.point_stab_flops(1, 0, 1, 1) == 105 + 5


def test_bytes_and_bound():
    assert ledger.point_stab_bytes(30, 160) == 4 * (6 + 8 + 320 + 60 + 60 + 93 + 4)
    t, by = ledger.bound_seconds(67e9, 0.0)
    assert t == pytest.approx(1e-3) and by == "operations"


@pytest.mark.parametrize("N,P,I,R", [(30, 0, 60, 140), (30, 160, 45, 90), (20, 3, 12, 30)])
def test_copies_the_programs_ledger(N, P, I, R):
    from ros2_mpc_tpu_torch.utils import roofline

    ps = roofline.point_stab_solve_flops(N, P, I, R).total_flops
    tr = roofline.tracking_solve_flops(N, P, I, R).total_flops
    assert np.isclose(ledger.point_stab_flops(N, P, I, R), ps, rtol=1e-12)
    assert np.isclose(ledger.tracking_flops(N, P, I, R), tr, rtol=1e-12)
    assert ledger.point_stab_bytes(N, 160) == roofline.point_stab_hbm_bytes(N, 160)
