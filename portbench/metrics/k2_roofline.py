"""K2's share of its roofline (%) per call (in a fleet, one tick's call): as
``k1_roofline``, with the tracking ledger."""

from yardstick import ledger

KERNEL = "tracking_kernel"


def read(run):
    if run.kernel != KERNEL:
        return None
    k2, _ = run.stretch.solver_kernels(KERNEL)
    if not k2:
        return None
    bound, _ = ledger.bound_seconds(*run.cell.per_call_work())
    return 100.0 * bound / (sum(d for _, _, d in k2) / len(k2) / 1e6)
