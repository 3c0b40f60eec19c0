"""K1's share of its roofline (%): the least time the card could take for a
call (the frozen ledger's operations over 67 TFLOP/s or its bytes over
3.35 TB/s, whichever is larger; the live obstacle prefixes from the inputs,
the executed iterations and rollouts from the reference's solves) over K1's
device time per call."""

from yardstick import ledger

KERNEL = "point_stab_kernel"


def read(run):
    if run.kernel != KERNEL:
        return None
    k1, _ = run.stretch.solver_kernels(KERNEL)
    if not k1:
        return None
    bound, _ = ledger.bound_seconds(*run.cell.per_call_work())
    return 100.0 * bound / (sum(d for _, _, d in k1) / len(k1) / 1e6)
