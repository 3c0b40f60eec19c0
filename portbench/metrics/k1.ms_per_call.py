"""K1's device time per call (ms), from the profiled stretch."""

KERNEL = "point_stab_kernel"


def read(run):
    if run.kernel != KERNEL:
        return None
    k1, _ = run.stretch.solver_kernels(KERNEL)
    return sum(d for _, _, d in k1) / len(k1) / 1e3 if k1 else None
