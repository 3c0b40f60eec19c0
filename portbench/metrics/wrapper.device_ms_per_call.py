"""Device time per bank call (ms) in kernels other than the solver kernel on
the program's stream: what ``CudaBankSolver._pack`` and ``_finish`` run."""


def read(run):
    if run.kind != "bank" or run.stretch.units == 0:
        return None
    k1, others = run.stretch.solver_kernels(run.kernel)
    return sum(d for _, _, d in others) / run.stretch.units / 1e3 if k1 else None
