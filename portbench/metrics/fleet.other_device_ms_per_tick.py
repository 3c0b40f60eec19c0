"""Device time per fleet tick (ms) in kernels other than K2 on the
program's stream: the reference windows, the handoff, the plant, the warm
shift and the wrappers."""


def read(run):
    if run.kind != "fleet" or run.stretch.units == 0:
        return None
    k2, others = run.stretch.solver_kernels(run.kernel)
    if not k2:
        return None
    return sum(d for _, _, d in others) / (run.stretch.units * run.cell.mix["ticks"]) / 1e3
