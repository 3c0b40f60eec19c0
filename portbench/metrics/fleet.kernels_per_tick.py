"""Kernels the fleet's tick loop launches on the program's stream, per tick
(the rollout's closing summary included)."""


def read(run):
    if run.kind != "fleet" or run.stretch.units == 0:
        return None
    k2, others = run.stretch.solver_kernels(run.kernel)
    if not k2:
        return None
    return (len(k2) + len(others)) / (run.stretch.units * run.cell.mix["ticks"])
