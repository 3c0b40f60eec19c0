"""Device time per bank call (ms) in the operations issued inside
``bank.finish`` (``CudaBankSolver._finish``: the outputs laid back
scenario-first, the converged flags)."""

from yardstick import spans


def read(run):
    return spans.per_unit(run, "bank.call", run.stretch.units, ("bank.finish",)) if run.kind == "bank" else None
