"""Device time per bank call (ms) in the operations issued inside
``bank.pack`` (``CudaBankSolver._pack``: the inputs laid into planes)."""

from yardstick import spans


def read(run):
    return spans.per_unit(run, "bank.call", run.stretch.units, ("bank.pack",)) if run.kind == "bank" else None
