"""Device time per fleet tick (ms) in the operations the bank wrappers
issue inside the tick's call: ``bank.pack`` and ``bank.finish``."""

from yardstick import spans


def read(run):
    if run.kind != "fleet":
        return None
    ticks = run.stretch.units * run.cell.mix["ticks"]
    return spans.per_unit(run, "fleet.tick", ticks, ("bank.pack", "bank.finish"))
