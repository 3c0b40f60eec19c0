"""Device time per fleet tick (ms) in the operations issued inside
``fleet.plant``: the goal latch, the first control, the RK4 plant, the
warm shift and the cross-track sums."""

from yardstick import spans


def read(run):
    if run.kind != "fleet":
        return None
    return spans.per_unit(run, "fleet.tick", run.stretch.units * run.cell.mix["ticks"], ("fleet.plant",))
