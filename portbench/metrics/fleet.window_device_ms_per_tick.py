"""Device time per fleet tick (ms) in the operations issued inside
``fleet.window``: every robot's reference window and its handoff gains."""

from yardstick import spans


def read(run):
    if run.kind != "fleet":
        return None
    return spans.per_unit(run, "fleet.tick", run.stretch.units * run.cell.mix["ticks"], ("fleet.window",))
