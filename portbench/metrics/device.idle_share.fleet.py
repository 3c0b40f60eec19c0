"""Share of the profiled stretch with nothing running on the card (%), in
the fleet cells."""


def read(run):
    return run.stretch.idle_percent() if run.kind == "fleet" else None
