"""Share of the profiled stretch with nothing running on the card (%), in
the bank cells."""


def read(run):
    return run.stretch.idle_percent() if run.kind == "bank" else None
