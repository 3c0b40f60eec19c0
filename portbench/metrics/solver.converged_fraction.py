"""Share of the window's scenarios whose KKT residual is below the
schedule's tolerance (%), from the outputs."""


def read(run):
    if run.kind != "bank":
        return None
    return 100.0 * run.cell.converged_fraction
