"""Share of the traced steps' wall time in which no device operation ran:
the union of the operations' intervals against the host's clock over
those steps."""


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
