"""100 minus the share of the profiled window in which an operation ran
on the card (the union of its kernel and copy intervals)."""


def read(run):
    p = run.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
