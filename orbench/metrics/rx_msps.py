"""Received IQ samples of every batch finished in the window over the
window's length (host clock), in millions a second."""


def read(run):
    return run.samples / run.window_s / 1e6 if run.window_s > 0 else None
