"""Blocking device-to-host reads a batch: the program's counter
``d2h.reads``, from the profiled window."""

from .. import recorded


def read(run):
    return recorded.mean(run, lambda r: r.counters.get("d2h.reads", 0))
