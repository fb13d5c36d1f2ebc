"""Host time a batch in the receive call outside every program span: the
root span's duration less its direct children, from the profiled
window."""

from .. import recorded


def read(run):
    return recorded.mean(run, lambda r: r.self_ns / 1e6)
