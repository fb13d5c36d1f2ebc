"""Launches of the LDPC BP kernel a batch: the difference of the
program's ``bp_decode_kernel.launches`` across each receive call, from
the profiled window."""

from .. import recorded


def read(run):
    return recorded.mean(run, lambda r: r.launches.get(
        "bp_decode_kernel.launches", 0))
