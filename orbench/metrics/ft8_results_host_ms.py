"""Host time a batch of the FT8 per-window result loop (payload bits,
``unpack77``, the result objects): the program's span
``orion.ft8.results``, from the profiled window."""

from .. import recorded


def read(run):
    return recorded.mean(run, lambda r: r.ms("orion.ft8.results"),
                         recorded.FT8)
