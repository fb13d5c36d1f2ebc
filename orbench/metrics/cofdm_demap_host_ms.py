"""Host time a batch in the COFDM soft demap (the header's call and each
(MCS, length) group's): the program's spans ``orion.frame.soft_demap``
summed over a ``decode_batch``, from the profiled window."""

from .. import recorded


def read(run):
    return recorded.mean(run, lambda r: r.ms("orion.frame.soft_demap"),
                         recorded.COFDM)
