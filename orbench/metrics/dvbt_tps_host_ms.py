"""Host time a batch of the DVB-T per-frame TPS loop (differential
decisions, the BCH(67, 53) decode, the word's fields): the program's span
``orion.dvbt.tps`` summed over a ``decode_batch``, from the profiled
window."""

from .. import recorded


def read(run):
    return recorded.mean(run, lambda r: r.ms("orion.dvbt.tps"),
                         "orion.dvbt.decode_batch")
