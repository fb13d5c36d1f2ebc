"""Host time a batch of the DVB-T receive (the symbol FFT, the
scattered-pilot estimate and CSI, the Figure-9a LLRs and the read of the
TPS cells): the program's span ``orion.dvbt.receive`` summed over a
``decode_batch``, from the profiled window."""

from .. import recorded


def read(run):
    return recorded.mean(run, lambda r: r.ms("orion.dvbt.receive"),
                         "orion.dvbt.decode_batch")
