"""Host time a batch of the DVB-T transport-stream layer (energy dispersal
undone, sync bytes checked and stripped): the program's spans
``orion.dvbt.ts`` summed over a ``decode_batch``, from the profiled
window."""

from .. import recorded


def read(run):
    return recorded.mean(run, lambda r: r.ms("orion.dvbt.ts"),
                         "orion.dvbt.decode_batch")
