"""Host time a batch in the blocking device-to-host reads of the receive
path (where the host waits for the card): the program's spans
``orion.d2h`` summed, from the profiled window."""

from .. import recorded


def read(run):
    return recorded.mean(run, lambda r: r.ms("orion.d2h"))
