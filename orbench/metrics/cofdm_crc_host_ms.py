"""Host time a batch of the COFDM chain's per-frame loop (bit packing,
byte descrambling, CRC-32 check and strip): the program's spans
``orion.chain.crc`` summed over a ``decode_batch``, from the profiled
window."""

from .. import recorded


def read(run):
    return recorded.mean(run, lambda r: r.ms("orion.chain.crc"),
                         recorded.COFDM)
