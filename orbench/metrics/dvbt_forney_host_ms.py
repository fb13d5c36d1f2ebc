"""Host time a batch of the DVB-T chain's deinterleaving, the Viterbi
output's read to the host and the per-row Forney deinterleaver included:
the program's spans ``orion.chain.deinterleave`` summed over a DVB-T
``decode_batch``, from the profiled window."""

from .. import recorded


def read(run):
    return recorded.mean(run, lambda r: r.ms("orion.chain.deinterleave"),
                         "orion.dvbt.decode_batch")
