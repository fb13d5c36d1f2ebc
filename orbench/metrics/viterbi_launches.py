"""Launches of the chunked Viterbi kernel a batch: the difference of the
program's ``viterbi_chunks_kernel.launches`` across each DVB-T receive
call, from the profiled window."""

from .. import recorded


def read(run):
    return recorded.mean(run, lambda r: r.launches.get(
        "viterbi_chunks_kernel.launches", 0), "orion.dvbt.decode_batch")
