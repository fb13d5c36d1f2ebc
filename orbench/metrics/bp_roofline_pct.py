"""The BP kernel's share of its roofline: the least time, on the H100's
published peaks, of the work that the benchmark's own plain BP does on the
LLRs the program handed the kernel in the profiled batches (each LLR read
once, bits and flags written once, the edge tables read once; 33 float32
operations an edge a row-iteration, sum-product), over the kernel's device
time there."""

import numpy as np

from ..peaks import least_ms
from ..reference import ldpc
from .bp_device_ms import bp_seconds

OPS_PER_EDGE = 33


def call_ms(name: str, llr, max_iter: int) -> float:
    c = ldpc.code(name)
    r = ldpc.bp_decode(c, llr.contiguous(), max_iter)
    B = llr.shape[0]
    col = int(np.bincount(c.check_bits[c.check_mask], minlength=c.n).max())
    n_bytes = B * c.n * 4 + B * c.k + B * 4 + 2 * c.check_bits.size \
        + 2 * col * c.n
    return least_ms(n_bytes, r.row_iters * c.edges * OPS_PER_EDGE)


def read(run):
    p = run.profile
    if p is None or not run.slots_profiled:
        return None
    dev_ms = bp_seconds(p) * 1e3
    if dev_ms <= 0:
        return None
    per_slot = {}
    for s in set(run.slots_profiled):
        calls = run.entry.bp_calls(run.records.slots[s])
        per_slot[s] = sum(call_ms(*c) for c in calls)
    least = sum(per_slot[s] for s in run.slots_profiled)
    return 100.0 * least / dev_ms
