"""The Viterbi kernel's share of its roofline: the least time, on the
H100's published peaks, of the work that the benchmark's own chunked
Viterbi does on the lanes the program handed the kernel in the profiled
batches (each chunk LLR and start metric read once, each decided bit
written once as a byte; the add-compare-select operations
``reference.dvbt.viterbi_ops`` counts), over the kernel's device time
there."""

from ..peaks import least_ms
from ..reference import dvbt
from .viterbi_device_ms import viterbi_seconds


def slot_ms(link: dvbt.Link, records) -> float:
    ms = 0.0
    for c0, c1, pm0, nchunk in records.get("chunks", []):
        L, span = c0.shape
        n_bytes = 2 * L * span * 4 + pm0.numel() * 4 + L * span
        ms += least_ms(n_bytes, dvbt.viterbi_ops(L, span, link))
    return ms


def read(run):
    p = run.profile
    if p is None or not run.slots_profiled:
        return None
    dev_ms = viterbi_seconds(p) * 1e3
    if dev_ms <= 0:
        return None
    link = dvbt.Link.of(run.cell["config_file"])
    per_slot = {s: slot_ms(link, run.records.slots[s])
                for s in set(run.slots_profiled)}
    least = sum(per_slot[s] for s in run.slots_profiled)
    return 100.0 * least / dev_ms if least > 0 else None
