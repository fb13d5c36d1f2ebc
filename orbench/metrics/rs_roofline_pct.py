"""The RS(204, 188) decoder kernel's share of its roofline: the least time,
on the H100's published bandwidth, of reading each codeword byte once and
writing each message byte and each word's flag once, for the words the
program handed the outer decoder in the profiled batches, over the
kernel's device time there."""

from ..peaks import least_ms
from ..reference import dvbt


def rs_seconds(profile):
    return sum(v for k, v in profile.by_kernel.items()
               if "rs_decode" in k)


def slot_ms(link: dvbt.Link, records) -> float:
    ms = 0.0
    for msg, ok in records.get("outer", []):
        words = msg.shape[0] * (msg.shape[1] // 8 // link.rs_k)
        ms += least_ms(words * (link.rs_n + link.rs_k + 4), 0)
    return ms


def read(run):
    p = run.profile
    if p is None or not run.slots_profiled:
        return None
    dev_ms = rs_seconds(p) * 1e3
    if dev_ms <= 0:
        return None
    link = dvbt.Link.of(run.cell["config_file"])
    per_slot = {s: slot_ms(link, run.records.slots[s])
                for s in set(run.slots_profiled)}
    least = sum(per_slot[s] for s in run.slots_profiled)
    return 100.0 * least / dev_ms if least > 0 else None
