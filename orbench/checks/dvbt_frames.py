"""DVB-T frames: the program against the plain receiver on the same IQ.

Compared: each batch's frames of the whole window (payload and TPS fields,
or the error), each frame's TPS fields, and on the last pass over each
pool batch every Viterbi lane and every RS output row, matched by
content, whatever calls made them. A Viterbi lane (its chunk LLRs as
handed to the kernel) is matched to the reference lane whose LLRs point
most nearly the same way (``llr_gap``: the widest gap over the RMS) and
must hand the kernel the reference lane's start metrics exactly; the
decoded rows the program returned are held to the reference's Viterbi
run on the program's own lanes (``viterbi_mismatch``: lanes whose kept
decisions differ, reference lanes left unmatched, and matched lanes whose
start metrics differ); a frame's RS output row (message bytes and flag) to
an equal row of the reference's."""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from ..reference import dvbt
from . import bf16, gap
from .cofdm_frames import match_rows


@dataclass
class Layers:
    """A receiver's layer outputs: each frame's TPS fields (or None); each
    chunked Viterbi call as (c0, c1, pm0, chunks a row, decoded rows (B,
    info bits)); every frame's RS output row (message bytes, flag)."""
    tps: list
    lanes: list
    outer: list


def layers(rec: dvbt.RxRecord) -> Layers:
    return Layers(rec.tps, [(rec.c0, rec.c1, rec.pm0, rec.nchunk, rec.rows)],
                  rec.outer)


def reference(cfg, params, batch, device, control=False):
    link = dvbt.Link.of(cfg)
    return dvbt.receive(link, batch.iq, link.payload_bytes,
                        bf16 if control else None)


def _viterbi(link: dvbt.Link, calls: list) -> int:
    """Lanes whose decoded bits differ from the reference's decode of the
    same lanes."""
    bad = 0
    for c0, c1, pm0, nchunk, rows in calls:
        B, info = rows.shape
        ref = dvbt.decoded_rows(dvbt.viterbi_chunks(c0, c1, pm0, link), B,
                                info, link)
        diff = (ref != rows.to(ref.device)).to(torch.uint8)
        diff = torch.nn.functional.pad(diff, (0, nchunk * link.chunk_steps
                                              - info))
        bad += int(diff.reshape(B * nchunk, -1).any(1).sum())
    return bad


def _lanes(o: Layers, r: Layers):
    """The LLR gap of the program's lanes, and the reference's lanes that
    no program lane matches or whose start metrics the matched program
    lane does not hold exactly."""
    def rows(calls, *k):
        return torch.cat([torch.cat([c[i] for i in k], 1) for c in calls]) \
            if calls else None
    p, q = rows(o.lanes, 0, 1), rows(r.lanes, 0, 1)
    m = match_rows(p, q)
    found = m >= 0
    if not bool(found.all()):
        return float("inf"), int((~found).sum())
    pm, ref = rows(o.lanes, 2).to(q.device)[m], rows(r.lanes, 2)
    start = int((pm != ref).any(1).sum()) if pm.shape == ref.shape \
        else len(q)
    return gap(p.to(q.device)[m], q), start


def _outer(o: list, r: list) -> int:
    """The reference's RS rows that the program's rows do not hold."""
    def key(m, ok):
        return bool(ok), np.asarray(m, np.uint8).tobytes()
    have = Counter(key(m, ok) for m, ok in o)
    bad = 0
    for m, ok in r:
        k = key(m, ok)
        if have[k]:
            have[k] -= 1
        else:
            bad += 1
    return bad


def compare(cfg, params, observed, refs, finals) -> dict:
    link = dvbt.Link.of(cfg)
    frames = sum(sum(a != b for a, b in zip(f, refs[s].frames))
                 + abs(len(f) - len(refs[s].frames)) for s, f in finals)
    tps = vit = rs = 0
    llr = 0.0
    for s, o in observed.items():
        if isinstance(o, dvbt.RxRecord):
            o = layers(o)
        r = layers(refs[s])
        tps += sum(a != b for a, b in zip(o.tps, r.tps)) \
            + abs(len(o.tps) - len(r.tps))
        g, lanes = _lanes(o, r)
        llr = max(llr, g)
        vit += lanes + _viterbi(link, o.lanes)
        rs += _outer(o.outer, r.outer)
    return {"frames_mismatch": frames, "tps_mismatch": tps,
            "viterbi_mismatch": vit, "rs_mismatch": rs, "llr_gap": llr}


def counters(ref) -> dict:
    """The reference's own work on a pool batch: RS words, words with a
    nonzero syndrome, words corrected, words failed, bytes corrected, and
    the Viterbi output's bit errors that RS corrected; TPS words that
    failed."""
    r = ref.rs
    return {"rs_words": int(r.ok.size), "rs_in_error": int(r.in_error.sum()),
            "rs_corrected": int((r.in_error & r.ok).sum()),
            "rs_failed": int((~r.ok).sum()),
            "rs_bytes_corrected": int(r.errors.sum()),
            "viterbi_bit_errors": int(r.bit_errors.sum()),
            "tps_failed": sum(t is None for t in ref.tps)}


def failed(truth, final) -> int:
    """Frames whose payload is not the one sent."""
    return sum(a[-1] != b[-1] for a, b in zip(final, truth)) \
        + abs(len(final) - len(truth))


def finals_of(ref) -> list:
    """A reference record's results in the form of ``Entry.final``."""
    return list(ref.frames)
