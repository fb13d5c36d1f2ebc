"""COFDM frames: the program against the plain receiver on the same IQ.

Compared: each batch's frames of the whole window (payload, metadata or
the error), each frame's decoded header fields, and every BP row and BCH
output of the last pass over each pool batch, matched to the reference's
by content, whatever calls made them: a BP row to the reference row whose
LLRs point most nearly the same way (the LLRs as handed to BP, widest gap
over the RMS; the decisions of every row the reference decodes to a
codeword), a frame's BCH output row (message bits and flag) to an equal
row of the reference's."""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from ..reference import cofdm
from . import bf16, gap


def reference(cfg, params, batch, device, control=False):
    return cofdm.receive(cofdm.Link.of(cfg), batch.iq,
                         bf16 if control else None)


def match_rows(p: torch.Tensor, r: torch.Tensor, chunk: int = 1024):
    """For each row of ``r``, the row of ``p`` whose direction is nearest
    (largest cosine); -1 where ``p`` has no such row or two rows of ``r``
    take the same one."""
    none = torch.full((r.shape[0],), -1, dtype=torch.int64, device=r.device)
    if p is None or p.ndim != 2 or p.shape[1] != r.shape[1] or not len(p):
        return none
    p = p.to(r.device, torch.float32)
    pn = p / p.norm(dim=1, keepdim=True).clamp_min(1e-30)
    rn = r.to(torch.float32)
    rn = rn / rn.norm(dim=1, keepdim=True).clamp_min(1e-30)
    idx = torch.cat([(rn[i:i + chunk] @ pn.T).argmax(1)
                     for i in range(0, r.shape[0], chunk)])
    once = torch.bincount(idx, minlength=p.shape[0])[idx] == 1
    return torch.where(once, idx, none)


def _rows(o: cofdm.Layers, r: cofdm.Layers):
    """The LLR gap and the LDPC mismatches of the program's BP rows."""
    m = match_rows(o.llr, r.llr)
    found = m >= 0
    if not bool(found.all()):
        llr = float("inf")
    else:
        llr = gap(o.llr.to(r.llr.device)[m], r.llr)
    mi = m.clamp_min(0)
    conv = r.unsat == 0
    if o.bits is None or not len(o.bits) \
            or o.bits.shape[1:] != r.bits.shape[1:]:
        return llr, int(conv.sum())
    bits = o.bits.to(r.bits.device)[mi]
    unsat = o.unsat.to(r.unsat.device)[mi]
    bad = conv & (~found | (bits != r.bits).any(1) | (unsat != 0))
    return llr, int(bad.sum())


def _outer(o: list, r: list) -> int:
    """The reference's BCH rows that the program's rows do not hold."""
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
    frames = sum(sum(a != b for a, b in zip(f, refs[s].frames))
                 for s, f in finals)
    header = ldpc = bch = 0
    llr = 0.0
    for s, o in observed.items():
        if isinstance(o, cofdm.RxRecord):
            o = cofdm.layers(o)
        r = cofdm.layers(refs[s])
        header += sum(a != b for a, b in zip(o.headers, r.headers)) \
            + abs(len(o.headers) - len(r.headers))
        g, bad = _rows(o, r)
        llr, ldpc = max(llr, g), ldpc + bad
        bch += _outer(o.outer, r.outer)
    return {"frames_mismatch": frames, "header_mismatch": header,
            "llr_gap": llr, "ldpc_mismatch": ldpc, "bch_mismatch": bch}


def counters(ref) -> dict:
    """The reference's own work on a batch's payload: BP row-iterations a
    row, rows left unconverged, BCH words, words in error, words
    corrected."""
    rows = sum(int(b.shape[0]) for b in ref.bp_bits[1:])
    return {"bp_iters_per_row": sum(ref.row_iters[1:]) / max(rows, 1),
            "bp_rows": rows,
            "bp_unconverged": int(sum(int((u != 0).sum())
                                      for u in ref.bp_unsat[1:])),
            "bch_words": sum(g.bch_words for g in ref.groups),
            "bch_in_error": sum(g.bch_in_error for g in ref.groups),
            "bch_fixed": sum(g.bch_fixed for g in ref.groups)}


def failed(truth, final) -> int:
    return sum(a != b for a, b in zip(final, truth))


def finals_of(ref) -> list:
    """A reference record's results in the form of ``Entry.final``."""
    return list(ref.frames)
