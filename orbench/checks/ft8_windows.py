"""FT8 windows: the program against the plain receiver on the same IQ.

Compared: each batch's windows of the whole window (decoded or not, the
message text, the carrier), each window's winning candidate and its 77
bits, the winner's LLRs (widest gap over the RMS of the row) and its
score (widest relative gap, over every batch)."""

from __future__ import annotations

from ..reference import ft8
from . import gap


def reference(cfg, params, batch, device, control=False):
    r = cfg["receiver"]
    return ft8.receive(batch.iq, r["base_hz"], r["max_hz"], r["max_cand"],
                       tf32=control)


def _final(res):
    return None if res is None else (res[2], res[3], res[4])


def compare(cfg, params, observed, refs, finals) -> dict:
    windows, score = 0, 0.0
    for s, f in finals:
        for a, b in zip(f, refs[s].results):
            b = _final(b)
            if (a is None) != (b is None) or (a is not None
                                              and a[:2] != b[:2]):
                windows += 1
            elif a is not None:
                score = max(score, abs(a[2] - b[2]) / max(abs(b[2]), 1e-30))
    winner = bits = 0
    llr = 0.0
    for s, o in observed.items():
        r = refs[s]
        k_o, k_r = o.scores.shape[1], r.scores.shape[1]
        for w, (a, b) in enumerate(zip(o.results, r.results)):
            if (a is None) != (b is None) or (a is not None and a[0] != b[0]):
                winner += 1
                continue
            if a is None:
                continue
            bits += a[1] != b[1]
            if w >= len(o.bins):
                llr = float("inf")
                continue
            co = (o.bins[w] == a[0]).nonzero()
            cr = (r.bins[w] == b[0]).nonzero()
            if not len(co) or not len(cr):
                llr = float("inf")
                continue
            llr = max(llr, gap(o.llr[w * k_o + int(co[0])],
                               r.llr[w * k_r + int(cr[0])]))
    return {"windows_mismatch": windows, "winner_mismatch": winner,
            "bits_mismatch": bits, "llr_gap": llr, "score_gap": score}


def failed(truth, final) -> int:
    return sum((a is None) != (t is None) or (a is not None
                                              and a[:2] != t)
               for a, t in zip(final, truth))


def finals_of(ref) -> list:
    """A reference record's results in the form of ``Entry.final``."""
    return [_final(r) for r in ref.results]
