"""Costas-array sync scoring for FT8/FT4 (counterpart of
``orion_sdr_tpu/sync/costas.py``; behavioral spec: sync/costas.rs).

The reference scores each (time, freq) candidate with a nested loop over
Costas cells. Here the per-cell difference metric
    C[s, b] = max(0, wf[s,b] − max(neighbors in freq and time))
is computed once for the whole waterfall (4 shifted maxes), and the score
grid over all candidate (t, f) pairs is a sum of shifted views of C — a
sparse correlation with the Costas kernel — on the waterfall's device.

Top-N: :func:`top_k_stable`, the rule of ``jax.lax.top_k``: the k largest
scores in descending order, and among equal scores the lower flat index
first. Ties are real: in a silent window every cell of C is 0, so every
score is. ``torch.topk`` promises no order for ties on CUDA, so the pick is
a stable descending sort.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..dsp.device import takes_host_data


@dataclass
class Candidate:
    """(ref sync/costas.rs Candidate)"""
    time_sym: int
    freq_bin: int
    score: float


def costas_kernel(costas, sync_pos: Sequence[int]) -> List[Tuple[int, int]]:
    """(symbol offset, tone offset) pairs of every Costas cell in a frame.

    ``costas``: one tone sequence shared by all blocks (FT8) or a (blocks,
    len) array with one sequence per block (FT4).
    """
    costas = np.asarray(costas, np.int64)
    if costas.ndim == 1:
        costas = np.broadcast_to(costas, (len(sync_pos), costas.shape[0]))
    out = []
    for blk, start in enumerate(sync_pos):
        for ci, tone in enumerate(costas[blk]):
            out.append((start + ci, int(tone)))
    return out


def costas_score(wf, costas, sync_pos: Sequence[int], time_sym: int,
                 freq_bin: int) -> float:
    """Score one candidate location (ref costas_score) — convenience/testing
    path on the host; the batch search uses the vectorized grid below."""
    w = wf.cpu().numpy() if isinstance(wf, torch.Tensor) else np.asarray(wf)
    S, B = w.shape
    total = 0.0
    for ds, tone in costas_kernel(costas, list(sync_pos)):
        sym = time_sym + ds
        bin_ = freq_bin + tone
        if not (0 <= sym < S and 0 <= bin_ < B):
            continue
        e_sig = w[sym, bin_]
        nb = [w[sym, bin_ - 1] if bin_ > 0 else -np.inf,
              w[sym, bin_ + 1] if bin_ + 1 < B else -np.inf,
              w[sym - 1, bin_] if sym > 0 else -np.inf,
              w[sym + 1, bin_] if sym + 1 < S else -np.inf]
        total += max(e_sig - max(nb), 0.0)
    return float(total)


def _shift_sum(cell, kernel, t_count, f_count, pad_top: int = 0):
    """score[..., t, f] = Σ_kernel cell[..., t + ds, f + db]; out-of-grid
    cells are 0 (kernel offsets are pre-shifted so ds + pad_top ≥ 0).
    Offsets are static, so the shifted views are plain slices, summed in
    kernel order."""
    max_ds = max(ds for ds, _ in kernel) + pad_top
    max_db = max(db for db, _ in kernel)
    S, B = cell.shape[-2:]
    pad_s = max(t_count + max_ds - (S + pad_top), 0)
    pad_b = max(f_count + max_db - B, 0)
    cp = torch.nn.functional.pad(cell, (0, pad_b, pad_top, pad_s))
    score = cell.new_zeros(cell.shape[:-2] + (t_count, f_count))
    for ds, db in kernel:
        s0 = ds + pad_top
        score = score + cp[..., s0:s0 + t_count, db:db + f_count]
    return score


@takes_host_data("wf")
def candidate_score_grid(wf: torch.Tensor, costas, sync_pos: Sequence[int],
                         num_tones: int, t_min: int, t_max: int):
    """Costas score grid over every (t, f) start: (..., S, B) waterfall →
    (..., t_count, f_count) on its device. Leading axes batch (the
    many-window receive path scores all windows at once)."""
    S, B = wf.shape[-2:]
    f_count = B - num_tones + 1
    t_count = t_max - t_min + 1
    kernel = costas_kernel(costas, [p + t_min for p in sync_pos])

    lead = wf.shape[:-2]
    neg_row = wf.new_full(lead + (1, B), -torch.inf)
    neg_col = wf.new_full(lead + (S, 1), -torch.inf)
    up = torch.cat([neg_row, wf[..., :-1, :]], dim=-2)
    down = torch.cat([wf[..., 1:, :], neg_row], dim=-2)
    left = torch.cat([neg_col, wf[..., :, :-1]], dim=-1)
    right = torch.cat([wf[..., :, 1:], neg_col], dim=-1)
    neigh = torch.maximum(torch.maximum(up, down), torch.maximum(left, right))
    cell = torch.clamp(wf - neigh, min=0.0)

    pad_top = max(0, -min(ds for ds, _ in kernel))
    return _shift_sum(cell, kernel, t_count, f_count, pad_top)


def top_k_stable(flat: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, in
    descending order, the lower index first among equal values (the order
    of ``jax.lax.top_k``)."""
    vals, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@takes_host_data("wf")
def find_candidates(wf: torch.Tensor, costas, sync_pos: Sequence[int],
                    num_tones: int, t_min: int, t_max: int,
                    max_candidates: int) -> List[Candidate]:
    """Top-N Costas-scored frame starts (ref find_candidates) of one (S, B)
    waterfall, ranked by :func:`top_k_stable`.

    ``t_min``/``t_max`` are inclusive symbol offsets into the waterfall.
    """
    S, B = wf.shape
    if B <= num_tones:
        return []
    f_count = B - num_tones + 1
    t_count = t_max - t_min + 1
    if t_count <= 0:
        return []
    score = candidate_score_grid(wf, costas, sync_pos, num_tones,
                                 t_min, t_max)
    k = min(max_candidates, t_count * f_count)
    vals, idx = top_k_stable(score.reshape(-1), k)
    vals = vals.cpu().numpy()
    idx = idx.cpu().numpy()
    return [Candidate(time_sym=int(i // f_count) + t_min,
                      freq_bin=int(i % f_count), score=float(v))
            for v, i in zip(vals, idx)]
