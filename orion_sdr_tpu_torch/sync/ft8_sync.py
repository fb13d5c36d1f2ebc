"""FT8/FT4 sync + soft LLR extraction (counterpart of
``orion_sdr_tpu/sync/ft8_sync.py``; behavioral spec: sync/ft8_sync.rs,
sync/ft4_sync.rs).

Waterfall (one product) → Costas candidate search (shifted-sum grid +
stable top-k) → per-candidate max-log LLRs from Gray-reordered per-tone
log-energies, normalised by √(24/var). All of it runs on the device of the
IQ, and the waterfall stays there: one gather over every (window,
candidate) pair builds the (R, 174) LLR matrix and each row is normalised
there. (The JAX batch path copies the waterfall to the host and loops over
windows and candidates; the function is the same.) Invalid symbols give
LLR 0; out-of-band tones score −1e30.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .waterfall import compute_waterfall
from .costas import candidate_score_grid, find_candidates, top_k_stable
from ..modulate.ft8 import (
    FT8_COSTAS, FT8_SYNC_POS, FT8_TONE_SPACING_HZ, FT8_SAMPLES_PER_SYM,
    FT8_TOTAL_SYMS, FT8_TONES, ft8_data_positions,
    FT4_COSTAS, FT4_SYNC_POS, FT4_TONE_SPACING_HZ, FT4_SAMPLES_PER_SYM,
    FT4_TOTAL_SYMS, FT4_TONES, ft4_data_positions,
)
from ..codec.gray import FT8_GRAY, FT4_GRAY

_N = 174


@dataclass
class FtSyncResult:
    """(ref Ft8SyncResult / Ft4SyncResult)"""
    time_sym: int
    freq_bin: int
    score: float
    llr: torch.Tensor    # (174,) float32 on the sync's device, + ⇒ bit 0


def _normalise_llr(llr: torch.Tensor) -> torch.Tensor:
    """Each row (last axis) times √(24/var), var = mean(llr²), where var >
    1e-10 — prevents LDPC saturation (ref normalise_llr). Scaled in float64
    and rounded to float32, as numpy's float32 array × float64 scalar."""
    x = llr.to(torch.float64)
    var = (x * x).mean(-1, keepdim=True)
    scale = torch.where(var > 1e-10, torch.sqrt(24.0 / var), 1.0)
    return (x * scale).to(torch.float32)


_LLR_TABLES: dict = {}


def _llr_tables(data_pos, gray, bits_per_sym: int, device):
    """A mode's LLR tables on ``device``, made once: the data symbol
    positions, the Gray tones, and for each bit b the binary values with b
    set (``hi``) and clear (``lo``), (bits_per_sym, n_tones / 2) each."""
    key = (tuple(int(p) for p in data_pos), tuple(int(g) for g in gray),
           bits_per_sym, torch.device(device))
    t = _LLR_TABLES.get(key)
    if t is None:
        vals = np.arange(len(gray))
        bit = (vals[None, :] >> (bits_per_sym - 1
                                 - np.arange(bits_per_sym))[:, None]) & 1
        t = _LLR_TABLES[key] = tuple(
            torch.as_tensor(np.asarray(a, np.int64), device=device)
            for a in (data_pos, gray, [vals[b == 1] for b in bit],
                      [vals[b == 0] for b in bit]))
    return t


def _extract_llrs(wf: torch.Tensor, win: torch.Tensor, time_sym: torch.Tensor,
                  freq_bin: torch.Tensor, data_pos: np.ndarray,
                  gray: np.ndarray, bits_per_sym: int) -> torch.Tensor:
    """Normalised max-log LLRs, (R, n_data·bits_per_sym) float32, of the
    candidates (``time_sym[r]``, ``freq_bin[r]``) of waterfall ``win[r]``
    of ``wf`` ((W, S, B), or (S, B) with ``win`` all 0), in one gather.

    s2[j] = log-energy of tone gray[j] (energy indexed by binary value);
    bit b's LLR = max over values with bit b set − max with bit b clear,
    negated into the positive ⇒ bit 0 convention.
    """
    S, B = wf.shape[-2:]
    dp, g, hi_vals, lo_vals = _llr_tables(data_pos, gray, bits_per_sym,
                                          wf.device)
    syms = time_sym[:, None] + dp                            # (R, n_data)
    bins = freq_bin[:, None] + g                             # (R, n_tones)
    valid = (syms >= 0) & (syms < S)
    ok = valid[:, :, None] & (bins < B)[:, None, :]
    e = wf.reshape(-1, S, B)[win[:, None, None],
                             syms.clamp(0, S - 1)[:, :, None],
                             bins.clamp(0, B - 1)[:, None, :]]
    s2 = torch.where(ok, e, -1.0e30)             # (R, n_data, n_tones)
    hi = s2[..., hi_vals].amax(-1)               # (R, n_data, bits)
    lo = s2[..., lo_vals].amax(-1)
    # missing symbols → zero LLR (maximum uncertainty)
    llr = torch.where(valid[..., None], -(hi - lo), 0.0)
    return _normalise_llr(llr.reshape(len(win), -1))


_MODE = {
    "ft8": dict(spacing=FT8_TONE_SPACING_HZ, sps=FT8_SAMPLES_PER_SYM,
                total_syms=FT8_TOTAL_SYMS, n_tones=FT8_TONES,
                bits_per_sym=3),
    "ft4": dict(spacing=FT4_TONE_SPACING_HZ, sps=FT4_SAMPLES_PER_SYM,
                total_syms=FT4_TOTAL_SYMS, n_tones=FT4_TONES,
                bits_per_sym=2),
}


def _mode_tables(mode: str):
    if mode == "ft8":
        return (FT8_COSTAS, [s for s, _ in FT8_SYNC_POS],
                ft8_data_positions(), np.asarray(FT8_GRAY))
    return (FT4_COSTAS, [s for s, _ in FT4_SYNC_POS],
            ft4_data_positions(), np.asarray(FT4_GRAY))


def _num_bins(base_hz, max_hz, m) -> int:
    freq_range = max(max_hz - base_hz, 0.0)
    return int(np.ceil(freq_range / m["spacing"])) + m["n_tones"] + 1


def _results(vals, idx, f_count, llr, t_min=0, sym_offset_adj=0):
    """(k,) scores and flat indices (host) and (k, 174) LLRs → results."""
    return [FtSyncResult(time_sym=int(i // f_count) + t_min - sym_offset_adj,
                         freq_bin=int(i % f_count), score=float(v), llr=l)
            for v, i, l in zip(vals, idx, llr)]


def _sync(iq: torch.Tensor, fs, base_hz, max_hz, t_min, t_max, max_cand,
          mode: str) -> List[FtSyncResult]:
    m = _MODE[mode]
    costas, sync_pos, data_pos, gray = _mode_tables(mode)
    num_bins = _num_bins(base_hz, max_hz, m)
    wf_syms = max(t_max + m["total_syms"] - t_min, 1)
    wf_sample_start = t_min * m["sps"] if t_min >= 0 else 0
    sym_offset_adj = -t_min if t_min < 0 else 0

    wf = compute_waterfall(iq, fs, base_hz, m["spacing"], m["sps"], wf_syms,
                           num_bins, wf_sample_start)
    wf_t_max = max(wf_syms - m["total_syms"], 0)
    cands = find_candidates(wf, costas, sync_pos, m["n_tones"], 0, wf_t_max,
                            max_cand)
    if not cands:
        return []
    dev = wf.device
    ts = torch.as_tensor([c.time_sym for c in cands], device=dev)
    fb = torch.as_tensor([c.freq_bin for c in cands], device=dev)
    llr = _extract_llrs(wf, torch.zeros_like(ts), ts, fb, data_pos, gray,
                        m["bits_per_sym"])
    return [FtSyncResult(time_sym=c.time_sym - sym_offset_adj,
                         freq_bin=c.freq_bin, score=c.score, llr=l)
            for c, l in zip(cands, llr)]


def _sync_grid_device(iq: torch.Tensor, fs: float, base_hz: float, mode: str,
                      num_bins: int, wf_syms: int, wf_sample_start: int,
                      wf_t_max: int, k: int):
    """Waterfall + Costas score grid + top-k of (possibly batched) windows
    on their device: (wf, values (..., k), flat indices (..., k))."""
    m = _MODE[mode]
    costas, sync_pos, _, _ = _mode_tables(mode)
    wf = compute_waterfall(iq, fs, base_hz, m["spacing"], m["sps"],
                           wf_syms, num_bins, wf_sample_start)
    score = candidate_score_grid(wf, costas, sync_pos, m["n_tones"],
                                 0, wf_t_max)
    vals, idx = top_k_stable(score.reshape(score.shape[:-2] + (-1,)), k)
    return wf, vals, idx


def _sync_batch_llrs(iq_batch: torch.Tensor, fs, base_hz, max_hz, max_cand,
                     mode: str):
    """The batched sync of (W, n) windows (t_min = t_max = 0) on their
    device: (f_count, scores (W, k), flat indices (W, k), LLRs (W·k, 174)
    window-major), or None when the band holds no candidate."""
    m = _MODE[mode]
    _, _, data_pos, gray = _mode_tables(mode)
    num_bins = _num_bins(base_hz, max_hz, m)
    f_count = num_bins - m["n_tones"] + 1
    if f_count <= 0:
        return None
    k = min(max(int(max_cand), 1), f_count)
    wf, vals, idx = _sync_grid_device(iq_batch, float(fs), float(base_hz),
                                      mode, num_bins, m["total_syms"], 0, 0,
                                      k)
    W = iq_batch.shape[0]
    win = torch.arange(W, device=wf.device).repeat_interleave(k)
    flat = idx.reshape(-1)
    llr = _extract_llrs(wf, win, flat // f_count, flat % f_count, data_pos,
                        gray, m["bits_per_sym"])
    return f_count, vals, idx, llr


def _sync_batch(iq_batch, fs, base_hz, max_hz, max_cand, mode: str, device
                ) -> List[List[FtSyncResult]]:
    """Batched _sync over (B, n) windows (t_min = t_max = 0) on
    ``device``."""
    x = torch.as_tensor(iq_batch, device=device)
    if x.dim() != 2:
        raise ValueError(f"windows must be (B, n), got {tuple(x.shape)}")
    if x.shape[0] == 0:
        return []
    got = _sync_batch_llrs(x, fs, base_hz, max_hz, max_cand, mode)
    if got is None:
        return [[] for _ in range(x.shape[0])]
    f_count, vals, idx, llr = got
    k = vals.shape[1]
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    return [_results(vals[b], idx[b], f_count, llr[b * k:(b + 1) * k])
            for b in range(x.shape[0])]


def ft8_sync_batch(windows, fs: float, base_hz: float, max_hz: float,
                   max_cand: int = 4, *, device="cuda"
                   ) -> List[List[FtSyncResult]]:
    """ft8_sync over (B, n) receive windows in one pass on ``device``."""
    return _sync_batch(windows, fs, base_hz, max_hz, max_cand, "ft8", device)


def ft4_sync_batch(windows, fs: float, base_hz: float, max_hz: float,
                   max_cand: int = 4, *, device="cuda"
                   ) -> List[List[FtSyncResult]]:
    """ft4_sync over (B, n) receive windows in one pass on ``device``."""
    return _sync_batch(windows, fs, base_hz, max_hz, max_cand, "ft4", device)


def ft8_sync(iq, fs: float, base_hz: float, max_hz: float,
             t_min: int = 0, t_max: int = 0, max_cand: int = 4, *,
             device="cuda") -> List[FtSyncResult]:
    """Search an IQ buffer for FT8 frames on ``device``; top candidates
    with 174 LLRs."""
    return _sync(torch.as_tensor(iq, device=device), fs, base_hz, max_hz,
                 t_min, t_max, max_cand, "ft8")


def ft4_sync(iq, fs: float, base_hz: float, max_hz: float,
             t_min: int = 0, t_max: int = 0, max_cand: int = 4, *,
             device="cuda") -> List[FtSyncResult]:
    """Search an IQ buffer for FT4 frames on ``device``; top candidates
    with 174 LLRs."""
    return _sync(torch.as_tensor(iq, device=device), fs, base_hz, max_hz,
                 t_min, t_max, max_cand, "ft4")


def _multi_sync_grid_device(frames: torch.Tensor, fs: float, base_hz: float,
                            mode: str, num_bins: int, k: int):
    """Waterfalls for N repeated transmissions + the SUMMED Costas score
    grid's top-k. Summing the per-frame score grids before candidate
    selection buys ~√N of sync sensitivity — the multi-frame averaging
    front half (WSJT-X's a-priori averaging idea, beyond the single-frame
    reference)."""
    m = _MODE[mode]
    costas, sync_pos, _, _ = _mode_tables(mode)
    wf = compute_waterfall(frames, fs, base_hz, m["spacing"], m["sps"],
                           m["total_syms"], num_bins, 0)        # (N, S, B)
    score = candidate_score_grid(wf, costas, sync_pos, m["n_tones"], 0, 0)
    vals, idx = top_k_stable(score.sum(0).reshape(-1), k)
    return wf, vals, idx


def ft_sync_multi(frames, fs: float, base_hz: float, max_hz: float,
                  max_cand: int, mode: str, *, device="cuda"
                  ) -> List[FtSyncResult]:
    """Multi-frame sync on ``device``: N frame-aligned captures of the SAME
    repeated transmission → candidates from the summed score grid, each
    carrying the SUM of the per-frame LLRs (joint log-likelihood of N
    independent observations, ~10·log10(N) dB of combining gain before the
    LDPC), normalised again.
    """
    m = _MODE[mode]
    _, _, data_pos, gray = _mode_tables(mode)
    x = torch.as_tensor(frames, device=device)
    if x.dim() != 2:
        raise ValueError(f"frames must be (n_frames, frame_len), got "
                         f"{tuple(x.shape)}")
    num_bins = _num_bins(base_hz, max_hz, m)
    f_count = num_bins - m["n_tones"] + 1
    if f_count <= 0 or x.shape[0] == 0:
        return []
    k = min(max(int(max_cand), 1), f_count)
    wf, vals, idx = _multi_sync_grid_device(x, float(fs), float(base_hz),
                                            mode, num_bins, k)
    N = x.shape[0]
    win = torch.arange(N, device=wf.device).repeat_interleave(k)
    flat = idx.repeat(N)
    per = _extract_llrs(wf, win, flat // f_count, flat % f_count, data_pos,
                        gray, m["bits_per_sym"]).reshape(N, k, -1)
    llr_sum = per[0]
    for b in range(1, N):           # frame order, as the JAX package sums
        llr_sum = llr_sum + per[b]
    return _results(vals.cpu().numpy(), idx.cpu().numpy(), f_count,
                    _normalise_llr(llr_sum))
