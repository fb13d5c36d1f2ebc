"""PSK31 carrier-detection sync (counterpart of
``orion_sdr_tpu/sync/psk31_sync.py``; behavioral spec: sync/psk31_sync.rs).

No Costas pattern: detection is per-bin energy persistence with a
near-local-peak criterion over the symbol-rate waterfall. The waterfall is
one complex64 product on the device (``sync/waterfall.py``); the run
extraction over the small (num_syms × num_bins) log-energy grid is host
numpy, copied from the JAX package (``np.median``, ``np.percentile``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..demodulate.psk31 import bpsk31_demod
from ..dsp.device import to_device
from ..modulate.psk31 import PSK31_BAUD, psk31_sps
from .waterfall import compute_waterfall


@dataclass
class Psk31SyncResult:
    """One detected carrier (ref Psk31SyncResult, sync/psk31_sync.rs:21-34)."""
    time_sym: int
    freq_bin: int
    carrier_hz: float
    score: float
    soft_bits: np.ndarray


def psk31_carrier_search(iq, fs: float, base_hz: float, max_hz: float,
                         min_carrier_syms: int = 8,
                         peak_margin_db: float = 6.0,
                         bin_hz: float = PSK31_BAUD,
                         with_floor: bool = False, device="cuda"):
    """Detection only: (time_sym, freq_bin, carrier_hz, score, end_sym) for
    every persistent spectral-peak run, unsorted (with the noise floor when
    ``with_floor``). ``bin_hz`` sets the waterfall's bin spacing (half-baud
    bins bound an off-grid carrier's split at −0.9 dB; psk31_decode_band
    uses them)."""
    z = to_device(iq, device, torch.complex64)
    sps = psk31_sps(fs)
    n = z.shape[-1]
    if sps == 0 or n == 0:
        return ([], 0.0) if with_floor else []
    num_syms = n // sps
    if num_syms == 0:
        return ([], 0.0) if with_floor else []
    num_bins = int(np.ceil(max(max_hz - base_hz, 0.0) / bin_hz)) + 1
    wf = compute_waterfall(z, fs, base_hz, bin_hz, sps, num_syms,
                           num_bins).cpu().numpy()          # (syms, bins)

    ln_margin = peak_margin_db * np.log(10.0) / 10.0
    min_run = max(min_carrier_syms, 1)
    # per-bin temporal median for bursts in silence; the 25th percentile of
    # the bin medians as the cross-bin floor for full-duration carriers
    bin_medians = np.median(wf, axis=0)
    noise_floor = np.percentile(bin_medians, 25.0)
    global_threshold = noise_floor + ln_margin
    # above the per-bin or global threshold, and within 1 dB of both
    # frequency neighbours (a carrier halfway between bins keeps both)
    near_ln = 1.0 * np.log(10.0) / 10.0
    left = np.pad(wf, ((0, 0), (1, 0)), constant_values=-np.inf)[:, :-1]
    right = np.pad(wf, ((0, 0), (0, 1)), constant_values=-np.inf)[:, 1:]
    is_peak = ((wf > bin_medians + ln_margin)
               | (bin_medians > global_threshold)) \
        & (wf >= left - near_ln) & (wf >= right - near_ln)

    found: List[tuple] = []
    for bin_ in range(num_bins):
        col = is_peak[:, bin_]
        edges = np.flatnonzero(np.diff(np.concatenate(
            [[0], col.view(np.int8), [0]])))
        for start, end in zip(edges[0::2], edges[1::2]):
            if end - start < min_run or start * sps >= n:
                continue
            score = float(wf[start:end, bin_].mean())
            found.append((int(start), bin_, float(base_hz + bin_ * bin_hz),
                          score, int(end)))
    return (found, float(noise_floor)) if with_floor else found


def psk31_sync(iq, fs: float, base_hz: float, max_hz: float,
               min_carrier_syms: int = 8, peak_margin_db: float = 6.0,
               n_bits: int = 64, max_cand: int = 4,
               device="cuda") -> List[Psk31SyncResult]:
    """Scan for PSK31 carriers; up to ``max_cand`` results by score,
    highest first, each with its first ``n_bits`` soft bits."""
    z = to_device(iq, device, torch.complex64)
    sps = psk31_sps(fs)
    found = psk31_carrier_search(z, fs, base_hz, max_hz, min_carrier_syms,
                                 peak_margin_db, device=z.device)
    candidates: List[Psk31SyncResult] = []
    for start, bin_, carrier_hz, score, _end in found:
        soft = bpsk31_demod(z[start * sps:], fs, carrier_hz, 1.0,
                            device=z.device).cpu().numpy()
        candidates.append(Psk31SyncResult(
            time_sym=start, freq_bin=bin_, carrier_hz=carrier_hz,
            score=score, soft_bits=soft[:n_bits]))
    candidates.sort(key=lambda r: -r.score)
    return candidates[:max_cand]


def best_sync(results: List[Psk31SyncResult], carrier_hz: float, baud: float):
    """The result nearest ``carrier_hz`` (≤ 2·baud away), the earliest
    time_sym first (ref util.rs:278-295). Returns (carrier_hz, time_sym)
    or None."""
    near = [r for r in results if abs(r.carrier_hz - carrier_hz) <= 2.0 * baud]
    if not near:
        return None
    best = min(near, key=lambda r: (r.time_sym, abs(r.carrier_hz - carrier_hz)))
    return (best.carrier_hz, best.time_sym)
