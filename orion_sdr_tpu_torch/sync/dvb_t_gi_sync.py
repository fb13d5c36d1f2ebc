"""DVB-T guard-interval acquisition and integer CFO (counterpart of
``orion_sdr_tpu/sync/dvb_t_gi_sync.py``; van de Beek ML over the cyclic
prefix).

The lag-n_fft product and energy are formed once for the whole buffer on
its device, every offset's γ/Φ is a cumulative-sum sliding window, and the
multi-symbol accumulation is a few shifted adds; only the scalars of the
winner cross to the host, where the origin-unwrap rule decides between two
candidates. The integer-CFO search is host numpy over one accumulated
spectrum.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..dsp.device import takes_host_data
from ..waveform.dvb_t import continual_pilot_bins


@dataclass(frozen=True)
class GiSyncConfig:
    """ρ = SNR/(SNR+1) weight; coherent accumulation bound; unwrap guard."""
    rho: float = 0.95
    max_symbols: int = 4
    origin_score_ratio: float = 0.5


class GiSyncResult(NamedTuple):
    start_sample: int
    cfo_hz: float
    score: float      # |γ|/Φ ∈ [0,1] at the winner (selection used |γ|−ρΦ)


def _sliding(x: torch.Tensor, win: int) -> torch.Tensor:
    c = torch.cumsum(x, dim=-1)
    c = torch.cat([c.new_zeros(x.shape[:-1] + (1,)), c], dim=-1)
    return c[..., win:] - c[..., :-win]


def _gamma_phi(iq: torch.Tensor, n_fft: int, cp_len: int):
    """Single-symbol γ(d), Φ(d) for every offset d ≤ len − n_fft − cp_len."""
    a = iq[..., : iq.shape[-1] - n_fft]
    b = iq[..., n_fft:]
    gamma = _sliding(a * torch.conj(b), cp_len)
    phi = 0.5 * _sliding(a.abs() ** 2 + b.abs() ** 2, cp_len)
    return gamma, phi


def _gi_metrics(iq: torch.Tensor, n_fft: int, cp_len: int, search_len: int,
                rho: float, max_syms: int):
    """(argmax of the accumulated ML metric, single-symbol score at it and
    at its period origin, γ and Φ at both), as host scalars."""
    g1, p1 = _gamma_phi(iq, n_fft, cp_len)
    n_valid = g1.shape[-1]
    period = n_fft + cp_len
    dev = iq.device
    d = torch.arange(search_len, device=dev)
    gamma = torch.zeros(search_len, dtype=torch.complex64, device=dev)
    phi = torch.zeros(search_len, dtype=torch.float32, device=dev)
    for s in range(max_syms):
        idx = d + s * period
        ok = idx <= n_valid - cp_len
        safe = torch.clamp(idx, 0, n_valid - 1)
        gamma = gamma + torch.where(ok, g1[safe], torch.zeros_like(g1[safe]))
        phi = phi + torch.where(ok, p1[safe], torch.zeros_like(p1[safe]))
    metric = gamma.abs() - rho * phi
    argmax = int(torch.argmax(metric))
    origin = argmax - argmax % period

    def at(dd: int):
        if dd > n_valid - cp_len:
            return 0.0, 0j, 0.0
        dd = min(max(dd, 0), n_valid - 1)
        g, p = complex(g1[dd]), float(p1[dd])
        return (min(abs(g) / p, 1.0) if p > 0 else 0.0), g, p

    sc_peak, _, _ = at(argmax)
    sc_origin, _, _ = at(origin)
    return (argmax, sc_peak, sc_origin, complex(gamma[argmax]),
            float(phi[argmax]), complex(gamma[origin]), float(phi[origin]))


@takes_host_data("iq")
def dvb_t_gi_sync(iq: torch.Tensor, n_fft: int, cp_len: int, fs: float,
                  search_len: int, cfg: GiSyncConfig = GiSyncConfig()
                  ) -> Optional[GiSyncResult]:
    """Best GI-aligned symbol start in offsets 0..search_len of a 1-D
    complex64 tensor, or None (too short, or no correlation energy)."""
    if cp_len == 0 or n_fft == 0 or search_len == 0:
        return None
    if iq.shape[-1] < search_len - 1 + n_fft + cp_len:
        return None
    period = n_fft + cp_len
    (argmax, sc_peak, sc_origin, g_peak, p_peak, g_origin, p_origin) = \
        _gi_metrics(iq.to(torch.complex64), n_fft, cp_len, search_len,
                    cfg.rho, max(cfg.max_symbols, 1))
    phase = argmax % period
    origin = argmax - phase
    use_origin = (cfg.origin_score_ratio > 0.0 and phase != 0
                  and period - phase <= -(-cp_len // 2)
                  and sc_origin >= min(max(cfg.origin_score_ratio, 0.0),
                                       1.0) * sc_peak)
    best_d = origin if use_origin else argmax
    bg = g_origin if use_origin else g_peak
    bp = p_origin if use_origin else p_peak
    score = min(abs(bg) / bp, 1.0) if bp > 0 else 0.0
    if score <= 0.0:
        # silence or blanked input: no acquisition
        return None
    cfo_hz = -float(np.arctan2(bg.imag, bg.real)) * fs / (2 * np.pi * n_fft)
    return GiSyncResult(start_sample=best_d, cfo_hz=cfo_hz, score=score)


@takes_host_data("iq")
def dvb_t_gi_refine(iq: torch.Tensor, n_fft: int, cp_len: int, fs: float,
                    coarse: int, radius: int,
                    cfg: GiSyncConfig = GiSyncConfig()
                    ) -> Optional[GiSyncResult]:
    """Local re-lock ±radius around a coarse estimate, unwrap guard off."""
    start = max(coarse - radius, 0)
    sub = iq[start:]
    local = GiSyncConfig(rho=cfg.rho, max_symbols=cfg.max_symbols,
                         origin_score_ratio=0.0)
    r = dvb_t_gi_sync(sub, n_fft, cp_len, fs,
                      min(2 * radius + 1, sub.shape[-1]), local)
    if r is None:
        return None
    return r._replace(start_sample=r.start_sample + start)


class IntegerCfoResult(NamedTuple):
    bins: int
    confidence: float


def dvb_t_integer_cfo(freq, n_fft: int, max_bins: int
                      ) -> Optional[IntegerCfoResult]:
    """Trial-shift continual-pilot energy search over one (accumulated)
    spectrum, all shifts at once (host numpy)."""
    f = np.asarray(freq)
    if len(f) < n_fft or n_fft == 0 or max_bins <= 0:
        return None
    pb = continual_pilot_bins()
    ks = np.arange(-max_bins, max_bins + 1)
    idx = (pb[None, :] + ks[:, None]) % n_fft
    energies = np.sum(np.abs(f[idx]) ** 2, axis=1)
    best = int(np.argmax(energies))
    mean = float(np.mean(energies))
    conf = float(energies[best]) / mean if mean > 0 else 0.0
    return IntegerCfoResult(bins=int(ks[best]), confidence=conf)
