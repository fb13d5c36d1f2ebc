"""GPS L1 C/A acquisition and tracking (counterpart of
``orion_sdr_tpu/gnss.py``).

The acquisition search — every PRN × every Doppler bin × every code phase
— is one batched torch.fft program on the capture's device: the carrier
wipe of every Doppler, per-ms FFTs, the conjugate code-spectrum product of
every PRN, inverse FFTs and a non-coherent sum, over all (PRN, Doppler,
block) planes at once. Tracking is the hand-written kernel
``ops/gnss_track.py`` (one block a satellite, the epochs in a loop inside
it); the nav-bit recovery on its prompts runs on the host, as in the JAX
package.

Wire compatibility: the C/A Gold-code generator (G1 = 1+x^3+x^10,
G2 = 1+x^2+x^3+x^6+x^8+x^9+x^10, per-PRN G2 tap pairs) gives the
published first-10-chip octal words (PRN1 = 1440, PRN2 = 1620, PRN3 =
1710, PRN4 = 1744) and the three-valued Gold cross-correlation
{-65, -1, 63}.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .dsp.device import to_device
from .ops.gnss_track import GPS_CA_RATE, GPS_L1_HZ, TAU, gnss_track

GPS_CA_LEN = 1023              # chips per 1 ms epoch
GPS_NAV_BIT_MS = 20            # one nav bit = 20 C/A epochs
GPS_NAV_PREAMBLE = np.array([1, 0, 0, 0, 1, 0, 1, 1], np.uint8)

# G2 output tap pair per PRN (IS-GPS-200 phase assignments, 1-based taps)
_G2_TAPS = {
    1: (2, 6), 2: (3, 7), 3: (4, 8), 4: (5, 9), 5: (1, 9), 6: (2, 10),
    7: (1, 8), 8: (2, 9), 9: (3, 10), 10: (2, 3), 11: (3, 4), 12: (5, 6),
    13: (6, 7), 14: (7, 8), 15: (8, 9), 16: (9, 10), 17: (1, 4),
    18: (2, 5), 19: (3, 6), 20: (4, 7), 21: (5, 8), 22: (6, 9),
    23: (1, 3), 24: (4, 6), 25: (5, 7), 26: (6, 8), 27: (7, 9),
    28: (8, 10), 29: (1, 6), 30: (2, 7), 31: (3, 8), 32: (4, 9),
}


@lru_cache(maxsize=None)
def gps_ca_code(prn: int) -> np.ndarray:
    """(1023,) uint8 C/A chips for ``prn`` in 1..32."""
    if prn not in _G2_TAPS:
        raise ValueError(f"PRN must be 1..32, got {prn}")
    t1, t2 = _G2_TAPS[prn]
    g1 = np.ones(10, np.uint8)
    g2 = np.ones(10, np.uint8)
    out = np.empty(GPS_CA_LEN, np.uint8)
    for i in range(GPS_CA_LEN):
        out[i] = g1[9] ^ g2[t1 - 1] ^ g2[t2 - 1]
        f1 = g1[2] ^ g1[9]
        f2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1[1:] = g1[:-1]
        g1[0] = f1
        g2[1:] = g2[:-1]
        g2[0] = f2
    return out


def _samples_per_ms(fs: float) -> int:
    n = fs * 1e-3
    ni = int(round(n))
    if abs(n - ni) > 1e-9:
        raise ValueError("fs must make 1 ms an integer number of samples")
    return ni


@lru_cache(maxsize=None)
def _ca_pm_sampled(prn: int, fs: float) -> np.ndarray:
    """(fs/1000,) f32 ±1 code samples for one epoch at rate ``fs``."""
    n = _samples_per_ms(fs)
    idx = (np.arange(n) * (GPS_CA_RATE / fs)).astype(np.int64) % GPS_CA_LEN
    return (1.0 - 2.0 * gps_ca_code(prn)[idx]).astype(np.float32)


def gps_ca_mod(prn: int, fs: float, n_ms: int, doppler_hz: float = 0.0,
               code_phase_chips: float = 0.0, nav_bits=None,
               amplitude: float = 1.0, carrier_phase: float = 0.0
               ) -> np.ndarray:
    """Synthesize a baseband C/A signal: (n_ms · fs/1000,) complex64 (host
    numpy, float64 inside, as the JAX package).

    ``code_phase_chips`` delays the code (the first sample sits that many
    chips before the epoch boundary); nav bits (50 bps) flip the code sign
    every 20 epochs, aligned to the first full epoch. The code rate is
    Doppler-scaled by 1 + doppler/L1 (coherent code/carrier dynamics)."""
    n = _samples_per_ms(fs) * int(n_ms)
    t = np.arange(n, dtype=np.float64) / fs
    chip_rate = GPS_CA_RATE * (1.0 + doppler_hz / GPS_L1_HZ)
    chips = t * chip_rate - float(code_phase_chips)
    ci = np.floor(chips).astype(np.int64)
    code = (1.0 - 2.0 * gps_ca_code(prn)[ci % GPS_CA_LEN]).astype(np.float64)
    if nav_bits is not None:
        nav = np.asarray(nav_bits).astype(np.int64) % 2
        epoch = ci // GPS_CA_LEN        # epoch counter (20 per bit)
        bit_idx = np.clip(epoch // GPS_NAV_BIT_MS, 0, len(nav) - 1)
        # epochs before the first boundary take bit 0
        bit_idx = np.where(epoch < 0, 0, bit_idx)
        code = code * (1.0 - 2.0 * nav[bit_idx])
    ph = carrier_phase + TAU * doppler_hz * t
    return (amplitude * code * np.exp(1j * ph)).astype(np.complex64)


class GpsAcquisition(NamedTuple):
    prn: int
    doppler_hz: float
    code_phase_samples: int     # offset of the code epoch start in samples
    score: float                # peak / strongest sidelobe outside ±1 chip
    snr_db: float               # peak over mean cell energy


def _acquire_grid(z: torch.Tensor, codes_pm: torch.Tensor,
                  dopp_hz: torch.Tensor, fs: float,
                  n_blocks: int) -> torch.Tensor:
    """(n,) capture → (P, D, spms) float32 non-coherent correlation metric,
    every (PRN, Doppler, block) plane in one batched FFT program."""
    dev = z.device
    spms = codes_pm.shape[-1]
    t = torch.arange(n_blocks * spms, dtype=torch.float32, device=dev) \
        / torch.tensor(np.float32(fs), device=dev)
    cf = torch.conj(torch.fft.fft(codes_pm.to(device=dev,
                                              dtype=torch.complex64), dim=-1))
    d = dopp_hz.to(device=dev, dtype=torch.float32)
    ph = (float(np.float32(TAU)) * d)[:, None] * t            # (D, M·spms)
    zz = z[: n_blocks * spms] * torch.polar(torch.ones_like(ph), -ph)
    bf = torch.fft.fft(zz.reshape(-1, n_blocks, spms), dim=-1)  # (D, M, s)
    corr = torch.fft.ifft(bf[None] * cf[:, None, None, :], dim=-1)
    return (corr.real ** 2 + corr.imag ** 2).sum(2)           # (P, D, s)


def gps_acquire(iq, fs: float, prns: Optional[Sequence[int]] = None,
                doppler_span_hz: float = 5000.0,
                doppler_step_hz: float = 250.0, n_noncoherent: int = 4,
                threshold: float = 1.8, device="cuda"
                ) -> List[GpsAcquisition]:
    """Search every (PRN, Doppler, code phase) cell of a capture in one
    device program; returns detections sorted by score.

    Detection statistic: the plane's peak over the strongest peak elsewhere
    in the same (PRN, Doppler) plane at least one chip away (peak to second
    peak, invariant to the noise floor)."""
    z = to_device(iq, device, torch.complex64)
    if z.dim() != 1:
        raise ValueError("gps_acquire takes a 1-D IQ capture")
    spms = _samples_per_ms(fs)
    n_blocks = int(n_noncoherent)
    if z.shape[0] < (n_blocks + 1) * spms:
        raise ValueError("capture shorter than the non-coherent span")
    prns = list(range(1, 33) if prns is None else prns)
    codes = torch.as_tensor(np.stack([_ca_pm_sampled(p, fs) for p in prns]))
    dopp = np.arange(-doppler_span_hz,
                     doppler_span_hz + 0.5 * doppler_step_hz,
                     doppler_step_hz).astype(np.float32)
    grid = _acquire_grid(z, codes, torch.as_tensor(dopp), float(fs),
                         n_blocks).cpu().numpy()
    chip_samp = max(1, int(round(fs / GPS_CA_RATE)))
    out = []
    for pi, prn in enumerate(prns):
        plane = grid[pi]                      # (D, spms)
        di, ci = np.unravel_index(np.argmax(plane), plane.shape)
        peak = float(plane[di, ci])
        # mask ±1 chip around the peak's code phase in every Doppler row
        # (the same peak smears across adjacent Doppler bins)
        mask = np.ones(spms, bool)
        mask[np.arange(ci - chip_samp, ci + chip_samp + 1) % spms] = False
        second = float(plane[:, mask].max())
        score = peak / max(second, 1e-12)
        if score >= threshold:
            snr_db = 10.0 * np.log10(peak / max(float(plane.mean()), 1e-12))
            out.append(GpsAcquisition(prn, float(dopp[di]), int(ci),
                                      score, snr_db))
    return sorted(out, key=lambda a: -a.score)


class GpsTrack(NamedTuple):
    prompt: np.ndarray          # (n_epochs,) complex prompt correlations
    doppler_hz: np.ndarray      # (n_epochs,) carrier-loop frequency
    code_phase: np.ndarray      # (n_epochs,) epoch-start sample positions
    nav_bits: np.ndarray        # (n_bits,) uint8 (polarity-ambiguous)
    bit_offset_ms: int          # epoch index where the first full bit starts
    lock: float                 # mean |I|/rms(Q) over the last half


def _track_scan(z: torch.Tensor, codes_pm, starts, f0_hz, fs: float,
                n_epochs: int,
                k_pll_f: float, k_pll_p: float, k_dll: float):
    """E/P/L correlator epochs with a Costas PLL and an envelope DLL for S
    satellites of one capture (the JAX bench's ``vmap`` of ``_track_scan``
    written out): (n,) capture, (S, spms) codes, (S,) starts and Dopplers →
    (S, n_epochs) prompts, frequencies, int32 epoch bases and fractions.
    The code NCO carries an int32 epoch base plus a float32 fraction kept in
    [−0.5, 0.5] (never an absolute float32 position, whose ulp on a
    multi-second capture would dead-zone the corrections); the carrier
    phase is wrapped mod 2π every epoch. One kernel launch for all, on
    the capture's device."""
    dev = z.device
    return gnss_track(z, to_device(codes_pm, dev, torch.float32),
                      to_device(starts, dev, torch.int32).reshape(-1),
                      to_device(f0_hz, dev, torch.float32).reshape(-1),
                      float(fs), int(n_epochs), float(k_pll_f),
                      float(k_pll_p), float(k_dll))


def gps_track(iq, fs: float, prn: int, doppler_hz: float,
              code_phase_samples: int, pll_bw: float = 18.0,
              dll_gain: float = 0.12, device="cuda") -> GpsTrack:
    """Track one satellite through a capture: E/P/L correlators, Costas
    PLL with a carrier-aided code NCO, nav-bit recovery from the prompt
    signs (bit edge chosen by maximum 20-epoch sign coherence). The loops
    run on ``device``; the returned fields are host numpy."""
    z = to_device(iq, device, torch.complex64)
    if z.dim() != 1:
        raise ValueError("gps_track takes a 1-D IQ capture")
    spms = _samples_per_ms(fs)
    d_el = max(1, int(round(0.5 * fs / GPS_CA_RATE)))
    start = int(code_phase_samples)
    if start < d_el:
        start += spms
    # one epoch of slack at both ends for E/L slices and code-phase drift
    n_epochs = (z.shape[0] - start - spms - d_el) // spms
    if n_epochs < 2:
        raise ValueError("capture too short to track")
    # Costas loop gains scaled from pll_bw (defaults 0.4·18 and 0.05·18)
    k_pll_f = 0.4 * pll_bw          # Hz per rad of phase error
    k_pll_p = 0.05 * pll_bw         # rad per rad
    prompts, freqs, bases, fracs = _track_scan(
        z, _ca_pm_sampled(prn, fs)[None], [start], [doppler_hz], float(fs),
        int(n_epochs), k_pll_f, k_pll_p, float(dll_gain))
    prompts = prompts[0].cpu().numpy()
    poss = (bases[0].cpu().numpy().astype(np.float64)
            + fracs[0].cpu().numpy().astype(np.float64))
    signs = np.sign(prompts.real).astype(np.float32)
    # settle: ignore the first 40 epochs when scoring bit-edge coherence
    s = signs[40:]
    n_bits_s = len(s) // GPS_NAV_BIT_MS - 1
    best_off, best_val = 0, -1.0
    for off in range(GPS_NAV_BIT_MS):
        seg = s[off: off + n_bits_s * GPS_NAV_BIT_MS]
        v = float(np.abs(seg.reshape(-1, GPS_NAV_BIT_MS).sum(1)).mean())
        if v > best_val:
            best_val, best_off = v, off
    off = (40 + best_off) % GPS_NAV_BIT_MS
    nb = (len(signs) - off) // GPS_NAV_BIT_MS
    sums = signs[off: off + nb * GPS_NAV_BIT_MS].reshape(
        -1, GPS_NAV_BIT_MS).sum(1)
    bits = (sums < 0).astype(np.uint8)
    half = prompts[len(prompts) // 2:]
    lock = float(np.mean(np.abs(half.real))
                 / max(float(np.sqrt(np.mean(half.imag ** 2))), 1e-12))
    return GpsTrack(prompts, freqs[0].cpu().numpy(), poss, bits, int(off),
                    lock)


def gps_nav_frame_sync(bits) -> Optional[int]:
    """Index of the first TLM preamble (10001011) in a nav bit stream,
    testing both polarities together (the earliest hit of either wins);
    None if absent.

    An 8-bit pattern false-alarms at ~1/128 per offset per polarity, so on
    streams long enough to hold a second subframe the search prefers hits
    that recur at the 300-bit subframe spacing (one preamble per subframe,
    IS-GPS-200 20.3.3); isolated hits are returned only when no recurring
    hit exists."""
    b = np.asarray(bits).astype(np.uint8) % 2
    if len(b) < 8:
        return None
    w = np.lib.stride_tricks.sliding_window_view(b, 8)
    hits: set = set()
    for pat in (GPS_NAV_PREAMBLE, 1 - GPS_NAV_PREAMBLE):
        hits.update(np.nonzero((w == pat).all(axis=1))[0].tolist())
    if not hits:
        return None
    recurring = sorted(h for h in hits if (h + 300) in hits)
    if recurring:
        return int(recurring[0])
    return int(min(hits))
