"""Measurement toolkit: the spectral yardsticks the tests assert against
(counterpart of ``orion_sdr_tpu/util.py``; behavioral spec: util.rs).

Everything but :func:`atan2_approx` and the Welch periodogram behind
:func:`spectrum_scan` is host numpy, copied from the JAX package (which
also runs it in numpy): it is measurement code, not the hot path.
:func:`atan2_approx` is the FM/PM discriminators' arctangent on torch
tensors, with the JAX version's float32 operation order (equal to it on
the CPU). Both take host data as the JAX ones do: a tensor stays on its
device, host data goes to ``device`` (None: the card), ``"cpu"`` runs the
plain path. :class:`trace` and :func:`measure` are the observability pair:
a ``torch.profiler`` trace of a block, and wall-clock throughput with the
card's queue drained on both sides of the work.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import obs
from .dsp.device import on_device, takes_host_data

SIGNAL_THRESHOLD = 0.1  # RMS below which a block is treated as silence (util.rs:297)
PSK31_BW_HZ = 62.5      # raised-cosine pulse: 2x baud (util.rs:300)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rms(x) -> float:
    x = _np(x)
    if x.size == 0:
        return 0.0
    return float(np.sqrt(np.mean(np.abs(x).astype(np.float64) ** 2)))


def hann(n: int) -> np.ndarray:
    """Periodic Hann window (util.rs:18-22)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def tone(fs: float, f_hz: float, n: int, amp: float = 1.0) -> np.ndarray:
    """Real sine tone (util.rs:25-29)."""
    k = np.arange(n, dtype=np.float64)
    return (amp * np.sin(2.0 * np.pi * f_hz * k / fs)).astype(np.float32)


def gen_complex_tone(fs: float, f_hz: float, n: int) -> np.ndarray:
    """Complex baseband tone e^{j2πft} (util.rs:32-39)."""
    k = np.arange(n, dtype=np.float64)
    ph = 2.0 * np.pi * f_hz * k / fs
    return (np.cos(ph) + 1j * np.sin(ph)).astype(np.complex64)


def snr_db_at(fs: float, f_hz: float, x) -> float:
    """Single-bin Hann-windowed DFT SNR at f_hz (util.rs:42-61)."""
    x = _np(x).astype(np.float64)
    if len(x) == 0:
        return 0.0
    n = len(x)
    w = hann(n).astype(np.float64)
    ph = 2.0 * np.pi * f_hz * np.arange(n) / fs
    re = float(np.sum(w * x * np.cos(ph)))
    im = float(np.sum(w * x * np.sin(ph)))
    sig = np.hypot(re, im) / (w.sum() + 1e-12)
    p_total = float(np.mean(x * x))
    p_sig = sig * sig
    p_noise = max(p_total - p_sig, 1e-12)
    return float(10.0 * np.log10(p_sig / p_noise))


def power_spectrum(samples, fs: float):
    """Hann-windowed power spectrum in dB; FFT size = next power of two
    clamped to [64, 4096]. Returns (power_db[n/2+1], bin_hz) (util.rs:96-133).
    Complex input is analysed as it is (positive-frequency bins reported)."""
    samples = _np(samples)
    cplx = np.iscomplexobj(samples)
    samples = samples.astype(np.complex128 if cplx else np.float64)
    n = 1 << max(int(np.ceil(np.log2(max(len(samples), 1)))), 0)
    n = int(np.clip(n, 64, 4096))
    buf = np.zeros(n, dtype=samples.dtype)
    m = min(len(samples), n)
    buf[:m] = samples[:m]
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)
    spec = np.fft.fft(buf * w)
    scale = 1.0 / n
    bins = n // 2 + 1
    mag_sq = (np.abs(spec[:bins]) * scale) ** 2
    return 10.0 * np.log10(mag_sq + 1e-12), fs / n


def nb_spectrum_snr_db(samples, fs: float, carrier_hz: float) -> float:
    """Peak bin (±3-bin AFC search) over the median of bins ≥ 10 away
    (util.rs:139-175)."""
    power_db, bin_hz = power_spectrum(samples, fs)
    n_bins = len(power_db)
    if n_bins < 3:
        return 0.0
    peak_bin = min(int(round(carrier_hz / bin_hz)), n_bins - 1)
    lo, hi = max(peak_bin - 3, 0), min(peak_bin + 3, n_bins - 1)
    sig_bin = lo + int(np.argmax(power_db[lo:hi + 1]))
    idx = np.arange(n_bins)
    mask = (idx > 0) & (np.abs(idx - sig_bin) >= 10)
    noise = power_db[mask]
    if noise.size == 0:
        return 0.0
    return float(power_db[sig_bin] - np.median(noise))


def wb_spectrum_snr_db(samples, fs: float, carrier_hz: float,
                       occupied_hz: float) -> float:
    """Mean in-band power over the median out of band (util.rs:184-218)."""
    power_db, bin_hz = power_spectrum(samples, fs)
    n_bins = len(power_db)
    if n_bins < 3 or bin_hz <= 0:
        return 0.0
    carrier_bin = int(round(carrier_hz / bin_hz))
    half = int(round((occupied_hz / 2.0) / bin_hz))
    lo = max(carrier_bin - half, 0)
    hi = min(carrier_bin + half, n_bins - 1)
    if lo > hi:
        return 0.0
    occ_mean = float(np.mean(power_db[lo:hi + 1]))
    idx = np.arange(n_bins)
    mask = (idx > 0) & ((idx < lo) | (idx > hi))
    outside = power_db[mask]
    if outside.size == 0:
        return 0.0
    return occ_mean - float(np.median(outside))


def spectrum_bw_hz(samples, fs: float, carrier_hz: float,
                   threshold_db: float = 35.0) -> float:
    """AM occupied bandwidth: the outermost bins within 35 dB of the carrier
    (util.rs:228-296)."""
    search_hz, carrier_drop_db, guard = 4000.0, 35.0, 3
    power_db, bin_hz = power_spectrum(samples, fs)
    n_bins = len(power_db)
    if n_bins < 3:
        return bin_hz
    nominal = min(int(round(carrier_hz / bin_hz)), n_bins - 1)
    lo, hi = max(nominal - 3, 0), min(nominal + 3, n_bins - 1)
    carrier_bin = lo + int(np.argmax(power_db[lo:hi + 1]))
    cutoff = power_db[carrier_bin] - carrier_drop_db
    search_bins = int(np.ceil(search_hz / bin_hz))

    lsb_lo = max(carrier_bin - search_bins, 0)
    lsb_hi = max(carrier_bin - guard, 0)
    left_edge = carrier_bin
    if lsb_lo < lsb_hi:
        above = np.nonzero(power_db[lsb_lo:lsb_hi + 1] >= cutoff)[0]
        if above.size:
            left_edge = lsb_lo + int(above[0])

    usb_lo = min(carrier_bin + guard, n_bins - 1)
    usb_hi = min(carrier_bin + search_bins, n_bins - 1)
    right_edge = carrier_bin
    if usb_lo < usb_hi:
        above = np.nonzero(power_db[usb_lo:usb_hi + 1] >= cutoff)[0]
        if above.size:
            right_edge = usb_lo + int(above[-1])

    return float((max(right_edge, left_edge) - left_edge + 1) * bin_hz)


def awgn(rng: np.random.Generator, shape, scale: float, complex_: bool = True):
    """Deterministic test AWGN (the role of the reference's seeded
    xorshift, tests/common/mod.rs)."""
    if complex_:
        return (scale * (rng.standard_normal(shape)
                         + 1j * rng.standard_normal(shape))
                / np.sqrt(2.0)).astype(np.complex64)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


class trace:
    """Profiling context: ``with util.trace("prof_dir"): run()`` records
    every CPU op and, where CUDA is available, every card kernel in the
    block under ``torch.profiler``, and writes a Chrome/Perfetto trace
    (``trace_<pid>_<n>.json``) into ``log_dir`` on exit; ``.path`` names
    the file. ``.spans`` holds the :class:`obs.Root` records of the
    receive calls made in the block (their spans are in the trace too,
    named ``orion.*``)."""

    _count = 0

    def __init__(self, log_dir: str) -> None:
        self.log_dir = log_dir
        self.path = None
        self.spans = []
        self._prof = None
        self._mark = 0

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._mark = obs.recorded()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        self.spans = obs.since(self._mark)
        os.makedirs(self.log_dir, exist_ok=True)
        trace._count += 1
        self.path = os.path.join(self.log_dir,
                                 f"trace_{os.getpid()}_{trace._count}.json")
        self._prof.export_chrome_trace(self.path)
        return False


def _drain_card() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure(fn, n_samples: int, repeats: int = 1):
    """Wall-clock throughput of ``fn`` processing ``n_samples`` a call:
    (Msps, seconds) over ``repeats`` calls. The card's queue is drained
    before the clock is read on each side, so the time covers the work
    and not only its enqueueing."""
    _drain_card()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    _drain_card()
    dt = time.perf_counter() - t0
    # millions of samples first, then one division by the time
    return (n_samples * repeats / 1e6 / dt if dt > 0 else float("inf")), dt


@takes_host_data("y", "x")
def atan2_approx(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Fast atan2: Rajan-family minimax polynomial, max error ≈ 0.0015 rad,
    continuous at the octant seam (the reference's util.rs:302-322 variant
    drops the (1−r) factor; the JAX package corrects it and so does this).
    float32, in the JAX version's operation order."""
    y = y.to(torch.float32)
    x = x.to(torch.float32)
    ax, ay = x.abs(), y.abs()
    mn = torch.minimum(ax, ay)
    mx = torch.maximum(ax, ay)
    r = mn / (mx + 1.1920929e-07)
    phi = r * (np.pi / 4) + r * (1.0 - r) * (0.2447 + r * 0.0663)
    phi = torch.where(ax < ay, (np.pi / 2) - phi, phi)
    sign_y = torch.where(y < 0.0, -1.0, 1.0)
    return torch.where(x < 0.0, (np.pi - phi) * sign_y, phi * sign_y)


# ── spectrum scanning ────────────────────────────────────────────────────────


@dataclass
class SpectrumSegment:
    """One occupied sub-band found by :func:`spectrum_scan`."""
    center_hz: float     # power-weighted centroid
    bw_hz: float         # occupied width at the detection threshold
    power_db: float      # mean in-segment PSD, dB re full-scale/bin
    snr_db: float        # mean in-segment PSD over the noise floor


def _welch_psd(iq: torch.Tensor, nfft: int) -> np.ndarray:
    """Welch-averaged periodogram of a complex capture: Hann segments, 50 %
    overlap, one batched FFT over all segments on ``iq``'s device; returned
    fftshifted as host float32."""
    z = iq.to(torch.complex64)
    hop = nfft // 2
    n_seg = max((z.shape[-1] - nfft) // hop + 1, 1)
    segs = z.unfold(-1, nfft, hop)[:n_seg]
    k = torch.arange(nfft, dtype=torch.float32, device=z.device)
    w = 0.5 - 0.5 * torch.cos(k * (2.0 * np.pi) / nfft)
    spec = torch.fft.fft(segs * w, dim=-1)
    scale = 1.0 / (nfft * 0.5)                    # Hann coherent gain 0.5
    psd = ((spec * scale).abs() ** 2).mean(dim=0).to(torch.float32)
    return np.fft.fftshift(psd.cpu().numpy())


def spectrum_scan(iq, fs: float, rbw_hz: float | None = None,
                  threshold_db: float = 10.0,
                  min_bw_hz: float | None = None,
                  gap_bins: int = 2, device=None):
    """Detect occupied sub-bands in a complex wideband capture: Welch PSD
    (one batched FFT where the capture is: a tensor on its device, host
    data on ``device``, None the card), noise floor = median bin, bins
    ``threshold_db`` above it, gaps of up to ``gap_bins`` closed, segments
    closer than ``min_bw_hz`` merged; each segment at least ``min_bw_hz``
    wide as a :class:`SpectrumSegment`, strongest first."""
    iq = on_device(iq, device, torch.complex64)
    if iq.ndim != 1:
        raise ValueError("spectrum_scan takes a 1-D capture")
    if len(iq) < 256:
        raise ValueError("capture too short to scan (need ≥256 samples)")
    if rbw_hz is None:
        rbw_hz = fs / 4096.0
    nfft = 1 << int(np.clip(np.round(np.log2(fs / max(rbw_hz, 1e-9))),
                            8, 16))
    nfft = min(nfft, 1 << int(np.floor(np.log2(len(iq)))))
    psd = _welch_psd(iq, nfft)
    psd_db = 10.0 * np.log10(psd + 1e-20)
    freqs = (np.arange(nfft) - nfft // 2) * (fs / nfft)
    floor_db = float(np.median(psd_db))
    mask = psd_db > floor_db + threshold_db
    if gap_bins > 0 and mask.any():
        occ = np.flatnonzero(mask)
        gaps = np.diff(occ)
        for i in np.flatnonzero((gaps > 1) & (gaps <= gap_bins + 1)):
            mask[occ[i]:occ[i + 1]] = True
    if min_bw_hz is None:
        min_bw_hz = 4.0 * fs / nfft
    min_bins = max(int(np.ceil(min_bw_hz / (fs / nfft))), 1)

    edges = np.flatnonzero(np.diff(np.concatenate(
        [[0], mask.astype(np.int8), [0]])))
    merged = []
    for a, b in zip(edges[::2], edges[1::2]):
        if merged and a - merged[-1][1] < min_bins:
            merged[-1][1] = b
        else:
            merged.append([a, b])
    out = []
    for a, b in merged:
        if b - a < min_bins:
            continue
        p = psd[a:b]
        center = float(np.sum(freqs[a:b] * p) / np.sum(p))
        mean_db = float(10.0 * np.log10(np.mean(p) + 1e-20))
        out.append(SpectrumSegment(center_hz=center,
                                   bw_hz=float((b - a) * fs / nfft),
                                   power_db=mean_db,
                                   snr_db=mean_db - floor_db))
    out.sort(key=lambda s: -s.power_db)
    return out
