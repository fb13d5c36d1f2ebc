"""Channel impairment simulator (counterpart of
``orion_sdr_tpu/channel.py``): oscillator and front-end imperfections,
static echoes, time-varying Rayleigh/Rician taps, and the Watterson HF
model, each applied to (..., n) IQ on ``device``.

Every random draw is the reference's: a ``np.random.Generator`` drawn on
the host in the same order and count (the phase-noise walk summed in
float64, the fading processes synthesised in numpy), so one seed gives the
same realisation in both packages. The per-sample application is torch on
the input's device. As in the reference, every leading row gets the same
channel realisation.
"""

from __future__ import annotations

import numpy as np
import torch

from .dsp.device import to_device
from .dsp.osc import rotate_host

__all__ = [
    "cfo_apply", "phase_noise_apply", "iq_imbalance_apply",
    "multipath_apply", "fading_taps", "fading_apply", "watterson_apply",
]


def _iq(x, device) -> torch.Tensor:
    return to_device(x, device, torch.complex64)


def cfo_apply(x, cfo_hz: float, fs: float, phase0: float = 0.0,
              device="cuda") -> torch.Tensor:
    """Carrier frequency offset: y = x · e^{j2π·cfo·t + jφ₀} (the rotation
    alone, without the phase tail)."""
    y, _ = rotate_host(_iq(x, device), float(cfo_hz), float(fs),
                       float(phase0))
    return y


def phase_noise_apply(rng: np.random.Generator, x, linewidth_hz: float,
                      fs: float, device="cuda") -> torch.Tensor:
    """Wiener (random-walk) oscillator phase noise of Lorentzian linewidth
    Δν: increments N(0, 2πΔν/fs) a sample, summed on the host in float64,
    rounded to float32 and rotated in on the device."""
    z = _iq(x, device)
    n = z.shape[-1]
    if n == 0 or linewidth_hz <= 0.0:
        return z
    step = np.sqrt(2.0 * np.pi * float(linewidth_hz) / float(fs))
    phi = torch.as_tensor(np.cumsum(step * rng.standard_normal(n)).astype(
        np.float32), device=z.device)
    return z * torch.complex(torch.cos(phi), torch.sin(phi))


def iq_imbalance_apply(x, amp_db: float = 0.0, phase_deg: float = 0.0,
                       device="cuda") -> torch.Tensor:
    """Receiver I/Q gain and phase imbalance: y = μ·x + ν·conj(x) with
    μ = (1 + g·e^{-jφ})/2, ν = (1 − g·e^{jφ})/2, g = 10^{amp/20}; (0 dB, 0°)
    is exactly the identity."""
    g = 10.0 ** (float(amp_db) / 20.0)
    ph = np.deg2rad(float(phase_deg))
    mu = 0.5 * (1.0 + g * np.exp(-1j * ph))
    nu = 0.5 * (1.0 - g * np.exp(1j * ph))
    z = _iq(x, device)
    if nu == 0.0:
        return z
    mu = complex(np.float32(mu.real), np.float32(mu.imag))
    nu = complex(np.float32(nu.real), np.float32(nu.imag))
    return mu * z + nu * torch.conj(z)


def _delayed(z: torch.Tensor, d: int) -> torch.Tensor:
    """z[n − d] with zeros before the start, same length."""
    if d == 0:
        return z
    return torch.nn.functional.pad(z[..., :-d], (d, 0)) if d < z.shape[-1] \
        else torch.zeros_like(z)


def _check_delays(delays_samp) -> tuple:
    """Integer sample delays, each non-negative."""
    d = tuple(int(v) for v in np.asarray(delays_samp).reshape(-1))
    if any(v < 0 for v in d):
        raise ValueError("delays_samp must be non-negative")
    return d


def multipath_apply(x, delays_samp, gains, normalize: bool = True,
                    device="cuda") -> torch.Tensor:
    """Static multipath: y[n] = Σ_k g_k · x[n − d_k] (causal, same length,
    (..., n) batches). ``normalize`` scales the gains to Σ|g|² = 1."""
    d = _check_delays(delays_samp)
    g = np.asarray(gains, np.complex128).reshape(-1)
    if len(d) != g.size:
        raise ValueError(f"delays ({len(d)}) and gains ({g.size}) disagree")
    if normalize:
        p = np.sqrt(np.sum(np.abs(g) ** 2))
        if p > 0:
            g = g / p
    z = _iq(x, device)
    y = torch.zeros_like(z)
    for gk, dk in zip(g, d):
        gk = complex(np.float32(gk.real), np.float32(gk.imag))
        y = y + gk * _delayed(z, dk)
    return y


def fading_taps(rng: np.random.Generator, n_out: int, rate_hz: float,
                doppler_hz: float, spectrum: str = "jakes",
                n_paths: int = 1, rice_k_db: float | None = None):
    """(n_paths, n_out) unit-power complex64 tap processes at ``rate_hz``
    (host numpy): white complex Gaussian spectra shaped by √PSD and
    inverse-FFT'd. ``spectrum`` "jakes" (S(f) ∝ 1/√(1−(f/f_d)²), |f| < f_d
    = ``doppler_hz``) or "gaussian" (σ = ``doppler_hz``, the Watterson
    path spectrum); ``rice_k_db`` adds a line-of-sight part of Rice factor
    K, total power kept 1."""
    if n_out <= 0 or n_paths <= 0:
        return np.zeros((max(n_paths, 0), max(n_out, 0)), np.complex64)
    if doppler_hz <= 0.0:
        raise ValueError("doppler_hz must be > 0 (use multipath_apply for "
                         "a static channel)")
    m = 1 << max(int(np.ceil(np.log2(max(n_out, 8)))) + 1, 4)
    f = np.fft.fftfreq(m, d=1.0 / float(rate_hz))
    if spectrum == "jakes":
        fd = float(doppler_hz)
        r = np.clip(np.abs(f) / fd, 0.0, 0.999)
        psd = np.where(np.abs(f) < fd, 1.0 / np.sqrt(1.0 - r * r), 0.0)
    elif spectrum == "gaussian":
        sigma = float(doppler_hz)
        psd = np.exp(-0.5 * (f / sigma) ** 2)
    else:
        raise ValueError(f"unknown spectrum {spectrum!r}")
    shape = np.sqrt(psd)
    out = np.empty((n_paths, n_out), np.complex64)
    for p in range(n_paths):
        w = (rng.standard_normal(m) + 1j * rng.standard_normal(m))
        h = np.fft.ifft(w * shape)[:n_out]
        h = h / np.sqrt(np.mean(np.abs(h) ** 2))
        if rice_k_db is not None:
            k_lin = 10.0 ** (float(rice_k_db) / 10.0)
            h = (np.sqrt(k_lin / (k_lin + 1.0)) +
                 np.sqrt(1.0 / (k_lin + 1.0)) * h)
            h = h / np.sqrt(np.mean(np.abs(h) ** 2))
        out[p] = h.astype(np.complex64)
    return out


def _fading(z: torch.Tensor, h: np.ndarray, pos: np.ndarray,
            delays: tuple) -> torch.Tensor:
    """Σ_k h_k(pos)·z[n − d_k], each path's taps linearly interpolated at
    the fractional tap indices ``pos`` (float32)."""
    dev = z.device
    hr = torch.as_tensor(np.ascontiguousarray(h.real), device=dev)
    hi = torch.as_tensor(np.ascontiguousarray(h.imag), device=dev)
    t = torch.as_tensor(pos, device=dev)
    i0 = torch.clamp(torch.floor(t).to(torch.int64), 0, hr.shape[-1] - 2)
    frac = t - i0.to(torch.float32)
    y = torch.zeros_like(z)
    for k, d in enumerate(delays):
        a = hr[k, i0] * (1 - frac) + hr[k, i0 + 1] * frac
        b = hi[k, i0] * (1 - frac) + hi[k, i0 + 1] * frac
        y = y + torch.complex(a, b) * _delayed(z, d)
    return y


def fading_apply(x, fs: float, taps, tap_rate_hz: float, delays_samp,
                 path_gains_db=None, normalize: bool = True,
                 device="cuda") -> torch.Tensor:
    """Time-varying multipath: y[n] = Σ_k g_k·h_k(n/fs)·x[n − d_k].
    ``taps`` (n_paths, n_taps) at ``tap_rate_hz`` (from
    :func:`fading_taps`), each path's process interpolated linearly to the
    sample rate on the device; ``normalize`` scales the path gains to
    Σ g² = 1."""
    z = _iq(x, device)
    h = np.asarray(taps, np.complex64)
    if h.ndim == 1:
        h = h[None, :]
    d = _check_delays(delays_samp)
    if h.shape[0] != len(d):
        raise ValueError(f"taps paths ({h.shape[0]}) and delays ({len(d)}) "
                         "disagree")
    g = (np.ones(len(d)) if path_gains_db is None else
         10.0 ** (np.asarray(path_gains_db, np.float64).reshape(-1) / 20.0))
    if g.size != len(d):
        raise ValueError("path_gains_db length mismatch")
    if normalize and g.size:
        g = g / np.sqrt(np.sum(g ** 2))
    h = h * g[:, None].astype(np.complex64)
    n = z.shape[-1]
    if n == 0:
        return z
    if h.shape[-1] < 2:
        h = np.concatenate([h, h], axis=-1)
    need = (n - 1) * float(tap_rate_hz) / float(fs)
    if h.shape[-1] - 1 < need:
        raise ValueError(
            f"taps too short: {h.shape[-1]} samples at {tap_rate_hz} Hz "
            f"covers {(h.shape[-1] - 1) / tap_rate_hz:.3f} s < "
            f"{(n - 1) / fs:.3f} s of signal")
    pos = (np.arange(n, dtype=np.float64) * float(tap_rate_hz) / float(fs)
           ).astype(np.float32)
    return _fading(z, h, pos, d)


def watterson_apply(rng: np.random.Generator, x, fs: float,
                    delay_s: float = 1e-3, spread_hz: float = 0.5,
                    path_gains_db=(0.0, 0.0), device="cuda") -> torch.Tensor:
    """CCIR 520 / ITU-R F.1487 Watterson HF channel: two independent
    Rayleigh paths with Gaussian Doppler spectra of RMS width
    ``spread_hz``/2, ``delay_s`` apart; unit average output power.
    "moderate" = (1 ms, 0.5 Hz), "disturbed" = (2 ms, 1 Hz)."""
    z = _iq(x, device)
    n = z.shape[-1]
    if n == 0:
        return z
    sigma = max(float(spread_hz) / 2.0, 1e-3)
    tap_rate = max(64.0 * sigma, 16.0)
    n_taps = int(np.ceil((n - 1) / float(fs) * tap_rate)) + 2
    taps = fading_taps(rng, n_taps, tap_rate, sigma, spectrum="gaussian",
                       n_paths=2)
    delays = (0, max(int(round(float(delay_s) * float(fs))), 1))
    return fading_apply(z, fs, taps, tap_rate, delays,
                        path_gains_db=path_gains_db, normalize=True,
                        device=z.device)
