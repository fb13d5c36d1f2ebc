"""FIR design and group-delay-aligned filtering (counterpart of the parts of
``orion_sdr_tpu/dsp/fir.py`` that the TX lowpass uses).

The design functions run in numpy and give constant float32 taps. Filtering
runs on the input tensor's device: a direct ``conv1d`` for short taps and
an FFT overlap-save for long ones (``_FFT_MIN_TAPS``); the two agree within
float32 rounding.
"""

from __future__ import annotations

import numpy as np
import torch

# ── design (numpy) ───────────────────────────────────────────────────────────


def kaiser_beta(a_db: float) -> float:
    """Kaiser window β for a stopband attenuation of ``a_db``."""
    if a_db > 50.0:
        return 0.1102 * (a_db - 8.7)
    if a_db >= 21.0:
        return 0.5842 * (a_db - 21.0) ** 0.4 + 0.07886 * (a_db - 21.0)
    return 0.0


def bessel_i0(x):
    """Modified Bessel I0 by its power series (40 terms)."""
    x = np.asarray(x, dtype=np.float64)
    half = 0.5 * x
    term = np.ones_like(x)
    acc = np.ones_like(x)
    for k in range(1, 41):
        term = term * half / k
        acc = acc + term * term
    return acc


def kaiser_lowpass_taps(num_taps: int, cutoff_norm: float,
                        stopband_db: float) -> np.ndarray:
    """Kaiser-windowed sinc lowpass, odd length, unit DC gain;
    ``cutoff_norm`` is the −6 dB cutoff as a fraction of fs."""
    m = max(num_taps, 3) | 1
    mid = m // 2
    fc = min(max(cutoff_norm, 1e-4), 0.4999)
    beta = kaiser_beta(stopband_db)
    i0b = bessel_i0(np.float64(beta))
    d = np.arange(m, dtype=np.float64) - mid
    ideal = np.where(d == 0, 2.0 * fc, np.sin(2.0 * np.pi * fc * d)
                     / np.where(d == 0, 1.0, np.pi * d))
    r = d / mid
    w = bessel_i0(beta * np.sqrt(np.maximum(1.0 - r * r, 0.0))) / i0b
    taps = ideal * w
    return (taps / taps.sum()).astype(np.float32)


def kaiser_transition_norm(num_taps: int, stopband_db: float) -> float:
    """Δf/fs ≈ (A − 8)/(14.36·M)."""
    m = float(max(num_taps, 3) | 1)
    return (max(stopband_db, 21.0) - 8.0) / (14.36 * m)


def kaiser_num_taps(transition_norm: float, stopband_db: float) -> int:
    """Odd tap count that reaches a transition width."""
    m = int(np.ceil((max(stopband_db, 21.0) - 8.0)
                    / (14.36 * max(transition_norm, 1e-4))))
    return max(m, 3) | 1


def group_delay(taps) -> int:
    return (len(taps) - 1) // 2


# ── filtering (torch) ────────────────────────────────────────────────────────

# At or above this many taps the FFT overlap-save path runs, below it the
# direct convolution. From chip_smoke.py's FIR sweep [20] over one DVB-T
# frame's stream on an NVIDIA H100 80GB HBM3 at 700 W: conv1d took 0.13-0.19
# ms at every count from 17 to 513 taps, the FFT path 0.31-0.66 ms; the
# FFT path keeps the longer filters.
_FFT_MIN_TAPS = 1025
_FFT_BLOCK = 65536


def _conv_direct(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """VALID correlation of (R, L) float32 rows with ``taps`` by conv1d:
    y[i] = Σ_j taps[j]·x[i + T − 1 − j]. TF32 off (cuDNN would otherwise
    round the operands to TF32 on the card)."""
    w = torch.as_tensor(np.ascontiguousarray(taps[::-1]),
                        device=x.device).reshape(1, 1, -1)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return torch.nn.functional.conv1d(x[:, None, :], w)[:, 0]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _fft_overlap_save(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """The same VALID correlation by FFT overlap-save: blocks of a power of
    two ≥ 4·T (``_FFT_BLOCK`` for long inputs), hop block − T + 1."""
    T = len(taps)
    L = x.shape[-1]
    n_out = L - (T - 1)
    block = min(_FFT_BLOCK, max(2048, 1 << int(np.ceil(np.log2(4 * T))),
                                1 << int(np.ceil(np.log2(max(L, 2))))))
    if block <= T:
        block = 1 << int(np.ceil(np.log2(2 * T)))
    hop = block - T + 1
    nblk = -(-n_out // hop)
    xb = torch.nn.functional.pad(x, (0, nblk * hop + T - 1 - L))
    blocks = xb.unfold(-1, block, hop)                 # (R, nblk, block)
    H = torch.fft.rfft(torch.as_tensor(np.ascontiguousarray(taps[::-1]),
                                       device=x.device), block)
    y = torch.fft.irfft(torch.fft.rfft(blocks, dim=-1) * H, block,
                        dim=-1)[..., T - 1:]
    return y.reshape(x.shape[0], -1)[:, :n_out].to(torch.float32)


def _conv_valid(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    if len(taps) >= _FFT_MIN_TAPS and x.shape[-1] >= len(taps):
        return _fft_overlap_save(x, taps)
    return _conv_direct(x, taps)


def fir_filter_aligned(x: torch.Tensor, taps) -> torch.Tensor:
    """Group-delay-compensated, same-length filtering with zero edge
    extension: output sample i is the filtered value of input sample i.
    ``x`` (..., n), real or complex, on any device."""
    taps = np.asarray(taps, np.float32)
    if len(taps) == 1:
        return x * float(taps[0])
    gd = group_delay(taps)
    n = x.shape[-1]
    lead = x.shape[:-1]
    cplx = x.is_complex()
    rows = (torch.cat([x.real.reshape(-1, n), x.imag.reshape(-1, n)])
            if cplx else x.reshape(-1, n)).to(torch.float32)
    # causal filter over [T − 1 zeros, x, gd zeros], then drop the delay
    xp = torch.nn.functional.pad(rows, (len(taps) - 1, gd))
    y = _conv_valid(xp, taps)[:, gd:gd + n]
    if cplx:
        half = y.shape[0] // 2
        y = torch.complex(y[:half], y[half:])
    return y.reshape(lead + (n,))
