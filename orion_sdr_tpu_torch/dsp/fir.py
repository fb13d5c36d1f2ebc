"""FIR design and application (counterpart of ``orion_sdr_tpu/dsp/fir.py``;
behavioral spec: dsp/fir.rs, dsp/decim.rs).

The design functions run in numpy and give constant float32 taps. Filtering
runs on the input tensor's device: a direct ``conv1d`` for short taps and
an FFT overlap-save for long ones (``_FFT_MIN_TAPS``); the two agree within
float32 rounding. The streaming forms carry the input tail (the last
``ntaps − 1`` samples) as their state.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import full_f32, on_device

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


def fir_lowpass_design(fs: float, pass_hz: float,
                       trans_hz: float) -> np.ndarray:
    """Sinc + Hann lowpass, unit DC gain (dsp/fir.rs:14-45)."""
    pass_hz = max(pass_hz, 10.0)
    trans_hz = max(trans_hz, pass_hz * 0.2)
    ntaps = max(int(np.ceil(fs / trans_hz)), 31) | 1
    fc = pass_hz / fs
    m = np.arange(ntaps) - ntaps // 2
    sinc = np.where(m == 0, 2.0 * fc,
                    (2.0 * fc) * np.sin(2.0 * np.pi * fc * m)
                    / np.where(m == 0, 1.0, np.pi * m))
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(ntaps) / (ntaps - 1.0))
    taps = sinc * w
    return (taps / taps.sum()).astype(np.float32)


def half_cosine_taps(sps: int) -> np.ndarray:
    """Unit-energy Hann matched-filter taps for PSK31 (dsp/fir.rs:317-340)."""
    if sps <= 1:
        return np.ones(max(sps, 1), dtype=np.float32)
    h = 0.5 - 0.5 * np.cos(np.pi * np.arange(sps) / (sps - 1.0))
    return (h / np.sqrt((h * h).sum())).astype(np.float32)


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


def conv1d_f32(rows: torch.Tensor, w: torch.Tensor,
               stride: int = 1) -> torch.Tensor:
    """``conv1d`` (a correlation) of (R, L) float32 rows with (C, 1, K)
    kernels → (R, C, L_out), TF32 off (cuDNN would otherwise round the
    operands to TF32 on the card)."""
    with full_f32():
        return torch.nn.functional.conv1d(rows[:, None, :], w, stride=stride)


def _conv_direct(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """VALID correlation of (R, L) float32 rows with ``taps`` by conv1d:
    y[i] = Σ_j taps[j]·x[i + T − 1 − j]."""
    w = torch.as_tensor(np.ascontiguousarray(taps[::-1]),
                        device=x.device).reshape(1, 1, -1)
    return conv1d_f32(x, w)[:, 0]


def _fft_overlap_save(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """The same VALID correlation by FFT overlap-save: blocks of a power of
    two ≥ 4·T (``_FFT_BLOCK`` for long inputs), hop block − T + 1. ``taps``
    (T,) for every row, or (R, T): one kernel a row."""
    T = taps.shape[-1]
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
    H = torch.fft.rfft(torch.as_tensor(
        np.ascontiguousarray(taps[..., ::-1]), device=x.device), block)
    if H.dim() == 2:
        H = H[:, None, :]                              # (R, 1, nf)
    y = torch.fft.irfft(torch.fft.rfft(blocks, dim=-1) * H, block,
                        dim=-1)[..., T - 1:]
    return y.reshape(x.shape[0], -1)[:, :n_out].to(torch.float32)


def _conv_valid(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    if len(taps) >= _FFT_MIN_TAPS and x.shape[-1] >= len(taps):
        return _fft_overlap_save(x, taps)
    return _conv_direct(x, taps)


def fir_filter_aligned(x, taps, device=None) -> torch.Tensor:
    """Group-delay-compensated, same-length filtering with zero edge
    extension: output sample i is the filtered value of input sample i.
    ``x`` (..., n), real or complex: a tensor is filtered on its device,
    host data on ``device`` (None: the card)."""
    x = on_device(x, device)
    taps = np.asarray(taps, np.float32)
    if len(taps) == 1:
        return x * float(taps[0])
    gd = group_delay(taps)
    n = x.shape[-1]
    rows, how = to_rows(x)
    # causal filter over [T − 1 zeros, x, gd zeros], then drop the delay
    xp = torch.nn.functional.pad(rows, (len(taps) - 1, gd))
    return from_rows(_conv_valid(xp, taps)[:, gd:gd + n], how)


def to_rows(x: torch.Tensor):
    """(..., n) real or complex → ((R, n) float32 rows, how to undo it):
    a complex tensor rides as its real rows then its imaginary rows."""
    n = x.shape[-1]
    if x.is_complex():
        return torch.cat([x.real.reshape(-1, n), x.imag.reshape(-1, n)]
                         ).to(torch.float32), (x.shape[:-1], True)
    return x.reshape(-1, n).to(torch.float32), (x.shape[:-1], False)


def from_rows(y: torch.Tensor, how) -> torch.Tensor:
    lead, cplx = how
    if cplx:
        half = y.shape[0] // 2
        y = torch.complex(y[:half], y[half:])
    return y.reshape(tuple(lead) + (y.shape[-1],))


def _causal_conv(x: torch.Tensor, taps, state=None):
    """Causal FIR with explicit tail state. Returns (y, new_state)."""
    taps = np.asarray(taps, np.float32)
    ntaps = len(taps)
    if ntaps == 1:
        y = x * float(taps[0])
        return y, (state if state is not None else
                   x.new_zeros(x.shape[:-1] + (0,)))
    if state is None:
        state = x.new_zeros(x.shape[:-1] + (ntaps - 1,))
    xp = torch.cat([state.to(x.dtype), x], dim=-1)
    rows, how = to_rows(xp)
    y = from_rows(_conv_valid(rows, taps), how)
    return y, xp[..., xp.shape[-1] - (ntaps - 1):]


def fir_apply(x, taps, state=None, device=None):
    """Streaming causal FIR: the output lags the input by
    ``group_delay(taps)`` (FirLowpass(Iq)::process / push, dsp/fir.rs:47-67,
    229-257). Returns (y, state), the state being the carried input
    tail. Host data runs on ``device`` (None: the card)."""
    x = on_device(x, device)
    return _causal_conv(x, taps, None if state is None
                        else on_device(state, x.device))


def fir_decimate(x, taps, m: int, state=None, device=None):
    """Lowpass, then every m-th sample from phase 0 (FirDecimator,
    dsp/decim.rs:10-77). Returns (y, state)."""
    y, state = fir_apply(x, taps, state, device)
    return y[..., ::m], state


def fir_filter_aligned_bank(pairs, device=None):
    """Aligned same-length filtering of several signals, each with its own
    odd-length taps, in one overlap-save call: ``pairs`` is a list of
    (x (..., n), taps); returns the filtered signals, each
    ``fir_filter_aligned(x, taps)`` up to FFT rounding. Complex signals
    ride as two real channels. Host data goes to ``device`` (None: the
    first tensor's device, else the card)."""
    if device is None:
        device = next((x.device for x, _ in pairs
                       if isinstance(x, torch.Tensor)), None)
    pairs = [(on_device(x, device), t) for x, t in pairs]
    taps = [np.asarray(t, np.float32) for _, t in pairs]
    gds = [group_delay(t) for t in taps]
    G = max(gds)
    L = max(len(t) - 1 - gd for t, gd in zip(taps, gds))
    K = G + L + 1
    chans, kerns, hows = [], [], []
    for (x, _), t, gd in zip(pairs, taps, gds):
        # aligned y[i] = Σ_j t[j]·x[i+gd−j]: a VALID correlation of x padded
        # by G on the left and L on the right with w[G+gd−j] = t[j]
        w = np.zeros(K, np.float32)
        w[G + gd - np.arange(len(t))] = t
        rows, how = to_rows(x)
        chans.append(rows)
        kerns.append(np.broadcast_to(w, (rows.shape[0], K)))
        hows.append((how, rows.shape[0]))
    X = torch.nn.functional.pad(torch.cat(chans), (G, L))
    Y = _fft_overlap_save(X, np.ascontiguousarray(np.concatenate(kerns)))
    out, r0 = [], 0
    for how, rows in hows:
        out.append(from_rows(Y[r0:r0 + rows], how))
        r0 += rows
    return out


def convolve(x: torch.Tensor, taps, mode: str = "same") -> torch.Tensor:
    """Row-wise ``numpy.convolve(x, taps, mode)`` (``jnp.convolve``'s
    flipping and centring) of (..., n) real or complex rows with real taps:
    ``same`` keeps n samples from index (T−1)//2 of the full convolution,
    ``valid`` the n − T + 1 where the taps lie inside the row."""
    taps = np.asarray(taps, np.float32)
    T = len(taps)
    rows, how = to_rows(x)
    # convolution = correlation with the reversed taps
    if mode == "same":
        rows = torch.nn.functional.pad(rows, (T - 1 - (T - 1) // 2,
                                              (T - 1) // 2))
    elif mode != "valid":
        raise ValueError(f"mode {mode!r}")
    return from_rows(_conv_valid(rows, taps), how)
