"""Single-carrier digital demod stages and the burst receiver (counterpart
of ``orion_sdr_tpu/demodulate/digital.py``; behavioral spec:
demodulate/{bpsk,qpsk,qam}.rs).

IQ → ``psk_qam_demod`` (carrier removal and gain) → soft symbols →
``decide`` / ``soft_llr``. Beyond the reference: a blind M-th-power CFO
estimate, SC-FDE equalization (torch.fft), Gardner timing recovery and the
decision-directed carrier PLL (the hand-written kernels
``ops/gardner.py`` and ``ops/dd_pll.py``), polyphase-energy timing, and
the burst receiver, whose preamble search and phase-ramp fit run on the
host as in the JAX package. Every entry point takes host data or a tensor
and ``device`` (default ``"cuda"``), and returns tensors on it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constellation import decide
from ..dsp.device import to_device
from ..dsp.fir import fir_filter_aligned
from ..dsp.osc import rotate
from ..modulate.digital import rrc_taps
from ..ops.dd_pll import dd_pll
from ..ops.gardner import gardner


def psk_qam_demod(iq, fs, rf_hz=0.0, gain=1.0, phase0=0.0, device="cuda"):
    """Carrier removal and gain: soft symbol passthrough (BpskDemod etc.).
    Returns (soft_symbols, phase_out)."""
    z = to_device(iq, device, torch.complex64)
    if rf_hz != 0.0:
        z, phase0 = rotate(z, -rf_hz, fs, phase0)
    return (z * gain).to(torch.complex64), phase0


def digital_demod(iq, order, fs, rf_hz=0.0, gain=1.0, phase0=0.0,
                  device="cuda"):
    """IQ → hard bits in one call. Returns (bits, phase_out)."""
    soft, phase = psk_qam_demod(iq, fs, rf_hz, gain, phase0, device)
    return decide(soft, order), phase


def _ipow(z: torch.Tensor, m: int) -> torch.Tensor:
    """z**m (m ≥ 1) by repeated squaring in the order of
    ``lax.integer_pow``."""
    acc = None
    while m > 0:
        if m & 1:
            acc = z if acc is None else acc * z
        m >>= 1
        if m > 0:
            z = z * z
    return acc


def estimate_cfo_mpsk(iq, fs: float, m: int = 4, device="cuda") -> float:
    """Blind carrier-offset estimate for M-PSK bursts: z^M wipes the
    modulation and leaves a tone at M·CFO, read from the phase of the
    delay-conjugate sum. Capture range ±fs/(2M)."""
    z = _ipow(to_device(iq, device, torch.complex64), int(m))
    prod = (z[..., 1:] * torch.conj(z[..., :-1])).sum(-1)
    ang = float(torch.atan2(prod.imag, prod.real))
    return ang * fs / (2.0 * np.pi * m)


def fde_equalize(iq, training, block: int = 256, noise_var: float = 1e-3,
                 device="cuda") -> torch.Tensor:
    """Single-carrier frequency-domain MMSE equalization (SC-FDE): the
    channel from the per-block spectral ratio against a known ``training``
    burst at the capture start, then the MMSE inverse applied overlap-save
    with 50 % overlap. Returns the equalized capture (same length, training
    included)."""
    t = to_device(training, device, torch.complex64)
    z = to_device(iq, device, torch.complex64)
    n_t = t.shape[-1]
    if n_t < 8 or z.shape[-1] < n_t:
        raise ValueError("training must be ≥8 samples and fit the capture")
    L = min(block, 1 << int(np.floor(np.log2(n_t))))
    nb_t = n_t // L
    rf = torch.fft.fft(z[: nb_t * L].reshape(nb_t, L), dim=-1)
    tf = torch.fft.fft(t[: nb_t * L].reshape(nb_t, L), dim=-1)
    h = ((rf * torch.conj(tf)).sum(0)
         / ((tf.real ** 2 + tf.imag ** 2).sum(0) + 1e-9))
    w = torch.conj(h) / ((h.real ** 2 + h.imag ** 2) + noise_var)
    n = z.shape[-1]
    hop = L // 2
    nblk = -(-(n - L) // hop) + 1 if n > L else 1
    total = (nblk - 1) * hop + L
    blocks = torch.nn.functional.pad(z, (0, total - n)).unfold(0, L, hop)
    eq = torch.fft.ifft(torch.fft.fft(blocks, dim=-1) * w, dim=-1)
    q = L // 4
    out = torch.cat([eq[0, :q], eq[:, q:q + hop].reshape(-1),
                     eq[-1, q + hop:]])
    return out[:n].to(torch.complex64)


def symbol_sync_gardner(x, sps: float, n_out: int, loop_bw: float = 0.02,
                        mu0: float = 0.0, device="cuda"):
    """Gardner timing recovery: fractional-delay symbol sampling driven by
    the mid-symbol error e = Re[(y_k − y_{k−1})·conj(y_mid)], on
    (..., n) samples, each row its own loop (one kernel launch for all).
    Returns (symbols (..., n_out), final positions (...,))."""
    return gardner(to_device(x, device, torch.complex64), float(sps),
                   int(n_out), float(loop_bw), float(mu0))


def symbol_sync_energy(x, sps: int, device="cuda"):
    """Burst timing by polyphase energy: after matched filtering the RRC
    symbol peaks concentrate energy in one of the sps sample phases — pick
    it and sample there. Returns (symbols normalized to unit RMS, phase
    index)."""
    z = to_device(x, device, torch.complex64)
    n = (z.shape[-1] // sps) * sps
    grid = z[:n].reshape(-1, sps)
    ph = int(torch.argmax((grid.real ** 2 + grid.imag ** 2).mean(0)))
    syms = grid[:, ph]
    rms = torch.sqrt((syms.real ** 2 + syms.imag ** 2).mean()) + 1e-12
    return torch.complex(syms.real / rms, syms.imag / rms), ph


def carrier_sync_dd(syms, order: str, loop_bw: float = 0.03,
                    device="cuda") -> torch.Tensor:
    """Decision-directed carrier phase/frequency PLL over recovered symbols
    (error = the angle of y against its nearest constellation point), on
    (..., n) symbols, each row its own loop (one kernel launch for all).
    Returns the derotated symbols."""
    return dd_pll(to_device(syms, device, torch.complex64), order,
                  float(loop_bw))


def burst_demod(iq, order: str, sps: int, preamble_syms, beta: float = 0.35,
                span: int = 8, cfo_sps_max: float = 0.01, device="cuda"):
    """Single-carrier burst receiver: matched RRC → polyphase-energy symbol
    timing → CFO-tolerant segmented preamble search → data-aided
    phase-ramp fit on the known preamble (absolute phase and residual CFO)
    → light DD tracking over the payload → bits. The burst must begin with
    ``preamble_syms`` (see modulate.digital.burst_preamble). Returns (bits,
    payload symbols) on ``device``."""
    z = to_device(iq, device, torch.complex64)
    zf = fir_filter_aligned(z, rrc_taps(sps, beta, span))
    if int(zf.shape[-1] / sps) - span < len(preamble_syms) + 4:
        raise ValueError("burst too short for the preamble")
    syms_d, _ph = symbol_sync_energy(zf, sps, device)
    syms = syms_d.cpu().numpy()
    # the preamble by sub-block correlations summed by magnitude (each
    # 8-symbol block decoheres alone, so a CFO ramp that nulls the
    # full-length correlation still peaks here)
    pre = np.asarray(preamble_syms, np.complex64)
    nb = max(len(pre) // 8, 1)
    blk = len(pre) // nb
    corr = None
    for b in range(nb):
        c = np.abs(np.correlate(syms[b * blk:], pre[b * blk:(b + 1) * blk],
                                mode="valid"))
        c = c[:len(syms) - len(pre) + 1]
        corr = c if corr is None else corr[:len(c)] + c
    k = int(np.argmax(corr))
    # a phase-ramp fit on the known preamble pins the residual CFO and the
    # absolute phase (no 90°·k ambiguity left for dense QAM's DD loop)
    seg = syms[k: k + len(pre)]
    dphi = np.unwrap(np.angle(seg * np.conj(pre)))
    slope, intercept = np.polyfit(np.arange(len(pre)), dphi, 1)
    idx = np.arange(len(syms)) - k
    syms = syms * np.exp(-1j * (intercept + slope * idx))
    # light DD tracking over the payload only
    payload = carrier_sync_dd(syms[k + len(pre):].astype(np.complex64),
                              order, loop_bw=0.01, device=device)
    return decide(payload, order).reshape(-1), payload
