"""PSK31 demodulators (counterpart of ``orion_sdr_tpu/demodulate/psk31.py``;
behavioral spec: demodulate/psk31.rs).

Decision-feedback matched filtering over the whole symbol with a
first-order decision-directed PLL (AFC, K = 0.05) at each symbol boundary.
The reference's per-sample feedback is linear in the previous symbol, so a
symbol's integral collapses to
    sym = (⟨h, s_k⟩ − prev_sym·Σh(1−h))·gain / Σh²,
and ⟨h, s_k⟩ for every symbol is one ``torch.matmul`` of the (…, n_syms,
sps) capture against the Hann window (float32, TF32 off). The per-symbol
PLL recurrence runs through the hand-written kernel ``ops/psk31_pll.py``
(one row a thread on the card; its plain version on the CPU). Entry
points take host data or a tensor and ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..dsp.device import full_f32, takes_host_data, to_device
from ..dsp.fir import convolve
from ..dsp.osc import rotate
from ..modulate.psk31 import PSK31_BAUD, psk31_hann, psk31_sps
from ..ops.psk31_pll import psk31_pll

BPSK31_LOOP_GAIN = 0.05
QPSK31_LOOP_GAIN = 0.05


_H: dict = {}


@takes_host_data("d_re")
def hard_decide_dbpsk(d_re: torch.Tensor) -> torch.Tensor:
    """±1.0 by the sign of the differential real component."""
    return torch.where(d_re >= 0.0, 1.0, -1.0).to(torch.float32)


@takes_host_data("d_re", "d_im")
def hard_decide_dqpsk(d_re: torch.Tensor, d_im: torch.Tensor):
    """The nearest unit-axis phasor, (±1, 0) or (0, ±1), as (re, im)."""
    re_wins = d_re.abs() >= d_im.abs()
    one = torch.ones_like(d_re, dtype=torch.float32)
    zero = torch.zeros_like(one)
    dec_re = torch.where(re_wins, torch.where(d_re >= 0.0, one, -one), zero)
    dec_im = torch.where(re_wins, zero, torch.where(d_im >= 0.0, one, -one))
    return dec_re, dec_im


def _hann(sps: int, device) -> torch.Tensor:
    key = (sps, torch.device(device))
    h = _H.get(key)
    if h is None:
        h = _H[key] = torch.as_tensor(psk31_hann(sps), device=device)
    return h


def pll_constants(sps: int, gain: float):
    """float32 (c_fb = Σh(1−h), scale = gain/Σh²) of the Hann window, summed
    in float32 on the host."""
    h = torch.as_tensor(psk31_hann(sps))
    c_fb = torch.sum(h * (1.0 - h))
    scale = float(np.float32(gain)) / torch.sum(h * h)
    return np.float32(c_fb.item()), np.float32(scale.item())


def matched_filter_dots(seg: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(..., n_syms, sps) complex64 → (..., n_syms) complex64 ⟨h, s_k⟩: one
    real matmul of the (…, n_syms, 2, sps) view against h, TF32 off."""
    ri = torch.view_as_real(seg).transpose(-1, -2)          # (…, 2, sps)
    with full_f32():
        dots = torch.matmul(ri, h)                           # (…, n_syms, 2)
    return torch.view_as_complex(dots.contiguous())


def _dfm_core(z: torch.Tensor, sps: int, gain: float, qpsk: bool,
              prev_sym0=1.0 + 0.0j, phase_acc0=0.0):
    """Decision-feedback matched filter + PLL over (..., n) complex64
    baseband (n a multiple of sps). Returns (soft, (prev_sym, phase_acc)):
    soft (..., n_syms) for BPSK or (..., n_syms, 2) for QPSK."""
    seg = z.reshape(z.shape[:-1] + (-1, sps))
    dots = matched_filter_dots(seg, _hann(sps, z.device))
    c_fb, scale = pll_constants(sps, gain)
    lead = dots.shape[:-1]
    prev = torch.broadcast_to(torch.as_tensor(
        prev_sym0, dtype=torch.complex64, device=z.device), lead)
    acc = torch.broadcast_to(torch.as_tensor(
        phase_acc0, dtype=torch.float32, device=z.device), lead)
    loop_gain = QPSK31_LOOP_GAIN if qpsk else BPSK31_LOOP_GAIN
    soft, prev_out, acc_out = psk31_pll(dots, prev, acc, c_fb, scale,
                                        loop_gain, qpsk)
    return soft, (prev_out, acc_out)


def _prep(iq, fs: float, rf_hz: float, offset: int, device):
    """Down-mix and trim to whole symbols from the symbol boundary implied
    by ``offset`` samples already consumed (ref new_with_offset)."""
    sps = psk31_sps(fs)
    z = to_device(iq, device, torch.complex64)
    if rf_hz != 0.0:
        z, _ = rotate(z, -rf_hz, fs)
    lead = (sps - (offset % sps)) % sps
    n_syms = max((z.shape[-1] - lead) // sps, 0)
    return z[..., lead:lead + n_syms * sps], sps, n_syms


def bpsk31_demod(iq, fs: float, rf_hz: float = 0.0, gain: float = 1.0,
                 offset: int = 0, device="cuda") -> torch.Tensor:
    """IQ → one soft value a symbol, Re(sym_c·conj(prev_sym)): positive ⇒
    bit 1 (no phase change), negative ⇒ bit 0."""
    z, sps, n_syms = _prep(iq, fs, rf_hz, offset, device)
    if n_syms == 0:
        return torch.zeros(z.shape[:-1] + (0,), dtype=torch.float32,
                           device=z.device)
    soft, _ = _dfm_core(z, sps, gain, qpsk=False)
    return soft


def qpsk31_demod(iq, fs: float, rf_hz: float = 0.0, gain: float = 1.0,
                 offset: int = 0, device="cuda") -> torch.Tensor:
    """IQ → (..., n_syms, 2) float32 [Re(d), Im(d)] differential products
    for the Viterbi MLSE (ref Qpsk31Demod)."""
    z, sps, n_syms = _prep(iq, fs, rf_hz, offset, device)
    if n_syms == 0:
        return torch.zeros(z.shape[:-1] + (0, 2), dtype=torch.float32,
                           device=z.device)
    soft, _ = _dfm_core(z, sps, gain, qpsk=True)
    return soft


def bpsk31_decide(soft) -> np.ndarray:
    """Hard decision: soft ≥ 0 → bit 1 (ref Bpsk31Decider); host uint8."""
    if isinstance(soft, torch.Tensor):
        soft = soft.cpu().numpy()
    return (np.asarray(soft) >= 0.0).astype(np.uint8)


def fftfreq(n: int, d: float, device) -> torch.Tensor:
    """float32 FFT bin frequencies, formed as ``jnp.fft.fftfreq`` forms them
    (integer bin index over the float32 of d·n)."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    k = torch.remainder(i + n // 2, n) - n // 2
    return k / float(np.float32(d * n))


def _roll_rows(zb: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Row r rolled left by starts[r] (``jnp.roll(row, −start)``)."""
    n = zb.shape[-1]
    idx = (torch.arange(n, device=zb.device)[None, :]
           + starts.to(torch.int64)[:, None]) % n
    return torch.gather(zb, 1, idx)


def psk31_refine_carriers(iq, fs: float, carriers_hz, qpsk: bool = False,
                          starts=None, length: int = 0,
                          max_df_hz: float = 0.0, device="cuda"):
    """Refine bin-granular carrier estimates to FFT resolution: squaring
    strips BPSK's modulation (z⁴ for QPSK), leaving a line at 2·Δf; one
    batched FFT of the mixed-down rows finds it, a 3-point parabola on the
    FFT ring gives the sub-bin offset. ``starts`` (K,) with ``length``
    restricts each row to its detected run (rolled to the run start,
    truncated), and a Hann matched-filter lowpass precedes the squaring.
    ``max_df_hz`` bounds the searched offset (p·max_df_hz); by default
    ±1.12·baud·p/2. Returns (K,) float32 refined carriers."""
    z = to_device(iq, device, torch.complex64)
    f = to_device(carriers_hz, z.device, torch.float32).reshape(-1)
    zb, _ = rotate(z[None, :], -f[:, None], fs)
    if starts is not None:
        zb = _roll_rows(zb, to_device(starts, z.device).reshape(-1))
    if length and length < zb.shape[-1]:
        zb = zb[:, :length]
    zb = convolve(zb, psk31_hann(psk31_sps(fs)), "same")
    w = zb * zb
    p = 2
    if qpsk:
        w = w * w
        p = 4
    S = torch.fft.fft(w, dim=-1).abs()
    nfft = w.shape[-1]
    freqs = fftfreq(nfft, 1.0 / fs, z.device)
    lim = p * max_df_hz if max_df_hz > 0.0 else PSK31_BAUD * (p / 2) * 1.12
    Sm = torch.where(freqs.abs()[None, :] <= lim, S, -1.0)
    idx = torch.argmax(Sm, dim=-1, keepdim=True)
    sl = torch.gather(S, 1, (idx - 1) % nfft)[:, 0]
    sp = torch.gather(S, 1, idx)[:, 0]
    sr = torch.gather(S, 1, (idx + 1) % nfft)[:, 0]
    den = sl - 2.0 * sp + sr
    delta = torch.where(den.abs() > 1e-20, 0.5 * (sl - sr) / den, 0.0)
    delta = torch.clamp(delta, -0.5, 0.5)
    df = (freqs[idx[:, 0]] + delta * (fs / nfft)) / p
    return f + df


def psk31_demod_multi(iq, fs: float, carriers_hz, gain: float = 1.0,
                      qpsk: bool = False, starts=None, device="cuda"):
    """Demodulate one capture against K carriers at once: the mix is a
    broadcast phase ramp (K, n); each carrier's symbol timing comes from
    the matched-filter output energy folded to the symbol cadence (argmax
    over the sps offsets); the matched filter is one batched matmul and the
    K PLL recurrences one kernel launch. ``starts`` (K,) rolls each row to
    its detected run start. Returns ((K, n_syms) soft (BPSK) or (K, n_syms,
    2) (QPSK), (K,) int32 sample offsets)."""
    z = to_device(iq, device, torch.complex64)
    sps = psk31_sps(fs)
    f = to_device(carriers_hz, z.device, torch.float32).reshape(-1)
    K = f.shape[0]
    n = z.shape[-1]
    n_syms = (n - sps) // sps if n >= 2 * sps else 0
    if n_syms == 0:
        shape = (K, 0, 2) if qpsk else (K, 0)
        return (torch.zeros(shape, dtype=torch.float32, device=z.device),
                torch.zeros((K,), dtype=torch.int32, device=z.device))
    zb, _ = rotate(z[None, :], -f[:, None], fs)               # (K, n)
    if starts is not None:
        zb = _roll_rows(zb, to_device(starts, z.device).reshape(-1))
    h = psk31_hann(sps)
    # timing: Σ_k |⟨h, z[o + k·sps : +sps]⟩|² peaks at the true boundary
    mf = convolve(zb, h[::-1].copy(), "valid")
    m = (mf.shape[-1] // sps) * sps
    e = mf[:, :m].abs() ** 2
    off = torch.argmax(e.reshape(K, -1, sps).sum(dim=1), dim=-1)   # (K,)
    take = n_syms * sps
    idx = off[:, None] + torch.arange(take, device=z.device)[None, :]
    zal = torch.gather(zb, 1, idx)
    soft, _ = _dfm_core(zal, sps, gain, qpsk=qpsk)
    return soft, off.to(torch.int32)


@takes_host_data("z")
def stream_step(z: torch.Tensor, phase0, prev_sym, phase_acc, sps: int,
                gain: float, qpsk: bool, carrier_hz: float, fs: float):
    """One whole-symbol chunk of the live decode: carries the down-mix
    phase and the PLL state across feeds. Returns (soft, prev_sym,
    phase_acc)."""
    if carrier_hz != 0.0:
        z, _ = rotate(z, -carrier_hz, fs, phase0)
    soft, (prev_out, acc_out) = _dfm_core(z, sps, gain, qpsk=qpsk,
                                          prev_sym0=prev_sym,
                                          phase_acc0=phase_acc)
    return soft, prev_out, acc_out
