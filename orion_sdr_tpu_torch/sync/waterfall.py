"""Symbol-rate magnitude spectrogram ("waterfall") for FT8/FT4 sync
(counterpart of ``orion_sdr_tpu/sync/waterfall.py``; behavioral spec:
sync/waterfall.rs).

The reference runs a Goertzel correlator per (symbol, tone). Here the whole
grid is one complex64 product: the capture is reshaped to (num_syms, sps)
and multiplied by the (sps, num_tones) tone-phasor matrix
W[i, k] = exp(−j2π·f_k·i/fs) (built in complex128 on the host, then rounded
to complex64, as in the JAX package). Log-power output matches the
reference: ln(|acc|² + 1e−12), with out-of-buffer symbols left at 0.0 (safe
for max-log scoring).

The product is ``torch.matmul`` in complex64 with TF32 off
(:func:`~orion_sdr_tpu_torch.dsp.device.full_f32`), as for the DVB-T pilot
GEMMs: with TF32 the tone phasors and samples would carry 10-bit mantissas,
and the log-powers that rank the Costas candidates would move by ~1e-3.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..dsp.device import full_f32, takes_host_data


@lru_cache(maxsize=64)
def _tone_matrix(fs: float, base_hz: float, tone_spacing_hz: float,
                 sps: int, num_tones: int) -> np.ndarray:
    i = np.arange(sps, dtype=np.float64)[:, None]
    f = base_hz + (np.arange(num_tones, dtype=np.float64)[None, :]
                   * tone_spacing_hz)
    return np.exp(-2j * np.pi * f * i / fs).astype(np.complex64)


_W: dict = {}


def tone_matrix(fs: float, base_hz: float, tone_spacing_hz: float, sps: int,
                num_tones: int, device) -> torch.Tensor:
    """:func:`_tone_matrix` as a complex64 tensor on ``device``, kept."""
    key = (float(fs), float(base_hz), float(tone_spacing_hz), int(sps),
           int(num_tones), torch.device(device))
    w = _W.get(key)
    if w is None:
        w = _W[key] = torch.as_tensor(_tone_matrix(*key[:5]), device=device)
    return w


@takes_host_data("iq")
def compute_waterfall(iq: torch.Tensor, fs: float, base_hz: float,
                      tone_spacing_hz: float, samples_per_sym: int,
                      num_syms: int, num_tones: int, time_offset: int = 0):
    """(..., num_syms, num_tones) float32 log-power grid on ``iq``'s device;
    symbol s correlates IQ samples [time_offset + s·sps, +sps) against each
    tone phasor."""
    z = iq.to(torch.complex64)
    n = z.shape[-1]
    need = time_offset + num_syms * samples_per_sym
    # Zero-pad the tail: a partial final symbol correlates over what exists,
    # fully-missing symbols get |0|² → ln(1e−12); the reference leaves those
    # rows at 0.0, so mark fully-missing rows 0.0 afterwards.
    if need > n:
        z = torch.cat([z, z.new_zeros(z.shape[:-1] + (need - n,))], dim=-1)
    z = z[..., time_offset:need]
    seg = z.reshape(z.shape[:-1] + (num_syms, samples_per_sym))
    w = tone_matrix(fs, base_hz, tone_spacing_hz, samples_per_sym, num_tones,
                    z.device)
    with full_f32():
        acc = seg @ w                               # (…, num_syms, num_tones)
    mag = torch.log(acc.abs() ** 2 + 1e-12).to(torch.float32)
    # symbols that start at or past the end of the buffer: a suffix of rows
    first_missing = min(max(-(-(n - time_offset) // samples_per_sym), 0),
                        num_syms)
    mag[..., first_missing:, :] = 0.0
    return mag
