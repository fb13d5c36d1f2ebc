"""Schmidl & Cox packet sync + integer-CFO training correlation (counterpart
of ``orion_sdr_tpu/sync/ofdm_sync.py``).

The repeated-segment base sequence and the training symbol's frequency
pattern come from fixed-seed xorshift64 generators, bit-exact with the JAX
package, so a frame from either package acquires on the other. The timing
metric's P(d)/R(d) are sliding-window sums of c[t] = conj(r[t])·r[t+L] and
|r[t+L]|² over (R−1)·L samples, taken as differences of cumulative sums on
the device (accumulated in float64, so a long stream buffer keeps its
precision).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..dsp.device import takes_host_data
from ..dsp.osc import rotate
from ..multicarrier import symbol_fft

_SEED_REPEAT = 0x4F46_444D_5052_4531
_SEED_TRAINING = 0x4F46_444D_5452_4E31


@dataclass(frozen=True)
class TrainingSymbol:
    n_fft: int
    cp_len: int

    def total_len(self) -> int:
        return self.n_fft + self.cp_len


@dataclass(frozen=True)
class OfdmPreamble:
    """num_repeats × repeat_len S&C repeats + optional training symbol."""
    num_repeats: int
    repeat_len: int
    training_symbol: Optional[TrainingSymbol] = None

    def with_training_symbol(self, n_fft: int, cp_len: int) -> "OfdmPreamble":
        return OfdmPreamble(self.num_repeats, self.repeat_len,
                            TrainingSymbol(n_fft, cp_len))

    def total_len(self) -> int:
        t = self.training_symbol.total_len() if self.training_symbol else 0
        return self.num_repeats * self.repeat_len + t


class OfdmSyncResult(NamedTuple):
    start_sample: int
    cfo_hz: float
    integer_cfo_bins: int
    score: float


def _xorshift64_signs(length: int, seed: int) -> np.ndarray:
    """±1 stream of xorshift64 sign draws: sign of
    (state as f32)/2^64 − 0.5, with the state in 64-bit arithmetic."""
    mask = (1 << 64) - 1
    state = seed
    out = np.empty(length, dtype=np.float32)
    for i in range(length):
        state = (state ^ (state << 13)) & mask
        state = (state ^ (state >> 7)) & mask
        state = (state ^ (state << 17)) & mask
        out[i] = 1.0 if (np.float32(state) / np.float32(2**64) - 0.5) >= 0.0 \
            else -1.0
    return out


def pseudo_random_unit_sequence(length: int, seed: int) -> np.ndarray:
    """Unit-average-energy QPSK-like sequence."""
    signs = _xorshift64_signs(2 * length, seed)
    s = np.float32(1.0 / np.sqrt(2.0))
    return (signs[0::2] * s + 1j * signs[1::2] * s).astype(np.complex64)


def training_symbol_freq_pattern(n_fft: int) -> np.ndarray:
    return pseudo_random_unit_sequence(n_fft, _SEED_TRAINING)


def generate_ofdm_preamble(preamble: OfdmPreamble) -> np.ndarray:
    """Time-domain preamble: tiled base sequence + (IFFT'd + CP) training
    symbol, complex64."""
    base = pseudo_random_unit_sequence(preamble.repeat_len, _SEED_REPEAT)
    parts = [np.tile(base, preamble.num_repeats)]
    if preamble.training_symbol is not None:
        t = preamble.training_symbol
        freq = training_symbol_freq_pattern(t.n_fft)
        time = np.fft.ifft(freq).astype(np.complex64)
        parts.append(np.concatenate([time[-t.cp_len:], time])
                     if t.cp_len else time)
    return np.concatenate(parts).astype(np.complex64)


def _sliding_sum(x: torch.Tensor, win: int) -> torch.Tensor:
    c = torch.cumsum(x, dim=-1)
    c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
    return c[..., win:] - c[..., :-win]


# scores this close to the top are a tie, taken at the earliest offset
# (orion_sdr_tpu/frame/demodulator.py's stream receiver, 1e-3)
_NEAR_TOP = 1e-3


@takes_host_data("iq")
def sc_metric(iq: torch.Tensor, repeat_len: int, num_repeats: int):
    """S&C correlation P(d) (complex) and window energy R(d) for every
    candidate offset d, each of length len(iq) − num_repeats·repeat_len + 1."""
    z = iq.to(torch.complex128)
    L = repeat_len
    W = (num_repeats - 1) * L
    p = _sliding_sum(torch.conj(z[..., :-L]) * z[..., L:], W)
    r = _sliding_sum(z[..., L:].abs() ** 2, W)
    return p.to(torch.complex64), r.to(torch.float32)


def sc_scores(iq: torch.Tensor, fs: float, preamble: OfdmPreamble,
              search_start: int = 0, search_end: Optional[int] = None):
    """Timing score and fractional CFO (Hz) for every offset from
    ``search_start`` on, as two tensors, or None when there is nothing to
    search. Score = |P|²/R² scaled by R/R_peak (the plateau tie-break), −1
    where the window holds no energy."""
    L, R = preamble.repeat_len, preamble.num_repeats
    if L == 0 or R < 2 or fs <= 0.0:
        return None
    n = iq.shape[-1]
    end = min(search_end if search_end is not None else n,
              max(n - preamble.total_len(), 0))
    if search_start >= end:
        return None
    p, r = sc_metric(iq, L, R)
    p = p[search_start:end]
    r = r[search_start:end]
    valid = r > 0.0
    score = torch.clamp(p.abs() ** 2 / torch.clamp(r * r, min=1e-30), 0.0, 1.0)
    score = torch.where(valid, score * (r / r.max()), -1.0)
    return score, torch.atan2(p.imag, p.real) / (2.0 * np.pi * L / fs)


def _with_integer_cfo(iq, fs, preamble, res: OfdmSyncResult) -> OfdmSyncResult:
    t = preamble.training_symbol
    if t is None:
        return res
    k = estimate_integer_cfo_bins(
        iq, fs, t, res.start_sample + preamble.repeat_len * preamble.num_repeats,
        res.cfo_hz)
    return res._replace(integer_cfo_bins=k)


@takes_host_data("iq")
def ofdm_sync(iq: torch.Tensor, fs: float, preamble: OfdmPreamble,
              search_start: int = 0, search_end: Optional[int] = None,
              max_candidates: int = 8) -> List[OfdmSyncResult]:
    """S&C acquisition over a 1-D IQ tensor; returns candidates sorted by
    score (see :func:`sc_scores`), the integer CFO from the training symbol
    for the top 5."""
    sc = sc_scores(iq, fs, preamble, search_start, search_end)
    if sc is None:
        return []
    score, cfo = sc
    top = torch.topk(score, min(max_candidates, score.shape[0]))
    results = [OfdmSyncResult(start_sample=int(d + search_start),
                              cfo_hz=float(f), integer_cfo_bins=0,
                              score=float(s))
               for s, d, f in zip(top.values.tolist(), top.indices.tolist(),
                                  cfo[top.indices].tolist()) if s >= 0]
    return [_with_integer_cfo(iq, fs, preamble, r) if i < 5 else r
            for i, r in enumerate(results)]


def first_preamble(iq: torch.Tensor, fs: float, preamble: OfdmPreamble,
                   threshold: float) -> Optional[OfdmSyncResult]:
    """The EARLIEST preamble whose score reaches ``threshold``: within one
    preamble span after the first offset at or above it, the earliest
    offset whose score is within ``_NEAR_TOP`` of that span's peak (the JAX
    receiver's rule among near-equal top scores), with its fractional and
    integer CFO; None if no offset reaches it.

    A streaming receiver must take frames in order. The best-scoring
    candidate of :func:`ofdm_sync` can belong to a later frame when two
    preambles share the buffer, and decoding that one first would drain the
    earlier frame with it. Within one preamble the metric's plateau can
    peak a sample late, where the integer-CFO search on the training symbol
    goes wrong; the earliest near-top offset is where the JAX receiver
    decodes."""
    sc = sc_scores(iq, fs, preamble)
    if sc is None:
        return None
    score, cfo = sc
    above = torch.nonzero(score >= threshold)
    if above.shape[0] == 0:
        return None
    first = int(above[0, 0])
    span = preamble.repeat_len * preamble.num_repeats
    window = score[first:first + span]
    near = torch.nonzero(window >= window.max() - _NEAR_TOP)
    d = first + int(near[0, 0])
    return _with_integer_cfo(iq, fs, preamble, OfdmSyncResult(
        start_sample=d, cfo_hz=float(cfo[d]), integer_cfo_bins=0,
        score=float(score[d])))


@takes_host_data("iq")
def estimate_integer_cfo_bins(iq: torch.Tensor, fs: float,
                              training: TrainingSymbol, training_start: int,
                              fractional_cfo_hz: float) -> int:
    """Circular bin-shift search on the training symbol: the argmax of the
    circular cross-correlation against the known pattern, as a signed bin
    shift in −n/2..=n/2."""
    total = training.total_len()
    if training_start + total > iq.shape[-1]:
        return 0
    raw = iq[training_start:training_start + total]
    corrected, _ = rotate(raw, np.float32(-fractional_cfo_hz), fs)
    freq = symbol_fft(corrected, training.n_fft, training.cp_len)[0]
    known = torch.as_tensor(training_symbol_freq_pattern(training.n_fft),
                            device=iq.device)
    x = torch.fft.ifft(torch.fft.fft(freq.to(torch.complex128))
                       * torch.conj(torch.fft.fft(known.to(torch.complex128))))
    n = training.n_fft
    best = int(torch.argmax(x.abs() ** 2))
    return best if best <= n // 2 else best - n
