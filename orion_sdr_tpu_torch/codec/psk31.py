"""QPSK31 rate-1/2 K=5 convolutional code and Viterbi MLSE (counterpart of
``orion_sdr_tpu/codec/psk31.py``; behavioral spec: codec/psk31.rs).

G0 = 0o25 = 0b10101, G1 = 0o23 = 0b10011. For input x[n] the coded pair is
    g0[n] = x[n] ^ x[n-2] ^ x[n-4]
    g1[n] = x[n] ^ x[n-3] ^ x[n-4]
(no tail: PSK31 is a continuous stream). The trellis has 16 states (the 4
most recent inputs, newest at bit 3).

The encoder is a shift-XOR in numpy. The batch decoders
(:func:`viterbi_decode`, :func:`viterbi_decode_coherent`) decode every row
of the leading axes in one launch of the kernel ``csrc/psk31_viterbi.cu``
on a CUDA device, forward pass and traceback, or run its plain torch
version on the CPU (``ops/psk31_viterbi.py``), with the JAX scans' branch
metrics, tie rules and per-step renormalisation. The text pipeline
decodes with the fixed-lag :class:`StreamingViterbi`, a numpy copy.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..dsp.device import to_device
from ..ops.psk31_viterbi import psk31_viterbi

NUM_STATES = 16
TRACEBACK_DEPTH = 32  # fldigi-style fixed lag; textbook 5·(K−1)=20 + margin
_PATHMEM = 128

# DQPSK step phasor per dibit = g0·2 + g1; after differential detection
# d = sym·conj(prev), Re(d) soft-demodulates g0 and Im(d) g1, positive ⇒
# coded bit 0 (modulate/psk31.rs QPSK31_PHASE_STEP).
DQPSK_EXP = np.array([1.0 + 0.0j, 0.0 - 1.0j, 0.0 + 1.0j, -1.0 + 0.0j],
                     dtype=np.complex64)


def conv_encode(bits, sr: int = 0) -> np.ndarray:
    """Rate-1/2 K=5 encode; returns interleaved [g0_0, g1_0, g0_1, ...].
    ``sr`` is the 4-bit encoder state (bit k = the input 4−k steps ago)."""
    x = np.asarray(bits, dtype=np.uint8) & 1
    hist = np.array([(sr >> k) & 1 for k in range(4)], dtype=np.uint8)
    xp = np.concatenate([hist, x])
    n = len(x)
    g0 = xp[4:4 + n] ^ xp[2:2 + n] ^ xp[0:n]
    g1 = xp[4:4 + n] ^ xp[1:1 + n] ^ xp[0:n]
    out = np.empty(2 * n, dtype=np.uint8)
    out[0::2] = g0
    out[1::2] = g1
    return out


def conv_encode_final_sr(bits, sr: int = 0) -> int:
    """Encoder shift register after encoding ``bits`` from state ``sr``."""
    for b in np.asarray(bits, dtype=np.uint8) & 1:
        sr = (sr >> 1) | (int(b) << 3)
    return sr


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


@lru_cache(maxsize=1)
def _trellis():
    """(pred, bit_of_ns, dibit): the predecessors of next state ns are
    pred[ns] = [2·(ns&7), 2·(ns&7)+1], the input bit reaching ns is
    (ns>>3)&1, and dibit[p, b] = g0·2+g1 of the step from p on input b."""
    pred = np.stack([2 * (np.arange(NUM_STATES) & 7),
                     2 * (np.arange(NUM_STATES) & 7) + 1],
                    axis=1).astype(np.int32)
    bit_of_ns = ((np.arange(NUM_STATES) >> 3) & 1).astype(np.int32)
    dibit = np.zeros((NUM_STATES, 2), np.int32)
    for s in range(NUM_STATES):
        for b in range(2):
            window = (b << 4) | s
            dibit[s, b] = (_parity(window & 0b10101) * 2
                           + _parity(window & 0b10011))
    return pred, bit_of_ns, dibit


_INF = np.float32(3.0e38) / 2


def viterbi_decode(soft_pairs, device="cuda") -> torch.Tensor:
    """Non-coherent soft Viterbi over DQPSK differential products.
    ``soft_pairs``: (..., n_syms, 2) float32 [Re(d), Im(d)]. Returns
    (..., n_syms) uint8 bits. Branch metric |d − DQPSK_EXP[dibit]|²."""
    return psk31_viterbi(to_device(soft_pairs, device, torch.float32),
                         coherent=False)


def viterbi_decode_coherent(soft_pairs, device="cuda") -> torch.Tensor:
    """Coherent MLSE: each state carries a hypothesised absolute phasor
    (initially (1, 0), as the modulator starts); branch metric
    |sym_c − hyp·step|²."""
    return psk31_viterbi(to_device(soft_pairs, device, torch.float32),
                         coherent=True)


def viterbi_decode_hard(bits, device="cuda") -> torch.Tensor:
    """Hard-input decode: (c0, c1) pairs mapped to DQPSK phasors, then
    :func:`viterbi_decode`."""
    b = np.asarray(bits, dtype=np.uint8).reshape(-1, 2)
    d = DQPSK_EXP[b[:, 0] * 2 + b[:, 1]]
    pairs = np.stack([d.real, d.imag], axis=-1).astype(np.float32)
    return viterbi_decode(pairs, device=device)


class StreamingViterbi:
    """Fixed-lag (32-symbol) sliding-window Viterbi for live QPSK31 text,
    host-side numpy (at 31.25 baud the trellis is tiny next to the
    demod)."""

    def __init__(self, phase_steps=DQPSK_EXP) -> None:
        pred, bit_of_ns, dibit = _trellis()
        self._pred = pred
        self._trans_dibit = dibit[pred, bit_of_ns[:, None]]
        self._exp = np.asarray(phase_steps, dtype=np.complex64)
        self.pm = np.full(NUM_STATES, _INF, np.float32)
        self.pm[0] = 0.0
        self.history = np.zeros((_PATHMEM, NUM_STATES), np.int32)
        self.ptr = 0
        self.count = 0

    def feed_symbol(self, s_re: float, s_im: float):
        d = np.complex64(s_re + 1j * s_im)
        bm4 = np.abs(d - self._exp) ** 2
        cand = self.pm[self._pred] + bm4[self._trans_dibit]
        j = np.argmin(cand, axis=1)
        self.pm = cand[np.arange(NUM_STATES), j]
        self.history[self.ptr] = self._pred[np.arange(NUM_STATES), j]
        self.ptr = (self.ptr + 1) % _PATHMEM
        self.count += 1
        if self.count % 256 == 255:
            self.pm -= self.pm.min()
        if self.count <= TRACEBACK_DEPTH:
            return None
        state = int(np.argmin(self.pm))
        p = (self.ptr + _PATHMEM - 1) % _PATHMEM
        for _ in range(TRACEBACK_DEPTH):
            state = int(self.history[p][state])
            p = (p + _PATHMEM - 1) % _PATHMEM
        return (state >> 3) & 1

    def flush(self):
        out = []
        for _ in range(TRACEBACK_DEPTH):
            b = self.feed_symbol(0.0, 0.0)
            if b is not None:
                out.append(b)
        return out
