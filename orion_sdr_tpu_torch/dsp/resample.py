"""Polyphase rational resampling (counterpart of
``orion_sdr_tpu/dsp/resample.py``).

``resample`` / ``Resampler`` change the sample rate by a rational up/down
(48 kHz → 44.1 kHz is 147/160). The JAX package runs upfirdn as one
``conv_general_dilated`` with ``lhs_dilation = up`` and stride ``down``.
Here it is one strided ``conv1d`` in polyphase form: output t + s·up reads
x[s·down + m] for the m of its phase, so the ``up`` phases are the output
channels of one (up, 1, K) kernel (K ≈ taps/up + down) and the zero-stuffed
stream is never formed. Streaming is chunk-boundary invariant: the state is
the input tail and the output grid's position.
"""

from __future__ import annotations

from functools import lru_cache
from math import gcd

import numpy as np
import torch

from .device import on_device, takes_host_data
from .fir import to_rows, from_rows, conv1d_f32, kaiser_lowpass_taps


def resample_taps(up: int, down: int, taps_per_phase: int = 24,
                  stopband_db: float = 70.0) -> np.ndarray:
    """Kaiser anti-image/anti-alias lowpass for an up/down resampler at the
    ×up internal rate: cutoff 0.5/max(up, down), ``taps_per_phase`` taps in
    each of the ``up`` legs, DC gain ``up``."""
    up, down = int(up), int(down)
    g = gcd(up, down)
    up, down = up // g, down // g
    n = taps_per_phase * up
    n |= 1
    taps = kaiser_lowpass_taps(n, 0.5 / max(up, down), stopband_db)
    return (taps * up / taps.sum()).astype(np.float32)


@lru_cache(maxsize=64)
def _polyphase(taps: bytes, up: int, down: int, lead: int):
    """The polyphase kernel of y[t] = Σ_k h[k]·z[lead + t·down − k] over the
    zero-stuffed z (z[m·up] = x[m]): W (up, 1, K) and the first input index
    m_min, so that y[t + s·up] = Σ_j W[t, 0, j]·x[s·down + m_min + j]."""
    h = np.frombuffer(taps, np.float32)
    T = len(h)
    q = lead + np.arange(up) * down                  # z index of output t
    m_hi = q // up                                   # newest input it reads
    m_min = int(m_hi.min()) - (-(-T // up)) + 1
    K = int(m_hi.max()) - m_min + 1
    W = np.zeros((up, 1, K), np.float32)
    for t in range(up):
        for j in range(K):
            k = q[t] - (m_min + j) * up
            if 0 <= k < T:
                W[t, 0, j] = h[k]
    return W, m_min


_W: dict = {}


def _upfirdn_strided(xp: torch.Tensor, taps: np.ndarray, up: int, down: int,
                     lead: int, n_out: int) -> torch.Tensor:
    """y[t] = Σ_k h[k]·z[lead + t·down − k], t < n_out, over the zero-stuffed
    stream of xp (..., L) (z[i·up] = xp[i], zero elsewhere)."""
    taps = np.ascontiguousarray(taps, np.float32)
    W, m_min = _polyphase(taps.tobytes(), up, down, lead)
    key = (taps.tobytes(), up, down, lead, xp.device)
    w = _W.get(key)
    if w is None:
        w = _W[key] = torch.as_tensor(W, device=xp.device)
    K = W.shape[-1]
    S = -(-n_out // up)
    L = xp.shape[-1]
    # input index m_min + j + s·down for s < S, j < K, zero outside [0, L)
    need = (S - 1) * down + K
    lo, hi = -m_min, m_min + need - L
    rows, how = to_rows(xp)
    if lo < 0:
        rows = rows[:, -lo:]
        lo = 0
    if hi < 0:
        rows = rows[:, :rows.shape[-1] + hi]
        hi = 0
    y = conv1d_f32(torch.nn.functional.pad(rows, (lo, hi)), w, stride=down)
    y = y[..., :S].transpose(1, 2).reshape(rows.shape[0], S * up)[:, :n_out]
    return from_rows(y, how)


def resample(x, up: int, down: int, taps=None, device=None) -> torch.Tensor:
    """One-shot rational resample, group-delay compensated: output sample m
    lands on input time m·down/up, length ⌈n·up/down⌉. ``taps``: a
    prototype from :func:`resample_taps` (24 taps a phase, 70 dB by
    default). Host data runs on ``device`` (None: the card)."""
    x = on_device(x, device)
    up, down = int(up), int(down)
    g = gcd(up, down)
    up, down = up // g, down // g
    if up < 1 or down < 1:
        raise ValueError("up and down must be positive")
    n = x.shape[-1]
    if taps is None:
        taps = resample_taps(up, down)
    n_out = -(-n * up // down)
    gd = (len(taps) - 1) // 2
    return _upfirdn_strided(x, np.asarray(taps, np.float32), up, down,
                            lead=gd, n_out=n_out)


class Resampler:
    """Streaming rational resampler (chunk-boundary invariant): ``feed``
    returns the causal output (lagging by the prototype's group delay), and
    the outputs of any chunking concatenate to the one-shot causal
    resample; ``flush`` drains the group-delay tail. ``feed`` takes host
    data as the JAX one does: a tensor stays on its device, host data goes
    to its ``device`` keyword (None: the card)."""

    def __init__(self, up: int, down: int, taps=None,
                 taps_per_phase: int = 24, stopband_db: float = 70.0):
        g = gcd(int(up), int(down))
        self.up, self.down = int(up) // g, int(down) // g
        if self.up < 1 or self.down < 1:
            raise ValueError("up and down must be positive")
        self.taps = (np.asarray(taps, np.float32) if taps is not None
                     else resample_taps(self.up, self.down, taps_per_phase,
                                        stopband_db))
        # input tail long enough that every future output's window is local
        self._t = -(-(len(self.taps) - 1) // self.up)
        self._tail = None
        self._m_next = 0          # next output index on the global grid
        self._n_in = 0            # total inputs consumed

    @takes_host_data("x")
    def feed(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] == 0:
            return x[..., :0]
        if self._tail is None:
            self._tail = x.new_zeros(x.shape[:-1] + (self._t,))
        xp = torch.cat([self._tail, x], dim=-1)
        self._n_in += x.shape[-1]
        # outputs m with m·down < n_in·up (causal: window wholly in the past)
        m_stop = -(-self._n_in * self.up // self.down)
        n_out = m_stop - self._m_next
        if n_out <= 0:
            self._tail = xp[..., xp.shape[-1] - self._t:]
            return x[..., :0]
        # local zero-stuffed coordinate of global position m_next·down
        lead = (self._m_next * self.down
                - (self._n_in - x.shape[-1] - self._t) * self.up)
        y = _upfirdn_strided(xp, self.taps, self.up, self.down, lead, n_out)
        self._m_next = m_stop
        self._tail = xp[..., xp.shape[-1] - self._t:]
        return y

    def flush(self) -> torch.Tensor:
        """Drain the outputs still inside the filter (feeds the group delay's
        worth of zeros), then reset to a fresh stream."""
        if self._tail is None:
            return torch.zeros(0, dtype=torch.float32)
        pad = -(-(len(self.taps) - 1) // self.up)
        out = self.feed(self._tail.new_zeros(self._tail.shape[:-1] + (pad,)))
        self._tail = None
        self._m_next = 0
        self._n_in = 0
        return out
