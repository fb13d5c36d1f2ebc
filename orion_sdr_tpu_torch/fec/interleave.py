"""Block and Forney convolutional interleavers (counterpart of
``orion_sdr_tpu/fec/interleave.py``). Host numpy, as in the reference: they
permute bytes and bits of one frame at a time.

* Block: row-in / column-out over rows·cols elements, any dtype.
* Forney (I branches, depth M): a byte entering branch j = t mod I at
  stream position t leaves at t + j·M·I (interleave) or t + (I−1−j)·M·I
  (deinterleave), so the whole device is strided copies out of
  [history | input], with the last (I−1)·M·I inputs carried as state.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


# ── block interleaver ────────────────────────────────────────────────────────


def block_interleave(x, rows: int, cols: int):
    """(..., rows·cols) → (..., rows·cols): write rows, read columns."""
    x = np.asarray(x)
    n = rows * cols
    if x.shape[-1] != n:
        raise ValueError("interleave input must be one full block")
    m = x.reshape(x.shape[:-1] + (rows, cols))
    return np.swapaxes(m, -1, -2).reshape(x.shape[:-1] + (n,))


def block_deinterleave(x, rows: int, cols: int):
    x = np.asarray(x)
    n = rows * cols
    if x.shape[-1] != n:
        raise ValueError("deinterleave input must be one full block")
    m = x.reshape(x.shape[:-1] + (cols, rows))
    return np.swapaxes(m, -1, -2).reshape(x.shape[:-1] + (n,))


# ── Forney convolutional interleaver ─────────────────────────────────────────


def conv_roundtrip_delay(branches: int, depth: int) -> int:
    return branches * (branches - 1) * depth


class ForneyState(NamedTuple):
    history: np.ndarray  # the last (I−1)·M·I inputs (zeros initially)
    pos: int              # commutator offset of the next input byte


def _forney_apply(x, branches: int, depth: int, state: Optional[ForneyState],
                  deinterleave: bool):
    x = np.asarray(x)
    I, M = branches, depth
    D = (I - 1) * M * I                   # the longest delay
    if state is None:
        state = ForneyState(np.zeros(x.shape[:-1] + (D,), x.dtype), 0)
    n = x.shape[-1]
    pos = int(state.pos)
    out = np.empty_like(x)
    n_head = min(n, D)                    # outputs that may reach the history
    xp = np.concatenate([state.history, x[..., :n_head]], axis=-1)
    for c in range(I):                    # one stride class per branch
        t0 = (c - pos) % I
        j = (I - 1 - c) if deinterleave else c
        d_c = j * M * I
        if t0 < n_head:
            m = (n_head - t0 + I - 1) // I
            s0 = D + t0 - d_c
            out[..., t0:t0 + I * m:I] = xp[..., s0:s0 + I * m:I]
        tb = t0 + ((n_head - t0 + I - 1) // I) * I
        if tb < n:
            m = (n - tb + I - 1) // I
            s0 = tb - d_c
            out[..., tb:tb + I * m:I] = x[..., s0:s0 + I * m:I]
    if n >= D:
        hist = np.ascontiguousarray(x[..., n - D:])
    else:
        hist = np.concatenate([state.history[..., n:], x], axis=-1)
    return out, ForneyState(hist, int((pos + n) % I))


def forney_interleave(x, branches: int = 12, depth: int = 17,
                      state: Optional[ForneyState] = None):
    """Streaming Forney interleave, 1:1 in length, state carried; the DVB-T
    outer interleaver is I = 12, M = 17. Returns (out, state)."""
    return _forney_apply(x, branches, depth, state, deinterleave=False)


def forney_deinterleave(x, branches: int = 12, depth: int = 17,
                        state: Optional[ForneyState] = None):
    """Matched deinterleaver: branch j delays by (I−1−j)·M."""
    return _forney_apply(x, branches, depth, state, deinterleave=True)


def forney_flush(branches: int, depth: int, state: ForneyState,
                 deinterleave: bool = False):
    """Drain by feeding roundtrip-delay zeros."""
    d = conv_roundtrip_delay(branches, depth)
    zeros = np.zeros(state.history.shape[:-1] + (d,), state.history.dtype)
    return _forney_apply(zeros, branches, depth, state, deinterleave)
