"""IIR sections as parallel linear recurrences (counterpart of
``orion_sdr_tpu/dsp/iir.py``; behavioral spec: dsp/iir.rs, dsp/dc.rs).

Each second-order section is split by partial fractions into a complex
one-pole: for the conjugate pole pair (p, p̄) of 1 + a1·z⁻¹ + a2·z⁻²,

    y = 2·Re(A·s),   s[n] = p·s[n−1] + v[n],   A = p/(p − p̄),

where v is the 3-tap numerator FIR of x. A real input of at least two
chunks takes the real-Toeplitz chunk route: the zero-state output is one
real (…, C) @ (C, C) matmul a call, with tables built in float64 and
rounded once (kept per device); chunk carries chain through a small complex
scan. Other inputs take the complex one-pole route
(:func:`~orion_sdr_tpu_torch.dsp.recurrence.first_order`). Every product
is ``torch.matmul`` in float32 / complex64 with TF32 off
(:func:`~orion_sdr_tpu_torch.dsp.device.full_f32`), as the JAX package runs
them at ``Precision.HIGHEST``.

States: BiquadState (complex carry, last two inputs); a cascade carries a
pair of them; the DC blocker a (..., 2) tensor (x1, y1).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .device import full_f32, on_device
from .recurrence import _first_order_assoc, first_order


class BiquadCoefs(NamedTuple):
    b0: float
    b1: float
    b2: float
    a1: float
    a2: float


def design_butter_lp(fs: float, fc: float) -> BiquadCoefs:
    """RBJ cookbook Butterworth lowpass biquad, Q = 1/√2 (dsp/iir.rs:49-76)."""
    w0 = 2.0 * np.pi * fc / fs
    sin, cos = np.sin(w0), np.cos(w0)
    alpha = sin / (2.0 * np.sqrt(0.5))
    b0 = (1.0 - cos) * 0.5
    b1 = 1.0 - cos
    b2 = (1.0 - cos) * 0.5
    a0 = 1.0 + alpha
    return BiquadCoefs(b0 / a0, b1 / a0, b2 / a0, -2.0 * cos / a0,
                       (1.0 - alpha) / a0)


def dc_pole(fs: float, cut_hz: float) -> float:
    """DC-blocker pole r (dsp/dc.rs:15-22)."""
    return float(np.clip(1.0 - 2.0 * np.pi * (max(cut_hz, 0.1) / fs),
                         0.0, 0.9999))


class BiquadState(NamedTuple):
    sp: torch.Tensor      # (...,) complex64 one-pole carry
    x_tail: torch.Tensor  # (..., 2) last two inputs [x[n−2], x[n−1]]


def _pole(c: BiquadCoefs) -> complex:
    disc = c.a1 * c.a1 - 4.0 * c.a2
    if disc >= 0:
        raise ValueError("biquad fast path requires a complex-conjugate "
                         "pole pair")
    return complex(-c.a1 / 2.0, np.sqrt(-disc) / 2.0)


def biquad_init(lead_shape, dtype=torch.float32, device="cuda") -> BiquadState:
    lead_shape = tuple(lead_shape)
    return BiquadState(
        sp=torch.zeros(lead_shape, dtype=torch.complex64, device=device),
        x_tail=torch.zeros(lead_shape + (2,), dtype=dtype, device=device))


_BQ_CHUNK = 128


@lru_cache(maxsize=64)
def _biquad_tables_np(p: complex, A: complex, C: int, ko: int):
    """Host constants of the real-drive chunked biquad (float64, rounded
    once): the Toeplitz operator of g[d] = 2·Re(A·p^d), the carry picks
    p^(C−1−j), the boundary rows ±2·(Re, Im)(A·p^(k+1)), the last-sample
    state picks p^(ko−j) (ko = offset of the last true sample in its
    chunk), p^C and p^(ko+1)."""
    d = np.arange(C)
    pk = p ** d
    g = 2.0 * np.real(A * pk)
    expo = d[None, :] - d[:, None]
    L = np.where(expo >= 0, g[np.maximum(expo, 0)], 0.0).astype(np.float32)
    tail = p ** (C - 1 - d)
    apk = A * p ** (d + 1)
    u = (2.0 * np.real(apk)).astype(np.float32)
    w = (-2.0 * np.imag(apk)).astype(np.float32)
    last = np.where(d <= ko, p ** np.maximum(ko - d, 0), 0.0)
    # the carry picks as one (C, 2) matrix: [Re, Im] of p^(C−1−j)
    carry = np.stack([tail.real, tail.imag], axis=1).astype(np.float32)
    lastm = np.stack([last.real, last.imag], axis=1).astype(np.float32)
    return L, carry, u, w, complex(p ** C), lastm, complex(p ** (ko + 1))


_BQ_TABLES: dict = {}


def _biquad_tables(p: complex, A: complex, C: int, ko: int, device):
    key = (p, A, C, ko, torch.device(device))
    t = _BQ_TABLES.get(key)
    if t is None:
        L, carry, u, w, pC, lastm, pko1 = _biquad_tables_np(p, A, C, ko)
        t = _BQ_TABLES[key] = tuple(
            torch.as_tensor(v, device=device) if isinstance(v, np.ndarray)
            else v for v in (L, carry, u, w, pC, lastm, pko1))
    return t


def _biquad_chunked_real(v: torch.Tensor, p: complex, A: complex,
                         s0: torch.Tensor):
    """Chunked s[n] = p·s[n−1] + v[n], y = 2·Re(A·s) for real v: one real
    Toeplitz matmul a chunk for the zero-state output, chunk carries
    through a small complex scan."""
    C = _BQ_CHUNK
    n = v.shape[-1]
    lead = v.shape[:-1]
    nchunk = -(-n // C)
    pad = nchunk * C - n
    vp = torch.nn.functional.pad(v, (0, pad)) if pad else v
    vc = vp.reshape(lead + (nchunk, C))
    ko = (n - 1) % C
    L, carry, u, w, pC, lastm, pko1 = _biquad_tables(p, A, C, ko, v.device)

    with full_f32():
        zs = torch.matmul(vc, L)                           # (..., nchunk, C)
        e = torch.matmul(vc, carry)                        # (..., nchunk, 2)
        # carry out = state at the last TRUE sample (the padded tail would
        # otherwise go on advancing the pole with zero drive)
        sl = torch.matmul(vc[..., -1, :], lastm)           # (..., 2)
    z = torch.complex(e[..., 0], e[..., 1])                # Σ p^(C−1−j)·v[j]
    s0 = torch.broadcast_to(s0.to(torch.complex64), lead)
    chain, _ = _first_order_assoc(complex(pC), z, s0)
    s_in = torch.cat([s0[..., None], chain[..., :-1]], dim=-1)  # carry in
    y = zs + s_in.real[..., None] * u + s_in.imag[..., None] * w
    y = y.reshape(lead + (nchunk * C,))[..., :n]
    s_last = s_in[..., -1] * complex(np.complex64(pko1)) + torch.complex(
        sl[..., 0], sl[..., 1])
    return y, s_last


def biquad(x, c: BiquadCoefs, state: BiquadState | None = None,
           device=None):
    """One second-order section over the last axis. Returns (y, state).
    Host data runs on ``device`` (None: the card)."""
    x = on_device(x, device)
    if state is None:
        state = biquad_init(x.shape[:-1], x.dtype, x.device)
    p = _pole(c)
    A = p / (p - np.conj(p))
    xp = torch.cat([state.x_tail.to(x.dtype), x], dim=-1)
    v = c.b0 * xp[..., 2:] + c.b1 * xp[..., 1:-1] + c.b2 * xp[..., :-2]
    if not x.is_complex() and abs(p) < 1.0 and x.shape[-1] >= 2 * _BQ_CHUNK:
        y, s_last = _biquad_chunked_real(v.to(torch.float32), complex(p),
                                         complex(A), state.sp)
    else:
        s, s_last = first_order(complex(p), v.to(torch.complex64),
                                y0=state.sp)
        y = 2.0 * (s * complex(np.complex64(A))).real
    return y.to(x.dtype), BiquadState(sp=s_last, x_tail=xp[..., -2:])


def lp_cascade(x, c: BiquadCoefs, state=None, device=None):
    """Two cascaded identical biquads = a 4th-order LR lowpass
    (dsp/iir.rs:44-87). ``state``: (BiquadState, BiquadState) or None."""
    x = on_device(x, device)
    if state is None:
        state = (biquad_init(x.shape[:-1], x.dtype, x.device),
                 biquad_init(x.shape[:-1], x.dtype, x.device))
    y0, s0 = biquad(x, c, state[0])
    y1, s1 = biquad(y0, c, state[1])
    return y1, (s0, s1)


def dc_blocker(x, r: float, state=None, device=None):
    """y[n] = x[n] − x[n−1] + r·y[n−1] (dsp/dc.rs). Returns (y, state),
    state = (x1, y1) packed in a (..., 2) tensor."""
    x = on_device(x, device)
    if state is None:
        state = torch.zeros(x.shape[:-1] + (2,), dtype=x.dtype,
                            device=x.device)
    if x.shape[-1] == 0:
        return x, state
    x1, y1 = state[..., 0], state[..., 1]
    xprev = torch.cat([x1[..., None], x[..., :-1]], dim=-1)
    y, y_last = first_order(float(r), x - xprev, y0=y1)
    return y, torch.stack([x[..., -1], y_last], dim=-1)


class LpDcState(NamedTuple):
    bq: tuple            # (BiquadState, BiquadState)
    dc: torch.Tensor     # (..., 2) dc blocker state


def lp_dc_init(lead_shape, dtype=torch.float32, device="cuda") -> LpDcState:
    lead_shape = tuple(lead_shape)
    return LpDcState(bq=(biquad_init(lead_shape, dtype, device),
                         biquad_init(lead_shape, dtype, device)),
                     dc=torch.zeros(lead_shape + (2,), dtype=dtype,
                                    device=device))


def lp_dc_cascade(x, c: BiquadCoefs, r: float,
                  state: LpDcState | None = None, map_fn=None, device=None):
    """LP4, an optional elementwise map (e.g. sqrt for AM power-sqrt), then
    the DC blocker (dsp/iir.rs:90-187)."""
    x = on_device(x, device)
    if state is None:
        state = lp_dc_init(x.shape[:-1], x.dtype, x.device)
    y, bq_state = lp_cascade(x, c, state.bq)
    if map_fn is not None:
        y = map_fn(y)
    y, dc_state = dc_blocker(y, r, state.dc)
    return y, LpDcState(bq=bq_state, dc=dc_state)
