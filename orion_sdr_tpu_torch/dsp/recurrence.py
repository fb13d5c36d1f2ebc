"""Parallel linear recurrences, the substrate for IIR state (counterpart of
``orion_sdr_tpu/dsp/recurrence.py``).

Every linear recurrence runs as a parallel prefix over affine maps instead
of a per-sample loop. Where the JAX package calls
``jax.lax.associative_scan``, the port runs :func:`affine_scan`, a
Hillis–Steele doubling of ``(a1·a2, a2·b1 + b2)`` over the last axis
(log2 n passes, each one elementwise op over the whole tensor). Its sums
are grouped differently from XLA's tree, so results agree with the JAX
package within float32 rounding (the tests state the tolerance), not bit
for bit. The constant-coefficient route is the JAX package's chunked
triangular matmul: one ``torch.matmul`` a call (float32 or complex64, TF32
off under :func:`~orion_sdr_tpu_torch.dsp.device.full_f32`), so the whole
capture is two passes over the data.

Signals are float32 / complex64 with time on the last axis; every function
takes an optional carry-in and returns the carry-out, so a long capture can
go through block by block.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from .device import full_f32, on_device

_CHUNK = 8192      # the JAX package's associative-scan chunk for array ``a``
_GEOM_CHUNK = 128  # chunk of the constant-coefficient matmul route


def affine_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the affine maps y ↦ a[i]·y + b[i] along the last
    axis, composed left to right: returns (A, B) with B[i] the state after
    step i from a zero state and A[i] the product a[0]·…·a[i]."""
    n = a.shape[-1]
    d = 1
    while d < n:
        a_hi, b_hi = a[..., d:], b[..., d:]
        a_lo, b_lo = a[..., :-d], b[..., :-d]
        b = torch.cat([b[..., :d], a_hi * b_lo + b_hi], dim=-1)
        a = torch.cat([a[..., :d], a_lo * a_hi], dim=-1)
        d *= 2
    return a, b


def _as(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _first_order_assoc(a, b: torch.Tensor, y0=None):
    """Scan core of :func:`first_order` (one shot)."""
    a = torch.broadcast_to(_as(a, b), b.shape)
    if y0 is not None:
        # fold the carry into the first element: y[0] = a[0]·y0 + b[0]
        b = torch.cat([(b[..., :1] + a[..., :1] * _as(y0, b)[..., None]),
                       b[..., 1:]], dim=-1)
    _, y = affine_scan(a, b)
    return y, y[..., -1]


_GEOM_TABLES: dict = {}


def _geom_tables(a, C: int, dtype: torch.dtype, device):
    """The constant-coefficient route's tables for pole ``a`` (built in
    float64 / complex128 on the host and rounded once, kept per device):
    L[j, k] = a^(k−j) for k ≥ j, the chunk-carry weights a^(k+1), and
    a^C."""
    key = (a, C, dtype, torch.device(device))
    t = _GEOM_TABLES.get(key)
    if t is None:
        k = np.arange(C)
        a_c = np.complex128(a) if isinstance(a, complex) else np.float64(a)
        expo = k[None, :] - k[:, None]
        L = np.where(expo >= 0, a_c ** np.maximum(expo, 0), 0)
        np_dt = np.complex64 if dtype == torch.complex64 else np.float32
        t = _GEOM_TABLES[key] = (
            torch.as_tensor(L.astype(np_dt), device=device),
            torch.as_tensor((a_c ** (k + 1)).astype(np_dt), device=device),
            a_c ** C)
    return t


def _first_order_const(a, b: torch.Tensor, y0):
    """Constant-coefficient route: y[k] = a·y[k−1] + b[k]. Within a chunk of
    C samples the zero-state response is one triangular matmul
    (zs = b @ L, L[j, k] = a^(k−j)); chunk boundaries chain through a small
    scan with coefficient a^C over n/C terms."""
    n = b.shape[-1]
    C = _GEOM_CHUNK
    if abs(a) >= 1.0 or n < 2 * C:
        return _first_order_assoc(a, b, y0)
    if isinstance(a, complex) and not b.is_complex():
        b = b.to(torch.complex64)
    nchunk = -(-n // C)
    pad = nchunk * C - n
    lead = b.shape[:-1]
    bp = torch.nn.functional.pad(b, (0, pad)) if pad else b
    bc = bp.reshape(lead + (nchunk, C))
    L, a_k1, aC = _geom_tables(a, C, bc.dtype, bc.device)
    with full_f32():
        zero_state = torch.matmul(bc, L)
    z = zero_state[..., -1]                                 # (..., nchunk)
    # boundary chain: y_in[i] = aC·y_in[i−1] + z[i−1], y_in[0] = y0
    if y0 is None:
        y0 = torch.zeros(lead, dtype=b.dtype, device=b.device)
    else:
        y0 = torch.broadcast_to(_as(y0, b), lead)
    aC = complex(aC) if isinstance(a, complex) else float(aC)
    chain, _ = _first_order_assoc(aC, z, y0)
    y_in = torch.cat([y0[..., None], chain[..., :-1]], dim=-1)
    y = zero_state + y_in[..., None] * a_k1
    y = y.reshape(lead + (nchunk * C,))[..., :n]
    return y, y[..., -1]


def first_order(a, b, y0=None, device=None):
    """Solve ``y[n] = a[n]·y[n−1] + b[n]`` along the last axis; returns
    ``(y, y_last)``. ``a``: a Python/numpy scalar (constant one-pole: the
    chunked matmul route) or a tensor broadcastable to ``b`` (the scan,
    in chunks of 8192 carried in turn when n is a multiple of it); ``y0``:
    the carry-in (0 by default). Host ``b`` runs on ``device`` (None: the
    card)."""
    b = on_device(b, device)
    n = b.shape[-1]
    if n == 0:
        lead = b.shape[:-1]
        y_last = (torch.zeros(lead, dtype=b.dtype, device=b.device)
                  if y0 is None else torch.broadcast_to(_as(y0, b), lead))
        return b, y_last
    if isinstance(a, numbers.Number) or (isinstance(a, np.generic)
                                         and np.ndim(a) == 0):
        return _first_order_const(
            complex(a) if np.iscomplexobj(np.asarray(a)) else float(a),
            b, y0)
    if n <= _CHUNK or n % _CHUNK != 0:
        return _first_order_assoc(a, b, y0)
    a = torch.broadcast_to(_as(a, b), b.shape)
    lead = b.shape[:-1]
    y_last = (torch.zeros(lead, dtype=b.dtype, device=b.device)
              if y0 is None else torch.broadcast_to(_as(y0, b), lead))
    ys = []
    for i in range(0, n, _CHUNK):
        y, y_last = _first_order_assoc(a[..., i:i + _CHUNK],
                                       b[..., i:i + _CHUNK], y_last)
        ys.append(y)
    return torch.cat(ys, dim=-1), y_last


def affine2(A, B, x, s0=None, device=None):
    """Solve the 2-state recurrence ``s[n] = A @ s[n−1] + B·x[n]``. ``A``:
    (2, 2) constant, ``B``: (2,), ``x``: (..., n), ``s0``: optional (..., 2)
    initial state. Returns ``(s, s_last)``, s of shape (..., n, 2): the
    state after absorbing x[..., k]. A Hillis–Steele doubling over the maps
    (A_n, b_n) with (A2, b2) ∘ (A1, b1) = (A2 @ A1, A2 @ b1 + b2). Host
    ``x`` runs on ``device`` (None: the card)."""
    x = on_device(x, device)
    A = _as(A, x)
    Bv = _as(B, x)
    n = x.shape[-1]
    As = torch.broadcast_to(A, x.shape + (2, 2))
    bs = x[..., None] * Bv                                   # (..., n, 2)
    with full_f32():
        if s0 is not None:
            b0 = bs[..., 0, :] + torch.einsum("ij,...j->...i", A, _as(s0, x))
            bs = torch.cat([b0[..., None, :], bs[..., 1:, :]], dim=-2)
        d = 1
        while d < n:
            A_hi, b_hi = As[..., d:, :, :], bs[..., d:, :]
            A_lo, b_lo = As[..., :-d, :, :], bs[..., :-d, :]
            bs = torch.cat([bs[..., :d, :], torch.einsum(
                "...ij,...j->...i", A_hi, b_lo) + b_hi], dim=-2)
            As = torch.cat([As[..., :d, :, :], torch.matmul(A_hi, A_lo)],
                           dim=-3)
            d *= 2
    return bs, bs[..., -1, :]
