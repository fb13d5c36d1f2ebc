"""The QPSK31 Viterbi decoders: the Hopper kernel ``csrc/psk31_viterbi.cu``
beside its plain torch version.

The JAX package decodes QPSK31's rate-1/2 K=5 code (16 states) with
``lax.scan``s over symbols: the forward ACS of ``viterbi_decode``
(non-coherent, on differential products) and of
``viterbi_decode_coherent`` (each state carries a hypothesised absolute
phasor), and their shared traceback (``orion_sdr_tpu/codec/psk31.py:98-164``;
no Pallas kernel). In eager torch each symbol is some ten launches forward
and a few back. The kernel runs one row a thread, every symbol of the row
in turn: the 16 path metrics (and the coherent phases) in registers, a warp
of rows a block with the rows' pairs staged through shared memory, one
16-bit survivor mask a step and row (bit ns = the predecessor chosen for
state ns) to a step-major scratch buffer, and the traceback in the same
thread. A launch is bound by the latency of that chain, n steps a row.

Both versions form the branch metrics as the JAX scans do under XLA:
- non-coherent: ``bm[e] = |d − DQPSK_EXP[e]|²`` rounded, then each
  candidate ``pm[p] + bm[dibit]`` rounded again;
- coherent: a state's phasor is ``(−j)^q``; a step multiplies it by
  ``DQPSK_EXP[dibit] = (−j)^INC[dibit]``, exactly, so ``q' = (q + INC) & 3``,
  and each candidate is ``pm[p] + h·h`` in ONE rounding, ``h = |s − (−j)^q'|``
  (XLA fuses the JAX scan's product and sum into a multiply-add there; the
  two-rounding form returns other bits at exact ties).
``j = 1`` only where the second candidate is strictly smaller, the new
metrics are renormalised by their minimum every step (NaN propagates, as
``torch.min``), and the traceback starts at the first minimum (the first
NaN if any, as ``torch.argmin``).

:func:`psk31_viterbi` launches the kernel for a CUDA tensor (built with nvcc
at first use; a failed build or launch raises) and runs
:func:`psk31_viterbi_reference` for a CPU tensor; it counts its launches in
``.launches``. The kernel's lengths are ``hypotf``, which the plain
version's complex ``abs`` computes on the card (:func:`branch_lengths`
returns the kernel's form, for checking that premise).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..buildlib import NVCC_FLAGS_NO_FMA, PTR, INT, I64, CudaLib

# the phase index that DQPSK_EXP[dibit] adds: DQPSK_EXP[e] = (−j)^INC[e]
INC = np.array([0, 1, 3, 2])
# (−j)^q, the coherent hypotheses
PHASORS = np.array([1.0, -1.0j, -1.0, 1.0j], dtype=np.complex64)

_LIB = CudaLib("psk31_viterbi", NVCC_FLAGS_NO_FMA, {
    "psk31_viterbi": [PTR, INT, I64, INT, PTR, PTR, PTR],
    "psk31_viterbi_lengths": [PTR, I64, PTR, PTR]})
build = _LIB.build


def _tables(device):
    """(pred, dibit of each transition, its phase increment), (16, 2) each:
    pred[ns, j] = 2·(ns & 7) + j."""
    from ..codec.psk31 import _trellis
    pred, bit_of_ns, dibit = _trellis()
    trans = dibit[pred, bit_of_ns[:, None]]
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                 for a in (pred, trans, INC[trans]))


def _fma(sq: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """float32 ``h·h + a`` rounded once (``fmaf``), from ``sq`` = h² in
    float64 (exact: 24-bit factors) and float32 ``a``: the sum is rounded to
    odd in float64 (TwoSum gives its error), and a round-to-odd value with
    29 more bits than float32 rounds to float32 as the exact sum would."""
    y = a.double()
    s = sq + y
    b = s - sq
    e = (sq - (s - b)) + (y - b)
    even = (s.view(torch.int64) & 1) == 0
    odd = torch.nextafter(s, torch.where(e > 0, math.inf, -math.inf))
    return torch.where((e != 0) & even & s.isfinite(), odd, s).float()


def psk31_viterbi_reference(pairs: torch.Tensor,
                            coherent: bool) -> torch.Tensor:
    """Plain version: one step a loop iteration over the symbol axis, in the
    kernel's operations, then the traceback through the survivor masks."""
    from ..codec.psk31 import _INF, DQPSK_EXP, NUM_STATES
    pred, trans, inc = _tables(pairs.device)
    lead, n = pairs.shape[:-2], pairs.shape[-2]
    z = torch.complex(pairs[..., 0], pairs[..., 1])
    ref = torch.as_tensor(PHASORS if coherent else DQPSK_EXP,
                          device=pairs.device)
    h = (z[..., None] - ref).abs()                       # (..., n, 4)
    bm = h.double() ** 2 if coherent else h * h
    pm = torch.full(tuple(lead) + (NUM_STATES,), float(_INF),
                    dtype=torch.float32, device=pairs.device)
    pm[..., 0] = 0.0
    q = torch.zeros(pm.shape, dtype=torch.int64, device=pairs.device)
    shift = torch.arange(NUM_STATES, device=pairs.device)
    masks = torch.empty(tuple(lead) + (n,), dtype=torch.int64,
                        device=pairs.device)
    for t in range(n):
        if coherent:
            idx = (q[..., pred] + inc) & 3                   # (..., 16, 2)
            cand = _fma(torch.take_along_dim(bm[..., t, None, :], idx, -1),
                        pm[..., pred])
        else:
            cand = pm[..., pred] + bm[..., t, trans]
        j = cand[..., 1] < cand[..., 0]
        new = torch.where(j, cand[..., 1], cand[..., 0])
        if coherent:
            q = torch.where(j, idx[..., 1], idx[..., 0])
        masks[..., t] = (j.to(torch.int64) << shift).sum(-1)
        pm = new - new.min(dim=-1, keepdim=True).values
    s = torch.argmin(pm, dim=-1)
    bits = torch.empty(tuple(lead) + (n,), dtype=torch.uint8,
                       device=pairs.device)
    for t in reversed(range(n)):
        bits[..., t] = (s >> 3) & 1
        s = 2 * (s & 7) + ((masks[..., t] >> s) & 1)
    return bits


def psk31_viterbi(pairs: torch.Tensor, coherent: bool) -> torch.Tensor:
    """(..., n, 2) float32 [re, im] pairs → (..., n) uint8 bits on the same
    device: ``viterbi_decode``'s non-coherent metric, or
    ``viterbi_decode_coherent``'s when ``coherent``."""
    if pairs.dtype != torch.float32:
        raise TypeError(f"pairs must be float32, got {pairs.dtype}")
    if pairs.dim() < 2 or pairs.shape[-1] != 2:
        raise ValueError(f"pairs must be (..., n, 2), got "
                         f"{tuple(pairs.shape)}")
    if pairs.device.type == "cpu":
        return psk31_viterbi_reference(pairs, bool(coherent))
    if pairs.device.type != "cuda":
        raise ValueError(f"no QPSK31 Viterbi kernel for device "
                         f"{pairs.device}")
    lead, n = pairs.shape[:-2], pairs.shape[-2]
    rows = math.prod(lead)
    bits = torch.empty((rows, n), dtype=torch.uint8, device=pairs.device)
    if rows and n:
        p = pairs.reshape(rows, n, 2).contiguous()
        if p.data_ptr() % 8:                # the kernel reads 8-byte pairs
            p = p.clone()
        masks = torch.empty((n, rows), dtype=torch.int16, device=p.device)
        _launch_into(p, coherent, masks, bits)
        psk31_viterbi.launches += 1
    return bits.reshape(tuple(lead) + (n,))


def _launch_into(pairs: torch.Tensor, coherent: bool, masks: torch.Tensor,
                 bits: torch.Tensor) -> None:
    """Launches the kernel on the caller's buffers, all contiguous CUDA
    tensors: ``pairs`` (rows, n, 2) float32 (8-byte aligned), ``masks``
    (n, rows) int16 survivor scratch, ``bits`` (rows, n) uint8."""
    rows, n = bits.shape
    _LIB.launch("psk31_viterbi", pairs.device, pairs.data_ptr(), rows, n,
                int(bool(coherent)), masks.data_ptr(), bits.data_ptr())


psk31_viterbi.launches = 0


def branch_lengths(z: torch.Tensor) -> torch.Tensor:
    """|z| of a complex64 CUDA tensor as the kernel forms a branch length
    (``hypotf(re, im)``), float32 of z's shape. Card only."""
    z = z.to(torch.complex64).contiguous()
    h = torch.empty(z.shape, dtype=torch.float32, device=z.device)
    if z.numel():
        _lengths_into(z, h)
    return h


def _lengths_into(z: torch.Tensor, h: torch.Tensor) -> None:
    """:func:`branch_lengths` into the caller's ``h``: ``z`` complex64 and
    ``h`` float32 of as many elements, contiguous CUDA tensors."""
    _LIB.launch("psk31_viterbi_lengths", z.device, z.data_ptr(), z.numel(),
                h.data_ptr())
