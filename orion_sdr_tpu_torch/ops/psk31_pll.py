"""The PSK31 decision-feedback PLL: the Hopper kernel ``csrc/psk31_pll.cu``
beside its plain torch version.

The JAX package runs the per-symbol recurrence of its PSK31 demodulators
as a ``lax.scan`` over the matched-filter dots (``_pll_scan``,
``orion_sdr_tpu/demodulate/psk31.py:65-100``; no Pallas kernel): hard
decision, phase error through ``rsqrt``, loop filter, wrap to [−π, π). In
eager torch each step would be some fifteen launches; the kernel runs one
row a thread, every symbol of the row in turn, a warp of rows a block with
the block's dots and soft values staged through shared memory.

:func:`psk31_pll` launches the kernel for a CUDA tensor (built with nvcc at
first use; a failed build or launch raises) and runs
:func:`psk31_pll_reference` for a CPU tensor; it counts its launches in
``.launches``. The plain version writes ``e^{−j·acc}`` as explicit cos and
sin and the phase error with ``rsqrt``, in real arithmetic, in the kernel's
order, so on the card the two differ only where the kernel's ``sincosf``
(the bits of ``cosf`` and ``sinf``: ``ops.dd_pll.sincos_mismatches``) and
``rsqrtf`` round otherwise than torch's own calls (the tests and the smoke
hold the decisions exact and the soft values to a stated bound). Against the JAX package (whose CPU build contracts products
and sums into fused multiply-adds, and whose cos/sin/rsqrt are XLA's) the
soft values agree within float32 rounding and the decisions on clean
symbols exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..buildlib import NVCC_FLAGS_NO_FMA, PTR, INT, I64, F32, CudaLib

_PI = float(np.float32(np.pi))
_TWO_PI = float(np.float32(2.0 * np.pi))

_LIB = CudaLib("psk31_pll", NVCC_FLAGS_NO_FMA, {
    "psk31_pll": [PTR, PTR, PTR, INT, I64, F32, F32, F32, INT, PTR, PTR, PTR,
                  PTR]})
build = _LIB.build


def psk31_pll_reference(dots: torch.Tensor, prev0: torch.Tensor,
                        acc0: torch.Tensor, c_fb: float, scale: float,
                        gain: float, qpsk: bool):
    """Plain version: one symbol a loop iteration over the last axis, in
    the kernel's real operations and order."""
    c_fb, scale, gain = float(c_fb), float(scale), float(gain)
    pr = prev0.real.to(torch.float32)
    pi = prev0.imag.to(torch.float32)
    acc = acc0.to(torch.float32)
    dr, di = dots.real, dots.imag
    n = dots.shape[-1]
    soft = torch.empty(dots.shape + ((2,) if qpsk else ()),
                       dtype=torch.float32, device=dots.device)
    for k in range(n):
        yr = (dr[..., k] - pr * c_fb) * scale
        yi = (di[..., k] - pi * c_fb) * scale
        c, s = torch.cos(acc), torch.sin(acc)
        cr = yr * c + yi * s
        ci = yi * c - yr * s
        d_re = cr * pr + ci * pi
        d_im = ci * pr - cr * pi
        if qpsk:
            re_wins = d_re.abs() >= d_im.abs()
            dec_re = torch.where(re_wins, torch.where(d_re >= 0.0, 1.0, -1.0),
                                 0.0)
            dec_im = torch.where(re_wins, 0.0,
                                 torch.where(d_im >= 0.0, 1.0, -1.0))
            cross = d_im * dec_re - d_re * dec_im
            soft[..., k, 0] = d_re
            soft[..., k, 1] = d_im
        else:
            cross = d_im * torch.where(d_re >= 0.0, 1.0, -1.0)
            soft[..., k] = d_re
        mag = d_re * d_re + d_im * d_im
        err = torch.where(mag > 1e-6, cross * torch.rsqrt(mag),
                          0.0)
        acc = torch.remainder(acc + gain * err + _PI, _TWO_PI) - _PI
        pr, pi = cr, ci
    return soft, torch.complex(pr, pi), acc


def psk31_pll(dots: torch.Tensor, prev0: torch.Tensor, acc0: torch.Tensor,
              c_fb: float, scale: float, gain: float, qpsk: bool):
    """(..., n) complex64 matched-filter dots, (...,) complex64 previous
    symbols and (...,) float32 phase accumulators → (soft (..., n) float32
    for BPSK or (..., n, 2) for QPSK, prev_out, acc_out) on the same
    device. ``c_fb``, ``scale``, ``gain`` are float32 constants."""
    if dots.dtype != torch.complex64:
        raise TypeError(f"dots must be complex64, got {dots.dtype}")
    lead = dots.shape[:-1]
    prev0 = torch.broadcast_to(prev0.to(torch.complex64), lead)
    acc0 = torch.broadcast_to(acc0.to(torch.float32), lead)
    c_fb, scale, gain = np.float32(c_fb), np.float32(scale), np.float32(gain)
    if dots.device.type == "cpu":
        return psk31_pll_reference(dots, prev0, acc0, c_fb, scale, gain, qpsk)
    if dots.device.type != "cuda":
        raise ValueError(f"no PSK31 PLL kernel for device {dots.device}")
    n = dots.shape[-1]
    rows = prev0.numel()
    d = dots.reshape(rows, n).contiguous()
    p0 = prev0.reshape(rows).contiguous()
    a0 = acc0.reshape(rows).contiguous()
    soft = torch.empty((rows, n) + ((2,) if qpsk else ()),
                       dtype=torch.float32, device=dots.device)
    prev_out = p0.clone()
    acc_out = a0.clone()
    if rows and n:
        _launch_into(d, p0, a0, c_fb, scale, gain, qpsk, soft, prev_out,
                     acc_out)
        psk31_pll.launches += 1
    return (soft.reshape(lead + soft.shape[1:]), prev_out.reshape(lead),
            acc_out.reshape(lead))


def _launch_into(dots: torch.Tensor, prev0: torch.Tensor, acc0: torch.Tensor,
                 c_fb: float, scale: float, gain: float, qpsk: bool,
                 soft: torch.Tensor, prev_out: torch.Tensor,
                 acc_out: torch.Tensor) -> None:
    """Launches the kernel on the caller's buffers, all contiguous CUDA
    tensors: ``dots`` (rows, n) complex64, ``prev0`` and ``prev_out``
    (rows,) complex64, ``acc0`` and ``acc_out`` (rows,) float32, ``soft``
    (rows, n) or (rows, n, 2) float32."""
    rows, n = dots.shape
    _LIB.launch("psk31_pll", dots.device, dots.data_ptr(), prev0.data_ptr(),
                acc0.data_ptr(), rows, n, float(c_fb), float(scale),
                float(gain), int(bool(qpsk)), soft.data_ptr(),
                prev_out.data_ptr(), acc_out.data_ptr())


psk31_pll.launches = 0
