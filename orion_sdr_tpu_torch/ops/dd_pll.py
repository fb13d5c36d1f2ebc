"""The decision-directed carrier PLL of the burst modem: the Hopper kernel
``csrc/dd_pll.cu`` beside its plain torch version.

The JAX package runs the per-symbol recurrence as a ``lax.scan``
(``_dd_pll_kernel``, ``orion_sdr_tpu/demodulate/digital.py:191-208``; no
Pallas kernel), and its bench ``vmap``s it over channels: derotate by the
carried phase, decide the nearest constellation point, take the angle
error, run a proportional-integral loop. In eager torch each step would be
some thirty launches; the kernel runs one row a thread, every symbol of
the row in turn, all rows in one launch, specialised on the constellation
(sign decisions, or 3, 7 or 15 thresholds in registers) with each block's
rows staged through shared memory.

:func:`dd_pll` launches the kernel for a CUDA tensor (built with nvcc at
first use; a failed build or launch raises) and runs
:func:`dd_pll_reference` for a CPU tensor; it counts its launches in
``.launches``. The plain version writes ``e^{−jφ}`` as explicit cos and
sin and every complex product in real arithmetic, in the kernel's order,
and both decide through ``constellation.decide_tables``: on the card the
two agree bit for bit. The kernel takes cos and sin from one ``sincosf``;
:func:`sincos_mismatches` counts on the card the float32 inputs where that
differs from ``cosf``/``sinf`` (none over all 2^32). Against the JAX scan
(XLA's cos/sin and fused multiply-adds) they agree within float32
rounding, carried by the loop.
"""

from __future__ import annotations

import numpy as np
import torch

from ..buildlib import NVCC_FLAGS_NO_FMA, PTR, INT, I64, F32, CudaLib
from ..constellation import decide_tables

_LIB = CudaLib("dd_pll", NVCC_FLAGS_NO_FMA, {
    "dd_pll": [PTR, INT, I64, PTR, INT, PTR, INT, INT, F32, F32, PTR, PTR],
    "dd_pll_sincos_mismatches": [INT, I64, PTR, PTR]})
build = _LIB.build


def loop_gains(loop_bw: float):
    """(kp, ki) as float32 values: kp = loop_bw, ki = loop_bw²/4."""
    return (float(np.float32(loop_bw)),
            float(np.float32(loop_bw * loop_bw / 4.0)))


_TABLES: dict = {}


def _tables(order: str, device):
    """(thresholds, levels, sign) of ``decide_tables`` with the two tables
    on ``device``, made once a device. The kernel decides by a tree of
    selects that needs the thresholds in ascending order."""
    key = (order, str(device))
    if key not in _TABLES:
        thr, lv, sign = decide_tables(order)
        if np.any(np.diff(thr) < 0):
            raise ValueError(f"{order}: decision thresholds must ascend")
        _TABLES[key] = (torch.as_tensor(thr, device=device),
                        torch.as_tensor(lv, device=device), sign)
    return _TABLES[key]


def _axis_level(v: torch.Tensor, thr, lv, sign: bool) -> torch.Tensor:
    if sign:
        return torch.where(v < 0.0, lv[1], lv[0])
    nat = (v[..., None] > thr).sum(-1)
    return lv[nat]


def dd_pll_reference(z: torch.Tensor, order: str, loop_bw: float
                     ) -> torch.Tensor:
    """Plain version: one symbol a loop iteration over the last axis of
    (rows, n) complex64, in the kernel's real operations and order."""
    kp, ki = loop_gains(loop_bw)
    thr, lv, sign = _tables(order, z.device)
    zr, zi = z.real, z.imag
    ph = torch.zeros(z.shape[:-1], dtype=torch.float32, device=z.device)
    f = torch.zeros_like(ph)
    out = torch.empty_like(z)
    for k in range(z.shape[-1]):
        c, s = torch.cos(ph), torch.sin(ph)
        vr, vi = zr[..., k], zi[..., k]
        yr = vr * c + vi * s
        yi = vi * c - vr * s
        rr = _axis_level(yr, thr, lv, sign)
        ri = torch.zeros_like(yi) if order == "bpsk" else \
            _axis_level(yi, thr, lv, sign)
        pr = yr * rr + yi * ri
        pi = yi * rr - yr * ri
        err = torch.atan2(pi, pr)
        f = f + ki * err
        ph = (ph + f) + kp * err
        out[..., k] = torch.complex(yr, yi)
    return out


def dd_pll(z: torch.Tensor, order: str, loop_bw: float) -> torch.Tensor:
    """(..., n) complex64 symbols → (..., n) complex64 derotated symbols on
    the same device, each row its own loop from φ = f = 0."""
    if z.dtype != torch.complex64:
        raise TypeError(f"symbols must be complex64, got {z.dtype}")
    if z.device.type == "cpu":
        return dd_pll_reference(z, order, loop_bw)
    if z.device.type != "cuda":
        raise ValueError(f"no DD-PLL kernel for device {z.device}")
    n = z.shape[-1]
    rows = int(np.prod(z.shape[:-1], dtype=np.int64))
    zz = z.reshape(rows, n).contiguous()
    out = torch.empty_like(zz)
    if rows and n:
        _launch_into(zz, order, loop_bw, _tables(order, z.device), out)
        dd_pll.launches += 1
    return out.reshape(z.shape)


def _launch_into(z: torch.Tensor, order: str, loop_bw: float, tables,
                 out: torch.Tensor) -> None:
    """Launches the kernel on the caller's buffers: ``z`` and ``out``
    (rows, n) complex64 contiguous CUDA tensors, ``tables`` ``_tables``'s
    (thresholds, levels, sign) for ``order``."""
    rows, n = z.shape
    thr, lv, sign = tables
    kp, ki = loop_gains(loop_bw)
    _LIB.launch("dd_pll", z.device, z.data_ptr(), rows, n, thr.data_ptr(),
                thr.numel(), lv.data_ptr(), int(sign), int(order == "bpsk"),
                kp, ki, out.data_ptr())


dd_pll.launches = 0


def sincos_mismatches(device="cuda", lo: int = 0, count: int = 1 << 32
                      ) -> int:
    """The float32 inputs with bit patterns lo .. lo + count − 1 (mod 2^32,
    lo < 2^31) where the card's ``sincosf`` gives other bits than its
    ``cosf`` and ``sinf`` (any NaN agrees with any NaN): the premise of the
    kernel's one range reduction. Card only."""
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    _sincos_into(lo, count, bad)
    return int(bad.item())


def _sincos_into(lo: int, count: int, bad: torch.Tensor) -> None:
    """Adds :func:`sincos_mismatches`'s count to ``bad``, a (1,) int64
    CUDA tensor."""
    _LIB.launch("dd_pll_sincos_mismatches", bad.device, int(lo), int(count),
                bad.data_ptr())
