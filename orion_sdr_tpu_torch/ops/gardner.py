"""The Gardner symbol-timing loop: the Hopper kernel ``csrc/gardner.cu``
beside its plain torch version.

The JAX package runs the per-symbol recurrence as a ``lax.scan``
(``_gardner_kernel``, ``orion_sdr_tpu/demodulate/digital.py:127-161``; no
Pallas kernel): linear interpolation at a float32 position and half a
symbol before it, the mid-symbol error, a clipped rate and a position
update. In eager torch each step would be some twenty-five launches, with
gathers at positions the previous step computed; the kernel runs one row a
block, every symbol of the row in turn on one lane, the row staged ahead
of it through a ring of ``DEPTH`` chunks of ``CHUNK`` samples in shared
memory and the symbols written back ``OUT_CHUNK`` at a time (the
constants of ``csrc/gardner.cu``, which
``tests/test_torch_gardner_schedule.py`` models and holds to it). A step
whose reads leave the chunks the chain holds reads device memory instead
and counts a window miss: ``gardner.last_misses`` holds the last launch's,
one int32 a row.

:func:`gardner` normalises each row to unit RMS with a torch reduction
(shared by both paths); :func:`gardner_rows` then launches the kernel on
the unit-RMS rows of a CUDA tensor (built with nvcc at first use; a failed
build or launch raises) or runs :func:`gardner_reference` for a CPU
tensor, and counts the launches in ``gardner.launches``. The plain
version rounds every product and sum apart in the kernel's order, so the
two agree bit for bit on the card. Against the JAX scan they agree
within float32 rounding carried by the loop.
"""

from __future__ import annotations

import numpy as np
import torch

from ..buildlib import NVCC_FLAGS_NO_FMA, PTR, INT, I64, F32, CudaLib

_LIB = CudaLib("gardner", NVCC_FLAGS_NO_FMA, {
    "gardner": [PTR, INT, I64, I64, F32, F32, F32, F32, F32, F32, PTR, PTR,
                PTR, PTR]})
build = _LIB.build

# the kernel's ring (csrc/gardner.cu: kChunk, kDepth, kOutChunk, kOutDepth)
CHUNK, DEPTH, OUT_CHUNK, OUT_DEPTH = 512, 4, 256, 2


def loop_constants(sps: float, loop_bw: float, mu0: float):
    """(pos0, rate0, kp, ki, lo, hi) as float32 values, formed as the JAX
    package forms them (in double, rounded once)."""
    f = np.float32
    return tuple(float(f(v)) for v in (
        sps * 1.0 + mu0, sps, loop_bw, loop_bw * loop_bw / 4.0, sps * 0.95,
        sps * 1.05))


def normalise(z: torch.Tensor) -> torch.Tensor:
    """Each row over its RMS (+1e-12 under the root): the Gardner error is
    amplitude-squared, so the loop gains and the ±1 error clip assume
    unit-RMS samples."""
    p = (z.real * z.real + z.imag * z.imag).mean(-1, keepdim=True)
    rms = torch.sqrt(p + 1e-12)
    return torch.complex(z.real / rms, z.imag / rms)


def _interp(zr, zi, p, n):
    i = torch.clamp(torch.floor(p).to(torch.int64), 0, n - 2)
    t = p - i.to(torch.float32)
    w = 1.0 - t
    i = i[:, None]
    a_r, a_i = zr.gather(-1, i)[:, 0], zi.gather(-1, i)[:, 0]
    b_r, b_i = zr.gather(-1, i + 1)[:, 0], zi.gather(-1, i + 1)[:, 0]
    return a_r * w + b_r * t, a_i * w + b_i * t


def gardner_reference(zn: torch.Tensor, sps: float, n_out: int,
                      loop_bw: float, mu0: float):
    """Plain version over (rows, n) unit-RMS complex64 rows: one symbol a
    loop iteration, in the kernel's real operations and order. Returns
    ((rows, n_out) complex64 symbols, (rows,) float32 final positions)."""
    pos0, rate0, kp, ki, lo, hi = loop_constants(sps, loop_bw, mu0)
    rows, n = zn.shape
    zr, zi = zn.real.contiguous(), zn.imag.contiguous()
    dev = zn.device
    pos = torch.full((rows,), pos0, dtype=torch.float32, device=dev)
    rate = torch.full((rows,), rate0, dtype=torch.float32, device=dev)
    pr = torch.zeros(rows, dtype=torch.float32, device=dev)
    pi = torch.zeros_like(pr)
    out = torch.empty((rows, n_out), dtype=torch.complex64, device=dev)
    for k in range(n_out):
        yr, yi = _interp(zr, zi, pos, n)
        mr, mi = _interp(zr, zi, pos - rate * 0.5, n)
        dr, di = yr - pr, yi - pi
        e = torch.clamp(-(dr * mr + di * mi), -1.0, 1.0)
        rate = torch.clamp(rate + ki * e, lo, hi)
        pos = (pos + rate) + kp * e
        out[:, k] = torch.complex(yr, yi)
        pr, pi = yr, yi
    return out, pos


def gardner_rows(zn: torch.Tensor, sps: float, n_out: int,
                 loop_bw: float = 0.02, mu0: float = 0.0):
    """The loop on (rows, n) unit-RMS complex64 rows (``normalise``'s
    output), contiguous: the kernel for a CUDA tensor, the plain version
    for a CPU tensor. Returns ((rows, n_out) symbols, (rows,) final
    positions); a launch's window misses, (rows,) int32, go to
    ``gardner.last_misses``."""
    if zn.device.type == "cpu":
        return gardner_reference(zn, sps, n_out, loop_bw, mu0)
    if zn.device.type != "cuda":
        raise ValueError(f"no Gardner kernel for device {zn.device}")
    rows, n = zn.shape
    pos0 = loop_constants(sps, loop_bw, mu0)[0]
    out = torch.empty((rows, n_out), dtype=torch.complex64, device=zn.device)
    pos = torch.full((rows,), pos0, dtype=torch.float32, device=zn.device)
    if rows and n_out:
        misses = torch.zeros(rows, dtype=torch.int32, device=zn.device)
        _launch_into(zn, sps, loop_bw, mu0, out, pos, misses)
        gardner.launches += 1
        gardner.last_misses = misses
    return out, pos


def _launch_into(zn: torch.Tensor, sps: float, loop_bw: float, mu0: float,
                 out: torch.Tensor, pos: torch.Tensor,
                 misses: torch.Tensor) -> None:
    """Launches the kernel on the caller's buffers: ``zn`` (rows, n)
    complex64 and ``out`` (rows, n_out) complex64, ``pos`` (rows,) float32
    and ``misses`` (rows,) int32, all contiguous CUDA tensors."""
    rows, n = zn.shape
    _LIB.launch("gardner", zn.device, zn.data_ptr(), rows, n, out.shape[1],
                *loop_constants(sps, loop_bw, mu0), out.data_ptr(),
                pos.data_ptr(), misses.data_ptr())


def gardner(z: torch.Tensor, sps: float, n_out: int, loop_bw: float = 0.02,
            mu0: float = 0.0):
    """(..., n) complex64 samples → ((..., n_out) complex64 symbols, (...,)
    float32 final positions) on the same device, each row its own loop.
    Needs 2 <= n < 2^31 samples a row when n_out > 0."""
    if z.dtype != torch.complex64:
        raise TypeError(f"samples must be complex64, got {z.dtype}")
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no Gardner kernel for device {z.device}")
    lead, n = z.shape[:-1], z.shape[-1]
    n_out = int(n_out)
    if n_out and not 2 <= n < 1 << 31:
        raise ValueError("the Gardner loop needs 2 to 2^31 - 1 samples a "
                         "row")
    rows = int(np.prod(lead, dtype=np.int64))
    zn = normalise(z.reshape(rows, n)).contiguous()
    out, pos = gardner_rows(zn, sps, n_out, loop_bw, mu0)
    return out.reshape(lead + (n_out,)), pos.reshape(lead)


gardner.launches = 0
gardner.last_misses = None
