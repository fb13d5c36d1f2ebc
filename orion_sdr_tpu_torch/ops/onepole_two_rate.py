"""The two-rate one-pole envelope: the Hopper kernel
``csrc/onepole_two_rate.cu`` beside its plain torch version.

``env[i] = a·env[i−1] + (1 − a)·x[i]`` with ``a = a_hi`` where x[i] is above
the envelope (``x > env``, or ``x >= env`` with ``ge``) and ``a_lo``
elsewhere. The JAX package runs it as a ``lax.scan`` (no Pallas kernel):
``agc_rms`` with attack ≠ release (``orion_sdr_tpu/dsp/agc.py:59-69``,
``x² > env``) and ``cw_mod`` (``orion_sdr_tpu/modulate/analog.py:40-47``,
``target >= env``). The pole depends on the state, so there is no parallel
prefix: a per-step torch loop would be a handful of launches a sample.

:func:`onepole_two_rate` launches the kernel for a CUDA tensor (built with
nvcc at first use; a failed build or launch raises) and runs
:func:`onepole_two_rate_reference` for a CPU tensor; it counts its launches
in ``.launches``. Both round a·env and b·x apart and then add, so they agree
bit for bit. The JAX package on the CPU contracts a·env + b·x into a fused
multiply-add, so the two packages agree within float32 rounding (about 1
ulp a step), not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..buildlib import NVCC_FLAGS_NO_FMA, PTR, INT, I64, F32, CudaLib

_LIB = CudaLib("onepole_two_rate", NVCC_FLAGS_NO_FMA, {
    "onepole_two_rate": [PTR, PTR, INT, I64, F32, F32, F32, F32, INT, PTR,
                         PTR, PTR]})
build = _LIB.build


def _poles(a_hi: float, a_lo: float):
    """The two poles and their complements 1 − a, rounded to float32 as the
    JAX package forms them (a float32, then 1 − a in float32)."""
    a_hi, a_lo = np.float32(a_hi), np.float32(a_lo)
    return a_hi, np.float32(1) - a_hi, a_lo, np.float32(1) - a_lo


def onepole_two_rate_reference(x: torch.Tensor, env0: torch.Tensor,
                               a_hi: float, a_lo: float, ge: bool):
    """Plain version: one step a loop iteration over the last axis."""
    ah, bh, al, bl = _poles(a_hi, a_lo)
    env = env0.to(torch.float32)
    out = torch.empty_like(x)
    for i in range(x.shape[-1]):
        xi = x[..., i]
        hi = xi >= env if ge else xi > env
        a = torch.where(hi, float(ah), float(al))
        b = torch.where(hi, float(bh), float(bl))
        env = a * env + b * xi
        out[..., i] = env
    return out, env


def onepole_two_rate(x: torch.Tensor, env0: torch.Tensor, a_hi: float,
                     a_lo: float, ge: bool):
    """(..., n) float32 samples and (...,) float32 initial envelopes →
    ((..., n) envelope, (...,) last envelope) on the same device."""
    if x.dtype != torch.float32 or env0.dtype != torch.float32:
        raise TypeError("x and env0 must be float32")
    if env0.shape != x.shape[:-1]:
        raise ValueError(f"env0 {tuple(env0.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return onepole_two_rate_reference(x, env0, a_hi, a_lo, ge)
    if x.device.type != "cuda":
        raise ValueError(f"no two-rate one-pole kernel for device {x.device}")
    n = x.shape[-1]
    rows = env0.numel()
    xs = x.reshape(rows, n).contiguous()
    e0 = env0.reshape(rows).contiguous()
    env = torch.empty_like(xs)
    last = torch.empty_like(e0)
    if rows and n:
        _launch_into(xs, e0, a_hi, a_lo, ge, env, last)
        onepole_two_rate.launches += 1
    else:
        last = e0.clone()
    return env.reshape(x.shape), last.reshape(env0.shape)


def _launch_into(x: torch.Tensor, env0: torch.Tensor, a_hi: float,
                 a_lo: float, ge: bool, env: torch.Tensor,
                 last: torch.Tensor) -> None:
    """Launches the kernel on the caller's buffers: ``x`` and ``env``
    (rows, n), ``env0`` and ``last`` (rows,), float32 contiguous CUDA
    tensors."""
    rows, n = x.shape
    _LIB.launch("onepole_two_rate", x.device, x.data_ptr(), env0.data_ptr(),
                rows, n, *(float(v) for v in _poles(a_hi, a_lo)),
                int(bool(ge)), env.data_ptr(), last.data_ptr())


onepole_two_rate.launches = 0
