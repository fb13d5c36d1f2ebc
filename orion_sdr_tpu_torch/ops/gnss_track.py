"""GPS early/prompt/late tracking loops: the Hopper kernel
``csrc/gnss_track.cu`` beside its plain torch version.

The JAX package runs the epoch recurrence as a ``lax.scan``
(``_track_scan``, ``orion_sdr_tpu/gnss.py:200-254``; no Pallas kernel), and
its bench ``vmap``s it over satellites: three sliced, carrier-wiped code
correlations an epoch, a Costas discriminator, an envelope DLL and a
carrier-aided code NCO carried as an int32 epoch base and a float32
fraction. In eager torch each epoch would be some seventy launches; the
kernel runs one block a satellite with the epochs in a loop inside it.

:func:`gnss_track` launches the kernel for a CUDA capture (built with nvcc
at first use; a failed build or launch raises) and runs
:func:`track_reference` for a CPU one; it counts its launches in
``.launches``. The plain version sums each correlation in the kernel's
fixed order (``THREADS`` strided partial sums, then a pairwise tree) and
writes every complex product in real arithmetic, so the two agree bit for
bit on the card. Against the JAX scan (XLA's dot order, its cos/sin and
fused multiply-adds) they agree within float32 rounding carried by the
loops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..buildlib import NVCC_FLAGS_NO_FMA, PTR, INT, I64, F32, CudaLib

_LIB = CudaLib("gnss_track", NVCC_FLAGS_NO_FMA, {
    "gnss_track": [PTR, I64, PTR, INT, INT, PTR, PTR, I64, INT, F32, F32, F32,
                   F32, F32, F32, F32, F32, PTR, PTR, PTR, PTR, PTR]})
build = _LIB.build

# threads a block, the width of the kernel's sum tree (csrc/gnss_track.cu)
THREADS = 512
TAU = 2.0 * np.pi
GPS_CA_RATE = 1.023e6
GPS_L1_HZ = 1575.42e6


def loop_constants(fs: float, spms: int, k_pll_f: float, k_pll_p: float,
                   k_dll: float) -> dict:
    """The loops' constants as the JAX scan forms them: float32 values
    (each rounded once from double) and the early/late spacing d_el."""
    f = np.float32
    spc = fs / GPS_CA_RATE
    return {"d_el": max(1, int(round(0.5 * spc))), "w0": float(f(TAU / fs)),
            "spms_f": float(f(spms)), "tau": float(f(TAU)),
            "l1": float(f(GPS_L1_HZ)), "spc": float(f(spc)),
            "kf": float(f(k_pll_f)), "kp": float(f(k_pll_p)),
            "kd": float(f(k_dll))}


def _sum_fixed(p: torch.Tensor) -> torch.Tensor:
    """(..., spms) → (...,): the kernel's order — THREADS strided partial
    sums in turn (zero padded), then pairs (t, t + stride) down to one."""
    spms = p.shape[-1]
    J = -(-spms // THREADS)
    p = torch.nn.functional.pad(p, (0, J * THREADS - spms))
    p = p.reshape(p.shape[:-1] + (J, THREADS))
    acc = torch.zeros(p.shape[:-2] + (THREADS,), dtype=p.dtype,
                      device=p.device)
    for j in range(J):
        acc = acc + p[..., j, :]
    stride = THREADS // 2
    while stride:
        acc = acc[..., :stride] + acc[..., stride:2 * stride]
        stride //= 2
    return acc[..., 0]


def slice_start(s: torch.Tensor, n: int, spms: int) -> torch.Tensor:
    """``lax.dynamic_slice``'s start: a negative start wraps by n
    (numpy-style), then the start clamps to [0, n − spms]."""
    return torch.clamp(torch.where(s < 0, s + n, s), 0, n - spms)


def _sign(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0.0, 1.0, torch.where(x < 0.0, -1.0, 0.0))


def track_reference(z: torch.Tensor, codes: torch.Tensor,
                    starts: torch.Tensor, f0: torch.Tensor, fs: float,
                    n_epochs: int, k_pll_f: float, k_pll_p: float,
                    k_dll: float):
    """Plain version: one epoch a loop iteration, all satellites at once,
    in the kernel's real operations and sum order."""
    S, spms = codes.shape
    n = z.shape[-1]
    c = loop_constants(fs, spms, k_pll_f, k_pll_p, k_dll)
    dev = z.device
    zr, zi = z.real.contiguous(), z.imag.contiguous()
    kf_ = torch.arange(spms, dtype=torch.float32, device=dev)
    ar = torch.arange(spms, device=dev)
    tiny = torch.tensor(1e-12, dtype=torch.float32, device=dev)
    l1 = torch.tensor(c["l1"], dtype=torch.float32, device=dev)
    base = starts.to(device=dev, dtype=torch.int64)
    frac = torch.zeros(S, dtype=torch.float32, device=dev)
    ph = torch.zeros_like(frac)
    cf = f0.to(device=dev, dtype=torch.float32)
    out_p = torch.empty((S, n_epochs), dtype=torch.complex64, device=dev)
    out_f = torch.empty((S, n_epochs), dtype=torch.float32, device=dev)
    out_b = torch.empty((S, n_epochs), dtype=torch.int32, device=dev)
    out_r = torch.empty((S, n_epochs), dtype=torch.float32, device=dev)
    for ep in range(n_epochs):
        wf = c["w0"] * cf
        p = ph[:, None] + wf[:, None] * kf_
        cs, sn = torch.cos(p), torch.sin(p)
        prods = []
        for off in (-c["d_el"], 0, c["d_el"]):
            idx = slice_start(base + off, n, spms)[:, None] + ar
            xr, xi = zr[idx], zi[idx]
            prods.append(codes * (xr * cs + xi * sn))
            prods.append(codes * (xi * cs - xr * sn))
        er, ei, pr, pi, lr, li = _sum_fixed(torch.stack(prods))
        pll = torch.atan2(pi * _sign(pr), torch.maximum(pr.abs(), tiny))
        ae = torch.sqrt(er * er + ei * ei)
        al = torch.sqrt(lr * lr + li * li)
        dll = (ae - al) / torch.maximum(ae + al, tiny)
        ph = torch.remainder((ph + wf * c["spms_f"]) + c["kp"] * pll,
                             c["tau"])
        cf = cf + c["kf"] * pll
        frac = (frac - c["spms_f"] * (cf / l1)) - (c["kd"] * dll) * c["spc"]
        shift = torch.round(frac)
        base = base + spms + shift.to(torch.int64)
        frac = frac - shift
        out_p[:, ep] = torch.complex(pr, pi)
        out_f[:, ep] = cf
        out_b[:, ep] = base.to(torch.int32)
        out_r[:, ep] = frac
    return out_p, out_f, out_b, out_r


def gnss_track(z: torch.Tensor, codes: torch.Tensor, starts: torch.Tensor,
               f0: torch.Tensor, fs: float, n_epochs: int, k_pll_f: float,
               k_pll_p: float, k_dll: float):
    """(n,) complex64 capture, (S, spms) float32 ±1 codes, (S,) int32
    epoch starts and (S,) float32 initial Dopplers → (prompts (S, E)
    complex64, frequencies (S, E) float32, epoch bases (S, E) int32,
    fractions (S, E) float32) on the capture's device, E = ``n_epochs``."""
    if z.dtype != torch.complex64 or z.dim() != 1:
        raise TypeError("the capture must be a 1-D complex64 tensor")
    dev = z.device
    codes = codes.to(device=dev, dtype=torch.float32).contiguous()
    starts = starts.to(device=dev, dtype=torch.int32).contiguous()
    f0 = f0.to(device=dev, dtype=torch.float32).contiguous()
    S, spms = codes.shape
    if z.shape[0] < spms:
        raise ValueError("the capture is shorter than one epoch")
    if dev.type == "cpu":
        return track_reference(z, codes, starts, f0, fs, int(n_epochs),
                               k_pll_f, k_pll_p, k_dll)
    if dev.type != "cuda":
        raise ValueError(f"no tracking kernel for device {dev}")
    E = int(n_epochs)
    c = loop_constants(fs, spms, k_pll_f, k_pll_p, k_dll)
    prompts = torch.empty((S, E), dtype=torch.complex64, device=dev)
    freqs = torch.empty((S, E), dtype=torch.float32, device=dev)
    bases = torch.empty((S, E), dtype=torch.int32, device=dev)
    fracs = torch.empty((S, E), dtype=torch.float32, device=dev)
    if S and E:
        zc = z.contiguous()
        _LIB.launch("gnss_track", dev, zc.data_ptr(), zc.shape[0],
                    codes.data_ptr(), S, spms, starts.data_ptr(),
                    f0.data_ptr(), E, c["d_el"], c["w0"], c["spms_f"],
                    c["tau"], c["l1"], c["spc"], c["kf"], c["kp"], c["kd"],
                    prompts.data_ptr(), freqs.data_ptr(), bases.data_ptr(),
                    fracs.data_ptr())
        gnss_track.launches += 1
    return prompts, freqs, bases, fracs


gnss_track.launches = 0
