"""GPS early/prompt/late tracking loops: the Hopper kernel
``csrc/gnss_track.cu`` beside its plain torch version.

The JAX package runs the epoch recurrence as a ``lax.scan``
(``_track_scan``, ``orion_sdr_tpu/gnss.py:200-254``; no Pallas kernel), and
its bench ``vmap``s it over satellites: three sliced, carrier-wiped code
correlations an epoch, a Costas discriminator, an envelope DLL and a
carrier-aided code NCO carried as an int32 epoch base and a float32
fraction. In eager torch each epoch would be some seventy launches; the
kernel runs one block of ``THREADS`` threads a satellite with the epochs in
a loop inside it, each epoch's samples prefetched into shared memory while
the epoch before runs.

:func:`gnss_track` launches the kernel for a CUDA capture (built with nvcc
at first use; a failed build or launch raises) and runs
:func:`track_reference` for a CPU one; it counts its launches in
``.launches`` and keeps the last launch's window misses (the epochs per
satellite that read device memory, not the prefetched window) in
``.last_misses``. The plain version sums each correlation in the kernel's
fixed order (``THREADS`` strided partial sums, a pairwise tree within each
warp of 32, then a pairwise tree over the warps) and writes every complex
product in real arithmetic, so the two agree bit for bit on the card.
Against the JAX scan (XLA's dot order, its cos/sin and fused multiply-adds)
they agree within float32 rounding carried by the loops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..buildlib import NVCC_FLAGS_NO_FMA, PTR, INT, I64, F32, CudaLib

_LIB = CudaLib("gnss_track", NVCC_FLAGS_NO_FMA, {
    "gnss_track": [PTR, I64, PTR, INT, INT, PTR, PTR, I64, INT, INT, INT, F32,
                   F32, F32, F32, F32, F32, F32, F32, PTR, PTR, PTR, PTR, PTR,
                   PTR]})
build = _LIB.build

# threads a satellite (128, 256 or 512), the width of the kernel's and the
# plain version's sum order: the fastest of chip_smoke [41]'s sweep at 8
# satellites x 2000 epochs (PERF.md §6)
THREADS = 512
WARP = 32
# M: the code shift (samples) an epoch's prefetched window allows for, on
# each side of the slices the epoch before predicts
WINDOW_MARGIN = 8
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


def _sum_fixed(p: torch.Tensor, threads: int | None = None) -> torch.Tensor:
    """(..., spms) → (...,): the kernel's order at ``threads`` threads
    (default ``THREADS``) — each thread's strided partial sum in turn (zero
    padded), pairs (l, l + s) for s = 16 .. 1 within each warp of 32, then
    pairs (w, w + s) for s = threads/64 .. 1 over the warp sums."""
    T = THREADS if threads is None else threads
    spms = p.shape[-1]
    J = -(-spms // T)
    p = torch.nn.functional.pad(p, (0, J * T - spms))
    p = p.reshape(p.shape[:-1] + (J, T))
    acc = torch.zeros(p.shape[:-2] + (T,), dtype=p.dtype, device=p.device)
    for j in range(J):
        acc = acc + p[..., j, :]
    acc = acc.reshape(acc.shape[:-1] + (T // WARP, WARP))
    for width in (WARP, T // WARP):
        stride = width // 2
        while stride:
            acc = acc[..., :stride] + acc[..., stride:2 * stride]
            stride //= 2
        acc = acc[..., 0]
    return acc


def slice_start(s: torch.Tensor, n: int, spms: int) -> torch.Tensor:
    """``lax.dynamic_slice``'s start: a negative start wraps by n
    (numpy-style), then the start clamps to [0, n − spms]."""
    return torch.clamp(torch.where(s < 0, s + n, s), 0, n - spms)


def window_misses(starts: torch.Tensor, bases: torch.Tensor, n: int,
                  spms: int, d_el: int, margin: int = WINDOW_MARGIN
                  ) -> torch.Tensor:
    """The kernel's window misses, from a run's (S,) starts and (S, E)
    output bases: (S,) int32, the epochs whose three slices do not all lie
    in the window placed from the base before (from start − spms for the
    first), [b + spms − d − M, b + 2·spms + d + M) clamped to the capture,
    its start rounded down to even and its length up to even (down where
    that would pass the capture's end), as its bulk copy needs. The kernel
    reads those epochs from device memory (a 16-byte aligned capture whose
    two windows fit the block's shared memory)."""
    base = torch.cat([starts.to(bases.device, torch.int64)[:, None],
                      bases[:, :-1].to(torch.int64)], dim=1)
    prev = torch.cat([base[:, :1] - spms, base[:, :-1]], dim=1)
    lo = torch.clamp(prev + spms - d_el - margin, min=0)
    lo = lo - lo % 2
    hi = torch.clamp(prev + 2 * spms + d_el + margin, max=n)
    cnt = torch.clamp(hi - lo, min=0)
    cnt = cnt + cnt % 2
    cnt = torch.where(lo + cnt > n, cnt - 2, cnt)
    sl = [slice_start(base + o, n, spms) for o in (-d_el, 0, d_el)]
    s_lo = torch.minimum(torch.minimum(sl[0], sl[1]), sl[2])
    s_hi = torch.maximum(torch.maximum(sl[0], sl[1]), sl[2]) + spms
    inside = (cnt > 0) & (s_lo >= lo) & (s_hi <= lo + cnt)
    return (~inside).sum(-1).to(torch.int32)


def _sign(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0.0, 1.0, torch.where(x < 0.0, -1.0, 0.0))


def track_reference(z: torch.Tensor, codes: torch.Tensor,
                    starts: torch.Tensor, f0: torch.Tensor, fs: float,
                    n_epochs: int, k_pll_f: float, k_pll_p: float,
                    k_dll: float, threads: int | None = None):
    """Plain version: one epoch a loop iteration, all satellites at once,
    in the kernel's real operations and sum order at ``threads`` threads a
    satellite (default ``THREADS``)."""
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
        er, ei, pr, pi, lr, li = _sum_fixed(torch.stack(prods),
                                                threads)
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
    fractions (S, E) float32) on the capture's device, E = ``n_epochs``.
    On the card ``gnss_track.last_misses`` is then the (S,) int32 count of
    each satellite's epochs that read device memory."""
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
    if z.shape[0] >= 1 << 31:
        raise ValueError("the tracking kernel takes captures of up to 2^31 - 1 "
                         "samples")
    E = int(n_epochs)
    prompts = torch.empty((S, E), dtype=torch.complex64, device=dev)
    freqs = torch.empty((S, E), dtype=torch.float32, device=dev)
    bases = torch.empty((S, E), dtype=torch.int32, device=dev)
    fracs = torch.empty((S, E), dtype=torch.float32, device=dev)
    misses = torch.zeros(S, dtype=torch.int32, device=dev)
    if S and E:
        zc = z.contiguous()
        if zc.data_ptr() % 16:
            zc = zc.clone()         # the window's bulk copy reads 16-byte units
        _launch_into(zc, codes, starts, f0, fs, k_pll_f, k_pll_p, k_dll,
                     prompts, freqs, bases, fracs, misses)
        gnss_track.launches += 1
    gnss_track.last_misses = misses
    return prompts, freqs, bases, fracs


def _launch_into(z: torch.Tensor, codes: torch.Tensor, starts: torch.Tensor,
                 f0: torch.Tensor, fs: float, k_pll_f: float, k_pll_p: float,
                 k_dll: float, prompts: torch.Tensor, freqs: torch.Tensor,
                 bases: torch.Tensor, fracs: torch.Tensor,
                 misses: torch.Tensor, threads: int | None = None) -> None:
    """Launches the kernel on the caller's buffers, all contiguous CUDA
    tensors: :func:`gnss_track`'s inputs, its four (S, E) outputs and the
    (S,) int32 window misses, at ``threads`` threads a satellite (default
    ``THREADS``). A capture that is not 16-byte aligned reads every
    epoch from device memory."""
    S, spms = codes.shape
    c = loop_constants(fs, spms, k_pll_f, k_pll_p, k_dll)
    _LIB.launch("gnss_track", z.device, z.data_ptr(), z.shape[0],
                codes.data_ptr(), S, spms, starts.data_ptr(), f0.data_ptr(),
                prompts.shape[1], c["d_el"], WINDOW_MARGIN,
                THREADS if threads is None else threads, c["w0"],
                c["spms_f"], c["tau"], c["l1"], c["spc"], c["kf"], c["kp"],
                c["kd"], prompts.data_ptr(), freqs.data_ptr(),
                bases.data_ptr(), fracs.data_ptr(), misses.data_ptr())


gnss_track.launches = 0
gnss_track.last_misses = None
