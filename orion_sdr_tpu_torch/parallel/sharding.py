"""Channel-parallel and time-parallel sharding (counterpart of
``orion_sdr_tpu/parallel/sharding.py``).

* channel parallel: many independent signals split over the mesh's ``ch``
  axis with no communication (``shard_channels``, the service-parallel
  DVB-T receive);
* time parallel: one fast stream split into time blocks; FIR overlap-save
  needs each shard to see its left neighbour's last ``ntaps − 1`` samples,
  a halo that :func:`~.mesh.ppermute` moves between shards: the streaming
  filter's state carry, turned into a collective. OFDM splits on symbol
  boundaries and needs no halo (CPE gathers one phase a symbol).

Results come back as tensors on the mesh's first device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constellation import bits_per_symbol, soft_llr
from ..dsp import fir as _fir
from ..dsp.device import to_device
from ..dsp.osc import TAU
from .mesh import Mesh, all_gather, ppermute, shard, unshard

_HOST_DTYPES = {np.dtype(np.float64): torch.float32,
                np.dtype(np.complex128): torch.complex64}


def as_tensor(x, device) -> torch.Tensor:
    """A tensor stays where it is; host data goes to ``device``, float64
    and complex128 narrowed to the single precision the JAX package works
    in."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return to_device(a, device, _HOST_DTYPES.get(a.dtype))


def make_mesh(n_devices: int | None = None, axis_names=("ch", "t"),
              shape=None, devices=None) -> Mesh:
    """A 2-D (channel × time) mesh, by default every device on ``ch``.
    ``devices``: the shards' devices (names or ``torch.device``, repeats
    allowed: ``["cuda:0"] * 8`` is eight shards on one card); None takes
    every CUDA device and raises when there is none."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "(e.g. ['cpu'] * 8) for a mesh of host shards")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"{n} shards asked of {len(devs)} devices")
    if shape is None:
        shape = (n, 1)
    return Mesh(np.asarray(devs[:n], dtype=object).reshape(shape), axis_names)


def shard_channels(fn, mesh: Mesh, axis: str = "ch"):
    """``fn`` with its first argument split on its leading (channel) axis
    over ``axis``: each shard runs ``fn`` on its rows (no collectives), the
    outputs (a tensor or a tuple of tensors) concatenated on the mesh's
    first device."""
    def wrapped(x, *args, **kw):
        xs = shard(as_tensor(x, mesh.first_device), mesh, (axis,))
        out = xs.map(lambda b: fn(b, *args, **kw))
        first = out.blocks.flat[0]
        if isinstance(first, tuple):
            return tuple(unshard(out.part(i), (axis,))
                         for i in range(len(first)))
        return unshard(out, (axis,))
    return wrapped


def _left_halo(xs, axis: str, width: int):
    """Each shard's left neighbour's last ``width`` samples (zeros on shard
    0): shard i sends its tail to shard i + 1."""
    nd = xs.mesh.shape[axis]
    tails = xs.map(lambda b: b[..., max(b.shape[-1] - width, 0):])
    return ppermute(tails, axis, [(i, i + 1) for i in range(nd - 1)])


def fir_overlap_save_sharded(x, taps, mesh: Mesh, time_axis: str = "t"):
    """Causal FIR over a time-sharded stream with halo exchange. ``x``:
    (..., n), n divisible by the mesh's ``time_axis`` size; each shard
    filters its block after receiving its left neighbour's last ntaps − 1
    samples (overlap-save): the single-device causal FIR."""
    taps = np.asarray(taps, np.float32)
    ntaps = len(taps)
    x = as_tensor(x, mesh.first_device)
    spec = (None,) * (x.dim() - 1) + (time_axis,)
    xs = shard(x, mesh, spec)
    left = _left_halo(xs, time_axis, ntaps - 1)
    ys = xs.map(lambda b, h: _fir.fir_apply(b, taps, state=h)[0], left)
    return unshard(ys, spec)


def fm_demod_sharded(iq, taps, mesh: Mesh, fs: float, deviation_hz: float):
    """A demod chain sharded over both axes: channels across ``ch``, time
    across ``t``, with the FIR tail and the discriminator's previous sample
    as one halo of ``ntaps`` samples. ``iq``: (channels, n). Returns the
    discriminator output at the input rate (float32)."""
    taps = np.asarray(taps, np.float32)
    ntaps = len(taps)
    k = 1.0 / max(deviation_hz, 1.0)
    zs = shard(as_tensor(iq, mesh.first_device), mesh, ("ch", "t"))
    left = _left_halo(zs, "t", ntaps)

    def body(zb, h):
        y, _ = _fir.fir_apply(zb, taps, state=h[..., 1:])
        # the block's first sample needs the filtered value of the halo's
        # last input: recomputed from the halo itself (exact)
        yl, _ = _fir.fir_apply(h[..., -1:], taps, state=h[..., :-1])
        prev = torch.cat([yl, y[..., :-1]], dim=-1)
        prod = y * torch.conj(prev)
        return (torch.atan2(prod.imag, prod.real) * k).to(torch.float32)

    return unshard(zs.map(body, left), ("ch", "t"))


def ofdm_soft_demap_sharded(cfg, constellation: str, iq, n_symbols: int,
                            mesh: Mesh, estimate=None):
    """Symbol-aligned time + channel sharding of the OFDM soft demap:
    ``iq`` (channels, n_symbols·sps) split over (``ch``, ``t``), each shard
    demapping whole symbols, every branch of ``frame.demodulator.
    soft_demap``: per-symbol pilot_interp (no halo), a held per-bin
    ``estimate`` (n_fft,) broadcast into every shard's ZF, DFT despreading,
    CPE (the raw phases, one a symbol, all-gathered over ``t`` and
    unwrapped whole on every shard), CSI weighting. Returns (channels,
    n_symbols·n_data·bits) LLRs."""
    from ..multicarrier import CarrierGrid, grid_extract, symbol_fft
    from ..ofdm import (channel_estimate_pilots, cpe_raw_phases, cpe_unwrap,
                        dft_deprecode, zf_equalize)

    g = CarrierGrid(cfg.carrier_plan)
    sps = g.n_fft + g.cp_len
    z = as_tensor(iq, mesh.first_device).to(torch.complex64)
    if z.dim() != 2 or z.shape[1] != n_symbols * sps:
        raise ValueError(f"iq must be (channels, {n_symbols * sps}), got "
                         f"{tuple(z.shape)}")
    t_dim = mesh.shape["t"]
    if n_symbols % t_dim:
        raise ValueError("symbols must split evenly across t")
    local_syms = n_symbols // t_dim
    pilots = cfg.equalizer_method == "pilot_interp" and g.pilot_bins.size
    est = None
    if estimate is not None and not pilots:
        est = as_tensor(estimate, mesh.first_device).to(torch.complex64)
    bits = bits_per_symbol(constellation)

    def front(zb):
        freq = symbol_fft(zb, g.n_fft, g.cp_len,
                          backoff=cfg.rx_window_backoff, n_symbols=local_syms)
        csi = None
        if pilots:
            known = g.pilot_values * np.complex64(cfg.gain)
            h = channel_estimate_pilots(freq, g.pilot_bins, known, g.n_fft)
            freq = zf_equalize(freq, h)
            csi = (h.abs() ** 2).to(torch.float32)
        elif est is not None:
            h = est.to(zb.device)
            freq = zf_equalize(freq, h)
            csi = (h.abs() ** 2).to(torch.float32)
        syms = grid_extract(g, freq)
        if cfg.transform_precoding:
            syms = dft_deprecode(syms)
            csi = None
        raw = (cpe_raw_phases(syms, constellation)
               if cfg.phase_tracking == "cpe" else None)
        return syms, csi, raw

    zs = shard(z, mesh, ("ch", "t"))
    st = zs.map(front)
    if cfg.phase_tracking == "cpe":
        full = all_gather(st.part(2), "t", dim=-1)

        def derotate(pos, s, raw_full):
            un = cpe_unwrap(raw_full, constellation)
            i = pos["t"] * local_syms
            loc = un[..., i:i + local_syms]
            rot = torch.polar(torch.ones_like(loc, dtype=torch.float32),
                              -loc.to(torch.float32))
            return s[0] * rot[..., None]
        syms = st.map(derotate, full, indexed=True)
    else:
        syms = st.part(0)

    def back(s, f):
        csi = f[1]
        llr = soft_llr(s.reshape(s.shape[:-2] + (-1,)), constellation)
        if csi is None:
            return llr
        cd = grid_extract(g, csi)
        w = cd / torch.clamp(cd.mean(-1, keepdim=True), min=1e-9)
        return (llr.reshape(llr.shape[:-1] + (local_syms,
                                              g.num_data_carriers, bits))
                * w[..., None]).reshape(llr.shape)

    return unshard(syms.map(back, st), ("ch", "t"))


def dvb_t_receive_sharded(segs, n_symbols: int, cp_len: int, backoff: int,
                          vbits: int, mesh: Mesh):
    """Service-parallel DVB-T receive: B aligned frame captures split over
    every shard of the mesh, each shard running the whole receive
    (``demodulate.dvb_t_frame.receive_frame_body``) on its frames, with no
    communication. Returns (llrs, tps_cells)."""
    from ..demodulate.dvb_t_frame import receive_frame_body

    z = as_tensor(segs, mesh.first_device).to(torch.complex64)
    if z.dim() != 2:
        raise ValueError("segs must be (frames, samples)")
    flat = mesh.flat("ch")
    if z.shape[0] % flat.size:
        raise ValueError("frame count must split evenly across the mesh")
    out = shard(z, flat, ("ch",)).map(
        lambda b: receive_frame_body(b, n_symbols, cp_len, backoff, vbits))
    return unshard(out.part(0), ("ch",)), unshard(out.part(1), ("ch",))
