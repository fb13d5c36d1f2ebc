"""Whole-frame multicarrier ops: grid map/extract, IFFT/CP, symbol window/FFT
(counterpart of ``orion_sdr_tpu/multicarrier/ops.py``).

A frame of N symbols is one batched tensor op over ``(..., n_symbols,
n_fft)``. FFT conventions: unity forward, 1/N-folded inverse (torch's
default), natural bin order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..dsp.device import takes_host_data
from ..constellation import map_bits, bits_per_symbol
from .plan import CarrierGrid


@takes_host_data("data_symbols")
def grid_map(grid: CarrierGrid, data_symbols: torch.Tensor,
             pilot_bins=None, pilot_values=None) -> torch.Tensor:
    """Scatter dense data symbols (..., n_sym, n_data) into FFT bins →
    (..., n_sym, n_fft), nulls zeroed and pilots inserted. ``pilot_bins``/
    ``pilot_values`` (numpy) override the grid's own pilots, as (n_pilots,)
    or per symbol (n_sym, n_pilots) for scattered layouts. Each bin reads
    from concat([data, pilots, 0]) through one static index table (one
    row a symbol for a per-symbol layout)."""
    d = data_symbols.to(torch.complex64)
    pb = grid.pilot_bins if pilot_bins is None else np.asarray(pilot_bins)
    pv = grid.pilot_values if pilot_values is None else np.asarray(pilot_values)
    pb = pb.astype(np.int64)
    n_data, n_pil = d.shape[-1], (pb.shape[-1] if pb.size else 0)
    pvt = torch.as_tensor(np.asarray(pv, np.complex64),
                          device=d.device).expand(d.shape[:-1] + (n_pil,))
    src = torch.cat([d, pvt, d.new_zeros(d.shape[:-1] + (1,))], dim=-1)
    zero_slot = n_data + n_pil                            # nulls → the 0 slot
    if pb.ndim <= 1:
        idx = np.full(grid.n_fft, zero_slot, np.int64)
        idx[grid.data_bins] = np.arange(n_data)
        idx[pb] = n_data + np.arange(n_pil)
        return src[..., torch.as_tensor(idx, device=d.device)]
    idx = np.full((pb.shape[0], grid.n_fft), zero_slot, np.int64)
    idx[:, grid.data_bins] = np.arange(n_data)
    np.put_along_axis(idx, pb, n_data + np.arange(n_pil), axis=-1)
    idx = torch.as_tensor(idx, device=d.device)
    return src.gather(-1, idx.expand(d.shape[:-1] + (grid.n_fft,)))


@takes_host_data("bits")
def map_bits_grid(grid: CarrierGrid, bits: torch.Tensor, order: str
                  ) -> torch.Tensor:
    """Constellation map + grid placement with the grid's own pilots:
    bits (..., n_sym·bps·n_data) → (..., n_sym, n_fft)."""
    spb = bits_per_symbol(order) * grid.num_data_carriers
    n_sym = bits.shape[-1] // spb
    if n_sym * spb != bits.shape[-1]:
        raise ValueError("bits length must be a whole number of OFDM symbols")
    syms = map_bits(bits, order).reshape(
        bits.shape[:-1] + (n_sym, grid.num_data_carriers))
    return grid_map(grid, syms)


@takes_host_data("freq_symbols")
def grid_extract(grid: CarrierGrid, freq_symbols: torch.Tensor) -> torch.Tensor:
    """(..., n_sym, n_fft) → (..., n_sym, n_data): gather the data bins."""
    return freq_symbols[..., grid.tensor("data_bins", freq_symbols.device)]


@takes_host_data("freq_grid")
def ofdm_assemble(freq_grid: torch.Tensor, cp_len: int,
                  taper: Optional[np.ndarray] = None) -> torch.Tensor:
    """IFFT + cyclic-prefix insert + optional per-symbol edge taper:
    (..., n_sym, n_fft) → time (..., n_sym·(n_fft+cp_len))."""
    x = torch.fft.ifft(freq_grid, dim=-1).to(torch.complex64)
    if cp_len > 0:
        x = torch.cat([x[..., -cp_len:], x], dim=-1)
    if taper is not None:
        x = x * torch.as_tensor(taper, device=x.device)
    return x.reshape(x.shape[:-2] + (-1,))


def symbol_taper(symbol_len: int, roll_off: int) -> Optional[np.ndarray]:
    """Raised-cosine (Tukey) edge taper table: ramp[i] = 0.5·(1 −
    cos(π(i+0.5)/L)) on the first and last ``roll_off`` samples of each
    symbol. None when roll_off == 0."""
    roll_off = min(roll_off, symbol_len // 2)
    if roll_off == 0:
        return None
    w = np.ones(symbol_len, dtype=np.float32)
    i = np.arange(roll_off)
    ramp = 0.5 * (1.0 - np.cos(np.pi * (i + 0.5) / roll_off))
    w[:roll_off] = ramp
    w[symbol_len - 1 - i] = ramp
    return w


@takes_host_data("time_stream")
def symbol_fft(time_stream: torch.Tensor, n_fft: int, cp_len: int,
               backoff: int = 0, n_symbols: Optional[int] = None
               ) -> torch.Tensor:
    """RX window-select + FFT over whole frames: (..., ≥ n_sym·(n_fft+cp))
    → (..., n_sym, n_fft). The FFT window of each symbol starts at
    ``cp_len − backoff`` (backoff clamped to cp_len)."""
    sym_len = n_fft + cp_len
    backoff = min(backoff, cp_len)
    if n_symbols is None:
        n_symbols = time_stream.shape[-1] // sym_len
    x = time_stream[..., : n_symbols * sym_len]
    x = x.reshape(x.shape[:-1] + (n_symbols, sym_len))
    start = cp_len - backoff
    return torch.fft.fft(x[..., start:start + n_fft], dim=-1).to(torch.complex64)


def max_pilot_safe_backoff(n_fft: int, pilot_spacing: int) -> int:
    """The largest RX window backoff, n_fft/(2·spacing), below which
    interpolating between pilots ``pilot_spacing`` bins apart does not
    alias the backoff's phase slope."""
    return n_fft // (2 * max(pilot_spacing, 1))
