"""Streaming multi-channel channelizer (counterpart of
``orion_sdr_tpu/dsp/channelizer.py``).

One batched program a block extracts C baseband channels from a wideband
capture: a (C, N) complex rotate to every center, one anti-alias FIR over
the channel batch, decimation to the channel rate. Carried mixer phases,
filter tails and the input remainder stay on the channelizer's device
between blocks; the fixed internal block (m·4096 wideband samples) makes
the output independent of how callers chunk their feeds. The gateway front
end of the band receivers (``OfdmFrameBandStreamDemod``,
``DvbTBandStreamDemod``, ``am_band_demod``, ``ssb_band_demod``,
``fm_band_demod``), and with ``band_compose`` its TX mirror.

Phase ramps, as the JAX package's jitted block rounds them: the mixer
phase of sample k (1-based) is ``phase0 + w·k`` with ``w = c·f``, ``c =
float32(−2π/fs)``, in one rounding (XLA fuses the multiply-add; formed
here in float64 and rounded once); the carried phase is ``(phase0 +
f·float32(c·L)) mod 2π`` in one rounding (XLA folds the constant c·L
before the multiply-add).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .device import sanitize_iq, to_device
from .fir import (fir_apply, fir_filter_aligned, kaiser_lowpass_taps,
                  kaiser_num_taps)

_TAU = float(2.0 * np.pi)


def _channelize_block(z: torch.Tensor, f: torch.Tensor, c: np.float32,
                      phase0: torch.Tensor, fir_state: torch.Tensor,
                      taps: np.ndarray, m: int):
    """Mix C channels to baseband, lowpass, decimate.

    ``z`` (L,) complex64 with L a multiple of ``m``; ``f`` (C,) float32
    centers (Hz) and ``c`` = float32(−2π/fs); ``phase0`` (C,) float32
    carried mixer phases; ``fir_state`` (C, ntaps−1) carried filter tails.
    Returns (y (C, L/m), phase_out (C,), new_state)."""
    n = z.shape[-1]
    w = (float(c) * f).double()                        # float32 product
    k = torch.arange(1, n + 1, dtype=torch.float64, device=z.device)
    ph = (phase0.double()[:, None] + w[:, None] * k).to(torch.float32)
    zb = z[None, :] * torch.polar(torch.ones_like(ph), ph)
    cn = float(c * np.float32(n))
    phase_out = torch.remainder(
        (phase0.double() + f.double() * cn).to(torch.float32), _TAU)
    y, st = fir_apply(zb, taps, state=fir_state)
    return y[..., ::m], phase_out, st


def _anti_alias_taps(fs_hi: float, fs_lo: float, passband_hz: float,
                     stopband_db: float) -> np.ndarray:
    """Kaiser lowpass at ``fs_hi`` passing ``passband_hz`` with its −6 dB
    point midway between that and the Nyquist of ``fs_lo``."""
    pass_n = float(passband_hz) / fs_hi
    stop_n = 0.5 * fs_lo / fs_hi
    trans = max(stop_n - pass_n, 1e-4)
    return kaiser_lowpass_taps(kaiser_num_taps(trans, stopband_db),
                               0.5 * (pass_n + stop_n), stopband_db)


def _rate_ratio(fs_hi: float, fs_lo: float, what: str) -> int:
    m = fs_hi / fs_lo
    if abs(m - round(m)) > 1e-9 or round(m) < 1:
        raise ValueError(f"{what} ({fs_hi}) must be an integer multiple of "
                         f"the channel rate ({fs_lo})")
    return int(round(m))


def band_compose(chans, centers_hz, fs_out: float, fs_in: float,
                 passband_hz: float | None = None,
                 stopband_db: float = 60.0, device="cuda") -> torch.Tensor:
    """Compose C channel-rate signals into one wideband capture: zero-stuff
    ×(fs_out/fs_in), anti-image lowpass over the channel batch, mix each
    channel to its center, sum (the TX mirror of :class:`Channelizer`).
    Group-delay-free: channel sample k lands at wideband sample k·m.

    ``chans``: (C, n) complex at ``fs_in``; ``centers_hz``: (C,) offsets
    from the output center. Returns (n·m,) complex64 on ``device``."""
    x = to_device(chans, device, torch.complex64)
    if x.dim() != 2:
        raise ValueError("chans must be (C, n)")
    m = _rate_ratio(fs_out, fs_in, "fs_out")
    centers = np.asarray(list(centers_hz), np.float32)
    if centers.shape != (x.shape[0],):
        raise ValueError("need one center per channel")
    if np.any(np.abs(centers) >= fs_out / 2.0):
        raise ValueError("channel centers must sit inside ±fs_out/2")
    if m == 1:
        taps = np.ones(1, np.float32)
    else:
        taps = _anti_alias_taps(fs_out, fs_in, 0.4 * fs_in if passband_hz
                                is None else passband_hz, stopband_db)
    c, n = x.shape
    xz = torch.zeros((c, n * m), dtype=x.dtype, device=x.device)
    xz[:, ::m] = x
    y = fir_filter_aligned(xz, taps * np.float32(m))  # zero-stuff power back
    w = np.float32(_TAU / fs_out) * centers          # rad/sample, +center
    k = torch.arange(1, n * m + 1, dtype=torch.float32, device=x.device)
    ph = torch.as_tensor(w, device=x.device)[:, None] * k
    return (y * torch.polar(torch.ones_like(ph), ph)).sum(dim=-2).to(
        torch.complex64)


class Channelizer:
    """Streaming C-channel extraction from one wideband stream on
    ``device``.

    ``fs_wide`` must be an integer multiple of ``fs_out``. ``passband_hz``
    is the one-sided bandwidth each channel must pass undistorted (default
    0.4·fs_out); the anti-alias Kaiser lowpass puts its −6 dB point midway
    between that and the output Nyquist.
    """

    def __init__(self, fs_wide: float, fs_out: float,
                 centers_hz: Sequence[float],
                 passband_hz: float | None = None,
                 stopband_db: float = 60.0, device="cuda") -> None:
        self.m = _rate_ratio(fs_wide, fs_out, "fs_wide")
        self.fs_wide = float(fs_wide)
        self.fs_out = float(fs_out)
        self.device = torch.device(device)
        self.centers_hz = np.asarray(list(centers_hz), np.float32)
        if self.centers_hz.ndim != 1 or self.centers_hz.size == 0:
            raise ValueError("centers_hz must be a non-empty 1-D sequence")
        if np.any(np.abs(self.centers_hz) >= fs_wide / 2.0):
            raise ValueError("channel centers must sit inside ±fs_wide/2")
        self.taps = _anti_alias_taps(
            fs_wide, fs_out, 0.4 * fs_out if passband_hz is None
            else passband_hz, stopband_db)
        c = self.centers_hz.size
        self._f = torch.as_tensor(self.centers_hz, device=self.device)
        self._c = np.float32(-_TAU / fs_wide)
        self._phase = torch.zeros(c, dtype=torch.float32, device=self.device)
        self._state = torch.zeros((c, len(self.taps) - 1),
                                  dtype=torch.complex64, device=self.device)
        self._rem = torch.zeros(0, dtype=torch.complex64, device=self.device)
        # fixed internal block aligned to absolute sample offsets: the output
        # does not depend on the feed sizes, and the float32 in-block phase
        # ramp stays within ~0.006 rad of rounding (the carried remainder
        # re-anchors the phase every block)
        self._block = self.m * 4096

    @property
    def num_channels(self) -> int:
        return int(self.centers_hz.size)

    def __len__(self) -> int:
        return self._rem.shape[0]

    def _empty(self) -> torch.Tensor:
        return torch.zeros((self.num_channels, 0), dtype=torch.complex64,
                           device=self.device)

    def _run(self, block: torch.Tensor) -> torch.Tensor:
        y, self._phase, self._state = _channelize_block(
            block, self._f, self._c, self._phase, self._state, self.taps,
            self.m)
        return y

    def push(self, iq) -> torch.Tensor:
        """Feed wideband IQ (host data or a tensor), get (C, n_new)
        baseband output on the device (n_new may be 0 while the input
        buffers up to an internal block)."""
        buf = torch.cat([self._rem, sanitize_iq(to_device(iq, self.device))])
        n_blocks = buf.shape[0] // self._block
        take = n_blocks * self._block
        self._rem = buf[take:]
        if not take:
            return self._empty()
        outs = [self._run(buf[i * self._block:(i + 1) * self._block])
                for i in range(n_blocks)]
        return outs[0] if n_blocks == 1 else torch.cat(outs, dim=-1)

    def flush(self) -> torch.Tensor:
        """Drain the remainder (zero-padded up to a decimation multiple);
        empty if nothing is buffered."""
        n = self._rem.shape[0]
        if not n:
            return self._empty()
        take = -(-n // self.m) * self.m
        block = torch.nn.functional.pad(self._rem, (0, take - n)) \
            if take > n else self._rem
        self._rem = self._rem[:0]
        return self._run(block)


class BandStreams:
    """C per-channel stream receivers behind one :class:`Channelizer`: the
    common body of the band receivers. Each stream is fed its row of the
    channelizer's device output (no host round trip) and keeps its own
    Incomplete/Failed semantics; ``feed``/``flush`` return {channel_index:
    new results} for the channels that produced anything."""

    def __init__(self, channelizer: Channelizer, streams: list) -> None:
        self.channelizer = channelizer
        self.streams = streams

    @property
    def centers_hz(self) -> np.ndarray:
        return self.channelizer.centers_hz

    def __len__(self) -> int:
        return len(self.channelizer)

    def _drain(self, y: torch.Tensor) -> dict:
        out = {}
        if y.shape[-1]:
            for c, s in enumerate(self.streams):
                res = s.feed(y[c])
                if res:
                    out[c] = res
        return out

    def feed(self, iq) -> dict:
        """Feed wideband IQ (any size: the output does not depend on the
        chunking)."""
        return self._drain(self.channelizer.push(iq))

    def flush(self) -> dict:
        """Process the sub-decimation remainder and drain every stream."""
        out = self._drain(self.channelizer.flush())
        for c, s in enumerate(self.streams):
            res = s.flush()
            if res:
                out.setdefault(c, []).extend(res)
        return out
