"""Chirp spread spectrum (LoRa-style) receiver (counterpart of
``orion_sdr_tpu/demodulate/css.py``).

Dechirp × FFT: multiplying by the conjugate base upchirp turns every
symbol into a tone at shift·bw/2^SF, so a frame demodulates as one batched
FFT over symbol windows on the device. Acquisition slides the symbol grid
over 8 coarse, then fine, sub-symbol offsets and looks for a run of
consistent preamble tones; the two downchirp sync symbols pin the payload
start. The per-offset scores, medians and argmax run on the host in numpy
(``np.median`` of an even bin count averages the two middle values, and
``argmax`` takes the first of equal peaks), as in the JAX package.

Two faults of the JAX receiver are not copied: a lock up to half a symbol
off (the preamble scores cannot tell timing) is re-timed from the sync
symbols when its payload fails the CRC, and a whole zero pad byte is not
taken for payload (see :func:`css_demod` and :func:`_payload`). Wherever
the JAX receiver decodes, the port returns the same frame.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..dsp.device import to_device
from ..dsp.osc import TAU
from ..fec.crc import crc16
from ..modulate.css import (CSS_PREAMBLE_UPCHIRPS, _chirp_phase,
                            css_samples_per_symbol)


class CssFrame(NamedTuple):
    payload: bytes
    crc_ok: bool
    snr_db: float


def _dechirp_fft(z: torch.Tensor, base: torch.Tensor, n_sym: int,
                 spsym: int, m: int) -> torch.Tensor:
    """(≥ n_sym·spsym,) capture, (spsym,) complex base chirp → (n_sym, m)
    |FFT| of the dechirped symbols."""
    d = z[: n_sym * spsym].reshape(n_sym, spsym) * base.conj()[None, :]
    # decimate the dechirped tone to the m-point grid (fs may exceed bw)
    dd = d.reshape(n_sym, m, spsym // m).sum(dim=-1)
    return torch.fft.fft(dd, dim=-1).abs().to(torch.float32)


def _base(sf: int, bw: float, fs: float, down: bool = False):
    """(cos, sin) float32 of the base chirp's phase (host numpy)."""
    f = _chirp_phase(sf, bw, fs, 0, down=down)
    ph = np.cumsum(TAU * f / fs).astype(np.float32)
    return np.cos(ph), np.sin(ph)


def _base_tensor(sf, bw, fs, down, device) -> torch.Tensor:
    re, im = _base(sf, bw, fs, down)
    return torch.complex(torch.as_tensor(re, device=device),
                         torch.as_tensor(im, device=device))


def _score(mag: np.ndarray) -> np.ndarray:
    return mag.max(axis=-1) / (np.median(mag, axis=-1) + 1e-12)


def _signed(b: int, m: int) -> int:
    return (int(b) + m // 2) % m - m // 2


def _payload(syms: np.ndarray, sc: np.ndarray, sf: int,
             m: int) -> Optional[CssFrame]:
    """Payload symbols (already shifted by the preamble bin) and their
    scores → CssFrame | None: trailing noise symbols trimmed, bits packed
    MSB first, the CRC-16 checked.

    The byte count is the packed length or one less (SF-bit packing can
    leave a partial trailing byte of pad bits), the longer tried first as
    in the JAX package. A count that passes is then shortened while its
    last byte is 0x00 and the shorter count passes too: a CRC-16 with no
    final XOR gives the message and its first CRC byte the checksum
    "second CRC byte, 0x00", so where the pad (or a noise symbol past the
    frame) holds a whole zero byte, the longer count passes falsely. The
    JAX package returns that extra byte."""
    good = sc > 8.0
    if not good.any():
        return None
    n_data = int(np.max(np.flatnonzero(good))) + 1   # trim trailing noise
    bits = ((syms[:n_data, None] >> np.arange(sf - 1, -1, -1)) & 1).astype(
        np.uint8).reshape(-1)
    n_bytes = len(bits) // 8
    if n_bytes < 2:
        return None
    data = np.packbits(bits[: n_bytes * 8])

    def crc_ok(k):
        return k >= 2 and crc16(data[:k - 2]) == (int(data[k - 2]) << 8
                                                  | int(data[k - 1]))
    k = n_bytes
    ok = crc_ok(k)
    if not ok and n_bytes > 2:
        k -= 1
        ok = crc_ok(k)
    while ok and data[k - 1] == 0 and crc_ok(k - 1):
        k -= 1
    payload = data[:k - 2]
    snr = float(20 * np.log10(max(np.mean(sc[:n_data]), 1.0) / np.sqrt(m)))
    return CssFrame(payload=bytes(payload), crc_ok=bool(ok), snr_db=snr)


def css_demod(iq, sf: int = 7, bw: float = 125_000.0,
              fs: float | None = None, device="cuda") -> Optional[CssFrame]:
    """Capture → CssFrame | None, on ``device``. Handles an unknown start
    offset (8 coarse sub-symbol lags, then a fine re-scan around the
    winner) and the constant tone-bin offset a fractional timing error
    leaves behind.

    The search scores each offset by its preamble tones alone, and the
    repeated upchirps dechirp to a pure tone at any offset, so the winner
    can sit up to half a symbol off (the JAX package's receiver, which
    this search mirrors, then decodes symbols straddling two windows). So
    when the payload at that lock fails its CRC, the lock is re-timed
    from the preamble's up bin u and the sync symbols' down bin v (a delay
    of d chips moves them to c + d and c − d, a carrier offset of c chips
    moves both), and decoded again there; the re-timed frame is returned
    when its CRC passes."""
    fs = float(fs if fs is not None else bw)
    z = to_device(iq, device, torch.complex64)
    spsym = css_samples_per_symbol(sf, bw, fs)
    m = 1 << sf
    step = spsym // m                       # samples a chip
    if z.shape[0] < (CSS_PREAMBLE_UPCHIRPS + 3) * spsym:
        return None
    # one symbol of zero tail: an off-grid alignment must not floor away
    # the final payload symbol
    z = torch.nn.functional.pad(z, (0, spsym))
    up = _base_tensor(sf, bw, fs, False, z.device)
    dn = _base_tensor(sf, bw, fs, True, z.device)

    def dechirp(off, base, n_sym=None):
        if n_sym is None:
            n_sym = (z.shape[0] - off) // spsym
        return _dechirp_fft(z[off:], base, n_sym, spsym, m).cpu().numpy()

    def scan(off):
        n_sym = (z.shape[0] - off) // spsym
        if n_sym < CSS_PREAMBLE_UPCHIRPS + 3:
            return None
        mag = dechirp(off, up, n_sym)
        score = _score(mag)
        args = mag.argmax(axis=-1)
        # preamble: a run of ≥ (N−1) argmax within ±1 bin of their median
        # (noise jitters the peak a bin) at high score
        for s0 in range(0, n_sym - CSS_PREAMBLE_UPCHIRPS - 2):
            run = args[s0: s0 + CSS_PREAMBLE_UPCHIRPS - 1]
            center = int(np.median(run))
            dev = np.minimum((run - center) % m, (center - run) % m)
            if np.all(dev <= 1) and np.all(
                    score[s0: s0 + CSS_PREAMBLE_UPCHIRPS - 1] > 6.0):
                return (float(np.mean(score[s0: s0 + 7])), off, s0,
                        center, mag, args)
        return None

    def sync(off, s0):
        """|FFT| of the two downchirp sync windows after the preamble
        against the down reference, or None past the capture's end."""
        dstart = off + (s0 + CSS_PREAMBLE_UPCHIRPS) * spsym
        if dstart + 2 * spsym > z.shape[0]:
            return None
        return dechirp(dstart, dn, 2)

    def decode(off, s0, bin0, mag, args):
        # the two downchirp sync symbols right after the preamble must
        # dechirp strongly against the down reference (a tone-like
        # interferer faking the preamble, or a one-symbol mis-lock, fails)
        dmag = sync(off, s0)
        if dmag is None or not np.all(_score(dmag) > 5.0):
            return None
        pay0 = s0 + CSS_PREAMBLE_UPCHIRPS + 2
        if pay0 >= mag.shape[0]:
            return None
        # payload symbols end where the tone collapses into noise
        return _payload((args[pay0:] - bin0) % m, _score(mag[pay0:]), sf, m)

    coarse = max(spsym // 8, 1)
    best = None
    for off in range(0, spsym, coarse):
        cand = scan(off)
        if cand is not None and (best is None or cand[0] > best[0]):
            best = cand
    if best is None:
        return None
    # fine timing around the coarse winner (the grid stays anchored on it):
    # a residual sub-symbol error smears the tone and costs ~5 dB
    fine = max(spsym // 64, 1)
    base_off = best[1]
    for doff in range(-coarse // 2, coarse // 2 + 1, fine):
        off2 = base_off + doff
        if off2 < 0 or doff == 0:
            continue
        cand = scan(off2)
        if cand is not None and cand[0] > best[0]:
            best = cand
    _, off, s0, bin0, mag, args = best
    frame = decode(off, s0, bin0, mag, args)
    if frame is not None and frame.crc_ok:
        return frame

    # re-time: of the two sync windows the one that holds a single
    # downchirp (the first when the lock is late, the second when early)
    # scores higher
    dmag = sync(off, s0)
    if dmag is None:
        return frame
    v = _signed(dmag[int(np.argmax(_score(dmag)))].argmax(), m)
    u = _signed(bin0, m)
    d0 = _signed(u - v, m) // 2
    # 2d ≡ u − v (mod m) leaves the delay d modulo m/2, and locks whole
    # symbols apart read the same bins: both halves (the smaller carrier
    # offset c = u − d first), each at the lock's symbol and its two
    # neighbours, until one decodes with its CRC
    for d in sorted((d0, _signed(d0 + m // 2, m)),
                    key=lambda d: abs(_signed(u - d, m))):
        start = off + s0 * spsym - d * step   # the preamble's first sample
        off2 = start % spsym
        mag2 = dechirp(off2, up)
        args2 = mag2.argmax(axis=-1)
        for s02 in (start // spsym, start // spsym - 1,
                    start // spsym + 1):
            if s02 < 0 or (d == 0 and off2 == off and s02 == s0):
                continue
            retimed = decode(off2, s02, (u - d) % m, mag2, args2)
            if retimed is not None and retimed.crc_ok:
                return retimed
    return frame
