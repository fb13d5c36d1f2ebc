"""AFSK-1200 (Bell 202) receiver → AX.25 frames, and the RTTY receivers
(counterpart of ``orion_sdr_tpu/demodulate/afsk.py``).

Non-coherent dual-tone discrimination: complex correlators at the mark and
space tones (mix, then a boxcar over one bit: a matched filter for the
tone envelope), the decision waveform |mark| − |space|, bit sampling on
the baud grid with a timing-offset search, NRZI decode, HDLC deframe and
FCS. The decision waveform is one batched device program over (…, n)
audio (the boxcar through ``dsp/fir.py::conv1d_f32``, TF32 off); timing
and framing are host numpy, text-rate work, as in the JAX package.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..dsp.device import to_device
from ..dsp.fir import conv1d_f32
from ..dsp.osc import TAU
from ..modulate.afsk import AFSK_BAUD, AFSK_MARK_HZ, AFSK_SPACE_HZ
from ..modulate.afsk import nrzi_decode


def fsk2_decision(audio, fs: float, sps_i: int,
                  mark_hz: float = AFSK_MARK_HZ,
                  space_hz: float = AFSK_SPACE_HZ, device="cuda"):
    """(…, n) audio → (…, n) float32 decision waveform |mark| − |space|
    (boxcar matched filters one bit long, centred, zero edges) — shared by
    AFSK-1200 and RTTY."""
    x = to_device(audio, device, torch.float32)
    lead, n = x.shape[:-1], x.shape[-1]
    t = torch.arange(1, n + 1, dtype=torch.float32, device=x.device)
    rows = []
    for f_hz in (mark_hz, space_hz):
        ph = float(np.float32(TAU * f_hz / fs)) * t
        rows += [x * torch.cos(ph), x * torch.sin(ph)]
    r = torch.stack(rows).reshape(-1, n)
    r = torch.nn.functional.pad(r, (sps_i // 2, sps_i - 1 - sps_i // 2))
    w = torch.full((1, 1, sps_i), float(np.float32(1.0) / np.float32(sps_i)),
                   dtype=torch.float32, device=x.device)
    bb = conv1d_f32(r, w)[:, 0].reshape((2, 2) + tuple(lead) + (n,))
    env = torch.sqrt(bb[:, 0] * bb[:, 0] + bb[:, 1] * bb[:, 1])
    return env[0] - env[1]


def _best_bit_values(d: np.ndarray, sps: float) -> np.ndarray:
    """Sample a decision waveform at the baud grid, searching 8 timing
    offsets for the one maximizing mean |decision| — shared by the AFSK,
    RTTY and AIS paths."""
    n_bits = int(len(d) / sps) - 1
    if n_bits < 8:
        return np.zeros(0, np.float32)
    best = None
    for off in np.arange(0.0, sps, sps / 8.0):
        centers = (off + sps / 2.0 + np.arange(n_bits) * sps).astype(np.int64)
        centers = centers[centers < len(d)]
        vals = d[centers]
        score = float(np.mean(np.abs(vals)))
        if best is None or score > best[0]:
            best = (score, vals)
    return best[1]


def afsk1200_demod(audio, fs: float, device="cuda") -> np.ndarray:
    """Audio → HDLC bit stream (pre-NRZI bits, feed codec.ax25.hdlc_decode),
    host numpy. Bit timing by offset search over one bit period."""
    sps = fs / AFSK_BAUD
    sps_i = max(int(round(sps)), 2)
    d = fsk2_decision(audio, float(fs), sps_i, device=device).cpu().numpy()
    vals = _best_bit_values(d, sps)
    if vals.size == 0:
        return np.zeros(0, np.uint8)
    return nrzi_decode((vals > 0).astype(np.uint8))


def ax25_decode(audio, fs: float, device="cuda") -> List:
    """AFSK-1200 audio → validated AX.25 frames (the TNC receive path)."""
    from ..codec.ax25 import hdlc_decode
    return hdlc_decode(afsk1200_demod(audio, fs, device))


def rtty_decode(audio, fs: float, baud: float = 45.45,
                mark_hz: float = 2125.0, space_hz: float = 2295.0,
                device="cuda") -> str:
    """RTTY receive: 2-FSK audio → text. The dual-tone decision runs on
    ``device``; bit timing by offset search (best mean |decision| on the
    baud grid), then async unframing and Baudot page tracking."""
    from ..codec.rtty import rtty_unframe_bits, baudot_decode
    sps = fs / baud
    sps_i = max(int(round(sps)), 2)
    d = fsk2_decision(audio, float(fs), sps_i, float(mark_hz),
                      float(space_hz), device).cpu().numpy()
    vals = _best_bit_values(d, sps)
    if vals.size == 0:
        return ""
    return baudot_decode(rtty_unframe_bits((vals > 0).astype(np.uint8)))


class Afsk1200Stream:
    """Streaming AFSK-1200 TNC: feed audio chunks of any size, get AX.25
    frames as they complete (the feed/flush contract of the other stream
    receivers: chunk-boundary invariant).

    Each drain demodulates the whole buffered window on ``device`` but
    commits only frames that start before the retained overlap (one
    max-length frame plus timing slack), so a frame split across feeds
    decodes exactly once when its tail arrives."""

    # a full 330-byte AX.25 frame + flags ≈ 2700 bits ≈ 2.3 s at 1200 baud
    _OVERLAP_S = 2.5

    def __init__(self, fs: float, device="cuda") -> None:
        self.fs = float(fs)
        self.device = device
        self._buf = np.zeros(0, np.float32)
        self._base_bits = 0          # absolute bit index of buffer start
        self._emitted_to = 0         # absolute bit index already committed

    def __len__(self) -> int:
        return len(self._buf)

    def clear(self) -> None:
        self._buf = np.zeros(0, np.float32)
        self._base_bits = 0
        self._emitted_to = 0

    def feed(self, audio) -> list:
        if isinstance(audio, torch.Tensor):
            audio = audio.cpu().numpy()
        self._buf = np.concatenate([self._buf,
                                    np.asarray(audio, np.float32)])
        return self._drain(final=False)

    def flush(self) -> list:
        return self._drain(final=True)

    def _drain(self, final: bool) -> list:
        from ..codec.ax25 import hdlc_decode_with_pos
        sps = self.fs / AFSK_BAUD
        overlap_bits = int(self._OVERLAP_S * AFSK_BAUD)
        n_bits = int(len(self._buf) / sps) - 1
        if n_bits < 16:
            return []
        bits = afsk1200_demod(self._buf, self.fs, self.device)
        commit_end = self._base_bits + (len(bits) if final
                                        else max(len(bits) - overlap_bits, 0))
        out = []
        for frame, pos in hdlc_decode_with_pos(bits):
            abs_pos = self._base_bits + pos
            if self._emitted_to <= abs_pos < commit_end:
                out.append(frame)
        self._emitted_to = max(self._emitted_to, commit_end)
        # retain the overlap so split frames finish next feed
        keep_bits = min(overlap_bits + 16, len(bits))
        keep_samples = int(keep_bits * sps) + len(self._buf) \
            - int(len(bits) * sps)
        keep_samples = min(max(keep_samples, 0), len(self._buf))
        drop = len(self._buf) - keep_samples
        self._base_bits += int(round(drop / sps))
        self._buf = self._buf[drop:]
        if final:
            self.clear()
        return out


def rtty_decode_fsk(iq, fs: float, baud: float = 45.45,
                    device="cuda") -> str:
    """HF-style RTTY: RF frequency-shift keying at IQ baseband (typically
    170 Hz shift) rather than audio tones. FM-discriminate on ``device``,
    integrate per bit with an offset search, try both mark/space
    polarities, and keep the text with more printable characters."""
    from ..codec.rtty import rtty_unframe_bits, baudot_decode
    from .pocsag import pocsag_demod_bits
    bits = pocsag_demod_bits(iq, fs, baud, device)
    if bits.size == 0:
        return ""
    best = ""
    for pol in (0, 1):
        text = baudot_decode(rtty_unframe_bits(bits ^ pol))
        printable = sum(c.isprintable() and c != " " for c in text)
        if printable > sum(c.isprintable() and c != " " for c in best):
            best = text
    return best
