"""Capture file I/O (counterpart of ``orion_sdr_tpu/io.py``): IQ
recordings as 2-channel 16-bit WAV (left = I, right = Q) or a float32
``.npz``, and mono audio WAV. Stdlib + numpy; the writers also take a
tensor, which they bring to the host, and the readers return numpy, which
callers move to their device."""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np

from .util import _np


def write_iq_wav(path: str, iq, fs: float) -> None:
    """Complex capture → 2-channel 16-bit WAV (I left, Q right), scaled to
    90 % full scale."""
    z = _np(iq)
    if z.ndim != 1:
        raise ValueError("write_iq_wav takes a 1-D capture")
    peak = float(np.max(np.abs(np.stack([z.real, z.imag])))) or 1.0
    scale = 0.9 * 32767.0 / peak
    pcm = np.empty((len(z), 2), np.int16)
    pcm[:, 0] = np.round(z.real * scale)
    pcm[:, 1] = np.round(z.imag * scale)
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(int(round(fs)))
        w.writeframes(pcm.tobytes())


def read_iq_wav(path: str) -> Tuple[np.ndarray, float]:
    """2-channel 16-bit WAV → (complex64 capture scaled to ±1, fs)."""
    with wave.open(path, "rb") as w:
        if w.getnchannels() != 2 or w.getsampwidth() != 2:
            raise ValueError("expected a 2-channel 16-bit IQ WAV")
        fs = float(w.getframerate())
        raw = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    raw = raw.reshape(-1, 2).astype(np.float32) / 32767.0
    return (raw[:, 0] + 1j * raw[:, 1]).astype(np.complex64), fs


def write_audio_wav(path: str, audio, fs: float) -> None:
    """Real audio → mono 16-bit WAV, scaled to 90 % full scale."""
    x = _np(audio).astype(np.float32)
    if x.ndim != 1:
        raise ValueError("write_audio_wav takes 1-D audio")
    peak = float(np.max(np.abs(x))) or 1.0
    pcm = np.round(x * (0.9 * 32767.0 / peak)).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(round(fs)))
        w.writeframes(pcm.tobytes())


def read_audio_wav(path: str) -> Tuple[np.ndarray, float]:
    """Mono (or first-channel) 16-bit WAV → (float32 audio ±1, fs)."""
    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError("expected a 16-bit WAV")
        fs = float(w.getframerate())
        ch = w.getnchannels()
        raw = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    raw = raw.reshape(-1, ch)[:, 0]
    return (raw.astype(np.float32) / 32767.0), fs


def write_iq_npy(path: str, iq, fs: float) -> None:
    """Complex capture + rate → one .npz (lossless float32)."""
    z = _np(iq).astype(np.complex64)
    np.savez(path, iq_re=z.real.astype(np.float32),
             iq_im=z.imag.astype(np.float32), fs=np.float64(fs))


def read_iq_npy(path: str) -> Tuple[np.ndarray, float]:
    """A :func:`write_iq_npy` file → (complex64 capture, fs)."""
    with np.load(path) as d:
        z = (d["iq_re"] + 1j * d["iq_im"]).astype(np.complex64)
        return z, float(d["fs"])
