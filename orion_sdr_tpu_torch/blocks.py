"""Drop-in Block-style classes: the JAX package's ``blocks.py`` surface on
the port (counterpart of ``orion_sdr_tpu/blocks.py``).

Each class is a stateful wrapper over the port's functional API:
``process()`` (``modulate``/``demodulate`` for FT8/FT4) takes a 1-D
C-contiguous numpy array of the exact dtype and returns numpy, and the
streaming state (filter states, oscillator phases, PLL carries, buffered
samples) passes from one call to the next, so a capture fed in pieces
gives what one call on the whole gives. The constructors take the JAX
package's arguments and a trailing ``device`` (default "cuda"); the
compute runs there. Filter and oscillator states that the functional API
returns as tensors stay on the device between calls; the PSK31
demodulators keep their scalar carries (samples mixed, previous symbol,
phase accumulator) on the host, as the JAX package does. An oscillator
phase carried between calls goes into the rotation as a tensor, so p0 +
w·k rounds once, as in the JAX package's jitted modulators.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .modulate import analog as _ma
from .demodulate import analog as _da
from .modulate.digital import digital_mod
from .demodulate.digital import digital_demod
from .modulate import psk31 as _mp
from .demodulate import psk31 as _dp
from .modulate.ft8 import ft8_mod, ft4_mod
from .demodulate.ft8 import ft8_demod, ft4_demod
from .codec import ft8 as _ft8c
from .codec.psk31 import viterbi_decode as _psk31_viterbi
from .ofdm import carried_phase
from .util import _np as _host

__all__ = [
    "CwKeyedMod", "CwEnvelopeDemod", "AmDsbMod", "AmEnvelopeDemod",
    "SsbPhasingMod", "SsbProductDemod", "FmPhaseAccumMod",
    "FmQuadratureDemod", "PmDirectPhaseMod", "PmQuadratureDemod",
    "BpskMod", "BpskDemod", "QpskMod", "QpskDemod", "QamMod", "QamDemod",
    "Ft8Mod", "Ft8Demod", "Ft8Codec", "Ft4Mod", "Ft4Demod", "Ft4Codec",
    "Bpsk31Mod", "Bpsk31Demod", "Bpsk31Decider", "Qpsk31Mod", "Qpsk31Demod",
    "OfdmMod", "OfdmDemod",
]


def _c64(x) -> np.ndarray:
    return np.ascontiguousarray(_host(x), dtype=np.complex64)


def _f32(x) -> np.ndarray:
    return np.ascontiguousarray(_host(x), dtype=np.float32)


def _check_1d(x, dtype, what: str) -> np.ndarray:
    """The reference array contract: ``process()`` inputs are 1-D
    C-contiguous numpy arrays of the exact dtype; anything else raises
    ValueError."""
    if not isinstance(x, np.ndarray):
        raise ValueError(
            f"{what}: expected numpy.ndarray, got {type(x).__name__}")
    if x.dtype != dtype:
        raise ValueError(f"{what}: expected dtype {np.dtype(dtype).name}, "
                         f"got {x.dtype.name}")
    if x.ndim != 1:
        raise ValueError(f"{what}: expected 1-D, got {x.ndim}-D")
    if not x.flags["C_CONTIGUOUS"]:
        raise ValueError(f"{what}: expected C-contiguous layout")
    return x


def _in_c64(x):
    return _check_1d(x, np.complex64, "IQ input")


def _in_f32(x):
    return _check_1d(x, np.float32, "audio/soft input")


def _in_u8(x):
    return _check_1d(x, np.uint8, "bits/tones input")


class _Block:
    def __init__(self, device) -> None:
        self.device = torch.device(device)


# ── analog TX ────────────────────────────────────────────────────────────────


class CwKeyedMod(_Block):
    """(sample_rate, tone_hz, rise_ms, fall_ms): keying envelope in [0, 1]
    → keyed carrier; the envelope's two-rate one-pole carries across
    calls."""

    def __init__(self, sample_rate: float, tone_hz: float,
                 rise_ms: float = 3.0, fall_ms: float = 3.0,
                 device="cuda"):
        super().__init__(device)
        self.fs, self.tone_hz = sample_rate, tone_hz
        self.rise_ms, self.fall_ms = rise_ms, fall_ms
        self.gain = 1.0
        self._state = None

    def set_gain(self, g: float):
        self.gain = g

    def process(self, key_env) -> np.ndarray:
        iq, self._state = _ma.cw_mod(_in_f32(key_env), self.fs, self.tone_hz,
                                     self.rise_ms, self.fall_ms, self.gain,
                                     state=self._state, device=self.device)
        return _c64(iq)


class AmDsbMod(_Block):
    """(fs, rf_hz, carrier_level, modulation_index)."""

    def __init__(self, fs: float, rf_hz: float = 0.0,
                 carrier_level: float = 1.0, modulation_index: float = 1.0,
                 device="cuda"):
        super().__init__(device)
        self.fs, self.rf_hz = fs, rf_hz
        self.carrier_level, self.modulation_index = (carrier_level,
                                                     modulation_index)
        self.gain, self.clamp = 1.0, False
        self._phase = 0.0

    def set_gain(self, g: float):
        self.gain = g

    def set_clamp(self, on: bool):
        self.clamp = on

    def process(self, audio) -> np.ndarray:
        iq, self._phase = _ma.am_mod(
            _in_f32(audio), self.fs, self.rf_hz, self.carrier_level,
            self.modulation_index, self.gain, self.clamp,
            carried_phase(self._phase, self.device), device=self.device)
        return _c64(iq)


class SsbPhasingMod(_Block):
    """(fs, audio_bw_hz, audio_if_hz, rf_hz, usb)."""

    def __init__(self, fs: float, audio_bw_hz: float, audio_if_hz: float,
                 rf_hz: float = 0.0, usb: bool = True, device="cuda"):
        super().__init__(device)
        self.args = (fs, audio_bw_hz, audio_if_hz, rf_hz, usb)
        self._state = None

    def process(self, audio) -> np.ndarray:
        fs, bw, aif, rf, usb = self.args
        iq, self._state = _ma.ssb_mod(_in_f32(audio), fs, bw, aif, rf, usb,
                                      state=self._state, device=self.device)
        return _c64(iq)


class FmPhaseAccumMod(_Block):
    """(sample_rate, deviation_hz, rf_hz)."""

    def __init__(self, sample_rate: float, deviation_hz: float,
                 rf_hz: float = 0.0, device="cuda"):
        super().__init__(device)
        self.fs, self.deviation_hz, self.rf_hz = (sample_rate, deviation_hz,
                                                  rf_hz)
        self.gain = 1.0
        self._state = None

    def set_deviation(self, hz: float):
        self.deviation_hz = hz

    def set_gain(self, g: float):
        self.gain = g

    def process(self, audio) -> np.ndarray:
        iq, self._state = _ma.fm_mod(_in_f32(audio), self.fs,
                                     self.deviation_hz, self.rf_hz,
                                     self.gain, state=self._state,
                                     device=self.device)
        return _c64(iq)


class PmDirectPhaseMod(_Block):
    """(sample_rate, kp_rad_per_unit, rf_hz)."""

    def __init__(self, sample_rate: float, kp_rad_per_unit: float,
                 rf_hz: float = 0.0, device="cuda"):
        super().__init__(device)
        self.fs, self.kp, self.rf_hz = sample_rate, kp_rad_per_unit, rf_hz
        self.gain = 1.0
        self._phase = 0.0

    def set_gain(self, g: float):
        self.gain = g

    def set_sensitivity(self, kp: float):
        self.kp = kp

    def process(self, audio) -> np.ndarray:
        phase0 = carried_phase(self._phase, self.device)
        iq, self._phase = _ma.pm_mod(_in_f32(audio), self.fs, self.kp,
                                     self.rf_hz, self.gain, rf_phase0=phase0,
                                     device=self.device)
        return _c64(iq)


# ── analog RX ────────────────────────────────────────────────────────────────


class CwEnvelopeDemod(_Block):
    """(sample_rate, tone_hz, env_bw_hz)."""

    def __init__(self, sample_rate: float, tone_hz: float,
                 env_bw_hz: float = 300.0, device="cuda"):
        super().__init__(device)
        self.fs, self.tone_hz, self.env_bw_hz = (sample_rate, tone_hz,
                                                 env_bw_hz)
        self.gain = 1.0
        self._y = 0.0

    def set_gain(self, g: float):
        self.gain = g

    def process(self, iq) -> np.ndarray:
        audio, self._y = _da.cw_demod(_in_c64(iq), self.fs, self.env_bw_hz,
                                      self.gain, y0=self._y,
                                      device=self.device)
        return _f32(audio)


class AmEnvelopeDemod(_Block):
    """(fs, audio_bw_hz, abs_approx=False)."""

    def __init__(self, fs: float, audio_bw_hz: float,
                 abs_approx: bool = False, device="cuda"):
        super().__init__(device)
        self.fs, self.audio_bw_hz = fs, audio_bw_hz
        self.method = "abs_approx" if abs_approx else "power_sqrt"
        self._state = None

    def process(self, iq) -> np.ndarray:
        audio, self._state = _da.am_demod(_in_c64(iq), self.fs,
                                          self.audio_bw_hz,
                                          method=self.method,
                                          state=self._state,
                                          device=self.device)
        return _f32(audio)


class SsbProductDemod(_Block):
    """(fs, bfo_hz, audio_bw_hz)."""

    def __init__(self, fs: float, bfo_hz: float, audio_bw_hz: float,
                 device="cuda"):
        super().__init__(device)
        self.fs, self.bfo_hz, self.audio_bw_hz = fs, bfo_hz, audio_bw_hz
        self._state = None

    def process(self, iq) -> np.ndarray:
        audio, self._state = _da.ssb_demod(_in_c64(iq), self.fs, self.bfo_hz,
                                           self.audio_bw_hz,
                                           state=self._state,
                                           device=self.device)
        return _f32(audio)


class FmQuadratureDemod(_Block):
    """(fs, dev_hz, audio_bw_hz)."""

    def __init__(self, fs: float, dev_hz: float, audio_bw_hz: float,
                 device="cuda"):
        super().__init__(device)
        self.fs, self.dev_hz, self.audio_bw_hz = fs, dev_hz, audio_bw_hz
        self._state = None

    def process(self, iq) -> np.ndarray:
        audio, self._state = _da.fm_demod(_in_c64(iq), self.fs, self.dev_hz,
                                          self.audio_bw_hz,
                                          state=self._state,
                                          device=self.device)
        return _f32(audio)


class PmQuadratureDemod(_Block):
    """(fs, k, audio_bw_hz)."""

    def __init__(self, fs: float, k: float, audio_bw_hz: float,
                 device="cuda"):
        super().__init__(device)
        self.fs, self.k, self.audio_bw_hz = fs, k, audio_bw_hz
        self._state = None

    def process(self, iq) -> np.ndarray:
        audio, self._state = _da.pm_demod(_in_c64(iq), self.fs, self.k,
                                          self.audio_bw_hz,
                                          state=self._state,
                                          device=self.device)
        return _f32(audio)


# ── single-carrier digital ───────────────────────────────────────────────────


class _DigitalMod(_Block):
    order = "bpsk"

    def __init__(self, fs: float, rf_hz: float = 0.0, gain: float = 1.0,
                 device="cuda"):
        super().__init__(device)
        self.fs, self.rf_hz, self.gain = fs, rf_hz, gain
        self._phase = 0.0

    def set_gain(self, g: float):
        self.gain = g

    def process(self, bits) -> np.ndarray:
        phase0 = carried_phase(self._phase, self.device)
        iq, self._phase = digital_mod(_in_u8(bits), self.order, self.fs,
                                      self.rf_hz, self.gain, phase0,
                                      device=self.device)
        return _c64(iq)


class _DigitalDemod(_Block):
    order = "bpsk"

    def __init__(self, gain: float = 1.0, fs: float = 1.0,
                 rf_hz: float = 0.0, device="cuda"):
        super().__init__(device)
        self.fs, self.rf_hz, self.gain = fs, rf_hz, gain
        self._phase = 0.0

    def set_gain(self, g: float):
        self.gain = g

    def process(self, iq) -> np.ndarray:
        phase0 = carried_phase(self._phase, self.device)
        bits, self._phase = digital_demod(_in_c64(iq), self.order, self.fs,
                                          self.rf_hz, self.gain, phase0,
                                          device=self.device)
        return np.asarray(_host(bits), np.uint8)


class BpskMod(_DigitalMod):
    order = "bpsk"


class BpskDemod(_DigitalDemod):
    order = "bpsk"


class QpskMod(_DigitalMod):
    order = "qpsk"


class QpskDemod(_DigitalDemod):
    order = "qpsk"


def _qam(order: int) -> str:
    if order not in (16, 64, 256):
        raise ValueError(f"unsupported QAM order {order}")
    return f"qam{order}"


class QamMod(_DigitalMod):
    """(order, fs, rf_hz, gain); order ∈ 16/64/256."""

    def __init__(self, order: int, fs: float, rf_hz: float = 0.0,
                 gain: float = 1.0, device="cuda"):
        qam = _qam(order)
        super().__init__(fs, rf_hz, gain, device)
        self.order = qam


class QamDemod(_DigitalDemod):
    """(order, gain, fs, rf_hz); order ∈ 16/64/256."""

    def __init__(self, order: int, gain: float = 1.0, fs: float = 1.0,
                 rf_hz: float = 0.0, device="cuda"):
        qam = _qam(order)
        super().__init__(gain, fs, rf_hz, device)
        self.order = qam


# ── FT8/FT4 ──────────────────────────────────────────────────────────────────


class Ft8Mod(_Block):
    """(fs, base_hz, rf_hz, gain): data tones → one frame's IQ."""

    _mod = staticmethod(ft8_mod)

    def __init__(self, fs: float = 12000.0, base_hz: float = 1000.0,
                 rf_hz: float = 0.0, gain: float = 1.0, device="cuda"):
        super().__init__(device)
        self.fs, self.base_hz, self.rf_hz, self.gain = fs, base_hz, rf_hz, gain

    def modulate(self, data_tones) -> np.ndarray:
        return _c64(type(self)._mod(_in_u8(data_tones), self.fs,
                                    self.base_hz, self.rf_hz, self.gain,
                                    device=self.device))


class Ft4Mod(Ft8Mod):
    _mod = staticmethod(ft4_mod)


class Ft8Demod(_Block):
    """(fs, base_hz): a frame's IQ → its data tones (per-symbol tone
    argmax)."""

    _demod = staticmethod(ft8_demod)

    def __init__(self, fs: float = 12000.0, base_hz: float = 1000.0,
                 device="cuda"):
        super().__init__(device)
        self.fs, self.base_hz = fs, base_hz

    def demodulate(self, iq) -> np.ndarray:
        return np.asarray(type(self)._demod(_in_c64(iq), self.fs,
                                            self.base_hz,
                                            device=self.device), np.uint8)


class Ft4Demod(Ft8Demod):
    _demod = staticmethod(ft4_demod)


class Ft8Codec(_Block):
    """encode / decode_hard / decode_soft; each decode is one BP launch."""

    _enc = staticmethod(_ft8c.ft8_encode)
    _dec_hard = staticmethod(_ft8c.ft8_decode_hard)
    _dec_soft = staticmethod(_ft8c.ft8_decode_soft)

    def __init__(self, device="cuda"):
        super().__init__(device)

    def encode(self, payload) -> np.ndarray:
        p = np.frombuffer(bytes(payload), np.uint8)
        return np.asarray(type(self)._enc(p, device=self.device), np.uint8)

    def decode_hard(self, tones) -> Optional[bytes]:
        out = type(self)._dec_hard(_in_u8(tones), device=self.device)
        return None if out is None else bytes(out)

    def decode_soft(self, llr) -> Optional[bytes]:
        out = type(self)._dec_soft(_in_f32(llr), device=self.device)
        return None if out is None else bytes(out)


class Ft4Codec(Ft8Codec):
    _enc = staticmethod(_ft8c.ft4_encode)
    _dec_hard = staticmethod(_ft8c.ft4_decode_hard)
    _dec_soft = staticmethod(_ft8c.ft4_decode_soft)


# ── PSK31 ────────────────────────────────────────────────────────────────────


class Bpsk31Mod(_Block):
    """(fs, rf_hz, gain); modulate_text / modulate_bits."""

    _text = staticmethod(_mp.bpsk31_mod_text)
    _bits = staticmethod(_mp.bpsk31_mod_bits)

    def __init__(self, fs: float, rf_hz: float = 0.0, gain: float = 1.0,
                 device="cuda"):
        super().__init__(device)
        self.fs, self.rf_hz, self.gain = fs, rf_hz, gain

    def modulate_text(self, text: str, preamble_bits: int = 32,
                      postamble_bits: int = 32) -> np.ndarray:
        return _c64(type(self)._text(text, self.fs, self.rf_hz, self.gain,
                                     preamble_bits, postamble_bits,
                                     device=self.device))

    def modulate_bits(self, bits) -> np.ndarray:
        iq, _ = type(self)._bits(_in_u8(bits), self.fs, self.rf_hz,
                                 self.gain, device=self.device)
        return _c64(iq)


class Qpsk31Mod(Bpsk31Mod):
    _text = staticmethod(_mp.qpsk31_mod_text)
    _bits = staticmethod(_mp.qpsk31_mod_bits)


class _Psk31DemodBase(_Block):
    qpsk = False

    def __init__(self, fs: float, rf_hz: float = 0.0, gain: float = 1.0,
                 device="cuda"):
        super().__init__(device)
        self.fs, self.rf_hz, self.gain = fs, rf_hz, gain
        self.sps = _mp.psk31_sps(fs)
        self._leftover = np.zeros(0, np.complex64)
        self._n_mixed = 0            # samples already down-mixed
        self._prev_sym = 1.0 + 0.0j
        self._phase_acc = 0.0

    def process(self, iq) -> np.ndarray:
        """Whole symbols of the buffered and new samples through the
        down-mix and the PLL (one kernel launch), the rest kept for the
        next call; → per-symbol soft values (n,) or pairs (n, 2)."""
        z = np.concatenate([self._leftover, _in_c64(iq)])
        n_syms = len(z) // self.sps
        if n_syms == 0:
            self._leftover = z
            return np.zeros((0, 2) if self.qpsk else (0,), np.float32)
        take = n_syms * self.sps
        self._leftover = z[take:]
        # the down-mix oscillator runs on from the samples mixed so far
        phase0 = np.float32(-2.0 * np.pi * self.rf_hz
                            * self._n_mixed / self.fs)
        self._n_mixed += take
        soft, prev, acc = _dp.stream_step(
            torch.as_tensor(z[:take], device=self.device),
            torch.tensor(phase0, device=self.device),
            complex(np.complex64(self._prev_sym)),
            float(np.float32(self._phase_acc)), self.sps, self.gain,
            self.qpsk, self.rf_hz, self.fs)
        self._prev_sym = complex(prev.item())
        self._phase_acc = float(acc.item())
        return _f32(soft)


class Bpsk31Demod(_Psk31DemodBase):
    """(fs, rf_hz, gain) → per-symbol soft Re(d)."""

    qpsk = False


class Qpsk31Demod(_Psk31DemodBase):
    """Buffers the differential pairs; ``flush()`` runs the Viterbi MLSE
    over everything seen (``codec.psk31.viterbi_decode``)."""

    qpsk = True

    def __init__(self, fs: float, rf_hz: float = 0.0, gain: float = 1.0,
                 device="cuda"):
        super().__init__(fs, rf_hz, gain, device)
        self._pairs = []

    def process(self, iq) -> np.ndarray:
        soft = super().process(iq)
        if len(soft):
            self._pairs.append(soft)
        return soft

    def flush(self) -> np.ndarray:
        if not self._pairs:
            return np.zeros(0, np.uint8)
        pairs = np.concatenate(self._pairs)
        self._pairs = []
        return np.asarray(_host(_psk31_viterbi(pairs, device=self.device)),
                          np.uint8)


class Bpsk31Decider(_Block):
    """soft ≥ 0 → bit 1."""

    def __init__(self, device="cuda"):
        super().__init__(device)

    def process(self, soft) -> np.ndarray:
        s = torch.as_tensor(_in_f32(soft), device=self.device)
        return _host(s >= 0.0).astype(np.uint8)


# ── OFDM ─────────────────────────────────────────────────────────────────────


class OfdmMod(_Block):
    """(cfg): whole-symbol modulation of an ``OfdmConfig`` link; the RF
    oscillator's phase carries across calls."""

    def __init__(self, cfg, device="cuda"):
        super().__init__(device)
        self.cfg = cfg
        self._phase = 0.0

    def process(self, bits) -> np.ndarray:
        from .ofdm import ofdm_mod
        iq, self._phase = ofdm_mod(self.cfg, _in_u8(bits),
                                   phase0=self._phase, device=self.device)
        return _c64(iq)

    modulate = process


class OfdmDemod(_Block):
    """(cfg, equalizer='training_symbol'|'pilot_interp'): IQ → hard bits.
    ``estimate_channel(rx_training_freq)`` installs the held estimate of
    the training-symbol equalizer; 'pilot_interp' re-estimates every
    symbol from the plan's pilots."""

    def __init__(self, cfg, equalizer: str = "training_symbol",
                 device="cuda"):
        if equalizer not in ("training_symbol", "pilot_interp"):
            raise ValueError(
                f"OfdmDemod: unknown equalizer {equalizer!r} (expected "
                "'training_symbol' or 'pilot_interp')")
        super().__init__(device)
        self.cfg = cfg.with_equalizer_method(equalizer)
        self.equalizer = equalizer
        self._estimate = None
        self._phase = 0.0

    def estimate_channel(self, rx_training_freq, known_freq=None):
        from .ofdm import channel_estimate_training
        from .sync.ofdm_sync import training_symbol_freq_pattern
        if known_freq is None:
            known_freq = (training_symbol_freq_pattern(
                self.cfg.carrier_plan.n_fft) * self.cfg.gain)
        self._estimate = channel_estimate_training(
            _in_c64(rx_training_freq), _c64(known_freq), device=self.device)

    def process(self, iq) -> np.ndarray:
        from .ofdm import (ofdm_demod, ofdm_decide, channel_estimate_pilots,
                           zf_equalize)
        from .multicarrier import symbol_fft, grid_extract
        from .dsp.osc import rotate_host
        z = torch.as_tensor(_in_c64(iq), device=self.device)
        if self.equalizer == "pilot_interp":
            if self.cfg.rf_hz != 0.0:
                z, self._phase = rotate_host(z, np.float32(-self.cfg.rf_hz),
                                             self.cfg.fs, self._phase)
            g = self.cfg.grid()
            freq = symbol_fft(z, g.n_fft, g.cp_len,
                              backoff=self.cfg.rx_window_backoff)
            known = g.pilot_values * np.complex64(self.cfg.gain)
            est = channel_estimate_pilots(freq, g.pilot_bins, known, g.n_fft)
            soft = grid_extract(g, zf_equalize(freq, est))
        else:
            soft, self._phase = ofdm_demod(self.cfg, z,
                                           estimate=self._estimate,
                                           phase0=self._phase)
        return np.asarray(_host(ofdm_decide(self.cfg, soft)), np.uint8)

    demodulate = process
