"""ITU-R M.1677 Morse keying-envelope encoder and CW text decoder
(counterpart of ``orion_sdr_tpu/codec/morse.py``).

The encoder is host text-domain, the port's own copy (the keying envelope
bit for bit the reference's, its xorshift jitter included): it produces the
0/1 float envelope that feeds ``modulate.cw_mod``. PARIS timing: 1 unit =
1200/wpm ms; dot 1 unit, dash ``dash_weight``, intra-char gap 1,
inter-char ``char_space``, word gap ``word_space``.

The decoder (`morse_decode` / `morse_decode_band`): one batched program on
``device`` extracts every carrier's keying envelope
(``demodulate/analog.py::cw_envelope_multi``); on the host, as in the
reference, the carrier search (Welch spectrum), hysteresis keying
detection, joint dit/dah/gap unit estimation (no wpm prior) and the
reverse ITU table.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..demodulate.analog import cw_envelope_multi
from ..dsp.device import sanitize_iq, to_device

MORSE_TABLE = {
    "A": ".-", "B": "-...", "C": "-.-.", "D": "-..", "E": ".", "F": "..-.",
    "G": "--.", "H": "....", "I": "..", "J": ".---", "K": "-.-", "L": ".-..",
    "M": "--", "N": "-.", "O": "---", "P": ".--.", "Q": "--.-", "R": ".-.",
    "S": "...", "T": "-", "U": "..-", "V": "...-", "W": ".--", "X": "-..-",
    "Y": "-.--", "Z": "--..",
    "0": "-----", "1": ".----", "2": "..---", "3": "...--", "4": "....-",
    "5": ".....", "6": "-....", "7": "--...", "8": "---..", "9": "----.",
    ".": ".-.-.-", ",": "--..--", "?": "..--..", "'": ".----.", "!": "-.-.--",
    "/": "-..-.", "(": "-.--.", ")": "-.--.-", "&": ".-...", ":": "---...",
    ";": "-.-.-.", "=": "-...-", "+": ".-.-.", "-": "-....-", "_": "..--.-",
    '"': ".-..-.", "$": "...-..-", "@": ".--.-.",
}

_MASK64 = (1 << 64) - 1


def char_to_morse(c: str):
    return MORSE_TABLE.get(c.upper())


class MorseEncoder:
    """Text → keying envelope (0.0 = key up, 1.0 = key down)."""

    def __init__(self, sample_rate: float, wpm: float) -> None:
        self.sample_rate = float(sample_rate)
        self.wpm = float(wpm)
        self.jitter_pct = 0.0
        self.dash_weight = 3.0
        self.char_space = 3.0
        self.word_space = 7.0
        self.rng = 0x853C_49E6_748F_EA9B

    def with_jitter(self, pct: float) -> "MorseEncoder":
        self.jitter_pct = min(max(pct, 0.0), 30.0)
        return self

    def with_dash_weight(self, w: float) -> "MorseEncoder":
        self.dash_weight = min(max(w, 2.5), 3.5)
        return self

    def with_char_space(self, s: float) -> "MorseEncoder":
        self.char_space = min(max(s, 2.5), 4.0)
        return self

    def with_word_space(self, s: float) -> "MorseEncoder":
        self.word_space = min(max(s, 6.0), 9.0)
        return self

    def _unit(self) -> float:
        return (1200.0 / max(self.wpm, 1.0)) * 1e-3 * self.sample_rate

    def _xorshift_uniform(self) -> float:
        self.rng = (self.rng ^ (self.rng << 13)) & _MASK64
        self.rng = (self.rng ^ (self.rng >> 7)) & _MASK64
        self.rng = (self.rng ^ (self.rng << 17)) & _MASK64
        return (self.rng >> 11) * (1.0 / (1 << 53)) * 2.0 - 1.0

    def _jittered(self, unit: float, units: float) -> int:
        nominal = unit * units
        if self.jitter_pct <= 0.0:
            return int(round(nominal))
        delta = unit * (self.jitter_pct / 100.0) * self._xorshift_uniform()
        return max(int(round(nominal + delta)), 1)

    def encode_text(self, text: str) -> np.ndarray:
        """Unknown chars are skipped; runs of whitespace emit one word gap."""
        unit = self._unit()
        out = []
        pending_gap = None
        for c in text:
            if c.isspace():
                if pending_gap is not None or out:
                    pending_gap = self.word_space
                continue
            pattern = char_to_morse(c)
            if pattern is None:
                continue
            if pending_gap is not None:
                out.append(np.zeros(self._jittered(unit, pending_gap),
                                    np.float32))
                pending_gap = None
            for i, elem in enumerate(pattern):
                if i > 0:
                    out.append(np.zeros(self._jittered(unit, 1.0), np.float32))
                units = 1.0 if elem == "." else self.dash_weight
                out.append(np.ones(self._jittered(unit, units), np.float32))
            pending_gap = self.char_space
        return np.concatenate(out) if out else np.zeros(0, np.float32)


# ── CW text decoder ──────────────────────────────────────────────────────────

MORSE_REVERSE = {v: k for k, v in MORSE_TABLE.items()}


@dataclass
class MorseBandResult:
    """One decoded CW transmission from a band scan."""
    tone_hz: float
    score_db: float        # carrier line above the band's spectral floor
    wpm: float             # from the estimated unit (1 unit = 1200/wpm ms)
    text: str


def _key_from_env(env: np.ndarray):
    """Hysteresis key detection: (n,) envelope → (n,) bool key-down, or
    None when the envelope has no on/off contrast (no CW signal).

    Thresholds sit between the 5th percentile (key-up: noise floor of the
    ``env_bw_hz`` band) and the 97th percentile (key-down: carrier + noise);
    the 0.35/0.55 hysteresis pair means mid-level noise wiggle cannot
    chatter the key state. Vectorized forward-fill instead of a scan: each
    sample is decisively up/down/unchanged, and "unchanged" copies the most
    recent decisive state."""
    if env.size == 0:
        return None
    lo = float(np.percentile(env, 5.0))
    hi = float(np.percentile(env, 97.0))
    if hi < 1.6 * lo + 1e-12:
        return None
    up = lo + 0.55 * (hi - lo)
    dn = lo + 0.35 * (hi - lo)
    s = np.where(env >= up, 1, np.where(env <= dn, 0, -1)).astype(np.int8)
    idx = np.where(s >= 0, np.arange(s.size), 0)
    np.maximum.accumulate(idx, out=idx)
    key = s[idx] == 1
    if s[0] < 0:                       # undecided head copies nothing: key up
        key[: int(np.argmax(s >= 0))] = False
    return key


def _runs(key: np.ndarray) -> List[list]:
    """[[value, length], ...] run-length encoding of a bool array."""
    change = np.flatnonzero(np.diff(key.astype(np.int8))) + 1
    bounds = np.concatenate([[0], change, [key.size]])
    return [[bool(key[b]), int(e - b)]
            for b, e in zip(bounds[:-1], bounds[1:])]


def _denoise_runs(runs: List[list], min_run: int) -> List[list]:
    """Merge interior runs shorter than ``min_run`` into their neighbors.

    A sub-min_run run is a noise blip (the shortest real element, a dit at
    60 wpm, is ~20 env samples at 1 kHz); flipping it joins the two
    same-valued neighbors. Leading/trailing silence is never a blip."""
    runs = [r[:] for r in runs]
    while len(runs) >= 3:
        interior = [(r[1], i) for i, r in enumerate(runs[1:-1], start=1)]
        ln, i = min(interior)
        if ln >= min_run:
            break
        runs[i - 1][1] += runs[i][1] + runs[i + 1][1]
        del runs[i:i + 2]
    return runs


def _estimate_unit(durations: np.ndarray) -> float:
    """Unit length from the pooled mark+gap run durations (no wpm prior).

    The multiset of true durations is {1, 3, 7}·unit; the 1-unit cluster
    (dits + intra-char gaps) dominates any real text. Seed at the shortest
    run and iterate median-of-members twice — median, not mean, so a
    stray 3-unit member admitted by a jittery seed cannot drag the center."""
    d = np.sort(durations.astype(np.float64))
    if d.size == 0:
        return 0.0
    u = d[0]
    for _ in range(2):
        members = d[d < 2.0 * u]
        if members.size == 0:
            break
        u = float(np.median(members))
    return u


def _classify_runs(runs: List[list], unit: float) -> str:
    """Mark/space runs → text: mark <2u ⇒ dit; gap <2u ⇒ intra-char,
    <5u ⇒ char boundary, else word boundary. Unknown patterns are dropped
    (the encoder skips unknown chars, so roundtrips stay exact)."""
    out: List[str] = []
    sym = ""

    def flush():
        nonlocal sym
        if sym:
            ch = MORSE_REVERSE.get(sym)
            if ch is not None:
                out.append(ch)
            sym = ""

    for val, length in runs:
        u = length / unit
        if val:
            sym += "." if u < 2.0 else "-"
        elif u >= 2.0:
            flush()
            if u >= 5.0:
                out.append(" ")
    flush()
    return "".join(out).strip()


def _decode_env_row(env: np.ndarray, env_rate_hz: float,
                    min_run_env: int = 3):
    """One envelope row → (text, wpm, key) or None when no keying is
    present; ``key`` is the denoised bool key-down track (used by the band
    decode's shadow filter)."""
    key = _key_from_env(env)
    if key is None or not key.any():
        return None
    runs = _denoise_runs(_runs(key), min_run_env)
    # trim leading/trailing silence; need at least one mark left
    offset = 0
    while runs and not runs[0][0]:
        offset += runs.pop(0)[1]
    while runs and not runs[-1][0]:
        runs.pop()
    if not runs:
        return None
    unit = _estimate_unit(np.asarray([r[1] for r in runs], np.float64))
    if unit <= 0.0:
        return None
    text = _classify_runs(runs, unit)
    wpm = 1.2 / (unit / float(env_rate_hz))
    # rebuild the denoised key track from the merged runs (run lengths tile
    # the array exactly; ``offset`` is the trimmed leading silence)
    clean = np.zeros_like(key)
    at = offset
    for val, length in runs:
        if val:
            clean[at:at + length] = True
        at += length
    return text, wpm, clean


def _dilate(key: np.ndarray, r: int) -> np.ndarray:
    out = key.copy()
    for s in range(1, r + 1):
        out[s:] |= key[:-s]
        out[:-s] |= key[s:]
    return out


def _is_shadow(key: np.ndarray, stronger_key: np.ndarray,
               containment: float = 0.8, dilate: int = 3) -> bool:
    """True when ``key``'s marks happen (almost) only while ``stronger_key``
    is down — the signature of the stronger signal's keying sidebands or
    stopband leakage keying this row. An independent transmission overlaps
    a neighbor's key-down at roughly its duty cycle (~0.5), never ~1.0."""
    n = int(key.sum())
    if n == 0:
        return True
    inside = int((key & _dilate(stronger_key, dilate)).sum())
    return inside / n >= containment


def _welch_spectrum(iq: np.ndarray, fs: float, seg: int = 4096):
    """(freqs, mean |FFT|²) over non-overlapping Hann segments, on the host
    as in the reference."""
    n = int(len(iq))
    seg = min(seg, 1 << max(int(np.floor(np.log2(max(n, 2)))), 1))
    nseg = max(n // seg, 1)
    x = np.asarray(iq[: nseg * seg]).reshape(nseg, seg)
    w = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(seg) / seg)).astype(
        np.float64)
    S = np.mean(np.abs(np.fft.fft(x * w, axis=-1)) ** 2, axis=0)
    return np.fft.fftfreq(seg, 1.0 / fs), S


def _capture(iq, device):
    """(the sanitised capture on ``device``, its host copy)."""
    z = sanitize_iq(to_device(iq, device))
    return z, z.cpu().numpy()


def morse_decode_band(iq, fs: float, base_hz: float, max_hz: float,
                      max_carriers: int = 8, peak_margin_db: float = 10.0,
                      min_sep_hz: float | None = None,
                      env_bw_hz: float = 100.0,
                      env_rate_hz: float = 1000.0,
                      device="cuda") -> List[MorseBandResult]:
    """Decode every CW transmission in [base_hz, max_hz] with one envelope
    batch on ``device``. Carriers: local maxima of the host Welch spectrum
    ``peak_margin_db`` over the band's median floor, strongest first, at
    least ``min_sep_hz`` apart (default 2·env_bw_hz, the envelope filter's
    stopband edge); a weaker pick whose marks fall only inside a stronger
    one's key-down is that signal's keying sideband and is dropped."""
    z, zh = _capture(iq, device)
    if zh.size == 0:
        return []
    if min_sep_hz is None:
        min_sep_hz = 2.0 * env_bw_hz
    freqs, S = _welch_spectrum(zh, fs)
    band = (freqs >= base_hz) & (freqs <= max_hz)
    if not band.any():
        return []
    floor = max(float(np.median(S[band])), float(S.max()) * 1e-12, 1e-30)
    margin = 10.0 ** (peak_margin_db / 10.0)
    order = np.argsort(-S)
    picked: List[tuple] = []                     # (hz, score_db)
    for b in order:
        if S[b] < floor * margin:
            break
        if not band[b]:
            continue
        hz = float(freqs[b])
        if any(abs(hz - p[0]) < min_sep_hz for p in picked):
            continue
        picked.append((hz, 10.0 * np.log10(S[b] / floor)))
        if len(picked) >= max_carriers:
            break
    if not picked:
        return []

    env = cw_envelope_multi(
        z, fs, np.asarray([p[0] for p in picked], np.float32),
        env_bw_hz=env_bw_hz, env_rate_hz=env_rate_hz,
        device=z.device).cpu().numpy()
    results: List[MorseBandResult] = []
    kept_keys: List[np.ndarray] = []
    for (hz, score), row in zip(picked, env):
        dec = _decode_env_row(row, env_rate_hz)
        if dec is None or not dec[0]:
            continue
        text, wpm, key = dec
        if any(_is_shadow(key, kk) for kk in kept_keys):
            continue
        kept_keys.append(key)
        results.append(MorseBandResult(tone_hz=hz, score_db=score,
                                       wpm=wpm, text=text))
    return results


def morse_decode(iq, fs: float, tone_hz: float | None = None,
                 env_bw_hz: float = 100.0,
                 env_rate_hz: float = 1000.0, device="cuda") -> str:
    """Decode one CW transmission to text; ``tone_hz=None`` takes the
    strongest line of the host Welch spectrum."""
    z, zh = _capture(iq, device)
    if zh.size == 0:
        return ""
    if tone_hz is None:
        freqs, S = _welch_spectrum(zh, fs)
        tone_hz = float(freqs[int(np.argmax(S))])
    env = cw_envelope_multi(
        z, fs, np.asarray([tone_hz], np.float32), env_bw_hz=env_bw_hz,
        env_rate_hz=env_rate_hz, device=z.device).cpu().numpy()
    dec = _decode_env_row(env[0], env_rate_hz)
    return dec[0] if dec else ""
