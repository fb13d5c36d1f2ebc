"""Blind modulation classification (counterpart of
``orion_sdr_tpu/classify.py``): given a baseband channel capture, measure
modulation-agnostic features and label the signal — the dispatch stage
between :func:`spectrum_scan` and the mode receivers.

Features (host numpy, as in the reference, on the channel the device
channelizer cut out):
* envelope statistics (constant-envelope vs amplitude-bearing vs keyed),
* carrier prominence and spectral symmetry about the centroid,
* occupied bandwidth,
* cyclic-prefix autocorrelation (OFDM family, with the lag ≈ n_fft),
* post-discriminator tone census (FM stereo pilot; 2-level FSK),
* envelope keying periodicity (PSK31's Hann dips; CW's on/off).

``classify_signal`` labels one channel; ``band_survey`` scans a wideband
capture on ``device`` and labels every occupied segment; ``band_decode``
then decodes each with its mode's receiver on ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .codec.morse import morse_decode
from .codec.psk31_stream import psk31_decode_band
from .demodulate.afsk import rtty_decode_fsk
from .demodulate.analog import am_demod, fm_demod, ssb_band_demod
from .demodulate.fm_stereo import fm_stereo_demod
from .demodulate.pocsag import pocsag_decode
from .dsp.channelizer import Channelizer
from .dsp.device import to_device
from .util import SpectrumSegment, _np, spectrum_scan

@dataclass
class SignalClass:
    label: str
    confidence: float
    features: Dict[str, float] = field(default_factory=dict)


def _psd(z: np.ndarray, nfft: int) -> np.ndarray:
    nfft = min(nfft, 1 << int(np.floor(np.log2(len(z)))))
    hop = nfft // 2
    n_seg = max((len(z) - nfft) // hop + 1, 1)
    w = np.hanning(nfft)
    acc = np.zeros(nfft)
    for i in range(n_seg):
        seg = z[i * hop: i * hop + nfft] * w
        acc += np.abs(np.fft.fft(seg)) ** 2
    return np.fft.fftshift(acc / n_seg)


def classify_signal(iq, fs: float) -> SignalClass:
    """One baseband channel capture (host data or a tensor) → SignalClass;
    the features are computed on the host."""
    z = _np(iq).astype(np.complex64)
    if z.ndim != 1 or len(z) < 4096:
        raise ValueError("classify_signal needs a 1-D capture of ≥4096 "
                         "samples")
    feats: Dict[str, float] = {}
    env = np.abs(z)
    p_total = float(np.mean(env ** 2))
    if p_total < 1e-12:
        return SignalClass("noise", 1.0, feats)

    # envelope statistics (normalized to the 99.5th percentile — OFDM's
    # PAPR spikes make the raw max useless as a reference)
    env_cv = float(np.std(env) / (np.mean(env) + 1e-12))
    feats["env_cv"] = env_cv
    ref = float(np.percentile(env, 99.5)) + 1e-12
    duty = float(np.mean(env > 0.5 * ref))
    feats["duty"] = duty
    off_frac = float(np.mean(env < 0.1 * ref))
    feats["off_frac"] = off_frac          # CW keying rests near zero; AM
                                          # envelopes never do

    # spectrum features
    nfft = 4096
    psd = _psd(z, nfft)
    nfft = len(psd)
    freqs = (np.arange(nfft) - nfft // 2) * (fs / nfft)
    floor = np.median(psd)
    feats["peak_over_floor_db"] = float(10 * np.log10(
        np.max(psd) / (floor + 1e-20)))
    # occupied-bw mask: 10× the floor, but never below −30 dB of the peak
    # (synthetic noise-free captures have a floor near zero, which would
    # sweep −60 dB skirts into the bandwidth)
    mask = psd > max(10.0 * floor, float(np.max(psd)) * 1e-3)
    occ = freqs[mask]
    bw = float(occ.max() - occ.min()) if occ.size else 0.0
    feats["bw_hz"] = bw
    centroid = float(np.sum(freqs * psd * mask)
                     / (np.sum(psd * mask) + 1e-20))
    feats["centroid_hz"] = centroid
    # symmetry of the occupied spectrum about the centroid
    ci = int(round(centroid / (fs / nfft))) + nfft // 2
    half = min(ci, nfft - ci - 1, nfft // 2 - 1)
    if half > 4:
        lo = psd[ci - half:ci][::-1]
        hi = psd[ci + 1:ci + 1 + half]
        sym = float(np.sum(np.minimum(lo, hi)) / (np.sum(
            np.maximum(lo, hi)) + 1e-20))
    else:
        sym = 1.0
    feats["symmetry"] = sym
    # carrier: single dominating bin at the centroid?
    pk = int(np.argmax(psd))
    carrier_frac = float(psd[pk] / (np.sum(psd[mask]) + 1e-20)) \
        if mask.any() else 0.0
    feats["carrier_frac"] = carrier_frac

    # OFDM: cyclic-prefix autocorrelation — normalized |Σ z[t]·conj(z[t+L])|
    # peaks when the lag hits n_fft. A narrowband tone correlates at EVERY
    # lag, so the discriminant is the candidate-lag correlation MINUS the
    # correlation at a nearby control lag (flat for tones, peaked for OFDM).
    def _corr(lag):
        a, b = z[:-lag], z[lag:]
        return float(abs(np.vdot(b, a))
                     / (np.sqrt(np.vdot(a, a).real * np.vdot(b, b).real)
                        + 1e-20))

    best_cp = 0.0
    for lag in (256, 512, 1024, 2048):
        if lag * 3 > len(z):
            continue
        # several control lags, MAX taken: a periodic signal (tone-modulated
        # FM, steady tones) correlates at some nearby lag too, killing the
        # difference; true CP structure is specific to lag = n_fft
        ctrl = max(_corr(lag + d) for d in (-89, -37, 41, 97) if lag + d > 0)
        best_cp = max(best_cp, _corr(lag) - ctrl)
    feats["cp_corr"] = best_cp

    # discriminator-domain census (FM family / FSK)
    prod = z[1:] * np.conj(z[:-1])
    disc = np.arctan2(prod.imag, prod.real)
    dstd = float(np.std(disc))
    feats["disc_std"] = dstd
    pilot_prom = 0.0
    fsk_bimodal = 0.0
    if env_cv < 0.25 and bw > 0:
        dp = _psd(disc.astype(np.complex64), 8192)
        dn = len(dp)
        dfreqs = (np.arange(dn) - dn // 2) * (fs / dn)
        sel = (np.abs(dfreqs - 19000.0) < 300.0)
        near = (dfreqs > 10_000.0) & (dfreqs < 26_000.0) & ~sel
        if sel.any() and near.any() and fs > 2 * 19000.0:
            pilot_prom = float(np.max(dp[sel])
                               / (np.median(dp[near]) + 1e-20))
        # 2-FSK: the discriminator dwells at exactly two levels with an
        # EMPTY valley between (NRZ switching); tone-FM's sine swing is
        # bimodal too (arcsine density) but fills the valley. The histogram
        # range adapts ROBUSTLY to the dwell level (a percentile — noise
        # tails inflate the std 3× on narrow-shift FSK like RTTY).
        a = float(min(np.pi, max(1.5 * np.percentile(np.abs(disc), 90.0),
                                 1e-3)))
        hist, _ = np.histogram(disc, bins=32, range=(-a, a))
        h = hist / hist.sum()
        order = np.argsort(h)[::-1]
        top2 = np.sort(order[:2])
        if abs(int(top2[1]) - int(top2[0])) >= 5:
            p0, p1 = int(top2[0]), int(top2[1])
            # noise spreads each dwell level over ±1 bin — count the
            # 3-bin neighborhoods as the peaks, the strict middle as valley
            peaks = float(h[max(p0 - 1, 0):p0 + 2].sum()
                          + h[max(p1 - 1, 0):p1 + 2].sum())
            between = float(h[p0 + 2:p1 - 1].sum())
            # filtered transitions leave a little mass between the
            # levels; a sine's arcsine density leaves ~2× the peaks
            fsk_bimodal = peaks if between < 0.35 * peaks else 0.0
    feats["pilot19k_prom"] = pilot_prom
    feats["fsk_bimodal"] = fsk_bimodal

    # envelope keying periodicity (PSK31 Hann dips at the baud rate)
    psk31_peak = 0.0
    if 20.0 < bw < 200.0:
        e = env - np.mean(env)
        ep = np.abs(np.fft.rfft(e * np.hanning(len(e)))) ** 2
        ef = np.fft.rfftfreq(len(e), 1 / fs)
        band31 = (ef > 25.0) & (ef < 40.0)
        rest = (ef > 5.0) & (ef < 200.0)
        if band31.any() and rest.any():
            # the 31.25 Hz keying line must be the DOMINANT envelope
            # periodicity — CW keying has a stronger fundamental below it
            f_top = float(ef[rest][np.argmax(ep[rest])])
            if 25.0 < f_top < 40.0:
                psk31_peak = float(np.max(ep[band31])
                                   / (np.median(ep[rest]) + 1e-20))
    feats["psk31_env_peak"] = psk31_peak

    # ── decision tree ────────────────────────────────────────────────────────
    def made(label, conf):
        return SignalClass(label, float(np.clip(conf, 0.0, 1.0)), feats)

    if env_cv < 0.25 and fsk_bimodal > 0.6 and dstd < 2.0:
        return made("fsk", fsk_bimodal)     # before OFDM: a repeating FSK
                                            # preamble autocorrelates too
    if best_cp > 0.06 and env_cv > 0.3:
        # OFDM's envelope is Rayleigh-like (cv ≈ 0.52); a constant-envelope
        # signal with incidental periodicity (tone FM) cannot be OFDM
        return made("ofdm", min(1.0, best_cp * 8.0))
    if psk31_peak > 30.0 and bw < 200.0:
        return made("psk31", 0.9)
    if env_cv < 0.25:                       # constant envelope
        if pilot_prom > 10.0 and bw > 100e3:
            # a stereo composite is ~106 kHz wide at 75 kHz deviation; the
            # width gate keeps tone-FM harmonics at exactly 19 kHz (test
            # signals) from reading as a pilot
            return made("fm_stereo", min(1.0, pilot_prom / 50.0))
        if bw < 150.0:
            return made("cw", 0.7)
        return made("fm", 0.7)
    if carrier_frac > 0.25 and off_frac > 0.3:
        return made("cw", 0.8)              # keyed carrier: rests near zero
                                            # a third of the time — no AM
                                            # envelope does that
    if carrier_frac > 0.25 and sym > 0.5:
        return made("am", min(1.0, carrier_frac * 2 + sym - 0.5))
    if sym < 0.45 and feats["peak_over_floor_db"] > 6.0:
        return made("ssb", 1.0 - sym)
    if feats["peak_over_floor_db"] < 6.0 and env_cv > 0.4:
        return made("noise", 0.6)
    return made("unknown", 0.3)


@dataclass
class SurveyEntry:
    segment: SpectrumSegment
    signal: SignalClass


def _channels(z: torch.Tensor, fs: float, ch_fs: float, centers,
              passband_hz: float) -> torch.Tensor:
    """(C, n) baseband channels at ``ch_fs`` around ``centers`` of the
    capture ``z``: one push and flush of a Channelizer on its device."""
    ch = Channelizer(fs, ch_fs, centers, passband_hz=passband_hz,
                     device=z.device)
    return torch.cat([ch.push(z), ch.flush()], dim=-1)


def band_survey(iq, fs: float, channel_pad: float = 1.6,
                keep_top_db: float = 25.0, device="cuda",
                **scan_kwargs) -> List[SurveyEntry]:
    """Scan a wideband capture, channelize the occupied segments on
    ``device`` (one batched channelizer for every group of segments that
    share a channel rate), classify each channel → [SurveyEntry].

    ``keep_top_db``: drop segments more than this far below the strongest
    one (strong transmitters' spectral leakage would otherwise read as a
    litter of confident narrow mis-labels)."""
    z = to_device(iq, device, torch.complex64)
    segs = spectrum_scan(z, fs, device=z.device, **scan_kwargs)
    if segs:
        top = max(s.power_db for s in segs)
        segs = [s for s in segs if s.power_db >= top - keep_top_db]
    groups: dict = {}
    for s in segs:
        want = max(s.bw_hz * channel_pad, 8000.0)
        m = max(1, int(fs // want))
        groups.setdefault(m, []).append(s)
    results: dict = {}
    for m, group in groups.items():
        ch_fs = fs / m
        pb = min(0.45 * ch_fs, max(s.bw_hz for s in group) * 0.8)
        y = _channels(z, fs, ch_fs, [s.center_hz for s in group],
                      pb).cpu().numpy()
        for i, s in enumerate(group):
            try:
                results[id(s)] = classify_signal(y[i], ch_fs)
            except ValueError:
                results[id(s)] = SignalClass("unknown", 0.0)
    return [SurveyEntry(segment=s, signal=results[id(s)]) for s in segs]


@dataclass
class BandDecodeEntry:
    """One decoded band occupant: the survey entry plus whatever the
    dispatched receiver recovered (fields None when not applicable);
    ``audio`` is a tensor on the decode's device."""
    segment: SpectrumSegment
    signal: SignalClass
    audio: Optional[torch.Tensor] = None
    fs_audio: Optional[float] = None
    text: Optional[str] = None
    pages: Optional[list] = None      # POCSAG
    rds: Optional[object] = None      # FM stereo station data


def _decode(entry: BandDecodeEntry, z: torch.Tensor, fs: float) -> None:
    """Run the receiver of ``entry``'s label on its segment of ``z`` and
    fill the entry."""
    seg, label, dev = entry.segment, entry.signal.label, z.device

    def channel(min_rate, passband):
        m = max(1, int(fs // min_rate))
        return _channels(z, fs, fs / m, [seg.center_hz], passband)[0], fs / m

    if label == "am":
        y, ch_fs = channel(4 * 5e3, 6e3)
        entry.audio = am_demod(y, ch_fs, 5e3, device=dev)[0]
        entry.fs_audio = ch_fs
    elif label == "fm":
        y, ch_fs = channel(max(2.5 * seg.bw_hz, 24e3), 0.6 * seg.bw_hz + 3e3)
        entry.audio = fm_demod(y, ch_fs, seg.bw_hz / 4 + 2.5e3, 5e3,
                               device=dev)[0]
        entry.fs_audio = ch_fs
    elif label == "fm_stereo":
        y, ch_fs = channel(240e3, 110e3)
        st = fm_stereo_demod(y, ch_fs, decode_rds=True, device=dev)
        entry.audio = torch.stack([st.left, st.right])
        entry.fs_audio = ch_fs
        entry.rds = st.rds
        if st.rds is not None and getattr(st.rds, "ps_name", "").strip():
            entry.text = st.rds.ps_name.strip()
    elif label == "ssb":
        # blind dial estimate (voice: audio starts ~300 Hz above the
        # suppressed carrier + the 1.5 kHz IF); absolute pitch carries the
        # estimate's error, tone relations are exact
        dial = seg.center_hz - seg.bw_hz / 2.0 - 1800.0
        st = ssb_band_demod(z, fs, [dial], device=dev)
        if st:
            entry.audio = st[0].audio
            entry.fs_audio = st[0].fs_audio
    elif label == "cw":
        y, ch_fs = channel(8e3, 2e3)
        entry.text = morse_decode(y, ch_fs, device=dev)
    elif label == "psk31":
        y, ch_fs = channel(8e3, 1e3)
        results = psk31_decode_band(y, ch_fs, -500.0, 500.0, max_carriers=1,
                                    device=dev)
        if results:
            entry.text = results[0].text
    elif label == "fsk":
        y, ch_fs = channel(16 * 2400.0, 12e3)
        pages = pocsag_decode(y, ch_fs, device=dev)
        if pages:
            entry.pages = pages
            entry.text = " / ".join((p.text or p.digits or "") for p in pages)
        else:
            yn, ch_fs_n = channel(8e3, 1.5e3)            # RTTY is narrow
            text = rtty_decode_fsk(yn, ch_fs_n, device=dev)
            if sum(c.isalnum() for c in text) >= 6:
                entry.text = text


def band_decode(iq, fs: float, device="cuda",
                **survey_kwargs) -> List[BandDecodeEntry]:
    """Scan → classify → decode every signal of a wideband capture with its
    mode's receiver on ``device``, with no prior channel plan. Each segment
    is channelized twice (for the classification and at its receiver's
    rate), segments one after another."""
    z = to_device(iq, device, torch.complex64)
    out: List[BandDecodeEntry] = []
    for e in band_survey(z, fs, device=z.device, **survey_kwargs):
        entry = BandDecodeEntry(segment=e.segment, signal=e.signal)
        try:
            _decode(entry, z, fs)
        except ValueError:
            # what a receiver raises on a channel it cannot decode (too
            # short, no sync): the entry keeps its label. Anything else (a
            # torch or CUDA RuntimeError, a kernel build) propagates.
            pass
        out.append(entry)
    return out
