"""Streaming and whole-band PSK31 decoding (counterpart of
``orion_sdr_tpu/codec/psk31_stream.py``; behavioral spec:
codec/psk31.rs:400-572).

A host feed/flush loop around the device demod: IQ chunks are buffered to
whole symbols, the matched filter and the PLL kernel run on the device with
the (prev_sym, phase_acc) carry and the down-mix phase held across feeds,
and the text layers (the QPSK Viterbi, varicode) run on the host.
Chunk-boundary invariant: any chunking decodes as one shot does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .varicode import VaricodeDecoder
from .psk31 import StreamingViterbi, DQPSK_EXP
from ..demodulate.psk31 import (bpsk31_decide, psk31_demod_multi,
                                psk31_refine_carriers, stream_step)
from ..dsp.device import sanitize_iq, to_device
from ..modulate.psk31 import PSK31_BAUD, psk31_sps
from ..sync.psk31_sync import psk31_carrier_search


class Psk31Stream:
    """Persistent streaming PSK31 text decoder (BPSK31 or QPSK31); the
    demod runs on ``device``."""

    def __init__(self, fs: float, carrier_hz: float = 0.0, gain: float = 1.0,
                 qpsk: bool = False, device="cuda") -> None:
        self.device = torch.device(device)
        self.fs = float(fs)
        self.carrier_hz = float(carrier_hz)
        self.gain = float(gain)
        self.qpsk = qpsk
        self.sps = psk31_sps(fs)
        self._buf = np.zeros(0, np.complex64)
        self._fed_up_to = 0
        self._n_mixed = 0               # samples already through the rotator
        self._prev_sym = 1.0 + 0.0j
        self._phase_acc = 0.0
        self.vdec = VaricodeDecoder()
        self.viterbi = StreamingViterbi(DQPSK_EXP) if qpsk else None

    @classmethod
    def new_bpsk(cls, fs: float, carrier_hz: float = 0.0, gain: float = 1.0,
                 device="cuda"):
        return cls(fs, carrier_hz, gain, qpsk=False, device=device)

    @classmethod
    def new_qpsk(cls, fs: float, carrier_hz: float = 0.0, gain: float = 1.0,
                 device="cuda"):
        return cls(fs, carrier_hz, gain, qpsk=True, device=device)

    @property
    def fed_up_to(self) -> int:
        return self._fed_up_to

    def feed(self, iq) -> str:
        """Feed IQ samples (host data or a tensor); returns newly decoded
        printable ASCII."""
        iq = sanitize_iq(to_device(iq, "cpu", torch.complex64)).numpy()
        if iq.size == 0:
            return ""
        self._fed_up_to += len(iq)
        self._buf = np.concatenate([self._buf, iq])
        n_syms = len(self._buf) // self.sps
        if n_syms == 0:
            return ""
        take = n_syms * self.sps
        z = self._buf[:take]
        self._buf = self._buf[take:]
        # continue the down-mix phase across feeds
        phase0 = np.float32(-2.0 * np.pi * self.carrier_hz
                            * self._n_mixed / self.fs)
        self._n_mixed += take
        soft, prev_sym, phase_acc = stream_step(
            torch.as_tensor(z, device=self.device),
            torch.tensor(phase0, device=self.device),
            complex(np.complex64(self._prev_sym)),
            float(np.float32(self._phase_acc)), self.sps, self.gain,
            self.qpsk, self.carrier_hz, self.fs)
        self._prev_sym = complex(prev_sym.item())
        self._phase_acc = float(phase_acc.item())
        soft = soft.cpu().numpy()

        if not self.qpsk:
            return self.vdec.push_bits(bpsk31_decide(soft))

        text = []
        for d_re, d_im in soft:
            if d_re * d_re + d_im * d_im < 0.01:   # silence/startup skip
                continue
            b = self.viterbi.feed_symbol(float(d_re), float(d_im))
            if b is not None:
                text.append(self.vdec.push_bits([b]))
        return "".join(text)

    def flush(self) -> str:
        """Emit trailing characters after the last feed."""
        if not self.qpsk:
            return self.vdec.push_bits([0, 0])
        text = [self.vdec.push_bits(self.viterbi.flush())]
        text.append(self.vdec.push_bits([0, 0]))
        return "".join(text)


# ── whole-band decode ────────────────────────────────────────────────────────


# PLL-acquisition lead for band decode: symbols of pre-detection signal
# (preamble the correlator could not see) plus bounded noise the demod row
# is extended backward by. ~1.5 s at 31.25 baud.
_PLL_LEAD = 48


def _collapse_idle(bits) -> np.ndarray:
    """Collapse every 0-run longer than 2 down to exactly "00".

    The "00"-boundary automaton (wire-compatible with ref
    codec/varicode.rs:290-313) consumes idle zeros in PAIRS after a
    boundary, so following an odd-length zero run the next codeword picks
    up a leading zero and is dropped — in a band decode, any noise-flipped
    '1' ahead of the text re-randomizes that parity and kills the first
    real character ~50% of the time. Collapsing idle runs leaves every
    codeword preceded by exactly one "00" boundary; the stream itself is
    wire-identical (varicode idle is "zeros until the next mark")."""
    b = np.asarray(bits, np.uint8)
    if b.size == 0:
        return b
    z1 = np.concatenate([[0], b[:-1]])
    z2 = np.concatenate([[0, 0], b[:-2]]) if b.size >= 2 else np.zeros_like(b)
    return b[(b | z1 | z2).astype(bool)]


@dataclass
class Psk31BandResult:
    """One decoded PSK31 transmission from a band scan."""
    carrier_hz: float
    time_sym: int
    score: float
    text: str


def psk31_decode_band(iq, fs: float, base_hz: float, max_hz: float,
                      qpsk: bool = False, max_carriers: int = 8,
                      min_carrier_syms: int = 8, peak_margin_db: float = 6.0,
                      gain: float = 1.0,
                      device="cuda") -> List[Psk31BandResult]:
    """Decode EVERY PSK31 transmission in a band in one batched pass.

    The waterfall carrier search finds every persistent peak, the K
    detected carriers demodulate together on the device
    (psk31_demod_multi: broadcast mix, batched matched-filter matmul, one
    PLL kernel launch), and only the text layers run per carrier on the
    host. Results strongest first.
    """
    iq = sanitize_iq(to_device(iq, device, torch.complex64))
    # half-baud bins: off-grid carriers split −3.9 dB across baud-spaced
    # bins and fragment detection runs (see psk31_carrier_search). Runs are
    # extracted down to 2 symbols because the symbol-window correlator is
    # nearly blind to phase-reversal symbols (the pulse-shaped halves
    # cancel): the all-reversal preamble and 0-heavy varicode text show up
    # only as short 1-bit runs, and the first ≥min_carrier_syms run can sit
    # tens of symbols into the transmission (often it is the steady
    # postamble). Short runs recover the true time extent; detection still
    # requires one persistent run per cluster.
    found, floor_ln = psk31_carrier_search(iq, fs, base_hz, max_hz,
                                           2, peak_margin_db,
                                           bin_hz=PSK31_BAUD / 2.0,
                                           with_floor=True, device=device)
    # one carrier per spectral neighborhood: strongest run wins its ±1-baud
    # cluster (wide enough to absorb the half-baud detection split, narrow
    # enough that real signals ~2 baud apart stay separate); the cluster's
    # earliest start / latest end bound the decode
    found.sort(key=lambda c: -c[3])
    groups: List[List[tuple]] = []     # runs per cluster, strongest first
    for run in found:
        for g in groups:
            if abs(g[0][2] - run[2]) <= PSK31_BAUD:
                g.append(run)
                break
        else:
            groups.append([run])
    # Cluster extent comes only from runs within 8 dB of the cluster peak:
    # the transmission's own spectral lines (text/postamble on the carrier
    # bin, the all-reversal preamble's ±baud/2 lines at ≥ −7 dB) qualify,
    # while sub-threshold noise runs before/after the signal — which would
    # stretch the decode window into a neighbor's leakage floor — do not.
    ext_ln = 8.0 * np.log(10.0) / 10.0
    # [time_sym, carrier_hz, score, end_sym, length-weighted score]
    clusters: List[list] = []
    for g in groups:
        peak = g[0][3]
        qual = [r for r in g if r[3] >= peak - ext_ln]
        if max(r[4] - r[0] for r in qual) < min_carrier_syms:
            continue
        # length-weighted mean ln power: a 2-symbol run only exists where
        # noise peaked, so short-run means are selection-biased several dB
        # high; weighting by run length makes the sidelobe comparison below
        # ride the long (unbiased) runs
        wsum = sum((r[4] - r[0]) * r[3] for r in qual)
        wlen = sum(r[4] - r[0] for r in qual)
        clusters.append([min(r[0] for r in qual), g[0][2], peak,
                         max(r[4] for r in qual), wsum / wlen])

    # Sidelobe rejection: the symbol-length rectangular correlator has a
    # sinc response whose sidelobe envelope is ~−20·log10(π·Δf/baud) dB
    # (−13.3 dB at 1.43 baud, decaying only 1/Δf), so a high-SNR carrier
    # seeds detectable runs many baud away. A candidate within 7 dB of the
    # expected sidelobe level of any stronger pick is a sidelobe, not a
    # signal (a real neighbor *below* that level is indistinguishable by
    # power and undecodable anyway); 7 dB because run extraction is
    # selection-biased — runs form exactly where noise peaked, measuring
    # sidelobe clusters up to ~6 dB above the envelope model on clean
    # inputs. Scores are mean ln(signal+floor), so compare
    # floor-SUBTRACTED powers — near the floor the raw-score gap
    # compresses and far sidelobes of a strong carrier would otherwise
    # pass the relative-level test.
    def _excess(score_ln: float) -> float:
        return max(float(np.expm1(score_ln - floor_ln)), 1e-9)

    picked: List[list] = []
    for p in clusters:             # strongest first
        sidelobe = False
        for q in picked:
            # the emitter is modulated ~baud wide, which smears the sinc
            # nulls: evaluate the envelope at dx − baud/2, not dx
            dx = abs(p[1] - q[1]) / PSK31_BAUD - 0.5
            env_db = -20.0 * np.log10(max(np.pi * dx, 1.0))
            rel_db = 10.0 * np.log10(_excess(p[4]) / _excess(q[4]))
            if rel_db < env_db + 7.0:
                sidelobe = True
                break
        if not sidelobe and len(picked) < max_carriers:
            picked.append(p)
    if not picked:
        return []

    sps = psk31_sps(fs)
    coarse = np.asarray([p[1] for p in picked], np.float32)
    # The refine is anchored at each carrier's detected signal start so the
    # squared-spectrum line integrates only over the transmission; the
    # window is the shortest cluster extent, quantized to a power of two
    # symbols so repeated band scans reuse compilations.
    ref_starts = np.asarray([p[0] * sps for p in picked], np.int32)
    min_ext = max(min(p[3] - p[0] for p in picked), 8)
    ref_syms = 1 << int(np.log2(min_ext))
    # Half-baud detection bins bound the offset at ±baud/4 when the cluster
    # seeds on the carrier line, but a weak signal can seed on one of the
    # preamble's ±baud/2 lines instead, so allow ±0.55 baud. Inside that
    # window the squared signal's envelope sidebands (2Δf ± baud) can
    # appear, but the main line is ≥3.5 dB above them (Hann² envelope:
    # fundamental/DC = 0.5/0.375 per reversal-heavy worst case), so the
    # windowed argmax in psk31_refine_carriers still lands on the line.
    carriers = psk31_refine_carriers(
        iq, fs, coarse, qpsk, starts=ref_starts,
        length=min(int(ref_syms) * sps, int(iq.shape[-1])),
        max_df_hz=PSK31_BAUD * 0.55, device=device)
    # The demod is anchored _PLL_LEAD symbols BEFORE the detected start:
    # detection first fires on the earliest 1-bit run, which can be into
    # the text already (the all-reversal preamble is nearly invisible to
    # the symbol correlator), and the decision-feedback PLL needs the
    # preamble — anchored at the detected start it acquires during the
    # first characters and corrupts them. A bounded lead of noise is
    # benign (the PLL re-pulls within a few reversal symbols); an
    # UNbounded lead is not, which is why whole-buffer demod was dropped.
    lead_syms = [min(_PLL_LEAD, p[0]) for p in picked]
    starts = np.asarray([(p[0] - ld) * sps
                         for p, ld in zip(picked, lead_syms)], np.int32)
    soft, _off = psk31_demod_multi(iq, fs, carriers, gain, qpsk,
                                   starts=starts, device=device)
    soft = soft.cpu().numpy()
    carriers = carriers.cpu().numpy()
    for p, hz in zip(picked, carriers):
        p[1] = float(hz)

    results: List[Psk31BandResult] = []
    for (det_start, hz, score, end, _run), row, ld in zip(picked, soft,
                                                          lead_syms):
        # rows are anchored ld symbols before the detection start; the
        # cluster end (+2 slack) stops the decode before post-signal
        # noise — in a crowded band the leakage floor after a signal ends
        # would otherwise decode a strong neighbor's text
        row = row[:min(end - det_start + ld + 2, row.shape[0])]
        vdec = VaricodeDecoder()
        if not qpsk:
            bits = bpsk31_decide(row)
            text = ""
            if bits.any():
                vdec.push_bits([0, 0])
                text = vdec.push_bits(_collapse_idle(bits))
                text += vdec.push_bits([0, 0])
        else:
            vit = StreamingViterbi(DQPSK_EXP)
            vbits = []
            for d_re, d_im in row:
                if d_re * d_re + d_im * d_im < 0.01:   # silence/startup skip
                    continue
                b = vit.feed_symbol(float(d_re), float(d_im))
                if b is not None:
                    vbits.append(b)
            vbits.extend(vit.flush())
            vdec.push_bits([0, 0])
            text = vdec.push_bits(_collapse_idle(np.asarray(vbits, np.uint8)))
            text += vdec.push_bits([0, 0])
        results.append(Psk31BandResult(carrier_hz=float(hz),
                                       time_sym=int(det_start),
                                       score=float(score), text=text))
    return results
