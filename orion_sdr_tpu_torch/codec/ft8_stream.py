"""FT8/FT4 stream, many-window, multi-frame and multi-signal decoders
(counterpart of ``orion_sdr_tpu/codec/ft8_stream.py``; behavioral spec:
codec/ft8.rs:159-400).

Everything up to the payload bits runs on the decoder's device: sync
(waterfall, Costas grid, top-k, LLR gather), BP, the CRC and prior checks.
Each decode hands every candidate of its sync to ONE BP launch and then
takes the candidates in order, which gives what the JAX package's
decode-one-candidate-at-a-time loops give (they decode candidates of one
sync, whose LLRs no decode changes). The host unpacks the winning payloads
(``unpack77``) and, for multi-signal decode, steers the sequential
subtraction. A :class:`~..message.CallsignHashTable` persists across frames
so hashed nonstandard calls resolve in later messages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import obs
from ..dsp.device import sanitize_iq
from ..message import CallsignHashTable, unpack77, Ft8Message
from ..modulate.ft8 import (FT8_FRAME_LEN, FT4_FRAME_LEN,
                            FT8_TONE_SPACING_HZ, FT4_TONE_SPACING_HZ)
from ..sync.ft8_sync import ft8_sync, ft4_sync
from .ft8 import _decode_rows, _payload, decode_soft_batch


@dataclass
class Ft8DecodeResult:
    """(ref Ft8DecodeResult)"""
    message: Ft8Message
    carrier_hz: float
    snr_db: float       # Costas score — monotone with true SNR


def _iq(iq, device) -> torch.Tensor:
    x = torch.as_tensor(iq, device=device)
    obs.count_h2d(iq, x)
    return sanitize_iq(x)


def _first_decode(cands, payloads_by_prior, ht, carrier):
    """The first candidate, plain decodes before prior-primed ones, whose
    payload decoded and is not all zero (the all-zero codeword is
    CRC-consistent, so silence would otherwise "decode" as an empty
    free-text message)."""
    for payloads in payloads_by_prior:
        for cand, payload in zip(cands, payloads):
            if payload is not None and np.any(payload):
                return Ft8DecodeResult(message=unpack77(payload, ht),
                                       carrier_hz=carrier(cand),
                                       snr_db=cand.score)
    return None


class Ft8StreamDecoder:
    """Accumulates IQ at 12 kHz on ``device`` and decodes FT8 or FT4
    frames."""

    def __init__(self, fs: float, base_hz: float, max_hz: float,
                 max_cand: int = 4, ft8: bool = True, ap=None, *,
                 device="cuda") -> None:
        self.fs = float(fs)
        self.base_hz = float(base_hz)
        self.max_hz = float(max_hz)
        self.max_cand = max(int(max_cand), 1)
        self.is_ft8 = ft8
        self.frame_len = FT8_FRAME_LEN if ft8 else FT4_FRAME_LEN
        self.device = torch.device(device)
        self._buf = torch.zeros(0, dtype=torch.complex64, device=self.device)
        self.hash_table = CallsignHashTable()
        # a-priori prior (positions, bits) from ft8_ap_prior: candidates
        # that fail the plain decode get a second, prior-clamped BP pass
        self.ap = ap

    @classmethod
    def new_ft8(cls, fs: float, base_hz: float, max_hz: float,
                max_cand: int = 4, *, device="cuda"):
        return cls(fs, base_hz, max_hz, max_cand, ft8=True, device=device)

    @classmethod
    def new_ft4(cls, fs: float, base_hz: float, max_hz: float,
                max_cand: int = 4, *, device="cuda"):
        return cls(fs, base_hz, max_hz, max_cand, ft8=False, device=device)

    def __len__(self) -> int:
        return self._buf.shape[0]

    def view_buf(self) -> torch.Tensor:
        return self._buf

    def clear(self) -> None:
        self._buf = self._buf.new_zeros(0)

    def feed(self, iq) -> List[Ft8DecodeResult]:
        """Append samples; decode when a full frame is buffered."""
        self._buf = torch.cat([self._buf, _iq(iq, self.device)])
        if len(self) >= self.frame_len:
            return self._decode_buf()
        return []

    def flush(self) -> List[Ft8DecodeResult]:
        """Decode whatever is buffered (does not clear the buffer)."""
        if len(self) == 0:
            return []
        return self._decode_buf()

    def _decode_buf(self) -> List[Ft8DecodeResult]:
        spacing = FT8_TONE_SPACING_HZ if self.is_ft8 else FT4_TONE_SPACING_HZ
        search_min = self.base_hz
        search_max = max(self.max_hz + spacing, search_min + spacing)
        sync = ft8_sync if self.is_ft8 else ft4_sync
        cands = sync(self._buf, self.fs, search_min, search_max, 0, 0,
                     self.max_cand, device=self.device)
        if not cands:
            return []
        # plain decodes first; AP-primed retries only if nothing decodes
        # (matches WSJT-X ordering — an AP decode never masks a full one)
        priors = [None, self.ap] if self.ap is not None else [None]
        got = decode_soft_batch(torch.stack([c.llr for c in cands]), 20,
                                priors, ft4=not self.is_ft8)
        hit = _first_decode(cands, got, self.hash_table,
                            lambda c: self.base_hz + c.freq_bin * spacing)
        return [hit] if hit is not None else []


@obs.rooted("orion.ft8.decode_windows")
def _decode_windows(windows, fs, base_hz, max_hz, max_cand, hash_table, ft8,
                    ap, device):
    from ..sync.ft8_sync import _sync_batch_llrs

    x = _iq(windows, device)
    if x.dim() != 2:
        raise ValueError(f"windows must be (B, n), got {tuple(x.shape)}")
    W = x.shape[0]
    obs.count("windows", W)
    ht = hash_table if hash_table is not None else CallsignHashTable()
    spacing = FT8_TONE_SPACING_HZ if ft8 else FT4_TONE_SPACING_HZ
    with obs.span("orion.ft8.sync"):
        got = None if W == 0 else _sync_batch_llrs(
            x, fs, base_hz, max(max_hz + spacing, base_hz + spacing),
            max_cand, "ft8" if ft8 else "ft4")
    if got is None:
        return [None] * W
    f_count, vals, idx, llr = got
    k = vals.shape[1]

    # one batched BP over every candidate of every window; with an AP
    # prior the clamped retry rows (amplitude from the whole matrix) ride
    # the SAME batch
    priors = (None,) if ap is None else (None, ap)
    obs.count("bp.rows", llr.shape[0] * len(priors))
    with obs.span("orion.ft8.bp_crc"):
        bits, ok = _decode_rows(llr, 20, priors, per_row=False)
    with obs.span("orion.ft8.select"):
        # an all-zero (scrambled) payload is rejected: bits 0..79 of a91
        ok = ok & bits[:, :80].bool().any(-1)
        # each window's first passing row, plain rows before AP rows
        P = len(priors)
        okw = ok.reshape(P, W, k).transpose(0, 1).reshape(W, P * k)
        order = torch.arange(P * k, device=okw.device)
        first = torch.where(okw, order, P * k).amin(-1)
        hit = first < P * k
        first = torch.where(hit, first, 0)
        row = (first // k) * (W * k) + \
            torch.arange(W, device=okw.device) * k + first % k
        win_bits = bits[row]
        cand = first % k
        flat = idx.gather(1, cand[:, None])[:, 0]
        score = vals.gather(1, cand[:, None])[:, 0]
        # only the winners go to the host
        packed = obs.to_host(torch.cat([hit[:, None].long(), flat[:, None],
                                        win_bits.long()], 1))
        score = obs.to_host(score)
    results: List[Optional[Ft8DecodeResult]] = []
    with obs.span("orion.ft8.results"):
        for w in range(W):
            if not packed[w, 0]:
                results.append(None)
                continue
            payload = _payload(packed[w, 2:], ft4=not ft8)
            results.append(Ft8DecodeResult(
                message=unpack77(payload, ht),
                carrier_hz=base_hz + int(packed[w, 1] % f_count) * spacing,
                snr_db=float(score[w])))
    if obs.recording():
        obs.count("windows.decoded", int(packed[:, 0].sum()))
    return results


def ft8_decode_windows(windows, fs: float = 12000.0, base_hz: float = 200.0,
                       max_hz: float = 3000.0, max_cand: int = 4,
                       hash_table: Optional[CallsignHashTable] = None,
                       ap=None, *, device="cuda"):
    """Batch-decode many 15 s FT8 receive windows on ``device``
    (BASELINE.json config 3).

    ``windows``: (B, n) IQ at 12 kHz (host data or a tensor). One pass
    computes every window's waterfall, Costas score grid, top-k and the
    LLRs of every candidate; those of ALL windows decode in ONE BP launch
    (with ``ap``, the prior-clamped rows ride the same launch), the CRC and
    prior checks run on the device, and each window keeps its first
    passing candidate (plain rows before AP rows). Returns a list (len B)
    of Ft8DecodeResult-or-None.
    """
    return _decode_windows(windows, fs, base_hz, max_hz, max_cand,
                           hash_table, True, ap, device)


def ft4_decode_windows(windows, fs: float = 12000.0, base_hz: float = 200.0,
                       max_hz: float = 3000.0, max_cand: int = 4,
                       hash_table: Optional[CallsignHashTable] = None,
                       ap=None, *, device="cuda"):
    """ft8_decode_windows for 7.5 s FT4 windows (XOR-descrambled
    payloads)."""
    return _decode_windows(windows, fs, base_hz, max_hz, max_cand,
                           hash_table, False, ap, device)


def _decode_multi_frame(frames, fs, base_hz, max_hz, max_cand, ft8,
                        hash_table, max_iter, ap, device
                        ) -> Optional[Ft8DecodeResult]:
    from ..sync.ft8_sync import ft_sync_multi
    x = _iq(frames, device)
    spacing = FT8_TONE_SPACING_HZ if ft8 else FT4_TONE_SPACING_HZ
    ht = hash_table if hash_table is not None else CallsignHashTable()
    cands = ft_sync_multi(x, fs, base_hz,
                          max(max_hz + spacing, base_hz + spacing),
                          max_cand, "ft8" if ft8 else "ft4", device=device)
    if not cands:
        return None
    # plain decodes first; AP-primed retries only if none succeed
    priors = [None, ap] if ap is not None else [None]
    got = decode_soft_batch(torch.stack([c.llr for c in cands]), max_iter,
                            priors, ft4=not ft8)
    return _first_decode(cands, got, ht,
                         lambda c: base_hz + c.freq_bin * spacing)


def ft8_decode_multi_frame(frames, fs: float = 12000.0,
                           base_hz: float = 200.0, max_hz: float = 3000.0,
                           max_cand: int = 4, hash_table=None,
                           max_iter: int = 30, ap=None, *, device="cuda"
                           ) -> Optional[Ft8DecodeResult]:
    """Multi-frame averaging FT8 decode on ``device`` (beyond-reference
    sensitivity).

    ``frames``: (n_frames, 151680) — frame-aligned captures of the SAME
    message repeated over successive 15-s cycles (the WSJT-X multi-frame
    averaging scenario behind its −21 dB floor; the single-frame reference
    stops at −15). Candidates come from the SUMMED Costas score grids and
    their LLRs are summed across frames before one LDPC decode — each
    doubling of n_frames is worth ~1.5 dB of decode floor.
    """
    return _decode_multi_frame(frames, fs, base_hz, max_hz, max_cand,
                               True, hash_table, max_iter, ap, device)


def ft4_decode_multi_frame(frames, fs: float = 12000.0,
                           base_hz: float = 200.0, max_hz: float = 3000.0,
                           max_cand: int = 4, hash_table=None,
                           max_iter: int = 30, ap=None, *, device="cuda"
                           ) -> Optional[Ft8DecodeResult]:
    """Multi-frame averaging FT4 decode — see ft8_decode_multi_frame
    ((n_frames, 60480) captures)."""
    return _decode_multi_frame(frames, fs, base_hz, max_hz, max_cand,
                               False, hash_table, max_iter, ap, device)


# ── multi-signal decode via iterative subtraction ────────────────────────────
#
# Beyond the single-signal reference (codec/ft8.rs stops at the first
# CRC-passing candidate): decode EVERY signal in a crowded window by
# re-synthesizing each decoded frame, least-squares fitting it to the
# received IQ, subtracting it, and re-running sync on the residual — the
# WSJT-X multi-pass subtraction loop. The residual stays on the device; the
# re-synthesis is the runtime-tone CPFSK path and the per-symbol complex fit
# one reduction.


def _subtract_frame_impl(residual: torch.Tensor, tones_full, time_sym, f0,
                         fs, sps, mod_batch):
    """LS-subtract one re-synthesized frame from ``residual`` (a complex64
    tensor) in place.

    Per-symbol complex amplitudes a_k = ⟨r_k, s_k⟩/‖s_k‖² absorb channel
    gain/phase and slow drift; the dominant inter-symbol phase ramp is first
    folded into a frequency refinement (Δf from the a_{k+1}·conj(a_k) phase
    slope — candidates are waterfall-bin-granular, so a real signal can sit
    up to ±spacing/2 off grid) and the frame is re-synthesized once at the
    refined frequency. Returns (refined_hz, lag-1 amplitude coherence,
    fitted rms amplitude).

    The coherence |Σ a_{k+1}·ā_k| / Σ |a_{k+1}||a_k| separates true decodes
    from CRC-14 false positives on noise residuals: a real signal's fitted
    amplitudes share a slowly-varying phase (coherence → 1 even near the
    sensitivity floor) while a garbage fit is i.i.d. noise (≈ 1/√n_syms).
    The rms amplitude √mean|a_k|² feeds the caller's dynamic-range gate.
    """
    start = int(time_sym) * sps
    total = len(tones_full) * sps
    end = min(start + total, residual.shape[0])
    n_syms = (end - max(start, 0)) // sps
    if start < 0 or n_syms <= 0:
        return f0, 0.0, 0.0
    t_sym = sps / fs
    f = float(f0)
    tones = torch.as_tensor(np.asarray(tones_full)[None, :],
                            device=residual.device)
    a = None
    seg_s = None
    for it in range(2):
        s = mod_batch(tones, fs, f)[0][:n_syms * sps]
        seg_r = residual[start:start + n_syms * sps].reshape(n_syms, sps)
        seg_s = s.reshape(n_syms, sps)
        a = (seg_r * seg_s.conj()).sum(dim=1) / float(sps)
        if it == 1:
            break
        # phase slope across symbols → frequency refinement
        rot = (a[1:] * a[:-1].conj()).sum()
        df = float(torch.angle(rot)) / (2.0 * np.pi * t_sym)
        if abs(df) < 0.02:
            break
        f += df
    residual[start:start + n_syms * sps] -= (a[:, None] * seg_s).reshape(-1)
    denom = float((a[1:].abs() * a[:-1].abs()).sum())
    coh = float((a[1:] * a[:-1].conj()).sum().abs()) / max(denom, 1e-30)
    return f, coh, float(torch.sqrt(torch.mean(a.abs() ** 2)))


def _decode_multi_signal(iq, fs, base_hz, max_hz, max_cand, max_passes,
                         ft8, hash_table, max_iter, device
                         ) -> List[Ft8DecodeResult]:
    from ..sync.ft8_sync import _MODE, _mode_tables, _extract_llrs, _num_bins
    from ..sync.waterfall import compute_waterfall
    from ..sync.costas import Candidate, find_candidates
    from .ft8 import ft8_encode, ft4_encode

    mode = "ft8" if ft8 else "ft4"
    m = _MODE[mode]
    costas, sync_pos, data_pos, gray = _mode_tables(mode)
    spacing, sps = m["spacing"], m["sps"]
    encode = ft8_encode if ft8 else ft4_encode
    synth = _raw_cpfsk(ft8)
    ht = hash_table if hash_table is not None else CallsignHashTable()

    residual = _iq(iq, device).clone()
    search_max = max(max_hz + spacing, base_hz + spacing)
    num_bins = _num_bins(base_hz, search_max, m)
    wf_syms = m["total_syms"]
    wf_t_max = 0

    results: List[Ft8DecodeResult] = []
    seen = set()
    max_amp = 0.0
    # (time_sym, freq_bin) cells of already-subtracted signals: a co-channel
    # time-aligned weaker signal shares the Costas waveform, so subtraction
    # removes its sync energy too — it can never re-rank in top-k. Force LLR
    # re-extraction at these cells on every later pass.
    revisit: List[tuple] = []
    for _ in range(max(int(max_passes), 1)):
        wf = compute_waterfall(residual, fs, base_hz, spacing, sps, wf_syms,
                               num_bins, 0)
        cands = list(find_candidates(wf, costas, list(sync_pos),
                                     m["n_tones"], 0, wf_t_max, max_cand))
        have = {(c.time_sym, c.freq_bin) for c in cands}
        cands += [Candidate(time_sym=t, freq_bin=b, score=0.0)
                  for (t, b) in revisit if (t, b) not in have]
        if not cands:
            break
        ts = torch.as_tensor([c.time_sym for c in cands], device=wf.device)
        fb = torch.as_tensor([c.freq_bin for c in cands], device=wf.device)
        # every candidate of the pass in one BP launch: the pass's LLRs are
        # all taken before any subtraction, as in the JAX package
        llrs = _extract_llrs(wf, torch.zeros_like(ts), ts, fb, data_pos,
                             gray, m["bits_per_sym"])
        payloads = decode_soft_batch(llrs, max_iter, (None,),
                                     ft4=not ft8)[0]
        found_new = False
        for cand, payload in zip(cands, payloads):
            if payload is None or not np.any(payload):
                continue
            key = payload.tobytes()
            if key in seen:
                continue
            seen.add(key)
            tones = np.asarray(encode(payload, device=device), np.uint8)
            f_est, coh, amp = _subtract_frame_impl(
                residual, tones_full=_full_tone_sequence(tones, ft8),
                time_sym=cand.time_sym,
                f0=base_hz + cand.freq_bin * spacing,
                fs=fs, sps=sps, mod_batch=synth)
            if coh < 0.35 or amp < max_amp * 1e-3:
                # CRC-14 false positive on a residual. Incoherent fit =
                # white-noise residual; fit >60 dB below the strongest
                # subtracted signal = quantization/leakage junk (real FT8
                # bands span ~50 dB). The tiny fit stays subtracted; the
                # payload stays in `seen`.
                continue
            max_amp = max(max_amp, amp)
            found_new = True
            if (cand.time_sym, cand.freq_bin) not in revisit:
                revisit.append((cand.time_sym, cand.freq_bin))
            results.append(Ft8DecodeResult(message=unpack77(payload, ht),
                                           carrier_hz=f_est,
                                           snr_db=cand.score))
        if not found_new:
            break
    return results


def _full_tone_sequence(data_tones: np.ndarray, ft8: bool) -> np.ndarray:
    from ..modulate.ft8 import ft8_symbol_sequence, ft4_symbol_sequence
    seq = ft8_symbol_sequence if ft8 else ft4_symbol_sequence
    return np.asarray(seq(data_tones), np.uint8)


def _raw_cpfsk(ft8: bool):
    """Full-symbol-sequence CPFSK synth (tones incl. Costas, runtime
    frequency)."""
    from ..modulate.ft8 import (cpfsk_mod_batch, FT8_SAMPLES_PER_SYM,
                                FT4_SAMPLES_PER_SYM)
    sps = FT8_SAMPLES_PER_SYM if ft8 else FT4_SAMPLES_PER_SYM
    spacing = FT8_TONE_SPACING_HZ if ft8 else FT4_TONE_SPACING_HZ

    def synth(tones_2d, fs, base_hz):
        return cpfsk_mod_batch(tones_2d, sps, fs, base_hz, spacing)
    return synth


def ft8_decode_multi_signal(iq, fs: float = 12000.0, base_hz: float = 200.0,
                            max_hz: float = 3000.0, max_cand: int = 8,
                            max_passes: int = 3, hash_table=None,
                            max_iter: int = 30, *, device="cuda"
                            ) -> List[Ft8DecodeResult]:
    """Decode ALL FT8 signals in one receive window by iterative
    subtraction, on ``device``.

    Each pass: sync → decode every CRC-passing candidate → re-synthesize each
    decoded frame (CPFSK at the refined carrier), least-squares fit per-symbol
    complex amplitudes, subtract, and re-run sync on the residual so weaker
    signals hidden under strong ones become decodable (the WSJT-X multi-pass
    loop; the single-signal reference codec/ft8.rs:159-247 returns only the
    first decode). Stops early when a pass finds nothing new. Returns every
    distinct decode, strongest first.
    """
    return _decode_multi_signal(iq, fs, base_hz, max_hz, max_cand,
                                max_passes, True, hash_table, max_iter,
                                device)


def ft4_decode_multi_signal(iq, fs: float = 12000.0, base_hz: float = 200.0,
                            max_hz: float = 3000.0, max_cand: int = 8,
                            max_passes: int = 3, hash_table=None,
                            max_iter: int = 30, *, device="cuda"
                            ) -> List[Ft8DecodeResult]:
    """ft8_decode_multi_signal for FT4 windows (60 480-sample frames)."""
    return _decode_multi_signal(iq, fs, base_hz, max_hz, max_cand,
                                max_passes, False, hash_table, max_iter,
                                device)
