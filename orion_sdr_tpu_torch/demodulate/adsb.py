"""ADS-B 1090ES receiver (counterpart of ``orion_sdr_tpu/demodulate/
adsb.py``): envelope → preamble matched filter → candidate starts →
per-chip sums → PPM bit decisions → CRC-gated DF17 decode → CPR pairing.

The envelope, the preamble correlation and the per-chip sums of every
candidate run on ``device``; the peak picking, the candidate cap, the
bit/CRC layer and the duplicate rule run on the host, as in the reference.
The CRC-24 is the detector: the correlation only ranks candidates, so the
threshold sits low without false decodes."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..codec.adsb import AdsbMessage, adsb_decode_frame, adsb_pair_positions
from ..dsp.device import to_device
from ..dsp.fir import conv1d_f32
from ..modulate.adsb import ADSB_CHIP_RATE, FRAME_CHIPS, PREAMBLE_CHIPS


def _envelope_and_score(z: torch.Tensor, m: int):
    """|iq| and the preamble correlation score at every sample, normalised
    by the local energy over the same window (so strong frames do not mask
    weak ones): two valid-mode correlations of the zero-padded envelope."""
    env = torch.sqrt(z.real * z.real + z.imag * z.imag).to(torch.float32)
    tpl = np.repeat(PREAMBLE_CHIPS, m)
    tpl = (tpl / np.sqrt(np.sum(tpl * tpl))).astype(np.float32)
    T = len(tpl)
    envp = torch.nn.functional.pad(env, (0, T - 1))[None]
    corr = conv1d_f32(envp, torch.as_tensor(tpl, device=z.device)
                      .reshape(1, 1, T))[0, 0]
    energy = conv1d_f32(envp * envp, torch.ones(
        (1, 1, T), dtype=torch.float32, device=z.device))[0, 0]
    score = corr / torch.sqrt(torch.clamp(energy, min=1e-12))
    return env, score


def _chip_sums(env: torch.Tensor, starts: np.ndarray, m: int):
    """(k,) candidate starts → (k, FRAME_CHIPS) per-chip sums, one gather."""
    offs = torch.arange(FRAME_CHIPS * m, device=env.device)
    idx = torch.as_tensor(starts, device=env.device)[:, None] + offs[None, :]
    idx = torch.clamp(idx, 0, env.shape[-1] - 1)
    return env[idx].reshape(len(starts), FRAME_CHIPS, m).sum(dim=-1)


def adsb_decode_capture(iq, fs: float, max_candidates: int = 256,
                        score_threshold: float = 0.55,
                        device="cuda") -> List[AdsbMessage]:
    """Complex capture → every CRC-valid DF17 message, CPR pairs resolved.

    ``score_threshold`` is the normalised preamble correlation (1.0 = a
    perfect isolated preamble); the default passes weak or overlapped
    frames and lets the CRC adjudicate."""
    z = to_device(iq, device, torch.complex64)
    if z.dim() != 1:
        raise ValueError("adsb_decode_capture takes a 1-D capture")
    m = fs / ADSB_CHIP_RATE
    if abs(m - round(m)) > 1e-9 or round(m) < 1:
        raise ValueError(f"fs must be an integer multiple of 2 MHz, got {fs}")
    m = int(round(m))
    if z.shape[0] < FRAME_CHIPS * m:
        return []
    env, score = _envelope_and_score(z, m)
    # local maxima of the score above threshold, at most one per half-chip
    valid_to = score.shape[0] - FRAME_CHIPS * m + 1
    s = score[:max(valid_to, 0)].cpu().numpy()
    if s.size == 0:
        return []
    left = np.concatenate([[-np.inf], s[:-1]])
    right = np.concatenate([s[1:], [-np.inf]])
    cand = np.flatnonzero((s >= left) & (s > right) & (s > score_threshold))
    if cand.size == 0:
        return []
    if cand.size > max_candidates:
        cand = cand[np.argsort(s[cand])[::-1][:max_candidates]]
        cand = np.sort(cand)
    sums = _chip_sums(env, cand, m).cpu().numpy()
    data = sums[:, 16:].reshape(len(cand), 112, 2)
    bits = (data[:, :, 0] > data[:, :, 1]).astype(np.uint8)
    out: List[AdsbMessage] = []
    last_pos: dict = {}
    for row, pos in zip(bits, cand):
        msg = adsb_decode_frame(row)
        if msg is None:
            continue
        # identical bits within one frame duration = the same transmission
        # at adjacent correlation peaks; farther apart = a genuine repeat
        key = row.tobytes()
        if key in last_pos and int(pos) - last_pos[key] < FRAME_CHIPS * m:
            continue
        last_pos[key] = int(pos)
        out.append(msg)
    adsb_pair_positions(out)
    return out
