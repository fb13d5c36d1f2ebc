"""WSPR beacon receiver (counterpart of ``orion_sdr_tpu/demodulate/
wspr.py``; wire format in codec/wspr.py): joint coarse time/frequency
search on the published sync chips, then per-symbol 4-tone energies →
sequential decode.

The search grid's tone energies come from one device program: the capture
splits into eighth-symbol blocks, every block's correlation with the 4
tones at every frequency offset is one complex64 matmul (TF32 off), the
window correlations are 8 shifted adds and every (dt, symbol) energy a
strided slice. The band decode's spectrogram is one batched FFT; its sync
scores, the medians and the stack decoder run on the host in numpy, on the
band's bins only, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..codec.wspr import (WSPR_FS, WSPR_SPS, WSPR_SYMBOLS, WSPR_SYNC,
                          WsprMessage, wspr_decode_symbols)
from ..dsp.device import full_f32, to_device
from ..dsp.osc import TAU


def _phasor_neg(c: float, f: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """e^{−j·(c·f)·t}, the products rounded in float32 in that order (the
    JAX package's ``exp(−1j·float32(2π/fs)·f·t)``)."""
    ph = -((c * f) * t)
    return torch.polar(torch.ones_like(ph), ph)


def _energy_grid(z: torch.Tensor, dts, dfs, fs: float,
                 base_hz: float) -> torch.Tensor:
    """(n,) complex64 capture → (F, D, 162, 4) float32 tone energies for
    every (df, dt). ``dts`` are eighth-symbol-aligned sample offsets;
    samples outside the capture read as zeros."""
    dev = z.device
    n = z.shape[-1]
    nb = WSPR_SPS // 8
    dts = tuple(int(d) for d in dts)
    if any(d % nb for d in dts):
        raise ValueError("dt offsets must be eighth-symbol aligned")
    need = WSPR_SYMBOLS * WSPR_SPS
    pad_front = max(0, -min(dts))
    total = max(max(dts) + pad_front + need, n + pad_front)
    total = -(-total // nb) * nb
    zp = torch.nn.functional.pad(z, (pad_front, total - n - pad_front))
    nq = total // nb
    q = zp.reshape(nq, nb)
    c = float(np.float32(TAU / fs))
    k = torch.arange(nb, dtype=torch.float32, device=dev)
    f_tone = (np.float32(base_hz) + torch.arange(4, dtype=torch.float32,
                                                 device=dev)
              * np.float32(fs / WSPR_SPS))                      # (4,)
    tones = _phasor_neg(c, f_tone[:, None], k[None, :])         # (4, nb)
    df = to_device(np.asarray(dfs, np.float32), dev)[:, None]   # (F, 1)
    w = _phasor_neg(c, df, k[None, :])                          # (F, nb)
    kern = (tones[None, :, :] * w[:, None, :]).reshape(-1, nb)  # (F·4, nb)
    with full_f32():
        C = (q @ kern.T).reshape(nq, -1, 4).transpose(0, 1)     # (F, nq, 4)
    # df wipe at block start (a constant phase per df drops in |.|)
    b_time = (torch.arange(nq, dtype=torch.float32, device=dev) * nb
              - float(pad_front))
    C = C * _phasor_neg(c, df, b_time[None, :])[..., None]
    # tone phase advance of block j within its window
    pj = _phasor_neg(c, f_tone[None, :],
                     torch.arange(8, dtype=torch.float32,
                                  device=dev)[:, None] * nb)    # (8, 4)
    M = nq - 7
    corr = 0
    for j in range(8):
        corr = corr + C[:, j: j + M, :] * pj[j][None, None, :]  # (F, M, 4)
    outs = []
    for dt in dts:
        m0 = (dt + pad_front) // nb
        sl = corr[:, m0: m0 + 8 * WSPR_SYMBOLS: 8, :]           # (F, 162, 4)
        outs.append((sl.abs() ** 2).to(torch.float32))
    return torch.stack(outs, dim=1)                             # (F, D, ...)


def wspr_demod(iq, fs: float = WSPR_FS, base_hz: float = 1500.0,
               dt_max: int = 2 * WSPR_SPS, df_max_hz: float = 1.6,
               device="cuda") -> Optional[WsprMessage]:
    """Capture → message | None. Searches start offsets up to ``dt_max``
    samples and CFO up to ±``df_max_hz`` (quarter-tone steps)."""
    z = to_device(iq, device, torch.complex64)
    if z.shape[0] < WSPR_SYMBOLS * WSPR_SPS:
        return None
    df_step = fs / WSPR_SPS / 4.0
    dfs = np.arange(-df_max_hz, df_max_hz + 1e-9, df_step).astype(np.float32)
    dts = np.arange(0, max(dt_max, 1), WSPR_SPS // 4).astype(np.int32)
    dts = dts[dts + WSPR_SYMBOLS * WSPR_SPS <= z.shape[0]]
    if dts.size == 0:
        dts = np.zeros(1, np.int32)
    eg = _energy_grid(z, tuple(int(d) for d in dts), dfs, float(fs),
                      float(base_hz)).cpu().numpy()
    # sync score: energy in the two sync-consistent tones minus the rest
    s = WSPR_SYNC.astype(np.int64)
    i162 = np.arange(WSPR_SYMBOLS)
    insync = eg[..., i162, s] + eg[..., i162, s + 2]
    total = eg.sum(axis=-1)
    score = (insync - (total - insync)).sum(axis=-1)
    fi, di = np.unravel_index(np.argmax(score), score.shape)
    return wspr_decode_symbols(eg[fi, di])


def _spectrogram(z: torch.Tensor, n_hops: int, hop: int) -> torch.Tensor:
    """Quarter-symbol-hopped symbol-length FFTs (bin spacing = the tone
    spacing): (n_hops, 8192) float32 powers. With a hop that divides the
    symbol, every window is ``sps // hop`` row slices of the hop-blocked
    capture."""
    r = WSPR_SPS // hop
    if r * hop == WSPR_SPS:
        nq = n_hops + r - 1
        zq = z[: nq * hop].reshape(nq, hop)
        segs = torch.cat([zq[j: j + n_hops] for j in range(r)], dim=-1)
    else:
        segs = z.unfold(0, WSPR_SPS, hop)[:n_hops]
    return (torch.fft.fft(segs, dim=-1).abs() ** 2).to(torch.float32)


def wspr_decode_band(iq, fs: float = WSPR_FS, base_hz: float = 1400.0,
                     width_hz: float = 200.0, max_decodes: int = 8,
                     min_score_sigma: float = 5.0,
                     device="cuda") -> List[WsprMessage]:
    """Decode every beacon in a band (the real WSPR band is 200 Hz wide):
    one spectrogram on ``device`` covers all (time, frequency) candidates,
    the known sync chips score each on the host, and the top distinct
    candidates decode through the stack decoder."""
    z = to_device(iq, device, torch.complex64)
    hop = WSPR_SPS // 4
    n_hops = (z.shape[0] - WSPR_SPS) // hop + 1
    if n_hops < 4 * WSPR_SYMBOLS:
        return []
    df = fs / WSPR_SPS
    b0 = int(round(base_hz / df))
    nb = int(round(width_hz / df))
    # only the band's bins (and the three tones above its last) cross to
    # the host: every score and energy below reads from them
    spec = _spectrogram(z, int(n_hops), hop)[:, b0: b0 + nb + 3]
    spec = spec.cpu().numpy()
    s = WSPR_SYNC.astype(np.int64)
    i4 = np.arange(WSPR_SYMBOLS) * 4
    n_t0 = n_hops - 4 * WSPR_SYMBOLS + 1
    # the whole (t0, b) sync-score grid in one vectorized gather: in-sync
    # tones are {s, s+2}, the other two {1−s, 3−s}
    trow = np.arange(n_t0)[:, None, None] + i4[None, None, :]  # (n_t0,1,162)
    bcol = np.arange(nb)[None, :, None]                        # (1,nb,1)
    insync = spec[trow, bcol + s[None, None, :]] \
        + spec[trow, bcol + s[None, None, :] + 2]
    other = spec[trow, bcol + (1 - s)[None, None, :]] \
        + spec[trow, bcol + (3 - s)[None, None, :]]
    scores = (insync - other).sum(axis=-1).astype(np.float32)
    mu = float(np.median(scores))
    sd = float(np.median(np.abs(scores - mu))) * 1.4826 + 1e-12
    out: List[WsprMessage] = []
    work = scores.copy()
    for _ in range(4 * max_decodes):
        t0, b = np.unravel_index(int(np.argmax(work)), work.shape)
        if (work[t0, b] - mu) / sd < min_score_sigma:
            break
        # suppress the whole peak plateau (a strong beacon spans many
        # adjacent time/frequency cells) whether or not it decodes
        work[max(t0 - 8, 0): t0 + 9, max(b - 4, 0): b + 5] = -np.inf
        rows = spec[t0 + i4]
        e = np.stack([rows[np.arange(WSPR_SYMBOLS), b + k]
                      for k in range(4)], axis=-1)
        m = wspr_decode_symbols(e)
        if m is not None:
            out.append(m)
        if len(out) >= max_decodes:
            break
    return out
