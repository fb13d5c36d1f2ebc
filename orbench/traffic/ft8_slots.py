"""FT8 slot batches: ``windows`` receive windows of ``window_samples`` at
12 kHz; ``signals`` of them, at places drawn from the seed, hold one
standard message frame at sample 0 on a carrier of the 6.25 Hz grid in
``carrier_hz`` (unit power), the rest noise only; AWGN at ``snr_db`` in
2500 Hz over every window. ``pool`` batches."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import ft8
from . import Batch, generator

_L = "ABCDEFGHIJKLMNOPRSTUVWXYZ"       # no Q: "Q…" calls unpack as "3X…"


def _call(rng) -> str:
    head = "".join(rng.choice(list(_L), int(rng.integers(1, 3))))
    tail = "".join(rng.choice(list(_L), int(rng.integers(1, 4))))
    return f"{head}{int(rng.integers(0, 10))}{tail}"


def _extra(rng) -> str:
    k = int(rng.integers(0, 5))
    if k == 0:
        return (f"{_L[int(rng.integers(0, 17))]}{_L[int(rng.integers(0, 17))]}"
                f"{int(rng.integers(0, 100)):02d}")
    if k == 1:
        return f"{int(rng.integers(-24, 25)):+03d}"
    if k == 2:
        return f"R{int(rng.integers(-24, 25)):+03d}"
    return ("RR73", "73")[k - 3]


def messages(rng, n: int) -> list:
    return [("CQ" if rng.random() < 0.5 else _call(rng), _call(rng),
             _extra(rng)) for _ in range(n)]


def make(cfg: dict, params: dict, seed: int, device) -> list:
    rng = np.random.default_rng(seed)
    W, S = params["windows"], params["signals"]
    n = params["window_samples"]
    lo, hi = params["carrier_hz"]
    power = cfg["fs_hz"] / (2500.0 * 10.0 ** (params["snr_db"] / 10.0))
    pool = []
    for b in range(params["pool"]):
        where = np.sort(rng.choice(W, S, replace=False))
        msgs = messages(rng, S)
        carriers = lo + rng.integers(0, int((hi - lo) / ft8.SPACING) + 1,
                                     S) * ft8.SPACING
        x = torch.zeros((W, n), dtype=torch.complex64, device=device)
        seqs = torch.as_tensor(np.stack([ft8.tones(ft8.pack77(*m))
                                         for m in msgs]), device=device)
        for j in range(0, S, 64):
            frames = ft8.modulate(seqs[j:j + 64], torch.as_tensor(
                carriers[j:j + 64], device=device))
            x[torch.as_tensor(where[j:j + 64], device=device),
              :frames.shape[1]] = frames
        x += torch.randn(x.shape, dtype=torch.complex64, device=device,
                         generator=generator(seed, device, b)) \
            * float(np.sqrt(power))
        truth = [None] * W
        for w, m, c in zip(where, msgs, carriers):
            truth[w] = (" ".join(s for s in m if s), float(c))
        pool.append(Batch(x, W * n, truth))
    return pool
