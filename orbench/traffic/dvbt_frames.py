"""DVB-T frame batches: ``frames`` aligned 68-symbol frames a batch, one
from each multiplex: distinct cell ids drawn from the seed, frame numbers
cycling 0-3, each frame the largest whole-packet payload it holds, in
random bytes. Flat AWGN over each frame at ``snr_db`` C/N: the noise in the
occupied band (1705 of the 2048 bins) against the frame's own mean power.
``pool`` batches, all drawn from the seed."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import dvbt
from . import Batch, generator


def make(cfg: dict, params: dict, seed: int, device) -> list:
    link = dvbt.Link.of(cfg)
    rng = np.random.default_rng(seed)
    ratio = 10.0 ** (-params["snr_db"] / 10.0) * dvbt.N_FFT \
        / cfg["link"]["active_carriers"]
    n = params["frames"]
    pool = []
    for b in range(params["pool"]):
        cells = rng.choice(256, n, replace=n > 256)
        frames = [(i % 4, int(cells[i]),
                   rng.integers(0, 256, link.payload_bytes).astype(np.uint8))
                  for i in range(n)]
        iq = dvbt.transmit(link, frames, device)
        power = (iq.abs() ** 2).mean(-1)
        noise = torch.randn(iq.shape, dtype=torch.complex64, device=device,
                            generator=generator(seed, device, b))
        iq += noise * torch.sqrt(power * ratio)[:, None].to(torch.complex64)
        truth = [("ok", fn, link.constellation, link.code_rate, link.guard,
                  cid, bytes(p)) for fn, cid, p in frames]
        pool.append(Batch(iq, int(iq.numel()), truth))
    return pool
