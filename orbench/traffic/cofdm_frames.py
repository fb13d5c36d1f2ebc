"""COFDM frame batches: ``frames`` aligned frame bodies a batch, each with
``payload_bytes`` random bytes, a random sequence number, flags and
scrambler seed, its MCS taken in turn from ``mcs``; flat AWGN over each
row at ``noise_ratio`` times the frame's own mean signal power (or at
``snr_db`` per sample). ``pool`` batches, all drawn from the seed."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import cofdm
from . import Batch, generator


def make(cfg: dict, params: dict, seed: int, device) -> list:
    link = cofdm.Link.of(cfg)
    rng = np.random.default_rng(seed)
    ratio = params.get("noise_ratio")
    if ratio is None:
        ratio = 10.0 ** (-params["snr_db"] / 10.0)
    mcs = params["mcs"]
    pool = []
    for b in range(params["pool"]):
        frames = []
        for i in range(params["frames"]):
            frames.append((int(rng.integers(0, 2 ** 32)), mcs[i % len(mcs)],
                           int(rng.integers(0, 256)),
                           rng.integers(0, 256, params["payload_bytes"]
                                        ).astype(np.uint8),
                           int(rng.integers(0, 2 ** 32))))
        bodies = cofdm.transmit(link, frames, device)
        T = max(x.shape[0] for x in bodies)
        iq = torch.zeros((len(frames), T), dtype=torch.complex64,
                         device=device)
        for i, x in enumerate(bodies):
            iq[i, :x.shape[0]] = x
        power = torch.stack([(x.abs() ** 2).mean() for x in bodies])
        noise = torch.randn(iq.shape, dtype=torch.complex64, device=device,
                            generator=generator(seed, device, b))
        iq += noise * torch.sqrt(power * ratio)[:, None].to(torch.complex64)
        truth = [("ok", s, m, fl, bytes(p)) for s, m, fl, p, _ in frames]
        pool.append(Batch(iq, sum(x.shape[0] for x in bodies), truth))
    return pool
