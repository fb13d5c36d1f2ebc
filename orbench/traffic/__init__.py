"""Traffic generators: ``make(config, params, seed, device)`` draws a
cell's inputs from the seed, turns them into IQ with the benchmark's plain
transmitter and returns the pool of batches the window cycles."""

from dataclasses import dataclass

import torch


@dataclass
class Batch:
    iq: torch.Tensor        # (items, samples) complex64 on the device
    samples: int            # received samples the batch carries
    truth: list             # what was sent, an item each


def generator(seed: int, device, salt: int) -> torch.Generator:
    """A torch generator on ``device`` for stream ``salt`` of ``seed``."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + salt) % (1 << 63))
