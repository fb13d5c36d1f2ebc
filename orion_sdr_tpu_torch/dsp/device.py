"""Receiver input hygiene (counterpart of
``orion_sdr_tpu/dsp/device.py::sanitize_iq``), host-to-device moves, and the
full-float32 guard of the port's products."""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch


def sanitize_iq(iq, device=None) -> torch.Tensor:
    """Blank non-finite samples to 0 (a NaN burst would otherwise poison the
    cumulative-sum sync metrics for the whole buffer and can steer FEC onto
    the trivial all-zero codeword). Host data goes to ``device`` (None: the
    card)."""
    z = on_device(iq, device, torch.complex64)
    bad = ~torch.isfinite(z.real) | ~torch.isfinite(z.imag)
    return torch.where(bad, torch.zeros_like(z), z)


def to_device(x, device, dtype=None) -> torch.Tensor:
    """Host data (numpy, lists) or a tensor → a tensor on ``device``, of
    ``dtype`` when one is given."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        x = torch.as_tensor(a if a.flags.writeable else a.copy())
    return x.to(device=device, dtype=dtype) if dtype is not None else \
        x.to(device)


def on_device(x, device=None, dtype=None) -> torch.Tensor:
    """:func:`to_device` where ``device`` None keeps a tensor on its own
    device and sends host data to the card ("cuda")."""
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cuda"
    return to_device(x, device, dtype)


@contextmanager
def full_f32():
    """Float32 matmuls and convolutions at full float32 precision inside
    the block, as the JAX package's ``Precision.HIGHEST``: TF32 off for
    cuBLAS and cuDNN whatever the caller set, and restored on exit. With
    TF32 the operands would carry 10-bit mantissas, far outside the
    filters' and matched filters' stated tolerances."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
