"""Checks: ``reference(config, params, batch, device, control=False)`` runs
the plain reference on a pool batch (``control``: in the precision below
the configuration's, the control that has to fail); ``compare(config,
params, observed, refs, finals)`` gives each compared number (observed:
the program's layers on the last pass over each pool slot; finals: every
batch of the window's results with its slot); ``failed(truth, final)``
counts the items that did not come back as sent."""

import torch


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (real and imaginary parts apart), kept in
    its own dtype."""
    if x.is_complex():
        return torch.complex(bf16(x.real), bf16(x.imag))
    if not x.is_floating_point():
        return x
    return x.to(torch.bfloat16).to(x.dtype)


def gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """max |p − r| over the RMS of r; inf where the shapes differ."""
    if p is None or r is None or p.shape != r.shape:
        return float("inf")
    p, r = p.to(torch.float64), r.to(p.device, torch.float64)
    rms = float(torch.sqrt(torch.mean(r * r)))
    return float((p - r).abs().max()) / max(rms, 1e-30) if p.numel() else 0.0
