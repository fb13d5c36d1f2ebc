"""Receiver input hygiene (counterpart of
``orion_sdr_tpu/dsp/device.py::sanitize_iq``), host-to-device moves, and the
full-float32 guard of the port's products."""

from __future__ import annotations

import functools
import inspect
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


def pallas_placed(x, interpret) -> torch.Tensor:
    """A contiguous float32 tensor where one of the JAX package's
    ``*_pallas`` entry points runs: the CPU (the plain version) under
    ``interpret=True``, else by :func:`on_device`'s rule (a tensor stays on
    its device, host data goes to the card)."""
    return on_device(x, "cpu" if interpret else None,
                     torch.float32).contiguous()


# host dtypes the JAX package narrows (it runs with x64 off)
_NARROW = {np.dtype(np.float64): torch.float32,
           np.dtype(np.complex128): torch.complex64}


def takes_host_data(*names):
    """Decorator: the array parameters ``names`` of a torch function take
    host data (numpy, lists) as the JAX counterpart's do, by
    :func:`on_device`'s rule, and the function gains a keyword-only
    ``device=None``. A tensor argument stays where it is; host data goes to
    ``device``, else to the device of the first tensor among ``names``,
    else to the card. Host float64/complex128 arrays become float32/
    complex64, as the JAX package's ``jnp.asarray`` makes them. A call whose
    named arguments are all tensors (or not given) goes straight through,
    unbound, so a hot path that passes tensors pays one type test each."""
    def wrap(fn):
        sig = inspect.signature(fn)
        params = list(sig.parameters.values())
        positional = (inspect.Parameter.POSITIONAL_ONLY,
                      inspect.Parameter.POSITIONAL_OR_KEYWORD)
        slots = [(params.index(sig.parameters[n])
                  if sig.parameters[n].kind in positional else None, n)
                 for n in names]
        params.append(inspect.Parameter(
            "device", inspect.Parameter.KEYWORD_ONLY, default=None))

        def all_tensors(args, kwargs):
            for i, n in slots:
                x = args[i] if i is not None and i < len(args) else \
                    kwargs.get(n)
                if x is not None and not isinstance(x, torch.Tensor):
                    return False
            return True

        @functools.wraps(fn)
        def call(*args, device=None, **kwargs):
            if all_tensors(args, kwargs):
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            if device is None:
                device = next((x.device for x in map(bound.arguments.get,
                                                      names)
                               if isinstance(x, torch.Tensor)), None)
            for n in names:
                x = bound.arguments.get(n)
                if x is None or isinstance(x, torch.Tensor):
                    continue
                a = np.asarray(x)
                bound.arguments[n] = on_device(a, device,
                                               _NARROW.get(a.dtype))
            return fn(*bound.args, **bound.kwargs)
        call.__signature__ = sig.replace(parameters=params)
        return call
    return wrap


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
