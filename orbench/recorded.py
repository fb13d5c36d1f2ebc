"""The program's own span records (``orion_sdr_tpu_torch.obs``) of a run's
profiled window: the port records a root span a receive call while a
profiler session runs, and only the harness's profiled window runs one.
Readers of ``program_span`` and ``program_counter`` metrics take their
numbers a batch from here; a program without the recorder reads None."""

from __future__ import annotations

COFDM = "orion.frame.decode_batch"
FT8 = "orion.ft8.decode_windows"


def roots(run, name=None):
    """The roots of the last profiled session, one a profiled batch, or
    None: no profiled window, no recorder in the program, another number
    of roots than of batches, or (with ``name``) roots of another call."""
    p = run.profile
    if p is None or not p.batches:
        return None
    try:
        from orion_sdr_tpu_torch import obs
    except ImportError:
        return None
    kept = obs.roots()
    if not kept:
        return None
    got = [r for r in kept if r.session == kept[-1].session]
    if len(got) != p.batches:
        return None
    if name is not None and any(r.name != name for r in got):
        return None
    return got


def mean(run, value, name=None):
    """The mean a batch of ``value(root)``, or None as :func:`roots`."""
    got = roots(run, name)
    if got is None:
        return None
    return sum(value(r) for r in got) / len(got)
