"""Spans and counters inside the receive paths, recorded only while a
``torch.profiler`` session runs.

A receive call opens a root span (:func:`root`, or the :func:`rooted`
decorator); the stages inside it open :func:`span`s and add to
:func:`count`ers. While the profiler is on (``_profiler_enabled()``, the
same test ``record_function`` makes), each span enters
``torch.profiler.record_function(name)``, so it shows by name in the
trace's timeline, and notes its start and end with ``time.time_ns()``,
the Unix-epoch clock of the trace's ``trace_start_ns``. With the profiler
off a root is one check, a span or a counter one branch, and nothing is
recorded: the sites wrap whole loops, never the body of a per-frame or
per-window loop.

Each finished root leaves a :class:`Root` record: its duration, its
direct children's summed times and counts, every span under it by name,
its counters, and the launches each hand-written kernel counted across it
(the difference of the ``ops/`` wrappers' ``.launches`` attributes). The
last :data:`KEEP` roots are kept (:func:`roots`); ``util.trace(...)``'s
``.spans`` are the roots of its block. Roots recorded in one run of
profiled calls, with no unprofiled receive call between them, share a
``session`` number.

:func:`to_host` is the main path's blocking read of a tensor to the host:
inside a root it is the span ``orion.d2h`` with the counters ``d2h.reads``
and ``d2h.bytes`` (on a CPU tensor the same read, with no copy);
:func:`count_h2d` counts the host input a receive call puts on the card.
"""

from __future__ import annotations

import functools
import sys
import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field

import torch

# roots kept; older ones are dropped
KEEP = 4096

_profiling = torch._C._autograd._profiler_enabled
_now = time.time_ns

# every launch counter of the hand-written kernels' wrappers:
# ops module → its counters, "<function>.<attribute>"
LAUNCH_COUNTERS = {
    "dd_pll": ("dd_pll.launches",),
    "gardner": ("gardner.launches",),
    "gnss_track": ("gnss_track.launches",),
    "ldpc_bp": ("bp_decode_kernel.launches",
                "bp_decode_kernel.launches_edge"),
    "onepole_two_rate": ("onepole_two_rate.launches",),
    "outer_fec": ("bch_decode_kernel.launches", "rs_decode_kernel.launches"),
    "psk31_pll": ("psk31_pll.launches",),
    "psk31_viterbi": ("psk31_viterbi.launches",),
    "viterbi": ("viterbi_chunks_kernel.launches",
                "viterbi_chunks_kernel.launches_radix4",
                "viterbi_decode_soft_kernel.launches",
                "viterbi_decode_soft_kernel.launches_radix4"),
}


@dataclass
class Root:
    """One receive call's record; times in ns on ``time.time_ns()``'s
    clock. ``children``: the direct children, name → [ns, calls];
    ``spans``: every span under the root, name → [ns, calls];
    ``launches``: kernel launches across the root, by counter, where
    non-zero."""
    name: str
    session: int
    start_ns: int = 0
    end_ns: int = 0
    children: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    launches: dict = field(default_factory=dict)

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def self_ns(self) -> int:
        """The root's time outside its direct children."""
        return self.duration_ns - sum(v[0] for v in self.children.values())

    def ms(self, name: str) -> float:
        """Summed time of the spans called ``name`` under the root, in
        ms (0 where there is none)."""
        return self.spans.get(name, (0,))[0] / 1e6


_stack: list = []            # open spans, the root first
_roots: deque = deque(maxlen=KEEP)
_recorded = 0                # roots ever recorded
_session = 0
_idle = True                 # a root found the profiler off since the last


def _launch_counts() -> dict:
    out = {}
    for mod, names in LAUNCH_COUNTERS.items():
        m = sys.modules.get(f"{__package__}.ops.{mod}")
        if m is None:
            continue
        for n in names:
            fn, attr = n.split(".")
            out[n] = getattr(getattr(m, fn), attr)
    return out


_NOOP = nullcontext()


class _Span:
    __slots__ = ("name", "rec", "start", "rf", "launch0")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        global _session, _idle
        if _stack:
            self.rec = _stack[0].rec
        else:
            if _idle:
                _session += 1
                _idle = False
            self.rec = Root(self.name, _session)
            self.launch0 = _launch_counts()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        _stack.append(self)
        self.start = _now()
        return self

    def __exit__(self, *exc):
        global _recorded
        end = _now()
        _stack.pop()
        ns = end - self.start
        rec = self.rec
        if _stack:
            s = rec.spans.setdefault(self.name, [0, 0])
            s[0] += ns
            s[1] += 1
            if len(_stack) == 1:
                c = rec.children.setdefault(self.name, [0, 0])
                c[0] += ns
                c[1] += 1
        else:
            rec.start_ns, rec.end_ns = self.start, end
            now = _launch_counts()
            rec.launches = {k: v - self.launch0.get(k, 0)
                            for k, v in now.items()
                            if v != self.launch0.get(k, 0)}
            _roots.append(rec)
            _recorded += 1
        self.rf.__exit__(*exc)
        return False


def root(name: str):
    """A receive call's span: recorded while the profiler is on; inside
    another root, a span of it."""
    global _idle
    if _stack:
        return _Span(name)
    if not _profiling():
        _idle = True
        return _NOOP
    return _Span(name)


def rooted(name: str):
    """Decorator: each call of the function is a :func:`root` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with root(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def span(name: str):
    """A stage of the open root (a no-op outside one)."""
    return _Span(name) if _stack else _NOOP


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the open root's counter ``name`` (a no-op outside
    one)."""
    if _stack:
        c = _stack[0].rec.counters
        c[name] = c.get(name, 0) + n


def recording() -> bool:
    """Whether a root is open: guards a counter whose value costs work."""
    return bool(_stack)


def to_host(t: torch.Tensor):
    """``t.cpu().numpy()``, the main path's blocking read of a tensor;
    inside a root, the span ``orion.d2h`` and the counters ``d2h.reads``
    and ``d2h.bytes``."""
    if not _stack:
        return t.cpu().numpy()
    with _Span("orion.d2h"):
        out = t.cpu().numpy()
    count("d2h.reads")
    count("d2h.bytes", t.numel() * t.element_size())
    return out


def count_h2d(src, x: torch.Tensor) -> None:
    """Inside a root, adds ``x``'s bytes to ``h2d.bytes`` where ``x`` is
    host input ``src`` put on a device."""
    if _stack and x.device.type != "cpu" and not (
            isinstance(src, torch.Tensor) and src.device.type != "cpu"):
        count("h2d.bytes", x.numel() * x.element_size())


def roots() -> list:
    """The kept root records, oldest first."""
    return list(_roots)


def recorded() -> int:
    """How many roots were ever recorded (a mark for :func:`since`)."""
    return _recorded


def since(mark: int) -> list:
    """The kept roots recorded after :func:`recorded` read ``mark``."""
    n = min(_recorded - mark, len(_roots))
    return list(_roots)[len(_roots) - n:] if n > 0 else []
