"""Memory safety and run-to-run determinism of the port's hand-written
kernels: one case table over the branches each launching C entry of
``orion_sdr_tpu_torch/csrc/*.cu`` selects, and the checks every case runs.

Numpy, torch and the port only (no JAX): the card file
``tests/test_torch_kernel_safety_gpu.py`` and ``chip_smoke.py`` [55] run it
on the card, ``tests/test_torch_kernel_safety.py`` holds the table to the
sources and the checks to deliberately faulty stand-ins on the CPU.

Each case lays every input and output of one launch into a byte buffer of
its own (:class:`Slot`), with ``BAND`` bytes before and after it; a skew
moves the view off its 16-byte alignment where a branch depends on it. The
launch goes through the wrapper's own ``_launch_into`` (the half of each
wrapper that launches on buffers it is given, after the other half has
allocated them) with views into those buffers. :func:`run_case` then holds
the kernel to:

- **bands**: the bands around each output, filled with a sentinel before
  the launches, are unchanged after them, and every output element equals
  the plain version's on the same inputs (the output itself is filled with
  a sentinel first, so an element the kernel never writes shows);
- **halos**: the bytes around each input are filled three ways (two seeded
  random fills, then NaN/±inf for float inputs, a third random fill for
  the rest): the three launches give bit-identical outputs;
- **inputs**: every input buffer, halo included, is byte-equal before and
  after each launch;
- **determinism**: ``REPS`` repeat launches give bit-identical outputs
  alone, beside a second stream that keeps the SMs busy with float32
  products (so the blocks land in another order), with the rows permuted
  where rows are independent (the outputs permuted back), and at every
  launch shape the entry accepts that must not change the result (BP's
  persistent grid, the outer decoders' lanes and codewords a block).

:class:`Watch` keeps exact copies of live tensors and says at which step
and where their bytes first changed: chip_smoke [31]'s AGC sequence
(:func:`agc_sequence`) runs under it.
"""

from __future__ import annotations

import hashlib
import importlib.util
import math
import os
import time
import zlib
from dataclasses import dataclass, field, replace
from typing import Callable

import numpy as np
import torch

from orion_sdr_tpu_torch.codec import ft8_ldpc
from orion_sdr_tpu_torch.constellation import constellation_points
from orion_sdr_tpu_torch.demodulate.psk31 import pll_constants
from orion_sdr_tpu_torch.fec import bch_device
from orion_sdr_tpu_torch.fec.conv import _tables as conv_tables
from orion_sdr_tpu_torch.fec.galois import ReedSolomon
from orion_sdr_tpu_torch.fec.ldpc import LDPC_CODES, LdpcGraph, \
    _build_msg_col_rows, ldpc_graph
from orion_sdr_tpu_torch.frame.chain import shortened_bch_for
from orion_sdr_tpu_torch.gnss import _ca_pm_sampled, gps_ca_mod
from orion_sdr_tpu_torch.ops import dd_pll, gardner, gnss_track, ldpc_bp, \
    onepole_two_rate, outer_fec, psk31_pll, psk31_viterbi, viterbi

HERE = os.path.dirname(os.path.abspath(__file__))
BAND = 4096            # guard bytes before and after every buffer
REPS = 20              # repeat launches a determinism check
BUSY_PRODUCTS = 12     # 4096 x 4096 float32 products on the busy stream
SENTINELS = ((0xA7, 0x5C, 0xE3, 0x1F), (0x3D, 0xB2, 0x68, 0xC1))
BP_MAX_ITER = 20
TRACK_FS = 2.048e6     # 2048 samples a code epoch


# ── buffers ──────────────────────────────────────────────────────────────────

def pattern(n: int, pat, device) -> torch.Tensor:
    """``n`` bytes of the repeating byte pattern ``pat`` on ``device``."""
    base = torch.tensor(pat, dtype=torch.uint8, device=device)
    return base.repeat(-(-n // len(pat)))[:n]


def _item(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


class Slot:
    """A (shape, dtype) tensor inside a byte buffer: ``BAND`` + ``skew``
    bytes before it and ``BAND`` after. ``view`` is the tensor, ``raw`` the
    whole buffer; ``lo:hi`` the tensor's bytes in it."""

    def __init__(self, shape, dtype, device, skew: int = 0):
        item = _item(dtype)
        if skew % item:
            raise ValueError(f"a skew of {skew} bytes splits a {dtype}")
        self.shape, self.dtype = tuple(shape), dtype
        self.nbytes = math.prod(self.shape) * item
        self.lo = BAND + skew
        self.hi = self.lo + self.nbytes
        self.raw = torch.empty(self.hi + BAND, dtype=torch.uint8,
                               device=device)
        self.view = self.raw[self.lo:self.hi].view(dtype).view(self.shape)

    def bytes(self) -> torch.Tensor:
        return self.raw[self.lo:self.hi]

    def bands(self) -> torch.Tensor:
        return torch.cat([self.raw[:self.lo], self.raw[self.hi:]])


def fill_halo(slot: Slot, data: torch.Tensor, how: str, seed: int) -> None:
    """The whole buffer by ``how`` ("random" bytes from ``seed``, or
    "nonfinite": NaN, +inf, -inf as float32 words), then ``data`` in the
    tensor's place."""
    n = slot.raw.numel()
    if how == "nonfinite":
        words = np.resize(np.array([np.nan, np.inf, -np.inf], np.float32),
                          n // 4 + 1).view(np.uint8)[:n]
    else:
        words = np.random.default_rng(seed).integers(0, 256, n, np.uint8)
    slot.raw.copy_(torch.as_tensor(words))
    slot.view.copy_(data)


def fingerprint(t: torch.Tensor) -> str:
    """The first 16 hex digits of the SHA-256 of ``t``'s bytes."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(b.tobytes()).hexdigest()[:16]


def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8))


# ── the case table ───────────────────────────────────────────────────────────

@dataclass(frozen=True)
class Case:
    kernel: str          # a key of SETUPS
    p: tuple             # the case's parameters, (name, value) pairs
    smoke: bool = False  # one of chip_smoke [55]'s smallest cases
    main: bool = False   # at a main path's shape (the card file only)

    @property
    def params(self) -> dict:
        return dict(self.p)

    @property
    def label(self) -> str:
        return self.kernel + ":" + ",".join(f"{k}={v}" for k, v in self.p)


def case(kernel, smoke=False, main=False, **p) -> Case:
    return Case(kernel, tuple(p.items()), smoke, main)


@dataclass
class Setup:
    """One case laid out for launching: ``ins`` name → (tensor, skew bytes,
    row axis or None); ``outs`` name → (shape, dtype, kind, row axis or
    None), kind "out" (held to the plain version), "aux" (held to its
    model), "scratch" (the kernel's own: bands and determinism only) or
    "acc" (a zeroed accumulator); ``launch(ins, outs, shape)`` launches
    on the views at one of ``shapes`` (keyword overrides of the wrapper's
    launch shape, ``{}`` first: the wrapper's own); ``plain(ins)`` gives the plain version's "out"
    and "aux" tensors; ``same(got, want)`` holds them (exact unless the
    kernel states a tolerance)."""
    name: str
    entry: str
    ins: dict
    outs: dict
    launch: Callable
    plain: Callable
    branches: frozenset
    shapes: list = field(default_factory=lambda: [{}])
    same: Callable | None = None
    held: Callable | None = None    # (ins, got) → bool, in place of plain


def _exact(got: dict, want: dict) -> bool:
    return all(torch.equal(got[k], want[k]) for k in want)


def _rng(c: Case) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(c.label.encode()))


# BP (kernels 1 and 2): every pick(rule, D) width, both loads ──────────────

_GRAPHS: dict = {}


def _staircase_graph(n: int, k: int) -> LdpcGraph:
    """A (n, k) graph: message columns from the port's column builder, a
    dual-diagonal parity part (FT8's (174, 91) size gives D = 6)."""
    m = n - k
    rows = [[] for _ in range(m)]
    for c, rs in enumerate(_build_msg_col_rows(k, m, 0x1234_5678)):
        for r in rs:
            rows[r].append(c)
    for i in range(m):
        rows[i] += [k + i] + ([k + i - 1] if i else [])
    return _graph_of(f"staircase_{n}_{k}", n, k, rows)


def _random_graph(D: int) -> LdpcGraph:
    """96 bits, 40 checks of D and D − 1 bits (padded slots): the kernel's
    generic widths (D ≤ 8, ≤ 16, ≤ 32 without an exact instantiation)."""
    rng = np.random.default_rng(D)
    n, m = 96, 40
    rows = [sorted(rng.choice(n, D - (i % 2), replace=False).tolist())
            for i in range(m)]
    return _graph_of(f"random_d{D}", n, n - m, rows)


def _graph_of(name, n, k, rows) -> LdpcGraph:
    m = len(rows)
    D = max(len(r) for r in rows)
    cb = np.full((m, D), n, np.int32)
    mask = np.zeros((m, D), bool)
    for i, r in enumerate(rows):
        cb[i, :len(r)] = r
        mask[i, :len(r)] = True
    return LdpcGraph(name, n, k, m, np.zeros((m, k), np.uint8), cb, mask, D)


def bp_graph(name: str) -> LdpcGraph:
    if name not in _GRAPHS:
        if name in LDPC_CODES:
            g = ldpc_graph(name)
        elif name == "ft8":
            g = ft8_ldpc.ft8_ldpc_graph()
        elif name == "staircase174":
            g = _staircase_graph(174, 91)
        else:
            g = _random_graph(int(name[len("random"):]))
        _GRAPHS[name] = g
    return _GRAPHS[name]


_EXACT_WIDTHS = (5, 6, 7, 8, 11)


def bp_width(D: int):
    """The kernel instantiation ``pick`` takes for check degree D."""
    if D in _EXACT_WIDTHS:
        return D, True
    return (8 if D <= 8 else 16 if D <= 16 else 32), False


def bp_llrs(g: LdpcGraph, B: int, rng) -> np.ndarray:
    """The all-zero codeword (a codeword of every graph) at ±4 with three
    flips a row, every third row random-normal garbage."""
    llr = np.full((B, g.n), 4.0, np.float32)
    for b in range(B):
        if b % 3 == 2:
            llr[b] = rng.standard_normal(g.n)
        else:
            llr[b, rng.choice(g.n, 3, replace=False)] *= -1
    return llr


def bp_grids(B: int, resident: int) -> list:
    """The persistent grids a BP case launches, the wrapper's first: the
    resident blocks (at most B), a few, one."""
    return sorted({min(B, resident), min(3, B), 1}, reverse=True)


def setup_bp(c: Case, dev) -> Setup:
    p = c.params
    g, rule, B = bp_graph(p["graph"]), p["rule"], p["B"]
    t = ldpc_bp.graph_tables(g, dev)
    code = ldpc_bp._RULE_CODE[rule]
    llr = torch.as_tensor(bp_llrs(g, B, _rng(c)), device=dev)
    bulk = g.n % 4 == 0 and p["skew"] % 16 == 0
    if dev.type == "cuda":
        plan = ldpc_bp._resident(t, code, dev)
        grids = bp_grids(B, plan["blocks_per_sm"] * plan["sms"])
    else:
        grids = [B]

    def launch(i, o, shape):
        ldpc_bp._launch_into(
            replace(t, check_slots=i["check_slots"],
                    bit_slots=i["bit_slots"]),
            i["llr"], BP_MAX_ITER, rule, 0.75, o["bits"], o["unsat"],
            **shape)

    def plain(i):
        bits, unsat = ldpc_bp.bp_decode_reference(g, i["llr"], BP_MAX_ITER,
                                                  rule, 0.75)
        return {"bits": bits, "unsat": unsat}
    name = "ldpc_bp_decode" + ("_sum_product_edge"
                               if rule == "sum_product_edge" else "")
    return Setup(
        name, "ldpc_bp_decode",
        {"llr": (llr, p["skew"], 0), "check_slots": (t.check_slots, 0, None),
         "bit_slots": (t.bit_slots, 0, None)},
        {"bits": ((B, g.k), torch.uint8, "out", 0),
         "unsat": ((B,), torch.int32, "out", 0)},
        launch, plain,
        frozenset({("rule", code), ("width",) + bp_width(g.max_deg),
                   ("load", "bulk" if bulk else "word")}),
        [{}] + [{"grid": v} for v in grids[1:]])


# Viterbi (kernels 3 and 4): both radices, chunked and terminated, the
# decisions in shared memory or in the global scratch ──────────────────────

def setup_viterbi(c: Case, dev) -> Setup:
    p = c.params
    code, radix, L, T = p["code"], p["radix"], p["L"], p["T"]
    _, S, *_ = conv_tables(code)
    rng = _rng(c)
    chunked = p["mode"] == "chunked"
    llr = (rng.standard_normal((L, 2 * T)) * 2.0).astype(np.float32)
    ins = {}
    if chunked:
        ins["c0"] = (torch.as_tensor(llr[:, :T].copy(), device=dev), 0, 0)
        ins["c1"] = (torch.as_tensor(llr[:, T:].copy(), device=dev),
                     p["skew"], 0)
        pm0 = (rng.standard_normal((L, S)) * 3.0).astype(np.float32)
        pm0[::2, 1:] = -1e30               # chunk-0 rows: state 0 pinned
        ins["pm0"] = (torch.as_tensor(pm0, device=dev), 0, 0)
    else:
        ins["full"] = (torch.as_tensor(llr, device=dev), p["skew"], 0)
    if radix == 4:
        index, spec = viterbi.radix4_sum_table(code)
        ins["r4_index"] = (torch.as_tensor(index, device=dev), 0, None)
        ins["r4_spec"] = (torch.as_tensor(spec, device=dev), 0, None)
    global_scratch = T > viterbi.MAX_SMEM_STEPS
    outs = {"bits": ((L, T), torch.uint8, "out", 0)}
    if global_scratch:
        outs["scratch"] = ((L, -(-T // 32) * 256), torch.uint8, "scratch",
                           None)

    def launch(i, o, shape):
        l0, l1, pm = ((i["c0"], i["c1"], i["pm0"]) if chunked else
                      (i["full"][:, 0::2], i["full"][:, 1::2], None))
        viterbi._launch_into(
            l0, l1, pm, code, radix,
            (i["r4_index"], i["r4_spec"]) if radix == 4 else None,
            o["bits"], o.get("scratch"))

    def plain(i):
        loop = viterbi._acs_traceback4 if radix == 4 else \
            viterbi._acs_traceback
        if chunked:
            return {"bits": loop(i["c0"], i["c1"], i["pm0"], code, True)}
        pm = torch.full((i["full"].shape[0], S), -1e30, dtype=torch.float32,
                        device=i["full"].device)
        pm[:, 0] = 0.0
        return {"bits": loop(i["full"][:, 0::2], i["full"][:, 1::2], pm,
                             code, False)}
    return Setup(
        "viterbi_acs_traceback" + ("_radix4" if radix == 4 else ""),
        "viterbi_acs_traceback", ins, outs, launch, plain,
        frozenset({("radix", radix), ("mode", p["mode"]),
                   ("decisions", "global" if global_scratch
                    else "shared")}))


# F and G: the outer decoders, every t at 16 and 32 lanes ─────────────────

def _outer_shapes(kind: str, B: int, dev):
    """The wrapper's own launch ({}: its plan), then each lane width at the
    fewest and the most codewords a block it takes; and the lane widths
    these launch at."""
    if dev.type == "cuda":
        plan = outer_fec.launch_plan(kind, B, dev)
        first = (plan["lanes"], plan["groups_per_block"])
    else:
        first = (outer_fec.LANES[kind], 32 // outer_fec.LANES[kind])
    out = [first]
    for lanes, groups in ((16, 2), (16, 16), (32, 1), (32, 8)):
        if (lanes, groups) not in out:
            out.append((lanes, groups))
    return ([{}] + [{"lanes": lv, "groups": gv} for lv, gv in out[1:]],
            {lv for lv, _ in out})


def setup_bch(c: Case, dev) -> Setup:
    p = c.params
    t, B = p["t"], p["B"]
    code = shortened_bch_for(t)
    rng = _rng(c)
    words = code.encode(rng.integers(0, 2, (B, code.k)).astype(np.uint8))
    for i in range(B):
        ne = i % (t + 4)
        if ne:
            words[i, rng.choice(code.n, ne, replace=False)] ^= 1
    ins = {"in": (torch.as_tensor(words, device=dev), p["skew"], 0),
           "tables": (outer_fec._gf_tables(dev), 0, None),
           "words": (outer_fec._bch_words(code.n, t, dev), 0, None)}
    shapes, lanes = _outer_shapes("bch", B, dev)

    def launch(i, o, shape):
        outer_fec._launch_into(
            "outer_bch_decode", "bch", i["in"], (code.n, code.k, t),
            (i["tables"], i["words"]), o["out"], o["ok"], **shape)

    def plain(i):
        out, ok = bch_device.bch_decode_batch_reference(code.n, code.k, t,
                                                        i["in"])
        return {"out": out, "ok": ok}
    return Setup("outer_bch_decode", "outer_bch_decode", ins,
                 {"out": ((B, code.k), torch.uint8, "out", 0),
                  "ok": ((B,), torch.int32, "out", 0)},
                 launch, plain,
                 frozenset(("t", t, lv) for lv in lanes), shapes)


def setup_rs(c: Case, dev) -> Setup:
    p = c.params
    n, npar, B = p["n"], p["n_parity"], p["B"]
    rs = ReedSolomon(n, npar)
    rng = _rng(c)
    words = rs.encode(rng.integers(0, 256, (B, rs.k)).astype(np.uint8))
    for i in range(B):
        ne = i % (npar // 2 + 4)
        if ne:
            words[i, rng.choice(n, ne, replace=False)] ^= rng.integers(
                1, 256, ne).astype(np.uint8)
    ins = {"in": (torch.as_tensor(words, device=dev), p["skew"], 0),
           "tables": (outer_fec._gf_tables(dev), 0, None)}
    shapes, lanes = _outer_shapes("rs", B, dev)

    def launch(i, o, shape):
        outer_fec._launch_into("outer_rs_decode", "rs", i["in"], (n, npar),
                               (i["tables"],), o["out"], o["ok"], **shape)

    def plain(i):
        out, ok = bch_device.rs_decode_batch_reference(n, npar, i["in"])
        return {"out": out, "ok": ok}
    return Setup("outer_rs_decode", "outer_rs_decode", ins,
                 {"out": ((B, rs.k), torch.uint8, "out", 0),
                  "ok": ((B,), torch.int32, "out", 0)},
                 launch, plain,
                 frozenset(("half", npar // 2, lv) for lv in lanes), shapes)


# A: the PSK31 PLL ──────────────────────────────────────────────────────────

PLL_GAIN = 0.05


def pll_inputs(rows: int, n: int, qpsk: bool, rng):
    """Dots of a drifting carrier at 120 with BPSK flips or QPSK steps and
    noise, the previous symbols and phase accumulators a row."""
    k = np.arange(n)
    base = np.exp(1j * (0.01 * k + rng.uniform(0, 6, (rows, 1)))) * 120.0
    if qpsk:
        mod = np.exp(0.5j * np.pi * rng.integers(0, 4, (rows, n)))
    else:
        mod = np.where(rng.integers(0, 2, (rows, n)) == 1, 1.0, -1.0)
    dots = base * mod + 30.0 * (rng.standard_normal((rows, n))
                                + 1j * rng.standard_normal((rows, n)))
    prev = np.exp(1j * rng.uniform(0, 6, rows))
    acc = rng.uniform(-3, 3, rows)
    return (dots.astype(np.complex64), prev.astype(np.complex64),
            acc.astype(np.float32))


def pll_close(got: dict, want: dict) -> bool:
    """Decisions exact; soft values, symbols and phases within 1e-5 of the
    peak (the kernel's sincosf and rsqrtf against torch's own cos, sin and
    rsqrt on the card: ops/psk31_pll.py)."""
    s, r = got["soft"], want["soft"]
    lead = (s[..., 0], r[..., 0]) if s.dim() == 3 else (s, r)
    peak = max(float(r.abs().max()), 1.0)
    return (torch.equal(lead[0] >= 0, lead[1] >= 0)
            and float((s - r).abs().max()) <= 1e-5 * peak
            and float((got["prev_out"] - want["prev_out"]).abs().max())
            <= 1e-5
            and float((got["acc_out"] - want["acc_out"]).abs().max())
            <= 1e-5)


def setup_pll(c: Case, dev) -> Setup:
    p = c.params
    rows, n, qpsk = p["rows"], p["n"], p["qpsk"]
    dots, prev, acc = pll_inputs(rows, n, qpsk, _rng(c))
    c_fb, scale = pll_constants(256, 1.0)

    def launch(i, o, shape):
        psk31_pll._launch_into(i["dots"], i["prev0"], i["acc0"], c_fb,
                               scale, np.float32(PLL_GAIN), qpsk, o["soft"],
                               o["prev_out"], o["acc_out"])

    def plain(i):
        soft, po, ao = psk31_pll.psk31_pll_reference(
            i["dots"], i["prev0"], i["acc0"], c_fb, scale,
            np.float32(PLL_GAIN), qpsk)
        return {"soft": soft, "prev_out": po, "acc_out": ao}
    return Setup(
        "psk31_pll", "psk31_pll",
        {"dots": (torch.as_tensor(dots, device=dev), p["skew"], 0),
         "prev0": (torch.as_tensor(prev, device=dev), 0, 0),
         "acc0": (torch.as_tensor(acc, device=dev), 0, 0)},
        {"soft": ((rows, n) + ((2,) if qpsk else ()), torch.float32, "out",
                  0),
         "prev_out": ((rows,), torch.complex64, "out", 0),
         "acc_out": ((rows,), torch.float32, "out", 0)},
        launch, plain, frozenset({("qpsk", qpsk)}), same=pll_close)


# B: the two-rate one-pole ──────────────────────────────────────────────────

def onepole_poles(ge: bool):
    """(a_hi, a_lo) of the two callers at 8 kHz: agc_rms's attack and
    release (5 and 50 ms), cw_mod's rise and fall (3 and 2.5 ms)."""
    a = [float(np.exp(-1.0 / (ms * 1e-3 * 8000.0)))
         for ms in ((3.0, 2.5) if ge else (5.0, 50.0))]
    return a[0], a[1]


def onepole_steps_exact(x, env0, a_hi, a_lo, ge, env, last) -> bool:
    """A two-rate one-pole run held to its plain version at every step at
    once: each step recomputed from the run's own previous envelope (env0
    before the first) in the plain version's float32 operations (the two
    products rounded apart, then the sum). Exact at every step is exact
    over the whole run, by induction from env0."""
    ah, bh, al, bl = (float(v) for v in onepole_two_rate._poles(a_hi, a_lo))
    prev = torch.cat([env0[..., None], env[..., :-1]], dim=-1)
    hi = x >= prev if ge else x > prev
    expect = torch.where(hi, ah * prev + bh * x, al * prev + bl * x)
    return torch.equal(expect, env) and torch.equal(last, env[..., -1])


def setup_onepole(c: Case, dev) -> Setup:
    p = c.params
    rows, n, ge = p["rows"], p["n"], p["ge"]
    rng = _rng(c)
    if c.main:  # agc_rms's x² at chip_smoke [31]'s width, drawn on the card
        g = torch.Generator(dev).manual_seed(31)
        xt = (torch.randn((rows, n), device=dev, generator=g) * 3.0) ** 2
    elif ge:    # cw_mod's keying: 0/1 steps
        xt = torch.as_tensor(((np.arange(n) // 7 + np.arange(rows)[:, None])
                              % 2).astype(np.float32), device=dev)
    else:       # agc_rms's x²
        xt = torch.as_tensor((np.abs(rng.standard_normal((rows, n)) * 3.0)
                              ** 2).astype(np.float32), device=dev)
    env0 = torch.clamp(xt[:, 0], min=1e-12).contiguous()
    a_hi, a_lo = onepole_poles(ge)

    def launch(i, o, shape):
        onepole_two_rate._launch_into(i["x"], i["env0"], a_hi, a_lo, ge,
                                      o["env"], o["last"])

    def plain(i):
        env, last = onepole_two_rate.onepole_two_rate_reference(
            i["x"], i["env0"], a_hi, a_lo, ge)
        return {"env": env, "last": last}

    def held(i, got):
        return onepole_steps_exact(i["x"], i["env0"], a_hi, a_lo, ge,
                                   got["env"], got["last"])
    return Setup(
        "onepole_two_rate", "onepole_two_rate",
        {"x": (xt, p["skew"], 0), "env0": (env0, 0, 0)},
        {"env": ((rows, n), torch.float32, "out", 0),
         "last": ((rows,), torch.float32, "out", 0)},
        launch, plain, frozenset({("ge", ge)}),
        held=held if c.main else None)


# C: the DD-PLL ─────────────────────────────────────────────────────────────

DD_LOOP_BW = 0.03


def dd_symbols(order: str, rows: int, n: int, rng) -> np.ndarray:
    pts = constellation_points(order)
    k = np.arange(n)
    s = pts[rng.integers(0, len(pts), (rows, n))]
    return (s * np.exp(1j * (0.3 + 0.013 * k)) + 0.02 * (
        rng.standard_normal((rows, n)) + 1j * rng.standard_normal((rows, n)))
            ).astype(np.complex64)


def setup_dd(c: Case, dev) -> Setup:
    p = c.params
    order, rows, n = p["order"], p["rows"], p["n"]
    z = torch.as_tensor(dd_symbols(order, rows, n, _rng(c)), device=dev)
    thr, lv, sign = dd_pll._tables(order, dev)
    imag_zero = order == "bpsk"

    def launch(i, o, shape):
        dd_pll._launch_into(i["z"], order, DD_LOOP_BW,
                            (i["thr"], i["levels"], sign), o["out"])

    def plain(i):
        return {"out": dd_pll.dd_pll_reference(i["z"], order, DD_LOOP_BW)}
    return Setup(
        "dd_pll", "dd_pll",
        {"z": (z, p["skew"], 0), "thr": (thr, 0, None),
         "levels": (lv, 0, None)},
        {"out": ((rows, n), torch.complex64, "out", 0)},
        launch, plain,
        frozenset({("template", thr.numel(), bool(sign), imag_zero)}))


# D: the Gardner loop ───────────────────────────────────────────────────────

_MODULES: dict = {}


def gardner_model():
    """tests/test_torch_gardner_schedule.py (numpy, torch and the port):
    its ring model gives each row's window misses."""
    if "gardner" not in _MODULES:
        spec = importlib.util.spec_from_file_location(
            "test_torch_gardner_schedule",
            os.path.join(HERE, "test_torch_gardner_schedule.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES["gardner"] = mod
    return _MODULES["gardner"]


def setup_gardner(c: Case, dev) -> Setup:
    p = c.params
    rows, n, sps, bw, mu0, n_out = (p["rows"], p["n"], float(p["sps"]),
                                    p["loop_bw"], p["mu0"], p["n_out"])
    model = gardner_model()
    seed = zlib.crc32(c.label.encode()) % 1000
    z, zt = (model.shaped_rows(rows, n, int(sps), seed)
             if p["kind"] == "shaped" else model.noise_rows(rows, n, seed))

    def launch(i, o, shape):
        gardner._launch_into(i["z"], sps, bw, mu0, o["out"], o["pos"],
                             o["misses"])

    def plain(i):
        out, pos = gardner.gardner_reference(i["z"], sps, n_out, bw, mu0)
        if c.main:      # the ring model's Python loop is too long here
            return {"out": out, "pos": pos}
        misses = [model.ring_model(i["z"][r].cpu().numpy(), sps, n_out,
                                   bw, mu0)[2]
                  for r in range(i["z"].shape[0])]
        return {"out": out, "pos": pos,
                "misses": torch.tensor(misses, dtype=torch.int32,
                                       device=i["z"].device)}
    return Setup(
        "gardner", "gardner", {"z": (zt.to(dev), p["skew"], 0)},
        {"out": ((rows, n_out), torch.complex64, "out", 0),
         "pos": ((rows,), torch.float32, "out", 0),
         "misses": ((rows,), torch.int32,
                    "scratch" if c.main else "aux", 0)},
        launch, plain, frozenset({("gardner",)}))


# E: the GPS tracking loops ─────────────────────────────────────────────────

TRACK_GAINS = (7.2, 0.9, 0.12)
_PRNS = (5, 6, 9, 12, 14, 17, 21, 25)


def track_inputs(S: int, E: int, at_end: bool, rng):
    """A capture of E + 2 epochs holding S satellites at their code phases
    and Dopplers, their ±1 codes, epoch starts and initial Dopplers; with
    ``at_end`` every start sits in the capture's last epoch, so the
    windows and slices run into its end and clamp there."""
    spms = int(TRACK_FS / 1000)
    n_ms = E + 2
    z = np.zeros(spms * n_ms, np.complex128)
    starts, f0 = [], []
    for s in range(S):
        prn, dopp = _PRNS[s], 1500.0 + 400.0 * s
        phase = float(rng.uniform(0, 1000))
        z += gps_ca_mod(prn, TRACK_FS, n_ms, dopp, phase,
                        amplitude=1.0 / (s + 1))
        start = int(round(phase * spms / 1023.0)) % spms
        starts.append(start + (spms * (n_ms - 1) - 40 if at_end else 0))
        f0.append(dopp + 60.0)
    z = z + 0.3 * (rng.standard_normal(len(z))
                   + 1j * rng.standard_normal(len(z)))
    codes = np.stack([_ca_pm_sampled(prn, TRACK_FS) for prn in _PRNS[:S]])
    return (z.astype(np.complex64), codes.astype(np.float32),
            np.asarray(starts, np.int32), np.asarray(f0, np.float32))


def setup_track(c: Case, dev) -> Setup:
    p = c.params
    S, E, threads = p["S"], p["E"], p["threads"]
    z, codes, starts, f0 = track_inputs(S, E, p["at_end"], _rng(c))
    n, spms = len(z), codes.shape[1]
    k = gnss_track.loop_constants(TRACK_FS, spms, *TRACK_GAINS)
    window = p["skew"] % 16 == 0

    def launch(i, o, shape):
        gnss_track._launch_into(
            i["z"], i["codes"], i["starts"], i["f0"], TRACK_FS,
            *TRACK_GAINS, o["prompts"], o["freqs"], o["bases"], o["fracs"],
            o["misses"], threads)

    def plain(i):
        pr, fr, ba, fc = gnss_track.track_reference(
            i["z"], i["codes"], i["starts"], i["f0"], TRACK_FS, E,
            *TRACK_GAINS, threads)
        misses = (gnss_track.window_misses(i["starts"], ba, n, spms,
                                           k["d_el"]) if window
                  else torch.full(i["starts"].shape, E, dtype=torch.int32,
                                  device=ba.device))
        return {"prompts": pr, "freqs": fr, "bases": ba, "fracs": fc,
                "misses": misses.to(torch.int32)}
    return Setup(
        "gnss_track", "gnss_track",
        {"z": (torch.as_tensor(z, device=dev), p["skew"], None),
         "codes": (torch.as_tensor(codes, device=dev), 0, 0),
         "starts": (torch.as_tensor(starts, device=dev), 0, 0),
         "f0": (torch.as_tensor(f0, device=dev), 0, 0)},
        {"prompts": ((S, E), torch.complex64, "out", 0),
         "freqs": ((S, E), torch.float32, "out", 0),
         "bases": ((S, E), torch.int32, "out", 0),
         "fracs": ((S, E), torch.float32, "out", 0),
         "misses": ((S,), torch.int32, "aux", 0)},
        launch, plain,
        frozenset({("threads", threads), ("window", window)}))


# H: the QPSK31 batch Viterbi ───────────────────────────────────────────────

def qpsk31_pairs(rows: int, n: int, coherent: bool, rng) -> np.ndarray:
    """Random bits through the QPSK31 code at noise 0.3 a component:
    differential products, or absolute symbols for the coherent decoder."""
    from orion_sdr_tpu_torch.codec import psk31 as C
    out = []
    for row in rng.integers(0, 2, (rows, n)).astype(np.uint8):
        cw = C.conv_encode(row)
        sym = C.DQPSK_EXP[cw[0::2] * 2 + cw[1::2]]
        sym = (np.cumprod(sym) if coherent else sym) + 0.3 * (
            rng.standard_normal(n) + 1j * rng.standard_normal(n))
        out.append(np.stack([sym.real, sym.imag], -1))
    return np.asarray(out, np.float32).reshape(rows, n, 2)


def setup_h(c: Case, dev) -> Setup:
    p = c.params
    rows, n, coh = p["rows"], p["n"], p["coherent"]
    pairs = torch.as_tensor(qpsk31_pairs(rows, n, coh, _rng(c)), device=dev)

    def launch(i, o, shape):
        psk31_viterbi._launch_into(i["pairs"], coh, o["masks"], o["bits"])

    def plain(i):
        return {"bits": psk31_viterbi.psk31_viterbi_reference(i["pairs"],
                                                              coh)}
    return Setup(
        "psk31_viterbi", "psk31_viterbi", {"pairs": (pairs, p["skew"], 0)},
        {"bits": ((rows, n), torch.uint8, "out", 0),
         "masks": ((n, rows), torch.int16, "scratch", None)},
        launch, plain, frozenset({("coherent", coh)}))


# the two helpers ───────────────────────────────────────────────────────────

def setup_sincos(c: Case, dev) -> Setup:
    p = c.params

    def launch(i, o, shape):
        dd_pll._sincos_into(p["lo"], p["count"], o["bad"])

    def plain(i):       # sincosf gives the bits of cosf and sinf everywhere
        return {"bad": torch.zeros(1, dtype=torch.int64, device=dev)}
    return Setup("dd_pll", "dd_pll_sincos_mismatches", {},
                 {"bad": ((1,), torch.int64, "acc", None)},
                 launch, plain, frozenset({("helper",)}))


def setup_lengths(c: Case, dev) -> Setup:
    p = c.params
    rng = _rng(c)
    z = (rng.standard_normal(p["n"]) * 3 + 1j * rng.standard_normal(p["n"])
         ).astype(np.complex64)

    def launch(i, o, shape):
        psk31_viterbi._lengths_into(i["z"], o["h"])

    def plain(i):       # hypotf is torch's complex abs on the card
        return {"h": i["z"].abs()}
    return Setup("psk31_viterbi", "psk31_viterbi_lengths",
                 {"z": (torch.as_tensor(z, device=dev), p["skew"], 0)},
                 {"h": ((p["n"],), torch.float32, "out", 0)},
                 launch, plain, frozenset({("helper",)}))


SETUPS = {"gardner": setup_gardner, "track": setup_track, "bp": setup_bp,
          "h": setup_h, "pll": setup_pll, "dd": setup_dd,
          "viterbi": setup_viterbi, "bch": setup_bch, "rs": setup_rs,
          "onepole": setup_onepole, "sincos": setup_sincos,
          "lengths": setup_lengths}


def _table() -> list:
    """Every case, by the kernels' risk: D, E, BP, H, A, C, Viterbi, F/G,
    B, then the helpers. ``smoke`` marks the smallest case of each
    branch, which chip_smoke [55] runs."""
    t = []
    # D: n across the ring's chunk edges, a row start 8- but not 16-byte
    # aligned, symbols past the row's end, a loop that steps back
    for rows, n, sps, bw, mu0, n_out, kind, skew, smoke in (
            (1, 511, 4, 0.02, 0.0, 511 // 4 + 8, "shaped", 0, True),
            (2, 512, 4, 0.02, 1.0, 512 // 4 - 2, "shaped", 8, True),
            (3, 513, 4, 0.02, -2.5, 513 // 4 + 8, "shaped", 8, False),
            (2, 2049, 8, 0.02, 3.0, 2049 // 8 + 20, "shaped", 0, False),
            (3, 2049, 4, 8.0, 0.0, 500, "noise", 8, True),
            (33, 1030, 2, 0.3, 20.0, 520, "shaped", 8, False)):
        t.append(case("gardner", smoke, rows=rows, n=n, sps=sps,
                      loop_bw=bw, mu0=mu0, n_out=n_out, kind=kind,
                      skew=skew))
    # E: each width, one satellite, one epoch, the capture's end, the
    # prefetched window (a 16-byte aligned capture) and device reads
    for threads, S, E, at_end, skew, smoke in (
            (128, 1, 1, False, 0, True), (256, 2, 6, False, 8, True),
            (512, 3, 5, True, 0, True), (128, 3, 12, True, 8, False),
            (256, 1, 1, True, 0, False), (512, 4, 20, False, 0, False),
            (512, 1, 3, False, 8, False)):
        t.append(case("track", smoke, threads=threads, S=S, E=E,
                      at_end=at_end, skew=skew))
    # BP: every exact width and the three generic ones, each rule, the
    # bulk and the 4-byte load, batch 1 and a ragged batch
    smoke_bp = {("N512R12", "sum_product"), ("N512R12", "sum_product_edge"),
                ("staircase174", "min_sum"), ("ft8", "scaled_min_sum"),
                ("N576R23", "sum_product_edge"),
                ("N512R34", "scaled_min_sum"), ("random4", "sum_product"),
                ("random12", "min_sum"), ("random20", "sum_product_edge")}
    graphs = ("N512R12", "staircase174", "ft8", "N576R23", "N512R34",
              "random4", "random12", "random20")
    for j, g in enumerate(graphs):
        for r, rule in enumerate(ldpc_bp.RULES):
            t.append(case("bp", (g, rule) in smoke_bp, graph=g, rule=rule,
                          B=37, skew=4 * ((j + r) % 2)))
        t.append(case("bp", graph=g, rule="sum_product", B=1,
                      skew=4 * (j % 2)))
    t.append(case("bp", graph="N512R12", rule="min_sum", B=700, skew=0))
    # H: both metrics; 1, 31 and 33 rows (a part warp, a warp and one);
    # 1 symbol and a tile plus one
    for coh in (False, True):
        for rows in (1, 31, 33):
            for n in (1, 33):
                t.append(case("h", rows == 33 and n == 33, coherent=coh,
                              rows=rows, n=n, skew=8 * (rows % 2)))
    # A: BPSK and QPSK; rows 1, 31, 33; n 1, 31, 33 (a tile plus one)
    for qpsk in (False, True):
        for rows in (1, 31, 33):
            for n in (1, 31, 33):
                t.append(case("pll", rows == 33 and n == 33, qpsk=qpsk,
                              rows=rows, n=n, skew=8 * (n % 2)))
    # C: every template (sign with and without the zero imaginary part,
    # 3, 7 and 15 thresholds); ragged rows and symbols
    for order in ("bpsk", "qpsk", "qam16", "qam64", "qam256"):
        for rows, n, skew in ((33, 33, 8), (1, 1, 0), (31, 65, 0)):
            t.append(case("dd", (rows, n) == (33, 33), order=order,
                          rows=rows, n=n, skew=skew))
    # Viterbi: both radices, chunked and terminated, 1 lane and a part
    # block, T odd (radix 2), the decisions in the global scratch
    for code, radix, mode, L, T, skew, smoke in (
            ("k5", 2, "chunked", 1, 37, 4, True),
            ("dvb_k7", 2, "chunked", 33, 1217, 0, False),
            ("k5", 2, "terminated", 33, 55, 0, True),
            ("dvb_k7", 2, "terminated", 1, 107, 4, False),
            ("k5", 2, "chunked", 1, viterbi.MAX_SMEM_STEPS + 33, 0, True),
            ("k5", 4, "chunked", 33, 36, 4, True),
            ("dvb_k7", 4, "chunked", 1, 1220, 0, False),
            ("dvb_k7", 4, "terminated", 1, 104, 0, True),
            ("k5", 4, "terminated", 33, 100, 4, False),
            ("k5", 4, "chunked", 1, viterbi.MAX_SMEM_STEPS + 4, 0, True)):
        t.append(case("viterbi", smoke, code=code, radix=radix, mode=mode,
                      L=L, T=T, skew=skew))
    # F and G: every t, at 16 and 32 lanes (one case runs both); one
    # codeword and a batch that is no multiple of a block's codewords
    for tt in range(1, 9):
        t.append(case("bch", True, t=tt, B=37, skew=tt % 4))
        t.append(case("bch", t=tt, B=1, skew=0))
    t.append(case("bch", t=8, B=1000, skew=0))
    for half in range(1, 9):
        n = 204 if half in (1, 4, 8) else 60 + 16 * half
        t.append(case("rs", True, n=n, n_parity=2 * half, B=37,
                      skew=half % 4))
        t.append(case("rs", n=n, n_parity=2 * half, B=1, skew=0))
    t.append(case("rs", n=204, n_parity=16, B=1000, skew=3))
    # B: both comparisons; rows 1 and 33; n 1, 63 and 65
    for ge in (False, True):
        for rows in (1, 33):
            for n in (1, 63, 65):
                t.append(case("onepole", rows == 33 and n == 65, ge=ge,
                              rows=rows, n=n, skew=4 * (n % 2)))
    # each kernel at a main path's shape (chip_smoke's timed shapes)
    for kernel, p in (
            ("gardner", dict(rows=64, n=1 << 17, sps=8, loop_bw=0.02,
                             mu0=0.0, n_out=16380, kind="shaped", skew=0)),
            ("track", dict(threads=512, S=8, E=400, at_end=False, skew=0)),
            ("bp", dict(graph="N512R12", rule="sum_product", B=3072,
                        skew=0)),
            ("bp", dict(graph="N512R12", rule="sum_product_edge", B=3072,
                        skew=0)),
            ("h", dict(coherent=False, rows=16, n=2048, skew=0)),
            ("h", dict(coherent=True, rows=16, n=2048, skew=0)),
            ("pll", dict(qpsk=False, rows=16, n=2048, skew=0)),
            ("pll", dict(qpsk=True, rows=16, n=2048, skew=0)),
            ("dd", dict(order="qam16", rows=64, n=2048, skew=0)),
            ("viterbi", dict(code="dvb_k7", radix=2, mode="chunked",
                             L=3168, T=1216, skew=0)),
            ("viterbi", dict(code="dvb_k7", radix=4, mode="chunked",
                             L=3168, T=1216, skew=0)),
            ("bch", dict(t=8, B=12928, skew=0)),
            ("rs", dict(n=204, n_parity=16, B=3048, skew=0)),
            ("onepole", dict(ge=False, rows=64, n=1 << 20, skew=0))):
        t.append(case(kernel, main=True, **p))
    t.append(case("sincos", True, lo=0x3F000000, count=1 << 22))
    t.append(case("lengths", True, n=1000, skew=8))
    return t


CASES = _table()


def setup(c: Case, dev) -> Setup:
    return SETUPS[c.kernel](c, torch.device(dev))


# ── the checks ───────────────────────────────────────────────────────────────

_BUSY: dict = {}


def _busy_stream(dev):
    """Queues BUSY_PRODUCTS float32 products of 4096 x 4096 on a second
    stream of ``dev`` (its operands kept for the next call) and returns
    the stream."""
    key = str(dev)
    if key not in _BUSY:
        g = torch.Generator(dev).manual_seed(55)
        a = torch.randn((4096, 4096), device=dev, generator=g)
        _BUSY[key] = (torch.cuda.Stream(dev), a, torch.empty_like(a))
    s, a, c = _BUSY[key]
    s.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(s):
        for _ in range(BUSY_PRODUCTS):
            torch.mm(a, a, out=c)
    return s


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


class _Run:
    """One case's buffers and the launches on them."""

    def __init__(self, s: Setup, dev, launch):
        self.s, self.dev, self.launch = s, torch.device(dev), launch
        self.fail: list = []

    def slots_in(self, ins: dict, how: str, seed: int) -> dict:
        slots = {}
        for k, (t, skew, _) in ins.items():
            sl = Slot(t.shape, t.dtype, self.dev, skew)
            mode = how if (how != "nonfinite" or t.is_floating_point()
                           or t.is_complex()) else "random"
            fill_halo(sl, t, mode, seed + zlib.crc32(k.encode()))
            slots[k] = sl
        return slots

    def slots_out(self) -> dict:
        slots = {}
        for k, (shape, dtype, kind, _) in self.s.outs.items():
            sl = Slot(shape, dtype, self.dev)
            sl.raw.copy_(pattern(sl.raw.numel(), SENTINELS[0], self.dev))
            slots[k] = sl
        self.out_bands = {k: sl.bands().clone() for k, sl in slots.items()}
        return slots

    def fire(self, si: dict, so: dict, shape, rep: int) -> dict:
        """One launch: each output filled with a sentinel (the two by turns
        for held outputs, the first for scratch; zeros for an
        accumulator), then the kernel; returns the outputs' bytes."""
        for k, sl in so.items():
            kind = self.s.outs[k][2]
            if kind == "acc":
                sl.bytes().zero_()
            else:
                pat = SENTINELS[rep % 2 if kind != "scratch" else 0]
                sl.bytes().copy_(pattern(sl.nbytes, pat, self.dev))
        self.launch({k: v.view for k, v in si.items()},
                    {k: v.view for k, v in so.items()}, shape)
        return {k: sl.view.clone() for k, sl in so.items()}

    def bands_ok(self, so: dict) -> bool:
        ok = all(torch.equal(sl.bands(), self.out_bands[k])
                 for k, sl in so.items())
        if not ok:
            self.fail.append("an output's guard band changed")
        return ok

    def inputs_ok(self, si: dict, snap: dict) -> bool:
        ok = all(torch.equal(sl.raw, snap[k]) for k, sl in si.items())
        if not ok:
            bad = [k for k, sl in si.items() if not torch.equal(sl.raw,
                                                                 snap[k])]
            self.fail.append(f"input buffer(s) {bad} changed")
        return ok

    def equal(self, got: dict, ref: dict, what: str, keys=None) -> bool:
        keys = list(ref) if keys is None else keys
        bad = [k for k in keys if not same_bytes(got[k], ref[k])]
        if bad:
            self.fail.append(f"{what}: {bad} differ")
        return not bad


def _unpermute(t: torch.Tensor, axis, inv: torch.Tensor) -> torch.Tensor:
    return t.index_select(axis, inv.to(t.device))


def run_case(c: Case, dev, launch=None, reps: int = REPS,
             busy: bool = True) -> dict:
    """Every check of the module docstring on case ``c`` on ``dev``.
    ``launch`` replaces the kernel's launch (a stand-in, for the CPU
    tests); ``busy`` runs the busy-stream series (card only). Returns the
    readings: each check's verdict, the launches made, the outputs'
    fingerprints, the seconds and what failed."""
    t0 = time.perf_counter()
    dev = torch.device(dev)
    s = setup(c, dev)
    run = _Run(s, dev, launch or s.launch)
    held = [k for k, o in s.outs.items() if o[2] != "scratch"]
    ins = {k: v[0].clone() for k, v in s.ins.items()}
    want = None if s.held else (s.plain(ins) if dev.type == "cuda"
                                else plain_rows(s, ins))
    same = s.same or _exact
    res = {"case": c.label, "name": s.name, "entry": s.entry,
           "branches": sorted(map(str, s.branches)), "launches": 0}
    # halos: three fills, one launch each
    outs = run.slots_out()
    first = None
    halos = inputs = True
    plain_ok = None
    for j, how in enumerate(("random", "random", "nonfinite")):
        si = run.slots_in(s.ins, how, 1000 * (j + 1))
        snap = {k: sl.raw.clone() for k, sl in si.items()}
        got = run.fire(si, outs, s.shapes[0], j)
        _sync(dev)
        res["launches"] += 1
        inputs &= run.inputs_ok(si, snap)
        if first is None:
            first = got
            plain_ok = (s.held(ins, got) if s.held
                        else same({k: got[k] for k in held}, want))
            if not plain_ok:
                run.fail.append("the outputs differ from the plain version")
        else:
            halos &= run.equal(got, first, f"halo fill {how} {j}")
    bands = run.bands_ok(outs)
    det = {}
    # determinism: alone, beside a busy stream, rows permuted, shapes
    si = run.slots_in(s.ins, "random", 1)
    snap = {k: sl.raw.clone() for k, sl in si.items()}
    series = [("alone", False)] + ([("busy", True)]
                                   if busy and dev.type == "cuda" else [])
    for label, with_busy in series:
        stream = _busy_stream(dev) if with_busy else None
        got = [run.fire(si, outs, s.shapes[0], r) for r in range(reps)]
        if stream is not None:
            torch.cuda.current_stream(dev).wait_stream(stream)
        _sync(dev)
        res["launches"] += reps
        det[label] = all(run.equal(g, first, f"{label} repeat {r}")
                         for r, g in enumerate(got))
    rows = [t.shape[ax] for t, _, ax in s.ins.values() if ax is not None]
    if rows:
        n = rows[0]
        perm = torch.as_tensor(np.random.default_rng(n).permutation(n))
        inv = torch.argsort(perm)
        pins = {k: ((t.index_select(ax, perm.to(t.device)), sk, ax)
                    if ax is not None else (t, sk, ax))
                for k, (t, sk, ax) in s.ins.items()}
        psi = run.slots_in(pins, "random", 2)
        psnap = {k: sl.raw.clone() for k, sl in psi.items()}
        got = [run.fire(psi, outs, s.shapes[0], r) for r in range(reps)]
        _sync(dev)
        res["launches"] += reps
        back = [{k: _unpermute(g[k], s.outs[k][3], inv) for k in held}
                for g in got]
        det["permuted"] = all(run.equal(b, first, f"permuted repeat {r}",
                                        held) for r, b in enumerate(back))
        inputs &= run.inputs_ok(psi, psnap)
    else:
        det["permuted"] = None
    if len(s.shapes) > 1:
        ok = True
        for shape in s.shapes[1:]:
            got = [run.fire(si, outs, shape, r) for r in range(reps)]
            _sync(dev)
            res["launches"] += reps
            ok &= all(run.equal(g, first, f"shape {shape} repeat {r}",
                                held) for r, g in enumerate(got))
        det["shapes"] = ok
    else:
        det["shapes"] = None
    inputs &= run.inputs_ok(si, snap)
    bands &= run.bands_ok(outs)
    res.update(bands=bool(bands), halos=bool(halos), inputs=bool(inputs),
               plain=bool(plain_ok), determinism=det,
               shapes=[sh for sh in s.shapes if sh],
               fingerprint={k: fingerprint(v) for k, v in first.items()},
               failed=run.fail, s=time.perf_counter() - t0)
    res["ok"] = (res["bands"] and res["halos"] and res["inputs"]
                 and res["plain"]
                 and all(v is not False for v in det.values()))
    return res


def plain_rows(s: Setup, ins: dict) -> dict:
    """The plain version's outputs computed a row at a time where rows are
    independent: torch's CPU kernels round a vector's lanes and its tail
    apart, so there a row's bits would depend on its place in the batch."""
    axes = {k: ax for k, (_, _, ax) in s.ins.items() if ax is not None}
    if not axes:
        return s.plain(ins)
    k0 = next(iter(axes))
    parts = [s.plain({k: (t.narrow(axes[k], r, 1) if k in axes else t)
                      for k, t in ins.items()})
             for r in range(ins[k0].shape[axes[k0]])]
    return {k: torch.cat([q[k] for q in parts], s.outs[k][3])
            for k in parts[0]}


def plain_launch(c: Case, dev):
    """A stand-in launch that writes the plain version's outputs (a row at
    a time) into the guarded views: every check must pass on it (for the
    CPU tests)."""
    s = setup(c, dev)

    def launch(i, o, shape):
        for k, v in plain_rows(s, i).items():
            o[k].copy_(v)
    return launch


def summary(results: list) -> dict:
    """The readings of :func:`run_case` by kernels-line name: cases,
    launches, seconds, and each check true only if every case held (a
    determinism series None where no case runs it)."""
    out: dict = {}
    for r in results:
        e = out.setdefault(r["name"], {
            "cases": 0, "entries": [], "bands": True, "halos": True,
            "inputs": True, "plain": True,
            "determinism": {"alone": None, "busy": None, "permuted": None,
                            "shapes": None},
            "launches": 0, "s": 0.0, "failed": []})
        e["cases"] += 1
        if r["entry"] not in e["entries"]:
            e["entries"].append(r["entry"])
        for k in ("bands", "halos", "inputs", "plain"):
            e[k] = e[k] and r[k]
        for k, v in r["determinism"].items():
            if v is not None:       # None: the series does not apply
                d = e["determinism"]
                d[k] = v if d[k] is None else d[k] and v
        e["launches"] += r["launches"]
        e["s"] += r["s"]
        if not r["ok"]:
            e["failed"].append({"case": r["case"], "why": r["failed"]})
    return out


# ── chip_smoke [31]'s AGC sequence under watch ───────────────────────────────

WINDOW = 256            # samples a reported window


class Watch:
    """Exact copies of tensors taken at :meth:`keep`, held to the live
    tensors byte for byte at each :meth:`check`, and two kept copies held
    to each other by :meth:`match` (a host copy against the card data it
    was made from). A card tensor's check queues its comparison on the
    stream (no synchronise, so the sequence watched keeps its timing);
    :meth:`finish` synchronises, reads every check and records the first
    step at which bytes differed, on which side (card or host), where and
    in which bits."""

    def __init__(self):
        self.kept: dict = {}
        self.steps: list = []
        self.parted: dict | None = None

    def keep(self, name: str, t: torch.Tensor) -> None:
        self.kept[name] = (t, t.detach().clone())

    def check(self, step: str) -> None:
        flags = {}
        for name, (live, copy) in self.kept.items():
            changed = (_flat_bytes(live) != _flat_bytes(copy)).any()
            flags[name] = changed if live.device.type == "cuda" \
                else bool(changed)
        self.steps.append((step, flags))

    def match(self, step: str, a: str, b: str) -> None:
        self.steps.append((step, {(a, b): None}))

    def _parting(self, step, name) -> dict | None:
        if isinstance(name, tuple):         # two kept copies
            got, want = (self.kept[v][1].cpu() for v in name)
            side = "copy"
        else:
            live, copy = self.kept[name]
            got, want = live.detach().cpu(), copy.cpu()
            side = "card" if live.device.type == "cuda" else "host"
        where = first_window(got, want)
        if where["row"] is None:
            return None
        return {"step": step, "tensor": name, "side": side, **where}

    def finish(self) -> bool:
        """True when no kept tensor changed at any step and every match
        held."""
        for t, _ in self.kept.values():
            _sync(t.device)
        for step, flags in self.steps:
            for name, changed in flags.items():
                if self.parted is None and (changed is None
                                            or bool(changed)):
                    self.parted = self._parting(step, name)
        return self.parted is None

    def report(self) -> str:
        if self.parted is None:
            return (f"no byte changed in {len(self.kept)} kept tensors "
                    f"over {len(self.steps)} checks")
        return (f"bytes changed: {self.parted}; checks "
                f"{[step for step, _ in self.steps]}")


def _flat_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def first_window(got: torch.Tensor, kept: torch.Tensor) -> dict:
    """Where ``got`` first differs from ``kept`` (same shape): the row, the
    WINDOW-sample window holding the first changed element, how many
    elements changed there and in all, both values there and the bits
    that differ in each 32-bit word of it (hex)."""
    g = got.reshape(got.shape[0], -1) if got.dim() > 1 else got[None]
    k = kept.reshape(g.shape)
    item = g.element_size()
    gb = g.contiguous().view(torch.uint8).reshape(g.shape + (item,))
    kb = k.contiguous().view(torch.uint8).reshape(g.shape + (item,))
    diff = (gb != kb).any(-1)
    idx = diff.nonzero()
    if not len(idx):
        return {"row": None}
    r, i = (int(v) for v in idx[0])
    w0 = i - i % WINDOW
    words = (np.frombuffer(gb[r, i].numpy().tobytes(), np.uint8)
             ^ np.frombuffer(kb[r, i].numpy().tobytes(), np.uint8))
    bits = [hex(int.from_bytes(words[j:j + 4].tobytes(), "little"))
            for j in range(0, len(words), 4)] if item >= 4 else \
        [hex(int(w)) for w in words]
    return {"row": r, "index": i, "window": [w0, w0 + WINDOW],
            "changed_in_window": int(diff[r, w0:w0 + WINDOW].sum()),
            "changed": int(diff.sum()), "got": complex(g[r, i]),
            "kept": complex(k[r, i]), "bits": bits}


def agc_sequence(P, dev, fs: float, rows: int, log2_n: int, head: int
                 ) -> dict:
    """chip_smoke [31]'s main-path sequence under a :class:`Watch`: the
    seeded draw on the card, ``agc_rms`` on the card, ``cw_mod`` on the
    card, a synchronise, the card-side readings, the CPU path's copy of
    rows 0-1's first ``head`` samples, ``agc_rms`` and ``cw_mod`` on the
    CPU. Kept: ``iq[:2, :head]`` right after the draw, the agc launch's
    own x² and initial envelope slices right after it, the CPU copy right
    after it is made; compared after agc_rms on the card, after cw_mod,
    after the synchronise, after the CPU copy and after the CPU agc_rms,
    and the CPU copy byte for byte against the draw's kept copy
    (``watch.parted`` says where bytes first differed, None if nowhere).
    The two-rate launches are recorded and returned with their inputs and
    outputs."""
    import orion_sdr_tpu_torch.dsp.agc as agc_mod
    import orion_sdr_tpu_torch.modulate.analog as analog_mod
    from orion_sdr_tpu_torch.dsp.agc import agc_rms, design_agc
    onepole = onepole_two_rate.onepole_two_rate
    p = design_agc(fs, 5.0, 50.0, 0.3)
    n = 1 << log2_n
    watch = Watch()
    iq = torch.complex(*(torch.randn((rows, n), device=dev,
                                     generator=torch.Generator(dev)
                                     .manual_seed(s)) for s in (1, 2))) * 3.0
    keys = ((torch.arange(n, device=dev)[None, :] // 4000
             + torch.arange(rows, device=dev)[:, None]) % 2).float()
    watch.keep("iq", iq[:2, :head])
    seen = []

    def rec(x, env0, a_hi, a_lo, ge):
        env, last = onepole(x, env0, a_hi, a_lo, ge)
        seen.append((x, env0, a_hi, a_lo, ge, env, last))
        if len(seen) == 1:
            watch.keep("agc x^2", x[:2, :head])
            watch.keep("agc env0", env0[:2])
        return env, last
    for m in (agc_mod, analog_mod):
        m.onepole_two_rate = rec
    try:
        onepole.launches = 0
        y, _ = agc_rms(iq, p)
        watch.check("after agc_rms on the card")
        cw, _ = P.cw_mod(keys, fs, 700.0, device=dev)
        watch.check("after cw_mod")
        _sync(dev)
        launches = onepole.launches
        watch.check("after synchronize")
    finally:
        for m in (agc_mod, analog_mod):
            m.onepole_two_rate = onepole
    tail_rms = float(y[:, n // 2:].abs().pow(2).mean().sqrt())
    mark = keys[:, 7999] > 0                    # rows keyed over 4000-7999
    on = float(cw[mark, 7999].abs().min())
    x_kept = iq[:2, :head].cpu()                # the CPU path's input copy
    watch.keep("cpu copy", x_kept)
    watch.check("after the CPU copy")
    watch.match("the CPU copy against the draw's", "cpu copy", "iq")
    y_cpu, _ = agc_rms(x_kept, p)
    watch.check("after the CPU agc_rms")
    watch.finish()
    cw_cpu, _ = P.cw_mod(keys[:2, :head].cpu(), fs, 700.0, device="cpu")
    err_agc = float((y[:2, :head].cpu() - y_cpu).abs().max())
    err_cw = float((cw[:2, :head].cpu() - cw_cpu).abs().max())
    return {"p": p, "iq": iq, "keys": keys, "y": y, "cw": cw, "seen": seen,
            "launches": launches, "tail_rms": tail_rms, "on": on,
            "x_kept": x_kept, "y_cpu": y_cpu, "cw_cpu": cw_cpu,
            "err_agc": err_agc, "err_cw": err_cw, "watch": watch}
