"""Batched LDPC belief-propagation decoding: the Hopper kernel
``csrc/ldpc_bp.cu`` and its plain torch version.

Counterpart of ``orion_sdr_tpu/ops/ldpc_bp.py`` (the Pallas TPU kernels
``_ms_kernel_factory``, rules sum_product / min_sum / scaled_min_sum, and
``_bp_kernel_factory``, the edge-layout rule ``sum_product_edge``);
semantics of ``orion_sdr_tpu/fec/ldpc.py::bp_decode`` per row: every row
iterates until its syndrome is zero or ``max_iter`` is reached and returns
the snapshot with the fewest unsatisfied checks.

``sum_product_edge`` is the sum-product check update in the log domain, as
``_bp_kernel_factory`` computes it: t = clip(fast_tanh(msg/2), ±0.9999999),
a = log(max(|t|, 1e-12)), the check's log-sum taken in slot order and the
own term subtracted, the sign from the parity of the other edges' negative
t, then 2·fast_atanh(clip(sign·exp(loo), ±0.9999999)). The TPU kernel rounds
its one-hot contractions (the log-sum, the sign count, the bit totals) to
bf16; the port computes all of it in f32, so it decodes the same codewords
on decodable rows but not the TPU's trajectory.

:func:`bp_decode_kernel` launches the CUDA kernel for a CUDA tensor (built
with nvcc at first use; any failure raises) and runs
:func:`bp_decode_reference` for a CPU tensor. Both sum each bit's extrinsics
in the same fixed order and round every float operation alike (the edge
rule's ``log``/``exp`` are the card's ``logf``/``expf`` in the kernel and
torch's on the plain side), so on the card they agree bit for bit.
:func:`bp_decode_pallas` is the JAX package's entry point with its
arguments and results (the graph by its key, the N-bit hard plane) over the
same kernel, and with :func:`bp_decode_kernel` the way to reach the edge
rule: ``fec/ldpc.py::bp_decode`` takes only the three rules the JAX
``bp_decode`` implements.
"""

from __future__ import annotations

import ctypes
import hashlib
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..buildlib import NVCC_FLAGS_NO_FMA, PTR, INT, F32, CudaLib
from ..dsp.device import pallas_placed

RULES = ("sum_product", "min_sum", "scaled_min_sum", "sum_product_edge")
# the kernel's rule codes: 1 is min-sum with the extrinsics scaled
_RULE_CODE = {"sum_product": 0, "min_sum": 1, "scaled_min_sum": 1,
              "sum_product_edge": 2}
_CLIP_EDGE = 0.9999999



# the kernel's tables hold bit indices and edge ids as uint16; this marks a
# check's padded slot
NO_BIT = 0xFFFF
MAX_D = 32


@dataclass(frozen=True)
class BpTables:
    """One graph's edge tables on one device. The plain version reads the
    check-major tables (edge c·D + j); the kernel stages the compact
    slot-major ones (edge j·m + c) in shared memory."""
    n: int
    k: int
    m: int
    D: int
    C: int                        # largest column degree
    check_bits: torch.Tensor      # (m, D) int32, padded slots = n
    check_mask: torch.Tensor      # (m, D) uint8
    bit_edge_slots: torch.Tensor  # (n, C) int64 edge ids c·D + j, pad m·D
    check_slots: torch.Tensor     # (D·m,) uint16 bits as int16, [j·m + c],
    #                               padded slots = NO_BIT
    bit_slots: torch.Tensor       # (C·n,) uint16 edge ids j·m + c as int16,
    #                               [i·n + b], pad m·D (a slot that holds 0)
    key: tuple                    # (graph_key(g), device)


_TABLES: dict = {}
# id of a live graph object → its graph_key, dropped with the object
_KEYS: dict = {}


def graph_key(g) -> tuple:
    """The content of graph ``g`` that its tables depend on: name, sizes
    and a digest of ``check_bits``/``check_mask``. Computed once per graph
    object, so equal graphs built apart (as ``convert.ldpc_graph_from_fields``
    builds them) share one set of tables and launch plans."""
    key = _KEYS.get(id(g))
    if key is None:
        digest = hashlib.sha256(
            np.ascontiguousarray(g.check_bits, np.int32).tobytes()
            + np.ascontiguousarray(g.check_mask, bool).tobytes()).hexdigest()
        key = _KEYS[id(g)] = (g.name, g.n, g.k, g.m, g.max_deg, digest)
        weakref.finalize(g, _KEYS.pop, id(g), None)
    return key


def graph_tables(g, device) -> BpTables:
    """Edge tables for graph ``g`` on ``device``, built once per (graph
    content, device). Raises ValueError for a graph the kernel's 16-bit
    tables cannot hold (more than 65 535 bits, or m·D edge slots that reach
    65 535) or whose check degree D exceeds 32."""
    device = torch.device(device)
    key = (graph_key(g), device)
    t = _TABLES.get(key)
    if t is None:
        if g.n > NO_BIT or g.m * g.max_deg >= NO_BIT:
            raise ValueError(f"graph {g.name!r}: {g.n} bits and "
                             f"{g.m * g.max_deg} edge slots do not fit the "
                             f"kernel's 16-bit tables")
        if not 1 <= g.max_deg <= MAX_D:
            raise ValueError(f"graph {g.name!r}: check degree {g.max_deg} "
                             f"outside 1..{MAX_D}")
        m, D = g.m, g.max_deg
        cb = np.asarray(g.check_bits, np.int32).reshape(m, D)
        mask = np.asarray(g.check_mask, bool).reshape(m, D)
        if cb[mask].size and (cb[mask].min() < 0 or cb[mask].max() >= g.n):
            raise ValueError("check_bits index outside the codeword")
        edges = np.flatnonzero(mask.reshape(-1))
        bits = cb.reshape(-1)[edges]
        # each bit's edges in ascending check-major id: the order its
        # extrinsics are summed in, by both versions
        bit_edges = edges[np.argsort(bits, kind="stable")]
        deg = np.bincount(bits, minlength=g.n)
        ptr = np.concatenate([[0], np.cumsum(deg)])
        E = m * D
        C = max(int(deg.max(initial=0)), 1)
        slots = np.full((g.n, C), E, np.int64)
        for b in range(g.n):
            row = bit_edges[ptr[b]:ptr[b + 1]]
            slots[b, :len(row)] = row
        # slot-major renumbering c·D + j → j·m + c, the pad kept at m·D
        slot_major = np.where(slots < E, (slots % D) * m + slots // D, E)
        check_slots = np.where(mask, cb, NO_BIT).T.reshape(-1)

        def dev(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        def dev16(a):
            return dev(np.asarray(a, np.uint16).view(np.int16), torch.int16)

        t = BpTables(g.n, g.k, m, D, C, dev(np.where(mask, cb, g.n),
                                            torch.int32),
                     dev(mask, torch.uint8), dev(slots, torch.int64),
                     dev16(check_slots), dev16(slot_major.T.reshape(-1)),
                     key)
        _TABLES[key] = t
    return t


# ── plain torch version ──────────────────────────────────────────────────────


def _fast_tanh(x):
    x2 = x * x
    a = x * (945.0 + x2 * (105.0 + x2))
    b = 945.0 + x2 * (420.0 + x2 * 15.0)
    return torch.clamp(a / b, -1.0, 1.0)


def _fast_atanh(x):
    x2 = x * x
    a = x * (945.0 + x2 * (-735.0 + x2 * 64.0))
    b = 945.0 + x2 * (-1050.0 + x2 * 225.0)
    return a / b


def _check_update(msg, mask, rule: str, alpha: float):
    """(B, m, D) messages → extrinsics (0 on masked slots)."""
    D = msg.shape[-1]
    if rule == "sum_product":
        t = torch.where(mask, _fast_tanh(msg * 0.5), 1.0)
        left = [None] * D
        acc = torch.ones_like(t[..., 0])
        for j in range(D):
            left[j] = acc
            acc = acc * t[..., j]
        acc = torch.ones_like(t[..., 0])
        loo = [None] * D
        for j in range(D - 1, -1, -1):
            loo[j] = left[j] * acc
            acc = acc * t[..., j]
        ext = 2.0 * _fast_atanh(torch.clamp(torch.stack(loo, -1), -1.0, 1.0))
    elif rule == "sum_product_edge":
        t = torch.where(mask, torch.clamp(_fast_tanh(msg * 0.5), -_CLIP_EDGE,
                                          _CLIP_EDGE), 1.0)
        a = torch.log(torch.clamp(t.abs(), min=1e-12))
        total = a[..., 0]
        for j in range(1, D):
            total = total + a[..., j]
        neg = (t < 0.0).to(torch.int32)
        others = neg.sum(-1, keepdim=True) - neg
        sign = torch.where((others & 1) == 1, -1.0, 1.0)
        prod = sign * torch.exp(total[..., None] - a)
        ext = 2.0 * _fast_atanh(torch.clamp(prod, -_CLIP_EDGE, _CLIP_EDGE))
    else:
        a = torch.where(mask, msg.abs(), torch.inf)
        sign = torch.where(mask & (msg < 0), -1.0, 1.0)
        sign_par = torch.prod(sign, dim=-1, keepdim=True)
        min1 = a.amin(-1, keepdim=True)
        first = torch.arange(D, device=msg.device) == torch.argmin(
            a, dim=-1, keepdim=True)          # first minimum, as jnp.argmin
        min2 = torch.where(first, torch.inf, a).amin(-1, keepdim=True)
        mag = torch.where(first, min2, min1)
        scale = alpha if rule == "scaled_min_sum" else 1.0
        ext = (scale * (sign_par * sign)) * mag
    return torch.where(mask, ext, 0.0)


def bp_decode_reference(g, llr: torch.Tensor, max_iter: int = 50,
                        rule: str = "sum_product", alpha: float = 0.75,
                        store: str = "message"):
    """Plain torch BP over the whole batch on ``llr``'s device: (B, n) f32 →
    (bits (B, k) uint8, unsat (B,) int32); ``store="codeword"`` returns all
    n bits of the snapshot, (B, n). Rows that reached a zero syndrome
    keep iterating with the batch but can no longer change their snapshot,
    so each row's result is its own early-exit result."""
    _check_rule(rule)
    t = graph_tables(g, llr.device)
    B, n = llr.shape
    m, D = t.m, t.D
    cb = t.check_bits.to(torch.int64).reshape(-1)           # (m·D,)
    mask = t.check_mask.bool()                              # (m, D)

    def pad(x):
        return torch.cat([x, x.new_zeros((B, 1))], dim=-1)

    def syndrome(hard):
        h = pad(hard.to(torch.int32))[:, cb].reshape(B, m, D)
        return ((h * mask).sum(-1) & 1).sum(-1).to(torch.int32)

    hard = llr <= 0.0
    best = hard
    min_unsat = syndrome(hard)
    msg = torch.where(mask, pad(llr)[:, cb].reshape(B, m, D), 0.0)
    for _ in range(max_iter):
        if not bool((min_unsat > 0).any()):
            break
        ext = _check_update(msg, mask, rule, alpha)
        gathered = pad(ext.reshape(B, m * D))[:, t.bit_edge_slots]  # (B, n, c)
        s = gathered[..., 0]
        for j in range(1, gathered.shape[-1]):
            s = s + gathered[..., j]
        total = llr + s
        hard = total <= 0.0
        unsat = syndrome(hard)
        better = unsat < min_unsat
        best = torch.where(better[:, None], hard, best)
        min_unsat = torch.where(better, unsat, min_unsat)
        msg = torch.where(mask, pad(total)[:, cb].reshape(B, m, D) - ext, 0.0)
    width = t.n if store == "codeword" else t.k
    return best[:, :width].to(torch.uint8), min_unsat


# ── CUDA kernel ──────────────────────────────────────────────────────────────

_LIB = CudaLib("ldpc_bp", NVCC_FLAGS_NO_FMA, {
    "ldpc_bp_launch_plan": [INT, INT, INT, INT, INT, PTR, PTR, PTR],
    "ldpc_bp_decode": [PTR, INT, INT, INT, INT, INT, INT, PTR, PTR, INT, INT,
                       F32, INT, INT, ctypes.c_longlong, PTR, PTR, PTR]})
build = _LIB.build


def _check_rule(rule: str) -> None:
    if rule not in RULES:
        raise ValueError(f"unknown BP rule {rule!r} (expected one of {RULES})")


_PLANS: dict = {}


def _resident(t: BpTables, code: int, device: torch.device) -> dict:
    """The occupancy query for tables ``t`` under rule code ``code`` on a
    CUDA ``device`` (with its index), made once and kept."""
    key = (t.key, code)
    base = _PLANS.get(key)
    if base is None:
        thr, bps, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
        _LIB.call("ldpc_bp_launch_plan", device, t.n, t.m, t.D, t.C, code,
                  ctypes.byref(thr), ctypes.byref(bps), ctypes.byref(smem))
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        if bps.value < 1:
            raise RuntimeError(f"no block of the BP kernel fits an SM "
                               f"({smem.value} B shared memory)")
        base = _PLANS[key] = {"threads": thr.value,
                              "blocks_per_sm": bps.value,
                              "smem": smem.value, "sms": sms}
    return base


def launch_plan(g, rule: str, B: int, device=None) -> dict:
    """The launch :func:`bp_decode_kernel` makes for B codewords of graph
    ``g`` under ``rule``: ``threads`` (a block: one check a thread),
    ``blocks_per_sm`` (resident blocks an SM by
    cudaOccupancyMaxActiveBlocksPerMultiprocessor with that block size and
    shared memory), ``smem`` (bytes a block), ``sms``, ``grid`` (the
    resident blocks, at most B: block i stays resident and decodes rows i,
    i + grid, ... in turn) and ``codewords_per_block`` (B over the grid,
    rounded up). The occupancy
    query runs once per device, graph and rule and is kept."""
    _check_rule(rule)
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    base = _resident(graph_tables(g, device), _RULE_CODE[rule], device)
    grid = max(min(B, base["blocks_per_sm"] * base["sms"]), 1)
    return dict(base, grid=grid, codewords_per_block=-(-B // grid))


def bp_decode_kernel(g, llr: torch.Tensor, max_iter: int = 50,
                     rule: str = "sum_product", alpha: float = 0.75,
                     store: str = "message"):
    """Batched BP decode: ``llr`` (B, n) contiguous float32 → (bits (B, k)
    uint8, unsat (B,) int32) on the same device. ``store="codeword"``
    returns all n bits of each row's best snapshot, (B, n) uint8, in place
    of its k message bits (the kernel's store width set to n). A CUDA
    tensor launches the kernel on :func:`launch_plan`'s grid; a CPU tensor
    runs :func:`bp_decode_reference`. ``bp_decode_kernel.launches`` counts
    the launches of the three slab rules, ``.launches_edge`` those of
    ``sum_product_edge``."""
    _check_rule(rule)
    if store not in ("message", "codeword"):
        raise ValueError(f"store must be 'message' or 'codeword', "
                         f"got {store!r}")
    if llr.dtype != torch.float32:
        raise TypeError(f"llr must be float32, got {llr.dtype}")
    if llr.dim() != 2 or llr.shape[1] != g.n:
        raise ValueError(f"llr must be (B, {g.n}), got {tuple(llr.shape)}")
    if not llr.is_contiguous():
        raise ValueError("llr must be contiguous")
    if llr.device.type == "cpu":
        return bp_decode_reference(g, llr, max_iter, rule, alpha, store)
    if llr.device.type != "cuda":
        raise ValueError(f"no BP kernel for device {llr.device}")
    B = llr.shape[0]
    width = g.n if store == "codeword" else g.k
    bits = torch.empty((B, width), dtype=torch.uint8, device=llr.device)
    unsat = torch.empty((B,), dtype=torch.int32, device=llr.device)
    if B == 0:
        return bits, unsat
    _launch_into(graph_tables(g, llr.device), llr, max_iter, rule, alpha,
                 bits, unsat)
    if rule == "sum_product_edge":
        bp_decode_kernel.launches_edge += 1
    else:
        bp_decode_kernel.launches += 1
    return bits, unsat


def _launch_into(t: BpTables, llr: torch.Tensor, max_iter: int, rule: str,
                 alpha: float, bits: torch.Tensor, unsat: torch.Tensor,
                 grid: int | None = None) -> None:
    """Launches the kernel on the caller's buffers, all contiguous CUDA
    tensors: ``t`` the graph's tables, ``llr`` (B, n) float32, ``bits``
    (B, width) uint8 (width k or n), ``unsat`` (B,) int32; on ``grid``
    persistent blocks (default :func:`launch_plan`'s, the resident blocks
    at most B)."""
    B, width = bits.shape
    code = _RULE_CODE[rule]
    plan = _resident(t, code, llr.device)
    if grid is None:
        grid = min(B, plan["blocks_per_sm"] * plan["sms"])
    scale = float(alpha) if rule == "scaled_min_sum" else 1.0
    _LIB.launch("ldpc_bp_decode", llr.device, llr.data_ptr(), B, t.n, width,
                t.m, t.D, t.C, t.check_slots.data_ptr(),
                t.bit_slots.data_ptr(), int(max_iter), code, scale, grid,
                plan["threads"], plan["smem"], bits.data_ptr(),
                unsat.data_ptr())


bp_decode_kernel.launches = 0
bp_decode_kernel.launches_edge = 0


# ── the JAX package's entry points ───────────────────────────────────────────


def graph_by_key(graph_key: str):
    """The graph the JAX package names ``"name:n:k"``
    (``orion_sdr_tpu/fec/ldpc.py::_graph_key``): a staircase code of
    ``fec.ldpc.LDPC_CODES`` or FT8/FT4's ``ft8_174_91``. Raises KeyError
    for any other key."""
    from ..codec.ft8_ldpc import ft8_ldpc_graph
    from ..fec.ldpc import LDPC_CODES, ldpc_graph
    name, _, rest = graph_key.partition(":")
    if name in LDPC_CODES:
        g = ldpc_graph(name)
    elif name == "ft8_174_91":
        g = ft8_ldpc_graph()
    else:
        raise KeyError(graph_key)
    if f"{g.name}:{g.n}:{g.k}" != graph_key:
        raise KeyError(graph_key)
    return g


def bp_graph_fits(graph_key: str) -> bool:
    """Whether the port's kernel takes the graph ``graph_key`` names: its
    16-bit tables hold it (at most 65 535 bits and edge slots, check degree
    1 to 32) and, on a card, one block's shared memory as the kernel's own
    :func:`launch_plan` lays it out fits what a block may opt into there
    (the plan raises when the kernel cannot be given it). With no card the
    answer rests on the tables alone: the shared memory is the card's to
    say. The JAX package's rule is the TPU's VMEM budget; this is the
    card's."""
    g = graph_by_key(graph_key)
    if g.n > NO_BIT or g.m * g.max_deg >= NO_BIT or \
            not 1 <= g.max_deg <= MAX_D:
        return False
    if not torch.cuda.is_available():
        return True
    build()                     # a build failure raises, it is no answer
    dev = torch.device("cuda", torch.cuda.current_device())
    try:
        plan = launch_plan(g, "sum_product", 1, dev)
    except RuntimeError:        # the opt-in limit refused, or no block fits
        return False
    return plan["smem"] <= \
        torch.cuda.get_device_properties(dev).shared_memory_per_block_optin


def bp_decode_pallas(graph_key: str, llr, max_iter: int = 50,
                     interpret=None, *, rule: str = "sum_product",
                     alpha: float = 0.75, stall_iters: int = 12):
    """Counterpart of ``orion_sdr_tpu.ops.bp_decode_pallas``, with its
    arguments: the graph by its JAX key ``"name:n:k"`` (:func:`graph_by_key`)
    and (B, N) LLRs under any of the four rules, ``sum_product_edge``
    included. Returns (best (B, N) float32 hard plane of each row's best
    snapshot, min_unsat (B,) int32), as the JAX wrapper does (whose plane
    carries N padded to a multiple of 128 columns; the port's stops at N).

    ``interpret=True`` or a CPU tensor runs the plain version
    :func:`bp_decode_reference`; otherwise a tensor stays on its device and
    host data goes to the card, where the kernel runs (it raises if it
    cannot build or launch). ``stall_iters`` is accepted and has no effect:
    the JAX kernel lets a row that has not improved for ``stall_iters``
    iterations stop holding its tile of 128 rows, while the port's kernel
    ends each row on its own at a zero syndrome or ``max_iter``. So the two
    agree whenever ``stall_iters >= max_iter``."""
    del stall_iters
    best, unsat = bp_decode_kernel(graph_by_key(graph_key),
                                   pallas_placed(llr, interpret), max_iter,
                                   rule, alpha, store="codeword")
    return best.to(torch.float32), unsat
