"""Constructive IRA/staircase LDPC family: graph, encode, BP decode
(counterpart of ``orion_sdr_tpu/fec/ldpc.py``).

H = [A | T] is rebuilt from the same deterministic greedy fill (row-load
balance + 4-cycle guard, xorshift64 tie-break with per-code seeds), so the
graph is wire-exact with the JAX package. Codes: N512R12 (512,256), N576R23
(576,384), N512R34 (512,384), column weight 3.

Decoding runs the batched belief-propagation kernel
(``ops/ldpc_bp.py::bp_decode_kernel``): one CUDA thread block per codeword on
the card, its plain torch version on the CPU. Every row stops on its own at a
zero syndrome or at ``max_iter``, which is the per-row result of the JAX
package's f32 ``bp_decode``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..dsp.device import on_device

LDPC_CODES = {
    "N512R12": (512, 256, 0x4C44_5043_3531_3200),
    "N576R23": (576, 384, 0x4C44_5043_3531_3201),
    "N512R34": (512, 384, 0x4C44_5043_3531_3202),
}

COL_WEIGHT = 3
_MASK64 = (1 << 64) - 1


def _build_msg_col_rows(k: int, m: int, seed: int) -> list:
    """Deterministic A-block fill: per message column pick COL_WEIGHT rows,
    least-loaded first, rotating xorshift offset as tie-break, rejecting rows
    that would form an A-block 4-cycle."""
    state = seed

    def nxt():
        nonlocal state
        state = (state ^ (state << 13)) & _MASK64
        state = (state ^ (state >> 7)) & _MASK64
        state = (state ^ (state << 17)) & _MASK64
        return state

    row_load = [0] * m
    used_pairs = set()
    cols = []
    for _ in range(k):
        rows = []
        while len(rows) < COL_WEIGHT:
            offset = nxt() % m
            best, best_load = None, None
            for step in range(m):
                r = (offset + step) % m
                if r in rows:
                    continue
                if any((min(q, r), max(q, r)) in used_pairs for q in rows):
                    continue
                if best_load is None or row_load[r] < best_load:
                    best_load = row_load[r]
                    best = r
            if best is not None:
                rows.append(best)
            else:
                # relax the girth constraint rather than loop forever
                for step in range(m):
                    r = (offset + step) % m
                    if r not in rows:
                        rows.append(r)
                        break
        for i in range(len(rows)):
            row_load[rows[i]] += 1
            for j in range(i + 1, len(rows)):
                used_pairs.add((min(rows[i], rows[j]), max(rows[i], rows[j])))
        cols.append(sorted(rows))
    return cols


@dataclass(frozen=True, eq=False)
class LdpcGraph:
    """One code's Tanner graph as dense padded tables."""
    name: str
    n: int
    k: int
    m: int
    A: np.ndarray              # (m, k) uint8 — dense A block
    check_bits: np.ndarray     # (m, max_deg) int32, padded with n (dummy bit)
    check_mask: np.ndarray     # (m, max_deg) bool
    max_deg: int

    def __eq__(self, other):
        return (isinstance(other, LdpcGraph)
                and (self.name, self.n, self.k, self.m, self.max_deg)
                == (other.name, other.n, other.k, other.m, other.max_deg)
                and np.array_equal(self.A, other.A)
                and np.array_equal(self.check_bits, other.check_bits)
                and np.array_equal(self.check_mask, other.check_mask))

    __hash__ = object.__hash__


@lru_cache(maxsize=None)
def ldpc_graph(name: str) -> LdpcGraph:
    """Construct (and cache) a code's graph."""
    n, k, seed = LDPC_CODES[name]
    m = n - k
    cols = _build_msg_col_rows(k, m, seed)
    A = np.zeros((m, k), dtype=np.uint8)
    check_bits = [[] for _ in range(m)]
    for col, rows in enumerate(cols):
        for r in rows:
            A[r, col] = 1
            check_bits[r].append(col)
    for i in range(m):
        check_bits[i].append(k + i)
        if i > 0:
            check_bits[i].append(k + i - 1)
    max_deg = max(len(b) for b in check_bits)
    cb = np.full((m, max_deg), n, dtype=np.int32)
    mask = np.zeros((m, max_deg), dtype=bool)
    for i, bits in enumerate(check_bits):
        cb[i, :len(bits)] = bits
        mask[i, :len(bits)] = True
    return LdpcGraph(name=name, n=n, k=k, m=m, A=A,
                     check_bits=cb, check_mask=mask, max_deg=max_deg)


def _graph_key(g: LdpcGraph) -> str:
    """The key ``"name:n:k"`` the JAX package names a graph by, which
    ``ops.bp_decode_pallas`` takes (``ops.ldpc_bp.graph_by_key``)."""
    return f"{g.name}:{g.n}:{g.k}"


def ldpc_encode(name: str, message, device=None) -> torch.Tensor:
    """Systematic encode (..., K) bits → (..., N) uint8 codeword on the
    message's device (host data: ``device``, None for the card): s = A·msg
    mod 2 (the XOR of each check's message bits, gathered through the
    graph), parity = prefix-XOR(s)."""
    g = ldpc_graph(name)
    msg = on_device(message, device, torch.int32) & 1
    a_bits = np.where(g.check_mask & (g.check_bits < g.k), g.check_bits, g.k)
    idx = torch.as_tensor(a_bits, dtype=torch.int64, device=msg.device)
    msg_p = torch.cat([msg, msg.new_zeros(msg.shape[:-1] + (1,))], dim=-1)
    s = msg_p[..., idx].sum(-1) & 1                       # (..., m)
    p = torch.cumsum(s, dim=-1) & 1
    return torch.cat([msg, p], dim=-1).to(torch.uint8)


# the rules of the JAX bp_decode; its XLA path would decode any other string
# (sum_product_edge included) as min-sum, so here they raise instead. The
# edge-layout rule is reached through ops.ldpc_bp.bp_decode_kernel (a graph)
# or ops.bp_decode_pallas (the JAX package's graph key).
DECODE_RULES = ("sum_product", "min_sum", "scaled_min_sum")


def bp_decode(g: LdpcGraph, llr, max_iter: int = 50,
              rule: str = "sum_product", alpha: float = 0.75, device=None):
    """BP over a padded Tanner graph. ``llr``: (..., N) float32 LLRs,
    positive ⇒ bit 0: a tensor decodes on its device, host data on
    ``device`` (None: the card). Returns (message (..., K) uint8, unsat (...,) int32):
    0 unsatisfied checks means a valid codeword was reached. ``rule``:
    sum_product | min_sum | scaled_min_sum (extrinsics scaled by ``alpha``);
    any other raises ValueError."""
    from ..ops.ldpc_bp import bp_decode_kernel
    if rule not in DECODE_RULES:
        raise ValueError(f"unknown BP rule {rule!r} (expected one of "
                         f"{DECODE_RULES}; the edge-layout rule is "
                         f"ops.ldpc_bp.bp_decode_kernel's and "
                         f"ops.bp_decode_pallas's)")
    llr = on_device(llr, device, torch.float32)
    lead = llr.shape[:-1]
    flat = llr.reshape(-1, g.n).contiguous()
    bits, unsat = bp_decode_kernel(g, flat, max_iter, rule, alpha)
    return bits.reshape(lead + (g.k,)), unsat.reshape(lead)


def ldpc_decode(name: str, llr, max_iter: int = 50,
                rule: str = "sum_product", alpha: float = 0.75, device=None):
    """Belief-propagation decode of a named code; see :func:`bp_decode`."""
    return bp_decode(ldpc_graph(name), llr, max_iter, rule, alpha, device)


def ldpc_syndrome_weight(name: str, hard) -> torch.Tensor:
    """Unsatisfied parity checks of hard bits (..., N) of a named code →
    (...,) int32 counts, on the bits' device (host data: the card)."""
    g = ldpc_graph(name)
    h = on_device(hard).to(torch.int32) & 1
    hp = torch.cat([h, h.new_zeros(h.shape[:-1] + (1,))], dim=-1)
    cb = torch.as_tensor(g.check_bits, dtype=torch.int64, device=h.device)
    mask = torch.as_tensor(g.check_mask, device=h.device)
    x = torch.where(mask, hp[..., cb], 0).sum(-1) & 1
    return x.sum(-1).to(torch.int32)
