"""Long-constraint convolutional coding with SEQUENTIAL (stack) decoding —
a distinct FEC family from the Viterbi-decoded K=5/K=7 codes (the port's
own copy of ``orion_sdr_tpu/fec/sequential.py``, bit-exact with it): K=32
codes have a 2³¹-state trellis no Viterbi can walk, but
near/above the computational cutoff rate a stack decoder explores only a
thin tube of paths. This is the code family WSPR-class beacons use
(the Layland–Lushbaugh polynomials are the defaults).

Host-side by design: the search is data-dependent branch-and-bound (the
antithesis of fixed-shape device code); captures are tiny (≤ a few
hundred bits per transmission)."""

from __future__ import annotations

import heapq
from typing import Optional, Tuple

import numpy as np

LL_POLY1 = 0xF2D05351
LL_POLY2 = 0xE4613C47


def _parity32(x: int) -> int:
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x ^= x >> 8
    x ^= x >> 4
    x ^= x >> 2
    x ^= x >> 1
    return x & 1


def conv_encode_long(bits, k: int = 32,
                     polys: Tuple[int, int] = (LL_POLY1, LL_POLY2),
                     tail: bool = True) -> np.ndarray:
    """Rate-1/2 feedforward encode with constraint length ``k``; a
    (k−1)-bit zero tail flushes the register. Output order: p1, p2 per
    input bit."""
    b = list(np.asarray(bits, np.uint8) & 1)
    if tail:
        b += [0] * (k - 1)
    reg = 0
    out = np.empty(2 * len(b), np.uint8)
    for i, bit in enumerate(b):
        reg = ((reg << 1) | int(bit)) & ((1 << k) - 1)
        out[2 * i] = _parity32(reg & polys[0])
        out[2 * i + 1] = _parity32(reg & polys[1])
    return out


def stack_decode(llrs, n_info: int, k: int = 32,
                 polys: Tuple[int, int] = (LL_POLY1, LL_POLY2),
                 max_nodes: int = 200_000) -> Optional[np.ndarray]:
    """Stack (Zigangirov–Jelinek) sequential decoder for the rate-1/2
    zero-tailed code: ``llrs`` are 2·(n_info + k − 1) values, positive ⇒
    coded bit 0. Returns the n_info decoded bits, or None if the search
    exceeds ``max_nodes`` (deep-below-threshold capture).

    Fano metric per coded bit: log2 p(bit | llr) + 1 − R, with
    p from the LLR's sigmoid — paths agreeing with strong LLRs gain
    ~+0.5/bit, disagreements pay ~−|llr|/ln2."""
    llr = np.asarray(llrs, np.float32)
    total = n_info + k - 1
    if len(llr) < 2 * total:
        return None
    # per position: metric for hypothesis bit 0 / bit 1
    l0 = np.log2(1.0 / (1.0 + np.exp(-llr))) + 0.5      # p(bit=0)
    l1 = np.log2(1.0 / (1.0 + np.exp(llr))) + 0.5
    m0, m1 = l0[0::2], l1[0::2]
    n0, n1 = l0[1::2], l1[1::2]

    def branch(reg, depth, bit):
        reg2 = ((reg << 1) | bit) & ((1 << k) - 1)
        c1 = _parity32(reg2 & polys[0])
        c2 = _parity32(reg2 & polys[1])
        dm = (m1[depth] if c1 else m0[depth]) \
            + (n1[depth] if c2 else n0[depth])
        return reg2, dm

    # heap of (−metric, tiebreak, depth, reg, path_int)
    heap = [(-0.0, 0, 0, 0, 0)]
    counter = 1
    nodes = 0
    while heap and nodes < max_nodes:
        neg_m, _, depth, reg, path = heapq.heappop(heap)
        nodes += 1
        if depth == total:
            out = np.empty(n_info, np.uint8)
            for i in range(n_info):
                out[i] = (path >> (total - 1 - i)) & 1
            return out
        choices = (0, 1) if depth < n_info else (0,)   # zero tail forced
        for bit in choices:
            reg2, dm = branch(reg, depth, bit)
            heapq.heappush(heap, (neg_m - dm, counter, depth + 1, reg2,
                                  (path << 1) | bit))
            counter += 1
    return None
