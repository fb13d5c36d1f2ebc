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
:func:`bp_decode_pallas` is the entry point named after the JAX one, and
the way to reach the edge rule: ``fec/ldpc.py::bp_decode`` takes only the
three rules the JAX ``bp_decode`` implements.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from dataclasses import dataclass

import numpy as np
import torch

from ..buildlib import Built, build_shared

RULES = ("sum_product", "min_sum", "scaled_min_sum", "sum_product_edge")
# the kernel's rule codes: 1 is min-sum with the extrinsics scaled
_RULE_CODE = {"sum_product": 0, "min_sum": 1, "scaled_min_sum": 1,
              "sum_product_edge": 2}
_CLIP_EDGE = 0.9999999

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "ldpc_bp.cu")
# -fmad=false: no fused multiply-add contraction, so the kernel's float
# arithmetic rounds exactly like the plain version's separate tensor ops
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]


@dataclass(frozen=True)
class BpTables:
    """One graph's edge tables on one device."""
    n: int
    k: int
    m: int
    D: int
    check_bits: torch.Tensor     # (m, D) int32, padded slots = n
    check_mask: torch.Tensor     # (m, D) uint8
    bit_ptr: torch.Tensor        # (n + 1,) int32 CSR row pointers
    bit_edges: torch.Tensor      # (nnz,) int32 edge ids c·D + j, ascending
    bit_edge_slots: torch.Tensor  # (n, max col degree) int64, pad = m·D


_TABLES: dict = {}


def graph_tables(g, device) -> BpTables:
    """Edge tables for graph ``g`` on ``device``, built once per (graph
    content, device)."""
    device = torch.device(device)
    key = (g.name, g.n, g.k, g.m, g.max_deg, g.check_bits.tobytes(),
           g.check_mask.tobytes(), str(device))
    t = _TABLES.get(key)
    if t is None:
        cb = np.asarray(g.check_bits, np.int32).reshape(g.m, g.max_deg)
        mask = np.asarray(g.check_mask, bool).reshape(g.m, g.max_deg)
        if cb[mask].size and (cb[mask].min() < 0 or cb[mask].max() >= g.n):
            raise ValueError("check_bits index outside the codeword")
        edges = np.flatnonzero(mask.reshape(-1))
        bits = cb.reshape(-1)[edges]
        order = np.argsort(bits, kind="stable")
        bit_edges = edges[order].astype(np.int32)
        deg = np.bincount(bits, minlength=g.n)
        ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
        E = g.m * g.max_deg
        slots = np.full((g.n, max(int(deg.max(initial=0)), 1)), E, np.int64)
        for b in range(g.n):
            row = bit_edges[ptr[b]:ptr[b + 1]]
            slots[b, :len(row)] = row

        def dev(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)
        t = BpTables(g.n, g.k, g.m, g.max_deg,
                     dev(np.where(mask, cb, g.n), torch.int32),
                     dev(mask, torch.uint8), dev(ptr, torch.int32),
                     dev(bit_edges, torch.int32), dev(slots, torch.int64))
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
                        rule: str = "sum_product", alpha: float = 0.75):
    """Plain torch BP over the whole batch on ``llr``'s device: (B, n) f32 →
    (bits (B, k) uint8, unsat (B,) int32). Rows that reached a zero syndrome
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
    return best[:, :t.k].to(torch.uint8), min_unsat


# ── CUDA kernel ──────────────────────────────────────────────────────────────

_lib = None
_built: Built | None = None


def build() -> Built:
    """Compile ``csrc/ldpc_bp.cu`` with nvcc (once per process) and load it.
    Returns the build record; its log holds the ``-Xptxas -v`` report."""
    global _lib, _built
    if _lib is None:
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        _built = build_shared("ldpc_bp", [nvcc] + NVCC_FLAGS, [_SRC])
        lib = ctypes.CDLL(_built.path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ldpc_bp_decode.argtypes = [p, i, i, i, i, i, p, p, p, p, i, i,
                                       ctypes.c_float, p, p, p]
        lib.ldpc_bp_decode.restype = ctypes.c_int
        _lib = lib
    return _built


def _check_rule(rule: str) -> None:
    if rule not in RULES:
        raise ValueError(f"unknown BP rule {rule!r} (expected one of {RULES})")


def bp_decode_kernel(g, llr: torch.Tensor, max_iter: int = 50,
                     rule: str = "sum_product", alpha: float = 0.75):
    """Batched BP decode: ``llr`` (B, n) contiguous float32 → (bits (B, k)
    uint8, unsat (B,) int32) on the same device. A CUDA tensor launches the
    kernel (``bp_decode_kernel.launches`` counts the launches); a CPU tensor
    runs :func:`bp_decode_reference`. ``bp_decode_kernel.launches`` counts
    the launches of the three slab rules, ``.launches_edge`` those of
    ``sum_product_edge``."""
    _check_rule(rule)
    if llr.dtype != torch.float32:
        raise TypeError(f"llr must be float32, got {llr.dtype}")
    if llr.dim() != 2 or llr.shape[1] != g.n:
        raise ValueError(f"llr must be (B, {g.n}), got {tuple(llr.shape)}")
    if not llr.is_contiguous():
        raise ValueError("llr must be contiguous")
    if llr.device.type == "cpu":
        return bp_decode_reference(g, llr, max_iter, rule, alpha)
    if llr.device.type != "cuda":
        raise ValueError(f"no BP kernel for device {llr.device}")
    B = llr.shape[0]
    bits = torch.empty((B, g.k), dtype=torch.uint8, device=llr.device)
    unsat = torch.empty((B,), dtype=torch.int32, device=llr.device)
    if B == 0:
        return bits, unsat
    build()
    t = graph_tables(g, llr.device)
    scale = float(alpha) if rule == "scaled_min_sum" else 1.0
    with torch.cuda.device(llr.device):
        stream = torch.cuda.current_stream(llr.device).cuda_stream
        err = _lib.ldpc_bp_decode(
            llr.data_ptr(), B, t.n, t.k, t.m, t.D, t.check_bits.data_ptr(),
            t.check_mask.data_ptr(), t.bit_ptr.data_ptr(),
            t.bit_edges.data_ptr(), int(max_iter), _RULE_CODE[rule], scale,
            bits.data_ptr(), unsat.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ldpc_bp_decode launch failed: CUDA error {err}")
    if rule == "sum_product_edge":
        bp_decode_kernel.launches_edge += 1
    else:
        bp_decode_kernel.launches += 1
    return bits, unsat


bp_decode_kernel.launches = 0
bp_decode_kernel.launches_edge = 0


def bp_decode_pallas(g, llr: torch.Tensor, max_iter: int = 50, *,
                     rule: str = "sum_product", alpha: float = 0.75):
    """Counterpart of ``orion_sdr_tpu.ops.bp_decode_pallas``: the batched BP
    kernel under any of the four rules, ``sum_product_edge`` included.
    Takes the graph itself and returns what :func:`bp_decode_kernel`
    returns, (message bits (B, k) uint8, unsatisfied checks (B,) int32)."""
    return bp_decode_kernel(g, llr, max_iter, rule, alpha)
