"""Batched BCH and Reed–Solomon outer decoding: the Hopper kernel
``csrc/outer_fec.cu`` beside its plain torch version.

The JAX package decodes the outer code on the device with jnp programs and
no Pallas kernel (``orion_sdr_tpu/fec/bch_device.py:87``
``bch_decode_batch_device`` and ``:206`` ``rs_decode_batch_device``). Their
Berlekamp–Massey loop, transcribed op for op into eager torch, would be
hundreds of small launches a call; the kernel runs a group of lanes a
codeword and the whole batch in one launch (:func:`launch_plan`). It
computes the same function bit for bit: the plain versions are
``fec/bch_device.py::bch_decode_batch_reference`` and
``::rs_decode_batch_reference``.

:func:`bch_decode_kernel` and :func:`rs_decode_kernel` launch the kernel for
a CUDA tensor (built with nvcc at first use; a failed build or launch
raises) and run the plain version for a CPU tensor. Each counts its launches
in ``.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..buildlib import NVCC_FLAGS, PTR, INT, CudaLib
from ..fec.bch_device import (MAX_DEVICE_T, bch_decode_batch_reference,
                              rs_decode_batch_reference)
from ..fec.galois import GF_EXP, GF_LOG

# integer arithmetic only: no float flags matter for exactness
_LIB = CudaLib("outer_fec", NVCC_FLAGS, {
    "outer_bch_decode": [PTR, INT, INT, INT, INT, PTR, PTR, INT, INT, PTR,
                         PTR, PTR],
    "outer_rs_decode": [PTR, INT, INT, INT, PTR, INT, INT, PTR, PTR, PTR]})
build = _LIB.build

# Lanes a codeword, by code (the kernel takes 16 or 32; Berlekamp–Massey
# holds one of t + 2 <= 10 coefficients a lane). Set from chip_smoke.py's
# sweep [18] on an NVIDIA H100 80GB HBM3 at its 700 W power limit.
LANES = {"bch": 16, "rs": 32}
# A launch aims at this many blocks an SM before it puts more than one warp
# of codewords in a block (a block holds at most MAX_THREADS threads).
BLOCKS_PER_SM = 8
MAX_THREADS = 256

_TABLES: dict = {}
_SMS: dict = {}


def _gf_tables(device: torch.device) -> torch.Tensor:
    """GF(256) exp[512] then log[256] as one uint8 tensor on ``device``."""
    key = str(device)
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = torch.as_tensor(
            np.concatenate([GF_EXP, GF_LOG]).astype(np.uint8), device=device)
    return t


def bch_syndrome_words(n: int, t: int) -> np.ndarray:
    """(n,) uint64: byte i of word p is a^((2i+1)·(254 − p)) for i < t, the
    odd syndromes' terms of a set bit p of a BCH(n, ·, t) word."""
    deg = 254 - np.arange(n)
    w = np.zeros(n, np.uint64)
    for i in range(t):
        w |= GF_EXP[((2 * i + 1) * deg) % 255].astype(np.uint64) << \
            np.uint64(8 * i)
    return w


def _bch_words(n: int, t: int, device: torch.device) -> torch.Tensor:
    key = ("bch", n, t, str(device))
    w = _TABLES.get(key)
    if w is None:
        w = _TABLES[key] = torch.as_tensor(
            bch_syndrome_words(n, t).view(np.int64), device=device)
    return w


def plan_for(kind: str, B: int, sms: int) -> dict:
    """The launch for B codewords of ``kind`` ("bch" or "rs") on a card of
    ``sms`` SMs: ``lanes`` a codeword (:data:`LANES`), ``groups_per_block``
    codewords a block (a whole number of warps, at most MAX_THREADS
    threads, and few enough that the grid reaches BLOCKS_PER_SM blocks an
    SM where B allows), ``threads`` and ``grid``. Block b decodes rows
    b·groups_per_block + g, g < groups_per_block."""
    G = LANES[kind]
    if G not in (16, 32):
        raise ValueError(f"the outer-code kernel takes 16 or 32 lanes, not "
                         f"{G}")
    per_warp = 32 // G
    groups = -(-max(B, 1) // (sms * BLOCKS_PER_SM))
    groups = -(-groups // per_warp) * per_warp
    groups = max(per_warp, min(MAX_THREADS // G, groups))
    return {"lanes": G, "groups_per_block": groups, "threads": G * groups,
            "grid": -(-B // groups), "sms": sms}


def launch_plan(kind: str, B: int, device=None) -> dict:
    """:func:`plan_for` on the CUDA ``device`` (default: the current one),
    its SM count queried once per device and kept."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    sms = _SMS.get(device.index)
    if sms is None:
        sms = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return plan_for(kind, B, sms)


def _check_rows(x: torch.Tensor, n: int, what: str) -> None:
    if x.dtype != torch.uint8:
        raise TypeError(f"{what} must be uint8, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != n:
        raise ValueError(f"{what} must be (B, {n}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _launch(fn: str, kind: str, x: torch.Tensor, k: int, args, tables):
    """Allocates (B, k) uint8 messages and (B,) int32 flags on ``x``'s card
    and launches ``fn`` on the current stream at :func:`launch_plan`'s
    lanes and groups; raises on a CUDA error."""
    B = x.shape[0]
    out = torch.empty((B, k), dtype=torch.uint8, device=x.device)
    ok = torch.empty((B,), dtype=torch.int32, device=x.device)
    if B == 0:
        return out, ok, False
    plan = launch_plan(kind, B, x.device)
    _LIB.launch(fn, x.device, x.data_ptr(), B, *args,
                *[t.data_ptr() for t in tables], plan["lanes"],
                plan["groups_per_block"], out.data_ptr(), ok.data_ptr())
    return out, ok, True


def bch_decode_kernel(n: int, k: int, t: int, bits: torch.Tensor):
    """BCH(n, k, t) decode of (B, n) uint8 bit codewords (low bit of each
    byte) → ((B, k) uint8 message bits, (B,) int32 ok flags) on the same
    device; failed rows hold the systematic prefix. 1 <= t <= 8, k < n <=
    255."""
    _check_rows(bits, n, "bits")
    if not (1 <= t <= MAX_DEVICE_T and 0 < k < n <= 255):
        raise ValueError(f"no outer-code kernel for BCH(n={n}, k={k}, t={t})")
    if bits.device.type == "cpu":
        return bch_decode_batch_reference(n, k, t, bits)
    if bits.device.type != "cuda":
        raise ValueError(f"no outer-code kernel for device {bits.device}")
    out, ok, launched = _launch(
        "outer_bch_decode", "bch", bits, k, (n, k, t),
        (_gf_tables(bits.device), _bch_words(n, t, bits.device)))
    bch_decode_kernel.launches += launched
    return out, ok


def rs_decode_kernel(n: int, n_parity: int, received: torch.Tensor):
    """RS(n, n − n_parity) decode of (B, n) uint8 codewords → ((B, k) uint8
    messages, (B,) int32 ok flags) on the same device; failed rows hold the
    systematic prefix. n_parity even, 2..16; n_parity < n <= 255."""
    _check_rows(received, n, "received")
    if (n_parity % 2 or not 1 <= n_parity // 2 <= MAX_DEVICE_T
            or not n_parity < n <= 255):
        raise ValueError(f"no outer-code kernel for RS(n={n}, "
                         f"n_parity={n_parity})")
    if received.device.type == "cpu":
        return rs_decode_batch_reference(n, n_parity, received)
    if received.device.type != "cuda":
        raise ValueError(f"no outer-code kernel for device {received.device}")
    out, ok, launched = _launch("outer_rs_decode", "rs", received,
                                n - n_parity, (n, n_parity),
                                (_gf_tables(received.device),))
    rs_decode_kernel.launches += launched
    return out, ok


bch_decode_kernel.launches = 0
rs_decode_kernel.launches = 0
