"""Batched BCH and Reed–Solomon outer decoding: the Hopper kernel
``csrc/outer_fec.cu`` beside its plain torch version.

The JAX package decodes the outer code on the device with jnp programs and
no Pallas kernel (``orion_sdr_tpu/fec/bch_device.py:87``
``bch_decode_batch_device`` and ``:206`` ``rs_decode_batch_device``). Their
Berlekamp–Massey loop, transcribed op for op into eager torch, would be
hundreds of small launches a call; the kernel runs one codeword a thread
and the whole batch in one launch. It computes the same function bit for
bit: the plain versions are ``fec/bch_device.py::bch_decode_batch_reference``
and ``::rs_decode_batch_reference``.

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
    "outer_bch_decode": [PTR, INT, INT, INT, INT, PTR, PTR, PTR, PTR],
    "outer_rs_decode": [PTR, INT, INT, INT, PTR, PTR, PTR, PTR]})
build = _LIB.build


_TABLES: dict = {}


def _gf_tables(device: torch.device) -> torch.Tensor:
    """GF(256) exp[512] then log[256] as one uint8 tensor on ``device``."""
    key = str(device)
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = torch.as_tensor(
            np.concatenate([GF_EXP, GF_LOG]).astype(np.uint8), device=device)
    return t


def _check_rows(x: torch.Tensor, n: int, what: str) -> None:
    if x.dtype != torch.uint8:
        raise TypeError(f"{what} must be uint8, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != n:
        raise ValueError(f"{what} must be (B, {n}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _launch(fn: str, x: torch.Tensor, k: int, *args):
    """Allocates (B, k) uint8 messages and (B,) int32 flags on ``x``'s card
    and launches ``fn`` on the current stream; raises on a CUDA error."""
    B = x.shape[0]
    out = torch.empty((B, k), dtype=torch.uint8, device=x.device)
    ok = torch.empty((B,), dtype=torch.int32, device=x.device)
    if B == 0:
        return out, ok, False
    _LIB.launch(fn, x.device, x.data_ptr(), B, *args,
                _gf_tables(x.device).data_ptr(), out.data_ptr(),
                ok.data_ptr())
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
    out, ok, launched = _launch("outer_bch_decode", bits, k, n, k, t)
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
    out, ok, launched = _launch("outer_rs_decode", received, n - n_parity,
                                n, n_parity)
    rs_decode_kernel.launches += launched
    return out, ok


bch_decode_kernel.launches = 0
rs_decode_kernel.launches = 0
