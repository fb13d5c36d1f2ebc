"""Batched soft Viterbi ACS + traceback: the Hopper kernel
``csrc/viterbi.cu`` and its plain torch version.

Counterpart of ``orion_sdr_tpu/ops/viterbi.py`` (the Pallas TPU kernel
``_make_kernel``), with the semantics of the jnp references in
``orion_sdr_tpu/fec/conv.py``. Two modes:

* terminated (:func:`viterbi_decode_soft_kernel`): a zero-tail-terminated
  punctured stream per row; metrics pinned at state 0, never renormalised,
  traceback from state 0;
* chunked (:func:`viterbi_chunks_kernel`): per-lane initial metrics, the
  per-step maximum subtracted after every step, traceback from the argmax of
  the final metrics (lowest state index on ties).

A CUDA tensor launches the kernel (built with nvcc at first use; any failure
raises); a CPU tensor runs the plain version. Both add, compare and select
in the same order, so on the card they agree bit for bit on any input.
"""

from __future__ import annotations

import ctypes
import os
import shutil

import torch

from ..buildlib import Built, build_shared
from ..fec.conv import CONV_CODES, _tables, depuncture_llrs, tail_bits

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "viterbi.cu")
# -fmad=false: no fused multiply-add contraction, so the kernel's float
# arithmetic rounds exactly like the plain version's separate tensor ops
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]
# trellises longer than this keep their decisions in a global scratch buffer
# (8 bytes a step a lane) instead of shared memory
MAX_SMEM_STEPS = 200 * 1024 // 8
_NEG = -1e30


# ── plain torch version ──────────────────────────────────────────────────────


def _acs_traceback(l0: torch.Tensor, l1: torch.Tensor, pm: torch.Tensor,
                   code: str, chunked: bool) -> torch.Tensor:
    """Shared loop: (L, T) LLR pairs and (L, S) initial metrics → (L, T)
    uint8 bits."""
    _, S, top, _, _, prev, sign0, sign1 = _tables(code)
    dev = l0.device
    prev_t = torch.as_tensor(prev, dtype=torch.int64, device=dev)
    s0 = torch.as_tensor(sign0, device=dev)
    s1 = torch.as_tensor(sign1, device=dev)
    L, T = l0.shape
    lt0 = l0.t().contiguous()
    lt1 = l1.t().contiguous()
    decs = torch.empty((T, L, S), dtype=torch.bool, device=dev)
    for t in range(T):
        cand = pm[:, prev_t] + s0 * lt0[t, :, None, None] \
            + s1 * lt1[t, :, None, None]
        d = cand[..., 1] > cand[..., 0]
        pm = torch.where(d, cand[..., 1], cand[..., 0])
        if chunked:
            pm = pm - pm.max(dim=-1, keepdim=True).values
        decs[t] = d
    if chunked:
        state = torch.argmax(pm, dim=-1)          # first maximum
    else:
        state = torch.zeros(L, dtype=torch.int64, device=dev)
    bits = torch.empty((L, T), dtype=torch.uint8, device=dev)
    rows = torch.arange(L, device=dev)
    low = (S >> 1) - 1
    for t in range(T - 1, -1, -1):
        bits[:, t] = (state >> top).to(torch.uint8)
        z = decs[t][rows, state].to(torch.int64)
        state = ((state & low) << 1) | z
    return bits


def viterbi_chunks_reference(c0: torch.Tensor, c1: torch.Tensor,
                             pm0: torch.Tensor, code: str) -> torch.Tensor:
    """Plain chunked decode: (L, span) LLR pairs, (L, S) initial metrics →
    (L, span) uint8 bits, margins included."""
    _check_chunks(c0, c1, pm0, code)
    return _acs_traceback(c0, c1, pm0, code, chunked=True)


def viterbi_terminated_reference(llrs: torch.Tensor, info_bits: int,
                                 rate: str, code: str) -> torch.Tensor:
    """Plain terminated decode: (B, n_coded) punctured LLRs → (B,
    info_bits) uint8."""
    _check_llrs(llrs, code)
    full = depuncture_llrs(llrs, info_bits, rate, code)
    _, S, *_ = _tables(code)
    pm = full.new_full((full.shape[0], S), _NEG)
    pm[:, 0] = 0.0
    bits = _acs_traceback(full[:, 0::2], full[:, 1::2], pm, code,
                          chunked=False)
    return bits[:, :info_bits]


# ── CUDA kernel ──────────────────────────────────────────────────────────────

_lib = None
_built: Built | None = None


def build() -> Built:
    """Compile ``csrc/viterbi.cu`` with nvcc (once per process) and load it.
    Returns the build record; its log holds the ``-Xptxas -v`` report."""
    global _lib, _built
    if _lib is None:
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        _built = build_shared("viterbi", [nvcc] + NVCC_FLAGS, [_SRC])
        lib = ctypes.CDLL(_built.path)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.viterbi_acs_traceback.argtypes = [p, p, ll, i, p, i, i, i, i, i,
                                              p, p, p]
        lib.viterbi_acs_traceback.restype = ctypes.c_int
        _lib = lib
    return _built


def _check_code(code: str) -> None:
    if code not in CONV_CODES:
        raise ValueError(f"unknown convolutional code {code!r} (expected one "
                         f"of {sorted(CONV_CODES)})")


def _check_f32(name: str, x: torch.Tensor, dim: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.dim() != dim:
        raise ValueError(f"{name} must have {dim} dimensions, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no Viterbi kernel for device {x.device}")


def _check_chunks(c0, c1, pm0, code: str) -> None:
    _check_code(code)
    _, S, *_ = _tables(code)
    for name, x in (("c0", c0), ("c1", c1), ("pm0", pm0)):
        _check_f32(name, x, 2)
    if c1.shape != c0.shape:
        raise ValueError(f"c0 {tuple(c0.shape)} and c1 {tuple(c1.shape)} "
                         "differ in shape")
    if pm0.shape != (c0.shape[0], S):
        raise ValueError(f"pm0 must be ({c0.shape[0]}, {S}), got "
                         f"{tuple(pm0.shape)}")
    if c1.device != c0.device or pm0.device != c0.device:
        raise ValueError("c0, c1 and pm0 must be on one device")


def _check_llrs(llrs, code: str) -> None:
    _check_code(code)
    _check_f32("llrs", llrs, 2)


def _launch(l0_ptr: int, l1_ptr: int, ld: int, es: int, pm0, L: int, T: int,
            code: str, device) -> torch.Tensor:
    build()
    c = CONV_CODES[code]
    bits = torch.empty((L, T), dtype=torch.uint8, device=device)
    scratch = (torch.empty((L, T, 2), dtype=torch.int32, device=device)
               if T > MAX_SMEM_STEPS else None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _lib.viterbi_acs_traceback(
            l0_ptr, l1_ptr, ld, es, None if pm0 is None else pm0.data_ptr(),
            L, T, c["K"], c["g0"], c["g1"], bits.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"viterbi_acs_traceback launch failed: CUDA error "
                           f"{err}")
    return bits


def viterbi_chunks_kernel(c0: torch.Tensor, c1: torch.Tensor,
                          pm0: torch.Tensor, code: str) -> torch.Tensor:
    """Chunked decode of L lanes: ``c0``/``c1`` (L, span) contiguous float32
    LLR pairs, ``pm0`` (L, S) initial metrics → (L, span) uint8 bits on the
    same device, margins included. A CUDA tensor launches the kernel
    (``viterbi_chunks_kernel.launches`` counts the launches); a CPU tensor
    runs :func:`viterbi_chunks_reference`."""
    _check_chunks(c0, c1, pm0, code)
    if c0.device.type == "cpu":
        return viterbi_chunks_reference(c0, c1, pm0, code)
    L, T = c0.shape
    if L == 0 or T == 0:
        return torch.empty((L, T), dtype=torch.uint8, device=c0.device)
    bits = _launch(c0.data_ptr(), c1.data_ptr(), T, 1, pm0, L, T, code,
                   c0.device)
    viterbi_chunks_kernel.launches += 1
    return bits


def viterbi_decode_soft_kernel(llrs: torch.Tensor, info_bits: int,
                               rate: str, code: str) -> torch.Tensor:
    """Terminated decode: ``llrs`` (B, n_coded) contiguous float32
    punctured LLRs → (B, info_bits) uint8 on the same device. A CUDA tensor
    depunctures on the card and launches the kernel
    (``viterbi_decode_soft_kernel.launches`` counts the launches); a CPU
    tensor runs :func:`viterbi_terminated_reference`."""
    _check_llrs(llrs, code)
    if llrs.device.type == "cpu":
        return viterbi_terminated_reference(llrs, info_bits, rate, code)
    B = llrs.shape[0]
    T = info_bits + tail_bits(code)
    if B == 0:
        return torch.empty((0, info_bits), dtype=torch.uint8,
                           device=llrs.device)
    full = depuncture_llrs(llrs, info_bits, rate, code).contiguous()
    bits = _launch(full.data_ptr(), full.data_ptr() + 4, 2 * T, 2, None, B,
                   T, code, llrs.device)
    viterbi_decode_soft_kernel.launches += 1
    return bits[:, :info_bits]


viterbi_chunks_kernel.launches = 0
viterbi_decode_soft_kernel.launches = 0
