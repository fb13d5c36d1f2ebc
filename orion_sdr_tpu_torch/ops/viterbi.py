"""Batched soft Viterbi ACS + traceback: the Hopper kernel
``csrc/viterbi.cu`` and its plain torch version, in two radices.

Counterpart of ``orion_sdr_tpu/ops/viterbi.py`` (the Pallas TPU kernels
``_make_kernel``, radix 2, and ``_make_kernel4``, radix 4), with the
semantics of the jnp references in ``orion_sdr_tpu/fec/conv.py``. Two modes:

* terminated (:func:`viterbi_decode_soft_kernel`): a zero-tail-terminated
  punctured stream per row; metrics pinned at state 0, traceback from state
  0;
* chunked (:func:`viterbi_chunks_kernel`): per-lane initial metrics,
  traceback from the argmax of the final metrics (lowest state index on
  ties).

Radix 2 takes one trellis step at a time: z = 1 only where cand_1 > cand_0,
and in the chunked mode the maximum is subtracted after every step (the
terminated mode never renormalises). Radix 4 takes four steps a phase: the
16 candidates of a state, pm[((ns << 4) | idx) & (S−1)] plus a four-step
branch metric, go through a four-level select tree (z1 first, the lower z on
ties at each level) to one 4-bit decision, and the maximum is subtracted
once a phase in both modes. The two radices agree exactly on integer-valued
LLRs; on float LLRs they may part at near-ties. Radix 4 runs where it is
asked for (``radix=4``), or, with ``radix=None``, where ``FORCE_RADIX4`` is
set and the trellis allows it (:func:`pick_radix`), as the JAX package's
``_FORCE_RADIX4`` does.

A CUDA tensor launches the kernel (built with nvcc at first use; any failure
raises); a CPU tensor runs the plain version. Both add, compare and select
in the same order, so on the card they agree bit for bit on any input. The
radix-4 kernel reads its four-step branch sums from a table whose layout
:func:`radix4_sum_table` builds here; :func:`launch_plan` reports the block
size and occupancy a launch takes.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..buildlib import NVCC_FLAGS_NO_FMA as NVCC_FLAGS, PTR, INT, CudaLib
from ..dsp.device import pallas_placed
from ..fec.conv import CONV_CODES, _tables, depuncture_llrs, tail_bits

# trellises longer than this keep their decisions in a global scratch buffer
# (256 bytes a 32-step block a lane) instead of shared memory
MAX_SMEM_STEPS = 200 * 1024 // 8
_NEG = -1e30
# counterpart of orion_sdr_tpu/ops/viterbi.py::_FORCE_RADIX4: with radix=None
# the wrappers take radix 4 wherever the trellis allows it
FORCE_RADIX4 = False
# random GF(2) maps radix4_sum_table tries before it gives up on a code
_R4_MAP_TRIES = 10_000


def pick_radix(n_steps: int, code: str) -> int:
    """The radix a ``radix=None`` call takes: 4 when ``FORCE_RADIX4`` is set,
    the trellis length divides by 4 and the code has at least 16 states (the
    JAX package's dispatch condition), else 2."""
    _, S, *_ = _tables(code)
    return 4 if FORCE_RADIX4 and n_steps % 4 == 0 and S >= 16 else 2


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


@lru_cache(maxsize=None)
def _radix4_tables(code: str):
    """Per state ns and candidate idx = z1 + 2·z2 + 4·z3 + 8·z4: the
    predecessor four steps back, ((ns << 4) | idx) & (S−1), and for each of
    the four steps i whether its branch metric is ±(l0 − l1) rather than
    ±(l0 + l1) (``diff``) and whether it is negated (``neg``). Step i's
    encoder window is bits i..i+K−1 of X = (ns << 4) | idx."""
    K, S, *_ = _tables(code)
    g0, g1 = CONV_CODES[code]["g0"], CONV_CODES[code]["g1"]
    x = (np.arange(S)[:, None] << 4) | np.arange(16)[None, :]
    pred = x & (S - 1)
    diff = np.zeros((4, S, 16), bool)
    neg = np.zeros((4, S, 16), bool)
    for i in range(4):
        w = (x >> i) & ((1 << K) - 1)
        ca = np.vectorize(lambda v: bin(v & g0).count("1") & 1)(w)
        cb = np.vectorize(lambda v: bin(v & g1).count("1") & 1)(w)
        diff[i] = ca != cb
        neg[i] = ca == 1
    return pred, diff, neg


def _r4_patterns(code: str) -> np.ndarray:
    """(S, 16) pattern byte of each radix-4 candidate: bit 2i says step i's
    branch value is ±d (else ±s), bit 2i + 1 that it is negated. A linear
    function of X = (ns << 4) | idx over GF(2)."""
    _, diff, neg = _radix4_tables(code)
    return sum((diff[i].astype(np.int64) << (2 * i))
               | (neg[i].astype(np.int64) << (2 * i + 1)) for i in range(4))


def _r4_bank_conflicts(addr: np.ndarray) -> int:
    """Largest number of distinct table addresses that one shared-memory load
    of the radix-4 kernel (one idx, one state half, the warp's threads) puts
    in one of the 32 banks; 1 means conflict-free."""
    H = addr.shape[0] // 2
    worst = 1
    for half in (0, 1):
        for idx in range(16):
            a = np.unique(addr[half * H:(half + 1) * H, idx])
            worst = max(worst, int(np.bincount(a % 32).max()))
    return worst


@lru_cache(maxsize=None)
def radix4_sum_table(code: str):
    """The radix-4 kernel's table of four-step branch sums, built on the host
    from :func:`_radix4_tables`. Returns ``(index, spec)``:

    * ``index`` (S, 16) uint8: the table address of candidate idx of state
      ns, so that the candidate is ``pm[pred[ns, idx]] + table[index[ns,
      idx]]``;
    * ``spec`` (256,) uint8: the pattern byte (:func:`_r4_patterns`) of the
      sum kept at each address. Every pattern occurs (both codes use all
      256), so the table holds 256 floats a lane and phase.

    Addresses are the patterns put through an invertible GF(2) map chosen so
    that the 32 threads of a warp, each reading one candidate of one state
    half, never meet two addresses in one bank (:func:`_r4_bank_conflicts`).
    The search tries the identity, then up to ``_R4_MAP_TRIES`` seeded random
    maps, and raises ValueError for a code that none of them serves.
    """
    pat = _r4_patterns(code)
    bits = (np.arange(256)[:, None] >> np.arange(8)) & 1        # (256, 8)
    rng = np.random.default_rng(0)
    rows = np.eye(8, dtype=np.int64)
    for _ in range(_R4_MAP_TRIES + 1):
        perm = ((bits @ rows.T) & 1) @ (1 << np.arange(8))      # P → address
        if (len(np.unique(perm)) == 256
                and _r4_bank_conflicts(perm[pat]) == 1):
            spec = np.empty(256, np.uint8)
            spec[perm] = np.arange(256)
            return perm[pat].astype(np.uint8), spec
        rows = rng.integers(0, 2, (8, 8))
    raise ValueError(f"radix 4: no conflict-free table map for code {code!r} "
                     f"in {_R4_MAP_TRIES} tries")


def _acs_traceback4(l0: torch.Tensor, l1: torch.Tensor, pm: torch.Tensor,
                    code: str, chunked: bool) -> torch.Tensor:
    """Radix-4 loop: (L, T) LLR pairs with T % 4 == 0 and (L, S) initial
    metrics → (L, T) uint8 bits. A step's branch value is s = l0 + l1 or
    d = l0 − l1, negated where the coded bit pattern says so; a candidate
    is pm[pred] + ((v0 + v1) + (v2 + v3))."""
    _, S, top, *_ = _tables(code)
    pred, diff, neg = _radix4_tables(code)
    dev = l0.device
    pred_t = torch.as_tensor(pred, dtype=torch.int64, device=dev)
    diff_t = torch.as_tensor(diff, device=dev)
    flip = torch.as_tensor(np.where(neg, -1.0, 1.0), dtype=torch.float32,
                           device=dev)
    L, T = l0.shape
    T4 = T // 4
    s_all = (l0 + l1).t().contiguous()
    d_all = (l0 - l1).t().contiguous()
    idx0 = torch.arange(16, device=dev).expand(L, S, 16)
    decs = torch.empty((T4, L, S), dtype=torch.int64, device=dev)
    for g in range(T4):
        v = [torch.where(diff_t[i], d_all[4 * g + i, :, None, None],
                         s_all[4 * g + i, :, None, None]) * flip[i]
             for i in range(4)]
        val = pm[:, pred_t] + ((v[0] + v[1]) + (v[2] + v[3]))
        idx = idx0
        for _ in range(4):            # z1, z2, z3, z4: pairs adjacent in idx
            d = val[..., 1::2] > val[..., 0::2]
            val = torch.where(d, val[..., 1::2], val[..., 0::2])
            idx = torch.where(d, idx[..., 1::2], idx[..., 0::2])
        decs[g] = idx[..., 0]
        pm = val[..., 0]
        pm = pm - pm.max(dim=-1, keepdim=True).values
    if chunked:
        state = torch.argmax(pm, dim=-1)          # first maximum
    else:
        state = torch.zeros(L, dtype=torch.int64, device=dev)
    bits = torch.empty((L, T), dtype=torch.uint8, device=dev)
    rows = torch.arange(L, device=dev)
    for g in range(T4 - 1, -1, -1):
        for i in range(4):
            bits[:, 4 * g + 3 - i] = ((state >> (top - i)) & 1).to(torch.uint8)
        state = ((state << 4) | decs[g][rows, state]) & (S - 1)
    return bits


def _check_radix(radix: int, n_steps: int, code: str) -> None:
    _, S, *_ = _tables(code)
    if radix == 2:
        return
    if radix != 4:
        raise ValueError(f"radix must be 2 or 4, got {radix}")
    if n_steps % 4 or S < 16:
        raise ValueError(f"radix 4 needs a trellis length divisible by 4 and "
                         f"at least 16 states (got {n_steps} steps, {S} "
                         f"states)")


def viterbi_chunks_reference(c0: torch.Tensor, c1: torch.Tensor,
                             pm0: torch.Tensor, code: str,
                             radix: int = 2) -> torch.Tensor:
    """Plain chunked decode: (L, span) LLR pairs, (L, S) initial metrics →
    (L, span) uint8 bits, margins included."""
    _check_chunks(c0, c1, pm0, code)
    _check_radix(radix, c0.shape[1], code)
    loop = _acs_traceback4 if radix == 4 else _acs_traceback
    return loop(c0, c1, pm0, code, chunked=True)


def viterbi_terminated_reference(llrs: torch.Tensor, info_bits: int,
                                 rate: str, code: str,
                                 radix: int = 2) -> torch.Tensor:
    """Plain terminated decode: (B, n_coded) punctured LLRs → (B,
    info_bits) uint8."""
    _check_llrs(llrs, code)
    _check_radix(radix, info_bits + tail_bits(code), code)
    full = depuncture_llrs(llrs, info_bits, rate, code)
    _, S, *_ = _tables(code)
    pm = full.new_full((full.shape[0], S), _NEG)
    pm[:, 0] = 0.0
    loop = _acs_traceback4 if radix == 4 else _acs_traceback
    bits = loop(full[:, 0::2], full[:, 1::2], pm, code, chunked=False)
    return bits[:, :info_bits]


# ── CUDA kernel ──────────────────────────────────────────────────────────────

_LL = ctypes.c_longlong
_IP = ctypes.POINTER(INT)
_LIB = CudaLib("viterbi", NVCC_FLAGS, {
    "viterbi_acs_traceback": [PTR, PTR, _LL, INT, PTR, INT, INT, INT, INT, INT,
                              INT, PTR, PTR, PTR, PTR, PTR],
    "viterbi_launch_plan": [INT, INT, INT, INT, INT, INT, INT, INT, _IP, _IP,
                            ctypes.POINTER(_LL)]})
_SRC = _LIB.src
build = _LIB.build


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


@lru_cache(maxsize=None)
def _r4_device_tables(code: str, device: torch.device):
    """:func:`radix4_sum_table` on the card: (index, spec) uint8 tensors."""
    index, spec = radix4_sum_table(code)
    return (torch.as_tensor(index, device=device).contiguous(),
            torch.as_tensor(spec, device=device).contiguous())


def launch_plan(L: int, T: int, code: str, radix: int,
                chunked: bool = True, device=None) -> dict:
    """The launch the kernel makes for L lanes of T steps: ``warps`` (lanes a
    block), ``blocks_per_sm`` (resident blocks an SM by
    cudaOccupancyMaxActiveBlocksPerMultiprocessor with that block size and
    shared memory), ``smem`` (bytes a block), ``lanes_per_sm``, ``sms`` and
    ``waves`` (blocks over what the card holds at once, rounded up)."""
    _check_code(code)
    _check_radix(radix, T, code)
    device = torch.device("cuda") if device is None else torch.device(device)
    w, b, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    c = CONV_CODES[code]
    _LIB.call("viterbi_launch_plan", device, L, T, c["K"], c["g0"], c["g1"],
              radix, int(chunked), int(T > MAX_SMEM_STEPS), ctypes.byref(w),
              ctypes.byref(b), ctypes.byref(smem))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid = -(-L // w.value)
    return {"warps": w.value, "blocks_per_sm": b.value, "smem": smem.value,
            "lanes_per_sm": w.value * b.value, "sms": sms,
            "waves": -(-grid // (b.value * sms))}


def _launch(l0: torch.Tensor, l1: torch.Tensor, pm0, code: str,
            radix: int) -> torch.Tensor:
    """Allocates the (L, T) bits, the global decision scratch where T
    needs it (both radices: 256 bytes a 32-step block) and the radix-4
    tables, and launches on them."""
    L, T = l0.shape
    dev = l0.device
    bits = torch.empty((L, T), dtype=torch.uint8, device=dev)
    scratch = (torch.empty((L, -(-T // 32) * 256), dtype=torch.uint8,
                           device=dev)
               if T > MAX_SMEM_STEPS else None)
    r4 = _r4_device_tables(code, dev) if radix == 4 else None
    _launch_into(l0, l1, pm0, code, radix, r4, bits, scratch)
    return bits


def _launch_into(l0: torch.Tensor, l1: torch.Tensor, pm0, code: str,
                 radix: int, r4, bits: torch.Tensor, scratch) -> None:
    """Launches the kernel on the caller's buffers: ``l0``/``l1`` (L, T)
    float32 LLR views of one stride (a row's, a step's), ``pm0`` (L, S)
    contiguous initial metrics or None (state 0 pinned), ``r4`` the
    radix-4 tables (index, spec) or None, ``bits`` (L, T) uint8 and
    ``scratch`` the global decisions (None when T <= MAX_SMEM_STEPS), all
    on the card."""
    L, T = bits.shape
    c = CONV_CODES[code]
    index, spec = (None, None) if r4 is None else r4
    _LIB.launch("viterbi_acs_traceback", l0.device, l0.data_ptr(),
                l1.data_ptr(), l0.stride(0), l0.stride(1),
                None if pm0 is None else pm0.data_ptr(), L, T, c["K"],
                c["g0"], c["g1"], radix,
                None if index is None else index.data_ptr(),
                None if spec is None else spec.data_ptr(), bits.data_ptr(),
                None if scratch is None else scratch.data_ptr())


def _count(wrapper, radix: int) -> None:
    if radix == 4:
        wrapper.launches_radix4 += 1
    else:
        wrapper.launches += 1


def viterbi_chunks_kernel(c0: torch.Tensor, c1: torch.Tensor,
                          pm0: torch.Tensor, code: str,
                          radix: int | None = None) -> torch.Tensor:
    """Chunked decode of L lanes: ``c0``/``c1`` (L, span) contiguous float32
    LLR pairs, ``pm0`` (L, S) initial metrics → (L, span) uint8 bits on the
    same device, margins included. ``radix`` 2 or 4, or None for
    :func:`pick_radix`. A CUDA tensor launches the kernel
    (``viterbi_chunks_kernel.launches`` counts radix-2 launches,
    ``.launches_radix4`` radix-4 ones); a CPU tensor runs
    :func:`viterbi_chunks_reference`."""
    _check_chunks(c0, c1, pm0, code)
    L, T = c0.shape
    radix = pick_radix(T, code) if radix is None else radix
    _check_radix(radix, T, code)
    if c0.device.type == "cpu":
        return viterbi_chunks_reference(c0, c1, pm0, code, radix)
    if L == 0 or T == 0:
        return torch.empty((L, T), dtype=torch.uint8, device=c0.device)
    bits = _launch(c0, c1, pm0, code, radix)
    _count(viterbi_chunks_kernel, radix)
    return bits


def viterbi_decode_soft_kernel(llrs: torch.Tensor, info_bits: int,
                               rate: str, code: str,
                               radix: int | None = None) -> torch.Tensor:
    """Terminated decode: ``llrs`` (B, n_coded) contiguous float32
    punctured LLRs → (B, info_bits) uint8 on the same device. ``radix`` 2 or
    4, or None for :func:`pick_radix` of the info_bits + tail steps. A CUDA
    tensor depunctures on the card and launches the kernel
    (``viterbi_decode_soft_kernel.launches`` counts radix-2 launches,
    ``.launches_radix4`` radix-4 ones); a CPU tensor runs
    :func:`viterbi_terminated_reference`."""
    _check_llrs(llrs, code)
    T = info_bits + tail_bits(code)
    radix = pick_radix(T, code) if radix is None else radix
    _check_radix(radix, T, code)
    if llrs.device.type == "cpu":
        return viterbi_terminated_reference(llrs, info_bits, rate, code,
                                            radix)
    B = llrs.shape[0]
    if B == 0:
        return torch.empty((0, info_bits), dtype=torch.uint8,
                           device=llrs.device)
    full = depuncture_llrs(llrs, info_bits, rate, code).contiguous()
    bits = _launch(full[:, 0::2], full[:, 1::2], None, code, radix)
    _count(viterbi_decode_soft_kernel, radix)
    return bits[:, :info_bits]


viterbi_chunks_kernel.launches = 0
viterbi_chunks_kernel.launches_radix4 = 0
viterbi_decode_soft_kernel.launches = 0
viterbi_decode_soft_kernel.launches_radix4 = 0


# ── the JAX package's entry points ───────────────────────────────────────────


def viterbi_chunks_pallas(c0, c1, pm0, code: str,
                          interpret=None) -> torch.Tensor:
    """Counterpart of ``orion_sdr_tpu.ops.viterbi_chunks_pallas``, with its
    arguments and result: ``c0``/``c1`` (L, span) LLR pairs and ``pm0``
    (L, S) initial metrics → (L, span) float32 bit planes, margins
    included. ``interpret=True`` or a CPU tensor runs the plain version;
    otherwise a tensor stays on its device and host data goes to the card,
    where :func:`viterbi_chunks_kernel` launches (radix as
    :func:`pick_radix` picks). Every span launches it: the JAX wrapper
    sends odd spans to its jnp path because its Pallas kernel steps two
    trellis stages at a time, and the radix-2 kernel here steps one."""
    c0, c1, pm0 = (pallas_placed(x, interpret) for x in (c0, c1, pm0))
    return viterbi_chunks_kernel(c0, c1, pm0, code).to(torch.float32)


def viterbi_decode_soft_pallas(coded_llrs, info_bits: int, rate: str = "1/2",
                               code: str = "k5",
                               interpret=None) -> torch.Tensor:
    """Counterpart of ``orion_sdr_tpu.ops.viterbi_decode_soft_pallas``, with
    its arguments and result: (B, n_coded) or (n_coded,) punctured LLRs →
    (B, info_bits) or (info_bits,) uint8, terminated. Placement as
    :func:`viterbi_chunks_pallas`; the card runs
    :func:`viterbi_decode_soft_kernel` for every trellis length, odd ones
    included."""
    llrs = pallas_placed(coded_llrs, interpret)
    squeeze = llrs.dim() == 1
    if squeeze:
        llrs = llrs[None, :]
    bits = viterbi_decode_soft_kernel(llrs, info_bits, rate, code)
    return bits[0] if squeeze else bits
