"""Torch port: the frame CRCs (``fec/crc.py``, and the chain's one-frame
check built on them) against the JAX package's on every input kind they
take, and
``decode_chain_batch``'s batched CRC stage against the JAX package's
``decode_chain_batch`` and a per-frame loop of the port's ``decode_chain``:
CRC none / 16 / 32, outer none / BCH / RS, byte scramblers before the outer
code, frames whose CRC fails, and plans whose frames are short of their CRC
or of their bits."""

import dataclasses

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import orion_sdr_tpu.frame as J
from orion_sdr_tpu.fec import crc as jax_crc
from orion_sdr_tpu.frame.chain import decode_chain_batch as jax_decode_batch

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch.fec import crc as port_crc

torch.set_num_threads(1)

KNOWN = {"crc16": 0x29B1, "crc32": 0xCBF43926}     # over b"123456789"
LENGTHS = [0, 1, 2, 14, 1500, 1504, 4096]
KINDS = {
    "bytes": bytes,
    "bytearray": bytearray,
    "memoryview": lambda a: memoryview(bytes(a)),
    "contiguous": lambda a: a,
    "strided": lambda a: np.stack([a, ~a], axis=1)[:, 0],
    "list": lambda a: a.tolist(),
}
CRC_CASES = [(name, n, kind) for name in sorted(KNOWN) for n in LENGTHS
             for kind in KINDS] + [(name, "known", "bytes")
                                   for name in sorted(KNOWN)]


@pytest.mark.parametrize("name,length,kind", CRC_CASES)
def test_crc_matches_the_jax_package(name, length, kind):
    if length == "known":
        raw = np.frombuffer(b"123456789", np.uint8)
    else:
        raw = np.random.default_rng(length).integers(
            0, 256, length).astype(np.uint8)
    data = KINDS[kind](raw)
    if kind == "strided" and length > 1:
        assert not data.flags.c_contiguous
    got = getattr(port_crc, name)(data)
    assert type(got) is int
    assert got == getattr(jax_crc, name)(data)
    if length == "known":
        assert got == KNOWN[name]
    if kind in ("contiguous", "strided"):
        # the chain's one-frame check, on a frame of either layout
        framed = P.append_crc(name, raw)
        if kind == "strided":
            framed = np.stack([framed, ~framed], axis=1)[:, 0]
        body, ok = P.check_and_strip_crc(name, framed)
        assert ok is True and np.array_equal(body, raw)
        framed[-1] ^= 1
        assert P.check_and_strip_crc(name, framed)[1] is False


OUTERS = {
    "none": lambda M: M.OuterFec.none(),
    "bch": lambda M: M.OuterFec.bch(8),
    "rs": lambda M: M.OuterFec.reed_solomon(60, 8),
}
SCRAMBLERS = {
    "none": lambda M: M.ScramblerKind.none(),
    "per_frame": lambda M: M.ScramblerKind.additive(0b110, 7, 0,
                                                     per_frame=True),
    "dvb": lambda M: M.ScramblerKind.dvb_t_energy_dispersal(),
}
N_BYTES = 40
SEEDS = [11, 22, 33, 44, 55]
BAD = (1, 3)           # a payload bit flips after the CRC is appended
WRECKED = 4            # 20 coded bits flip in the first outer codeword's
                       # parity (in the payload without an outer code)
# (crc, outer, scrambler, plan): every CRC, outer code and scrambler on the
# block plan, then frames short of their CRC and short of their bits
CHAIN_CASES = [(c, o, s, "whole") for c in ("none", "crc16", "crc32")
               for o in sorted(OUTERS) for s in sorted(SCRAMBLERS)] + [
    ("crc32", "bch", "none", "short_of_crc"),
    ("crc16", "none", "per_frame", "short_of_crc"),
    ("crc32", "rs", "dvb", "short_of_bits"),
]


def _chain(M, outer, scrambler):
    return (OUTERS[outer](M), M.InnerFec.none(), M.InterleaverKind.none(),
            M.InterleaverKind.none(), SCRAMBLERS[scrambler](M),
            M.SCRAMBLER_BEFORE_OUTER)


def _plan(M, crc, args, shape):
    plan = M.block_plan(N_BYTES, crc, *args[:4])
    if shape == "short_of_crc":
        return dataclasses.replace(plan, framed_bytes=1)
    if shape == "short_of_bits":
        return dataclasses.replace(plan, framed_bytes=plan.framed_bytes + 64)
    return plan


def _llrs(crc, outer, args, plan):
    """(B, coded) LLRs of ±3: each row's framed bytes (CRC appended, then
    BAD's rows corrupted) through the rest of the port's chain."""
    rng = np.random.default_rng(0xC3C)
    rows = []
    for b, seed in enumerate(SEEDS):
        framed = P.append_crc(crc, rng.integers(0, 256, N_BYTES).astype(
            np.uint8))
        if b in BAD:
            framed[5] ^= 0x10
        coded = P.encode_chain(framed, "none", *args, seed,
                               device="cpu").numpy()
        assert len(coded) == plan.coded_bits
        llr = np.where(coded == 0, 3.0, -3.0).astype(np.float32)
        if b == WRECKED:
            parity = {"none": 0, "bch": P.BCH_INFO_BITS, "rs": 8 * 52}[outer]
            llr[parity + 5: parity + 25] *= -1
        rows.append(llr)
    return np.stack(rows)


def _same(a, b):
    return (a is None and b is None) or (
        a is not None and b is not None and a.dtype == b.dtype == np.uint8
        and np.array_equal(a, b))


@pytest.mark.parametrize("crc,outer,scrambler,shape", CHAIN_CASES)
def test_batched_crc_stage_matches_jax_and_the_frame_loop(crc, outer,
                                                          scrambler, shape):
    pargs, jargs = _chain(P, outer, scrambler), _chain(J, outer, scrambler)
    pplan, jplan = (_plan(P, crc, pargs, shape), _plan(J, crc, jargs, shape))
    assert dataclasses.asdict(pplan) == dataclasses.asdict(jplan)
    llrs = _llrs(crc, outer, pargs, P.block_plan(N_BYTES, crc, *pargs[:4]))
    datas, oks = P.decode_chain_batch(torch.as_tensor(llrs), pplan, crc,
                                      *pargs, SEEDS)
    jdatas, joks = jax_decode_batch(llrs, jplan, crc, *jargs, SEEDS)
    assert len(datas) == len(jdatas) == len(SEEDS)
    assert oks.dtype == bool and np.array_equal(oks, joks)
    assert all(_same(d, j) for d, j in zip(datas, jdatas))
    for b, seed in enumerate(SEEDS):
        try:
            one, ok = P.decode_chain(torch.as_tensor(llrs[b]), pplan, crc,
                                     *pargs, seed)
        except P.RxError:
            one, ok = None, False
        assert _same(datas[b], one) and oks[b] == ok
    if shape != "whole":
        assert datas == [None] * len(SEEDS) and not oks.any()
        return
    # the clean rows pass; a corrupted payload fails any CRC
    assert oks[0] and oks[2]
    assert all(oks[b] == (crc == "none") for b in BAD)
