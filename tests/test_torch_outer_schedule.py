"""Torch port: the outer-code kernel's schedule, modelled on the CPU.

``csrc/outer_fec.cu`` decodes a BCH or RS codeword with a group of G lanes
(G = 16 or 32). Lane l owns positions l, l + G, ...: it keeps partial
syndromes of its own bytes (RS: 2t bytes; BCH: one 64-bit word of the odd
syndromes, from ``ops/outer_fec.py::bch_syndrome_words``), and the group
XOR-reduces them by shuffles (lane ^ o for o = G/2 .. 1). A row with a
nonzero syndrome runs Berlekamp–Massey with coefficient i on lane i: the
syndrome S_(n−i) reaches lane i by a shuffle up the lanes, delta is a
16-lane XOR reduction of σ_i·S_(n−i), and every lane decides the reset
alike. Chien runs by position (each lane its own positions, its roots in a
bit mask); the lane that owns a root computes its Forney magnitude (RS) and
folds its correction into the residual syndromes, which the group reduces
with the root count, bad_dv and, for RS, σ's degree (a ballot of the lanes
whose coefficient is nonzero). An accepted row's lanes apply their own
corrections.

``bch_model`` and ``rs_model`` below are that schedule, lane by lane, in
numpy. They must equal ``bch_decode_batch_reference``,
``rs_decode_batch_reference`` and the JAX package's device decoders bit for
bit (messages and flags on every row, failed rows included), which holds
the kernel's data flow to the plain version before any card runs it. The plain versions correct every root;
the kernel keeps no cut because σ_0 = 1 makes σ a nonzero polynomial of
degree <= t + 1 with at most t + 1 roots in the window, which the model
asserts on every row.
"""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from orion_sdr_tpu.fec import bch_device as JB

from orion_sdr_tpu_torch.fec import Bch, ReedSolomon
from orion_sdr_tpu_torch.fec import bch_device as PB
from orion_sdr_tpu_torch.fec.galois import GF_EXP, GF_LOG
from orion_sdr_tpu_torch.frame import chain
from orion_sdr_tpu_torch.ops import outer_fec

# one thread per test worker, as in every tests/test_torch_*.py
torch.set_num_threads(1)

EXP = GF_EXP.astype(np.int64)
LOG = GF_LOG.astype(np.int64)
BM_LANES = 16
LANE_WIDTHS = (16, 32)      # the G the kernel takes
ROWS = 48


def gmul(a, b):
    return np.where((a != 0) & (b != 0), EXP[LOG[a] + LOG[b]], 0)


def ginv(a):
    return np.where(a != 0, EXP[255 - LOG[a]], 0)


def xor_all(v, width):
    """__shfl_xor_sync over ``width`` lanes, offsets width/2 .. 1: every
    lane ends with the XOR of its block of ``width`` lanes."""
    lanes = np.arange(v.shape[1])
    for o in (16, 8, 4, 2, 1):
        if o < width:
            v = v ^ v[:, lanes ^ o]
    return v


def sum_all(v, width):
    lanes = np.arange(v.shape[1])
    for o in (16, 8, 4, 2, 1):
        if o < width:
            v = v + v[:, lanes ^ o]
    return v


def shfl_up(v):
    """__shfl_up_sync by 1: lane i takes lane i − 1's value, lane 0 its
    own."""
    return np.concatenate([v[:, :1], v[:, :-1]], axis=1)


def berlekamp_massey(s, cap, start, G):
    """Lane-held BM over iterations start .. len(s) − 1 on (B, len(s))
    syndromes: returns (B, G) σ_i on lane i (0 on lanes >= cap)."""
    B = s.shape[0]
    lane = np.arange(G)[None]
    sig = np.broadcast_to(lane == 0, (B, G)).astype(np.int64)
    bx = np.broadcast_to(lane == 1, (B, G)).astype(np.int64)
    cur = np.zeros((B, G), np.int64)
    l = np.zeros((B, G), np.int64)
    for nn in range(start, s.shape[1]):
        cur = shfl_up(cur)
        cur[:, 0] = s[:, nn]
        delta = xor_all(gmul(sig, cur), BM_LANES)
        lim = 2 * l < nn if start == 1 else 2 * l <= nn
        reset = (delta != 0) & lim
        below, bx_below = shfl_up(sig), shfl_up(bx)
        nb = np.where(lane == 0, 0, gmul(ginv(delta), below))
        sig = np.where(delta != 0, sig ^ gmul(delta, bx), sig)
        bx = np.where(reset, nb, np.where(lane == 0, 0, bx_below))
        l = np.where(reset, nn - l if start == 1 else nn + 1 - l, l)
        sig = np.where(lane >= cap, 0, sig)
        bx = np.where(lane >= cap, 0, bx)
    return sig


def chien(sig, n, cap, G, nq):
    """(B, G, nq) roots: position p = lane + G·q in the window with
    σ(a^−(254 − p)) = 0, each lane stepping its own term logs."""
    B = sig.shape[0]
    lane = np.arange(G)
    allsig = sig[:, :cap]                      # every lane reads the scratch
    lsig = LOG[allsig]
    e = (lsig[:, None, :] + np.arange(cap)[None, None] * (1 + lane)[None, :,
                                                                     None]) \
        % 255                                   # (B, G, cap)
    roots = np.zeros((B, G, nq), bool)
    for q in range(nq):
        v = np.bitwise_xor.reduce(np.where(allsig[:, None, :] != 0, EXP[e],
                                           0), axis=-1)
        roots[:, :, q] = (lane + G * q < n)[None] & (v == 0)
        e = e + (np.arange(cap) * G) % 255
        e = np.where(e >= 255, e - 255, e)
    return roots


def lane_positions(n, G):
    nq = -(-255 // G)
    p = np.arange(G)[:, None] + G * np.arange(nq)[None]     # (G, nq)
    return p, p < n, nq


def bch_model(n, k, t, words, G):
    """The BCH kernel's schedule on (B, n) uint8 words → (msgs, ok)."""
    cap = t + 2
    r_all = np.asarray(words, np.int64) & 1
    B = r_all.shape[0]
    p, valid, nq = lane_positions(n, G)
    pc = np.minimum(p, n - 1)
    r = np.where(valid[None], r_all[:, pc], 0)              # (B, G, nq)
    w = outer_fec.bch_syndrome_words(n, t).astype(np.uint64)
    wl = np.where(valid, w[pc], np.uint64(0))              # (G, nq)
    acc = np.bitwise_xor.reduce(np.where(r == 1, wl[None], np.uint64(0)),
                                axis=-1)                    # (B, G)
    acc = xor_all(acc, G)
    any_err = acc[:, 0] != 0
    s = np.zeros((B, 2 * t + 1), np.int64)
    for i in range(t):
        s[:, 2 * i + 1] = ((acc[:, 0] >> np.uint64(8 * i)) &
                           np.uint64(0xFF)).astype(np.int64)
    for j in range(2, 2 * t + 1, 2):
        s[:, j] = gmul(s[:, j // 2], s[:, j // 2])
    sig = berlekamp_massey(s, cap, 1, G)
    roots = chien(sig, n, cap, G, nq)
    assert (roots.sum((1, 2)) <= cap - 1).all()
    fold = np.bitwise_xor.reduce(np.where(roots, wl[None], np.uint64(0)),
                                 axis=-1)
    fold = xor_all(fold, G)[:, 0]
    found = sum_all(roots.sum(-1), G)[:, 0]
    ok = ~any_err | ((fold == acc[:, 0]) & (found <= t))
    fix = any_err & ok
    r = r ^ (roots & fix[:, None, None])
    msgs = np.zeros((B, k), np.uint8)
    for lane in range(G):
        for q in range(nq):
            if p[lane, q] < k:
                msgs[:, p[lane, q]] = r[:, lane, q]
    return msgs, ok.astype(np.int32)


def rs_model(n, n_parity, words, G):
    """The RS kernel's schedule on (B, n) uint8 words → (msgs, ok)."""
    t = n_parity // 2
    cap = t + 2
    k = n - n_parity
    r_all = np.asarray(words, np.int64)
    B = r_all.shape[0]
    p, valid, nq = lane_positions(n, G)
    pc = np.minimum(p, n - 1)
    r = np.where(valid[None], r_all[:, pc], 0)              # (B, G, nq)
    deg = 254 - p
    # partial syndromes: lane l's bytes, S_j += r_p a^(j deg p)
    part = np.zeros((B, G, n_parity), np.int64)
    e = LOG[r]
    for j in range(n_parity):
        part[:, :, j] = np.bitwise_xor.reduce(
            np.where(r != 0, EXP[e], 0), axis=-1)
        e = e + deg[None]
        e = np.where(e >= 255, e - 255, e)
    syn = np.stack([xor_all(part[:, :, j], G) for j in range(n_parity)],
                   axis=-1)[:, 0]                           # (B, 2t)
    any_err = (syn != 0).any(-1)
    sig = berlekamp_massey(syn, cap, 0, G)
    nz_lanes = sig != 0
    sdeg = np.where(nz_lanes, np.arange(G)[None], 0).max(-1)   # the ballot
    # Ω_i on lane i < 2t from the scratch's σ and syndromes
    omega = np.zeros((B, n_parity), np.int64)
    for i in range(n_parity):
        for j in range(min(cap, i + 1)):
            omega[:, i] ^= gmul(sig[:, j], syn[:, i - j])
    roots = chien(sig, n, cap, G, nq)
    assert (roots.sum((1, 2)) <= cap - 1).all()
    # Forney at every lane position (kept where it is a root)
    d = deg[None]                                           # (1, G, nq)
    step = 255 - d
    om = np.zeros((B, G, nq), np.int64)
    dv = np.zeros((B, G, nq), np.int64)
    xm = np.zeros_like(d)
    for m in range(n_parity):
        oc = omega[:, m][:, None, None]
        om ^= np.where(oc != 0, EXP[LOG[oc] + xm], 0)
        if m + 1 < cap and m % 2 == 0:
            sc = sig[:, m + 1][:, None, None]
            dv ^= np.where(sc != 0, EXP[LOG[sc] + xm], 0)
        xm = xm + step
        xm = np.where(xm >= 255, xm - 255, xm)
    mag = gmul(EXP[d], gmul(om, ginv(dv)))
    mag = np.where(roots, mag, 0)
    bad = (roots & (dv == 0)).any(-1).any(-1)      # each lane's, then a ballot
    fold = np.zeros((B, G, n_parity), np.int64)
    ee = LOG[mag]
    for j in range(n_parity):
        fold[:, :, j] = np.bitwise_xor.reduce(np.where(mag != 0, EXP[ee], 0),
                                              axis=-1)
        ee = ee + d
        ee = np.where(ee >= 255, ee - 255, ee)
    resid_ok = np.stack([xor_all(fold[:, :, j], G)[:, 0] == syn[:, j]
                         for j in range(n_parity)], axis=-1).all(-1)
    n_err = sum_all(roots.sum(-1), G)[:, 0]
    ok = ~any_err | (resid_ok & ~bad & (n_err == sdeg) & (sdeg <= t))
    fix = any_err & ok
    r = r ^ np.where(fix[:, None, None], mag, 0)
    msgs = np.zeros((B, k), np.uint8)
    for lane in range(G):
        for q in range(nq):
            if p[lane, q] < k:
                msgs[:, p[lane, q]] = r[:, lane, q]
    return msgs, ok.astype(np.int32)


def _flip_rows(code, msgs, errors, rng, byte):
    words = code.encode(msgs)
    n = words.shape[1]
    for i in range(len(words)):
        ne = errors(i)
        if ne:
            pos = rng.choice(n, ne, replace=False)
            words[i, pos] ^= (rng.integers(1, 256, ne).astype(np.uint8)
                              if byte else 1)
    return words


def bch_rows(code, t, seed, rows=ROWS):
    """``rows`` codewords, row i with i % (t + 4) bit errors: up to t
    decodable, t + 1 .. t + 3 beyond it."""
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, (rows, code.k)).astype(np.uint8)
    return _flip_rows(code, msgs, lambda i: i % (t + 4), rng, False)


def rs_rows(rs, seed, rows=ROWS):
    t = rs.n_parity // 2
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 256, (rows, rs.k)).astype(np.uint8)
    return _flip_rows(rs, msgs, lambda i: i % (t + 4), rng, True)


def _same(got, want):
    assert np.array_equal(got[0], np.asarray(want[0]))
    assert np.array_equal(got[1].astype(bool), np.asarray(want[1]).astype(
        bool))


def _bch_codes(t):
    short = chain.shortened_bch_for(t)
    return [(short.n, short.k, short), (255, Bch(t, 255).k, Bch(t, 255))]


@pytest.mark.parametrize("G", LANE_WIDTHS)
@pytest.mark.parametrize("t", range(1, 9))
def test_bch_schedule_equals_the_plain_decoder(t, G):
    for n, k, code in _bch_codes(t):
        words = bch_rows(code, t, 100 * t + n)
        got = bch_model(n, k, t, words, G)
        out, ok = PB.bch_decode_batch_reference(n, k, t,
                                                torch.as_tensor(words))
        _same(got, (out.numpy(), ok.numpy()))
        _same(got, code.decode_batch(words))
        assert (got[1][np.arange(ROWS) % (t + 4) <= t] == 1).all()


def _rs_codes(t):
    codes = [ReedSolomon(204, 2 * t), ReedSolomon(255, 2 * t)]
    if t == 2:
        codes.append(ReedSolomon(60, 4))
    if t == 8:
        codes.append(ReedSolomon(20, 16))
    return codes


@pytest.mark.parametrize("G", LANE_WIDTHS)
@pytest.mark.parametrize("t", range(1, 9))
def test_rs_schedule_equals_the_plain_decoder(t, G):
    for rs in _rs_codes(t):
        words = rs_rows(rs, 7 * t + rs.n)
        got = rs_model(rs.n, rs.n_parity, words, G)
        out, ok = PB.rs_decode_batch_reference(rs.n, rs.n_parity,
                                               torch.as_tensor(words))
        _same(got, (out.numpy(), ok.numpy()))
        _same(got, rs.decode_batch(words))
        assert (got[1][np.arange(ROWS) % (t + 4) <= t] == 1).all()


def _bad_dv_words():
    """RS(204,188) rows of 9..13 byte errors, the first eight of them rows
    where σ' vanishes at a root of σ (bad_dv), ROWS in all."""
    from tests.test_torch_bch_device import _bad_dv_rows, _rs_garbage_words
    words = _rs_garbage_words(0)
    bad = np.flatnonzero(_bad_dv_rows(words))
    return words[np.concatenate([bad[:8], np.arange(ROWS - 8)])]


@pytest.mark.parametrize("G", LANE_WIDTHS)
def test_rs_schedule_where_the_derivative_vanishes(G):
    words = _bad_dv_words()
    got = rs_model(204, 16, words, G)
    out, ok = PB.rs_decode_batch_reference(204, 16, torch.as_tensor(words))
    _same(got, (out.numpy(), ok.numpy()))
    assert not got[1][:8].any()


# the JAX device decoders at two shapes (each compiles once: ~5-20 s)
@pytest.mark.parametrize("G", LANE_WIDTHS)
def test_schedule_equals_the_jax_device_decoders(G):
    code = chain.shortened_bch_for(8)
    words = bch_rows(code, 8, 5)
    _same(bch_model(code.n, code.k, 8, words, G),
          JB.bch_decode_batch_device(code.n, code.k, 8, words))
    for words in (rs_rows(ReedSolomon(204, 16), 6), _bad_dv_words()):
        _same(rs_model(204, 16, words, G),
              JB.rs_decode_batch_device(204, 16, words))


def test_bch_syndrome_words_are_the_odd_syndromes():
    # word p's byte i is bit p's term of S_(2i+1), as the plain decoder's
    # syndrome matrix has it (columns (2i)·8 .. (2i)·8 + 7 hold S_(2i+1))
    for n, t in ((184, 8), (128, 1), (255, 5)):
        _, T, _ = PB._tables(n, t)
        w = outer_fec.bch_syndrome_words(n, t)
        for i in range(t):
            byte = (w >> np.uint64(8 * i)) & np.uint64(0xFF)
            cols = T[:, 16 * i: 16 * i + 8]
            assert np.array_equal(byte.astype(np.int64),
                                  (cols << np.arange(8)).sum(-1))
        if t < 8:
            assert not (w >> np.uint64(8 * t)).any()


PLAN_BATCHES = (1, 4, 51, 83, 1632, 3048, 12928)


@pytest.mark.parametrize("kind", ["bch", "rs"])
@pytest.mark.parametrize("G", LANE_WIDTHS)
def test_launch_plan_covers_every_row_once(kind, G, monkeypatch):
    monkeypatch.setitem(outer_fec.LANES, kind, G)
    for B in PLAN_BATCHES:
        plan = outer_fec.plan_for(kind, B, 132)
        g = plan["groups_per_block"]
        assert plan["lanes"] == G and plan["threads"] == G * g
        assert plan["threads"] % 32 == 0
        assert plan["threads"] <= outer_fec.MAX_THREADS
        rows = (np.arange(plan["grid"])[:, None] * g
                + np.arange(g)[None]).reshape(-1)
        rows = rows[rows < B]
        assert np.array_equal(np.sort(rows), np.arange(B))
        # up to BLOCKS_PER_SM blocks an SM, a batch keeps one warp of
        # codewords a block, so it spreads over as many SMs as it can
        if B <= 132 * outer_fec.BLOCKS_PER_SM * (32 // G):
            assert plan["grid"] == -(-B // (32 // G))


def test_launch_plan_refuses_other_lane_counts(monkeypatch):
    assert outer_fec.plan_for("bch", 51, 132)["lanes"] == 16
    assert outer_fec.plan_for("rs", 51, 132)["lanes"] == 32
    monkeypatch.setitem(outer_fec.LANES, "bch", 8)
    with pytest.raises(ValueError):
        outer_fec.plan_for("bch", 10, 132)
