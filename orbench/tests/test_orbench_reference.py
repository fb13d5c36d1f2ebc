"""The plain transmitters and receivers: roundtrips at a tiny size, and
the reference's codes, waveforms and decoder held to the port's on the
CPU (the port is only read here, to check the yardstick)."""

import json
import os

import numpy as np
import pytest
import torch

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch.codec.ft8_ldpc import ft8_ldpc_graph
from orion_sdr_tpu_torch.fec.ldpc import ldpc_graph
from orion_sdr_tpu_torch.frame.chain import shortened_bch_for
from orion_sdr_tpu_torch.modulate.ft8 import ft8_symbol_sequence
from orion_sdr_tpu_torch.ops.ldpc_bp import bp_decode_reference

from orbench.reference import cofdm, ft8, ldpc
from orbench.reference.bch import Bch
from orbench.traffic import ft8_slots
from tiny import ROOT

CFG = json.load(open(os.path.join(ROOT, "orbench", "configs",
                                  "cofdm_ldpc_bch.json")))
LINK = cofdm.Link.of(CFG)


def _frames(rng, n, size):
    return [(int(rng.integers(0, 2 ** 32)), i % 4, i, rng.integers(
        0, 256, size).astype(np.uint8), int(rng.integers(0, 2 ** 32)))
        for i in range(n)]


def _batch(bodies, rng, ratio):
    T = max(b.shape[0] for b in bodies)
    iq = torch.zeros((len(bodies), T), dtype=torch.complex64)
    for i, b in enumerate(bodies):
        iq[i, :b.shape[0]] = b
        p = float((b.abs() ** 2).mean()) * ratio
        iq[i] += torch.as_tensor((rng.standard_normal(T) + 1j
                                  * rng.standard_normal(T)) * np.sqrt(p / 2),
                                 dtype=torch.complex64)
    return iq


@pytest.mark.parametrize("ratio", [0.0, 0.02])
def test_cofdm_roundtrip(ratio):
    rng = np.random.default_rng(1)
    frames = _frames(rng, 4, 50)
    rec = cofdm.receive(LINK, _batch(cofdm.transmit(LINK, frames, "cpu"),
                                     rng, ratio))
    assert rec.frames == [("ok", s, m, f, bytes(p)) for s, m, f, p, _ in
                          frames]
    assert [h[:4] for h in rec.headers] == [(m, len(p), s, f)
                                            for s, m, f, p, _ in frames]


def test_cofdm_bodies_equal_the_ports_modulator():
    rng = np.random.default_rng(2)
    frames = _frames(rng, 4, 40)
    plan = P.CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    pre = P.OfdmPreamble(repeat_len=128, num_repeats=4) \
        .with_training_symbol(256, 64)
    mod = P.OfdmFrameMod(P.OfdmConfig(plan, fs=1e6),
                         P.McsTable.default_ladder(), pre, device="cpu")
    for (s, m, f, p, sd), body in zip(frames,
                                      cofdm.transmit(LINK, frames, "cpu")):
        got = mod.modulate_frame(P.FramePacket(P.FrameMetadata(s, m, f), p),
                                 sd)[pre.total_len():]
        assert got.shape[0] == body.shape[0] == LINK.body_len(m, len(p))
        assert np.abs(got - body.numpy()).max() < 1e-6


def test_a_corrupt_header_is_reported():
    rng = np.random.default_rng(3)
    frames = _frames(rng, 2, 30)
    iq = _batch(cofdm.transmit(LINK, frames, "cpu"), rng, 0.0)
    iq[1, :960] = 0
    rec = cofdm.receive(LINK, iq)
    assert rec.frames[1] == ("err", cofdm.HEADER_ERR)
    assert rec.frames[0][0] == "ok"


def test_bch_equals_the_ports():
    rng = np.random.default_rng(4)
    b, pb = Bch(8, 120), shortened_bch_for(8)
    msg = rng.integers(0, 2, (200, 120)).astype(np.uint8)
    words = b.encode(msg)
    assert (words == pb.encode(msg)).all()
    for i in range(200):
        words[i, rng.choice(184, i % 12, replace=False)] ^= 1
    m, ok, in_error = b.decode_counted(words)
    pm, pok = pb.decode_batch(words)
    assert (m == pm).all() and (ok == pok).all() and 0 < ok.sum() < 200
    assert (in_error == (np.arange(200) % 12 > 0)).all()


def test_bp_rows_are_matched_by_content():
    from orbench.checks.cofdm_frames import match_rows
    gen = torch.Generator().manual_seed(6)
    r = torch.randn((300, 512), generator=gen)
    perm = torch.randperm(300, generator=gen)
    p = r[perm] * 1.7 + 0.01 * torch.randn((300, 512), generator=gen)
    m = match_rows(p, r, chunk=64)
    assert torch.equal(perm[m], torch.arange(300))
    missing = match_rows(r[1:10], r[:10])
    assert missing[0] == -1 and int((missing == -1).sum()) == 2
    assert (match_rows(r[:, :100], r) == -1).all()


@pytest.mark.parametrize("name", ["N512R12", "ft8_174_91"])
def test_ldpc_graph_and_bp_equal_the_ports(name):
    c = ldpc.code(name)
    g = ft8_ldpc_graph() if name == "ft8_174_91" else ldpc_graph(name)
    assert (c.check_bits == g.check_bits).all()
    assert (c.check_mask == g.check_mask).all()
    gen = torch.Generator().manual_seed(5)
    msg = torch.randint(0, 2, (24, c.k), generator=gen)
    cw = ldpc.encode(c, msg)
    syn = (torch.as_tensor(np.where(c.check_mask, 1, 0)) * torch.cat(
        [cw, cw.new_zeros(24, 1)], 1)[:, torch.as_tensor(c.check_bits)]
           ).sum(-1) % 2
    assert not syn.any()
    llr = (1.0 - 2.0 * cw.float()) * 2.0 + torch.randn(
        cw.shape, generator=gen) * 1.6
    r = ldpc.bp_decode(c, llr, 20)
    pb, pu = bp_decode_reference(g, llr.contiguous(), 20)
    assert torch.equal(r.bits, pb) and torch.equal(r.unsat, pu)
    assert r.row_iters > 0


def test_ft8_messages_tones_and_waveform_equal_the_ports():
    msgs = ft8_slots.messages(np.random.default_rng(6), 40)
    for m in msgs:
        p = ft8.pack77(*m)
        q = P.pack77(P.Ft8Standard(*m))
        assert (p == q).all()
        u = P.unpack77(q)
        assert ft8.text77(p) == " ".join(s for s in (u.call_to, u.call_de,
                                                     u.extra) if s)
    q = ft8.pack77(*msgs[0])
    tones = ft8.tones(q)
    assert (tones == ft8_symbol_sequence(P.ft8_encode(q, device="cpu"))).all()
    x = ft8.modulate(torch.as_tensor(tones[None]), torch.tensor([1250.0]))
    y = P.ft8_mod(P.ft8_encode(q, device="cpu"), 12000.0, 1250.0,
                  device="cpu")
    assert np.abs(x[0].numpy() - y.numpy()).max() < 1e-3


def test_ft8_roundtrip():
    msgs = ft8_slots.messages(np.random.default_rng(7), 2)
    x = torch.zeros((3, 180000), dtype=torch.complex64)
    seqs = torch.as_tensor(np.stack([ft8.tones(ft8.pack77(*m))
                                     for m in msgs]))
    x[:2, :151680] = ft8.modulate(seqs, torch.tensor([400.0, 2650.0]))
    x += torch.randn(x.shape, dtype=torch.complex64,
                     generator=torch.Generator().manual_seed(8)) * 8.7
    rec = ft8.receive(x, 200.0, 3000.0, 4)
    assert [r and r[2:4] for r in rec.results] == [
        (" ".join(s for s in msgs[0] if s), 400.0),
        (" ".join(s for s in msgs[1] if s), 2650.0), None]
