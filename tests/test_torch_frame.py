"""Torch port: the coded COFDM frame link against the JAX package — coded
bits bit-exact, frame IQ within float tolerance, and frames decoding across
packages in both directions (single, batch with mixed MCS and a trashed
header, and the streaming receiver at an unknown offset with CFO); the
RS, conv, interleaver and DVB scrambler branches of the chain, and a conv +
RS link in both trellis modes."""

import dataclasses

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import orion_sdr_tpu.frame as J
from orion_sdr_tpu.dsp.osc import rotate as jax_rotate
from orion_sdr_tpu.multicarrier import CarrierGrid as JaxGrid
from orion_sdr_tpu.multicarrier import CarrierPlan as JaxPlan
from orion_sdr_tpu.multicarrier import grid_map as jax_grid_map
from orion_sdr_tpu.ofdm import OfdmConfig as JaxOfdmConfig
from orion_sdr_tpu.sync.ofdm_sync import OfdmPreamble as JaxPreamble

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch.multicarrier import grid_map

# The plain torch versions run thousands of tiny ops; with one test worker
# per core, a torch thread pool as wide as the machine in every worker
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

FS = 1e6
SCRAMBLERS = {
    "none": (J.ScramblerKind.none(), P.ScramblerKind.none(),
             J.SCRAMBLER_BEFORE_OUTER),
    "per_frame": (J.ScramblerKind.additive(0b110, 7, 0, per_frame=True),
                  P.ScramblerKind.additive(0b110, 7, 0, per_frame=True),
                  J.SCRAMBLER_BEFORE_OUTER),
    "after_inner": (J.ScramblerKind.additive(0b1001, 15, 0x5A5A),
                    P.ScramblerKind.additive(0b1001, 15, 0x5A5A),
                    J.SCRAMBLER_AFTER_INNER),
}


def _links(scrambler="per_frame"):
    js, ps, pos = SCRAMBLERS[scrambler]
    jc = JaxOfdmConfig(JaxPlan(256, 64).with_contiguous_data(edge_guard=16),
                       fs=FS).with_scrambler(js).with_scrambler_pos(pos)
    pc = P.OfdmConfig(P.CarrierPlan(256, 64).with_contiguous_data(
        edge_guard=16), fs=FS).with_scrambler(ps).with_scrambler_pos(pos)
    jp = JaxPreamble(repeat_len=128, num_repeats=4).with_training_symbol(256, 64)
    pp = P.OfdmPreamble(repeat_len=128, num_repeats=4).with_training_symbol(
        256, 64)
    return jc, pc, jp, pp


def _payload(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.uint8)


@pytest.mark.parametrize("n_bytes", [64, 150])
@pytest.mark.parametrize("scrambler", sorted(SCRAMBLERS))
def test_encode_chain_bit_exact(scrambler, n_bytes):
    js, ps, pos = SCRAMBLERS[scrambler]
    data = _payload(n_bytes, n_bytes)
    for jm, pm in zip(J.McsTable.default_ladder().entries,
                      P.McsTable.default_ladder().entries):
        ref = J.encode_chain(data, "crc32", jm.outer_fec, jm.inner_fec,
                             J.InterleaverKind.none(), J.InterleaverKind.none(),
                             js, pos, 0xC0FFEE)
        ours = P.encode_chain(data, "crc32", pm.outer_fec, pm.inner_fec,
                              P.InterleaverKind.none(),
                              P.InterleaverKind.none(), ps, pos, 0xC0FFEE,
                              device="cpu")
        plan = P.block_plan(n_bytes, "crc32", pm.outer_fec, pm.inner_fec,
                            P.InterleaverKind.none(), P.InterleaverKind.none())
        assert ours.dtype == torch.uint8 and len(ours) == plan.coded_bits
        assert np.array_equal(ours.numpy(), ref)


def test_modulate_frame_matches():
    jc, pc, jp, pp = _links()
    jmod = J.OfdmFrameMod(jc, J.McsTable.default_ladder(), jp)
    pmod = P.OfdmFrameMod(pc, P.McsTable.default_ladder(), pp, device="cpu")
    for mcs in range(4):
        data = _payload(70, mcs)
        ref = jmod.modulate_frame(J.FramePacket(J.FrameMetadata(5, mcs), data),
                                  1000 + mcs)
        ours = pmod.modulate_frame(P.FramePacket(P.FrameMetadata(5, mcs),
                                                 data), 1000 + mcs)
        assert ours.dtype == np.complex64 and ours.shape == ref.shape
        # ifft rounding differs between libraries; samples are ~0.06 RMS
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_unported_configurations_raise():
    # the configurations that raised here before slice 1 was finished (CPE
    # tracking, DFT precoding, the TX lowpass, per-symbol pilot layouts)
    # now run and match the JAX package
    jc, pc, jp, pp = _links()
    rng = np.random.default_rng(12)
    iq = ((rng.standard_normal(4000) + 1j * rng.standard_normal(4000))
          * 0.1).astype(np.complex64)
    for jcfg, pcfg in ((jc.with_phase_tracking("cpe"),
                        pc.with_phase_tracking("cpe")),
                       (jc.with_transform_precoding(True),
                        pc.with_transform_precoding(True))):
        ref = np.asarray(J.soft_demap(jcfg, "qpsk", iq, 2))
        ours = P.soft_demap(pcfg, "qpsk", torch.as_tensor(iq), 2).numpy()
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)
    lp = pc.with_tx_lowpass_null_band(89, 60.0).tx_lowpass
    assert dataclasses.asdict(lp) == dataclasses.asdict(
        jc.with_tx_lowpass_null_band(89, 60.0).tx_lowpass)
    data = _payload(40, 9)
    ref = J.OfdmFrameMod(jc.with_tx_lowpass_null_band(89, 60.0),
                         J.McsTable.default_ladder(), jp).modulate_frame(
        J.FramePacket(J.FrameMetadata(1, 0), data), 3)
    ours = P.OfdmFrameMod(pc.with_tx_lowpass(lp), P.McsTable.default_ladder(),
                          pp, device="cpu").modulate_frame(
        P.FramePacket(P.FrameMetadata(1, 0), data), 3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    grid = P.CarrierGrid(pc.carrier_plan)
    syms = (rng.standard_normal((2, grid.num_data_carriers))
            + 0j).astype(np.complex64)
    bins, vals = np.array([[1, 2], [3, 4]]), np.arange(4).reshape(2, 2) + 1j
    assert np.array_equal(
        grid_map(grid, torch.as_tensor(syms), bins, vals).numpy(),
        np.asarray(jax_grid_map(JaxGrid(jc.carrier_plan), syms, bins,
                                vals.astype(np.complex64))))


# ── RS / conv / interleaver / DVB scrambler branches of the chain ───────────

CHAINS = {
    "rs_forney_conv_dvb": lambda M: (
        M.OuterFec.reed_solomon(204, 16), M.InnerFec.convolutional(
            "1/2", "dvb_k7"), M.InterleaverKind.convolutional(12, 17),
        M.InterleaverKind.none(), M.ScramblerKind.dvb_t_energy_dispersal(),
        M.SCRAMBLER_BEFORE_OUTER, 500),
    "rs_block_k5_dvb_after": lambda M: (
        M.OuterFec.reed_solomon(60, 8), M.InnerFec.convolutional("3/4", "k5"),
        M.InterleaverKind.none(), M.InterleaverKind.block(16, 24),
        M.ScramblerKind.dvb_t_energy_dispersal(), M.SCRAMBLER_AFTER_INNER,
        300),
    "bch_block_ldpc": lambda M: (
        M.OuterFec.bch(8), M.InnerFec.ldpc("N512R12"),
        M.InterleaverKind.block(8, 8), M.InterleaverKind.none(),
        M.ScramblerKind.none(), M.SCRAMBLER_BEFORE_OUTER, 100),
    "rs_forney_chunked_block": lambda M: (
        M.OuterFec.reed_solomon(204, 16), M.InnerFec.convolutional(
            "2/3", "dvb_k7"), M.InterleaverKind.convolutional(12, 17),
        M.InterleaverKind.block(12, 20),
        M.ScramblerKind.additive(0b1001, 15, 0x5A5A),
        M.SCRAMBLER_AFTER_INNER, 900),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_branches_match(name):
    *jargs, n = CHAINS[name](J)
    *pargs, _ = CHAINS[name](P)
    data = _payload(n, n)
    jplan = J.block_plan(n, "crc32", *jargs[:4])
    pplan = P.block_plan(n, "crc32", *pargs[:4])
    assert dataclasses.asdict(pplan) == dataclasses.asdict(jplan)
    ref = J.encode_chain(data, "crc32", *jargs, 1234)
    ours = P.encode_chain(data, "crc32", *pargs, 1234, device="cpu")
    assert len(ref) == jplan.coded_bits
    assert np.array_equal(ours.numpy(), ref)
    rng = np.random.default_rng(5)
    llr = np.where(ref == 0, 3.0, -3.0).astype(np.float32)
    llr = np.where(rng.random(len(llr)) < 0.005, -llr, llr)
    jd, jok = J.decode_chain(llr, jplan, "crc32", *jargs, 1234)
    pd, pok = P.decode_chain(torch.as_tensor(llr), pplan, "crc32", *pargs,
                             1234)
    assert jok and pok
    assert np.array_equal(pd, jd) and np.array_equal(pd, data)


def test_decode_chain_batch_runs_forney_per_frame():
    # two different frames through one batch: the Forney deinterleaver is a
    # stream with state, so each row must be its own stream
    *pargs, _ = CHAINS["rs_forney_conv_dvb"](P)
    plan = P.block_plan(500, "crc32", *pargs[:4])
    datas = [_payload(500, 60 + i) for i in range(2)]
    rows = [P.encode_chain(d, "crc32", *pargs, 0, device="cpu")
            for d in datas]
    llrs = torch.stack([torch.where(r == 0, 3.0, -3.0) for r in rows])
    got, oks = P.decode_chain_batch(llrs, plan, "crc32", *pargs, [0, 0])
    assert oks.all()
    for g, d in zip(got, datas):
        assert np.array_equal(g, d)
    outer_il = pargs[2]
    coded = np.stack([P.interleave_bits(outer_il, P.outer_encode(
        pargs[0], P.scramble_bytes(pargs[4], 0, P.append_crc("crc32", d)),
        device="cpu").numpy()) for d in datas])
    assert np.array_equal(P.deinterleave_bits(outer_il, coded)[
        :, : plan.outer_coded_bits], np.stack([P.outer_encode(
            pargs[0], P.scramble_bytes(pargs[4], 0, P.append_crc("crc32", d)),
            device="cpu").numpy() for d in datas]))


def _conv_links():
    """A COFDM link with the conv inner code, RS outer code and a block
    inner interleaver, in both packages."""
    jc, pc, jp, pp = _links()
    jc = jc.with_inner_interleaver(J.InterleaverKind.block(32, 48))
    pc = pc.with_inner_interleaver(P.InterleaverKind.block(32, 48))
    jt = J.McsTable([J.Mcs("qpsk", J.InnerFec.convolutional("1/2", "dvb_k7"),
                           J.OuterFec.reed_solomon(204, 16))])
    pt = P.McsTable([P.Mcs("qpsk", P.InnerFec.convolutional("1/2", "dvb_k7"),
                           P.OuterFec.reed_solomon(204, 16))])
    return jc, pc, jp, pp, jt, pt


@pytest.mark.parametrize("n_bytes", [300, 2000])
def test_conv_link_round_trip_and_cross_decode(n_bytes):
    # 300 B: a terminated trellis (≤ 4096 info bits); 2000 B: chunked
    jc, pc, jp, pp, jt, pt = _conv_links()
    data = _payload(n_bytes, n_bytes + 1)
    jiq = J.OfdmFrameMod(jc, jt, jp).modulate_frame(
        J.FramePacket(J.FrameMetadata(3, 0), data), 0x77)
    piq = P.OfdmFrameMod(pc, pt, pp, device="cpu").modulate_frame(
        P.FramePacket(P.FrameMetadata(3, 0), data), 0x77)
    np.testing.assert_allclose(piq, jiq, rtol=0, atol=1e-5)
    pdemod = P.OfdmFrameDemod(pc, pt, device="cpu")
    jdemod = J.OfdmFrameDemod(jc, jt)
    for iq in (jiq, piq):
        for got in (pdemod.decode(iq[pp.total_len():]),
                    jdemod.decode(iq[jp.total_len():])):
            assert np.array_equal(got.payload, data)
    rng = np.random.default_rng(n_bytes)
    body = jiq[jp.total_len():]
    noisy = np.stack([body + 0.02 * (rng.standard_normal(len(body))
                                     + 1j * rng.standard_normal(len(body))
                                     ).astype(np.complex64)
                      for _ in range(2)])
    for got in pdemod.decode_batch(noisy):
        assert isinstance(got, P.FramePacket)
        assert np.array_equal(got.payload, data)


def test_cross_decode_single():
    jc, pc, jp, pp = _links()
    jt, pt = J.McsTable.default_ladder(), P.McsTable.default_ladder()
    data = _payload(120, 7)
    jiq = J.OfdmFrameMod(jc, jt, jp).modulate_frame(
        J.FramePacket(J.FrameMetadata(9, 2, 3), data), 0xBEEF)
    piq = P.OfdmFrameMod(pc, pt, pp, device="cpu").modulate_frame(
        P.FramePacket(P.FrameMetadata(9, 2, 3), data), 0xBEEF)
    got_p = P.OfdmFrameDemod(pc, pt, device="cpu").decode(jiq[pp.total_len():])
    got_j = J.OfdmFrameDemod(jc, jt).decode(piq[jp.total_len():])
    for got in (got_p, got_j):
        assert np.array_equal(got.payload, data)
        assert (got.metadata.sequence_num, got.metadata.mcs_index,
                got.metadata.flags) == (9, 2, 3)


def _batch(mod, pkt, meta, pre_len):
    """Mixed-MCS aligned batch + one trashed header, AWGN at 0.02 × signal
    power (the JAX package's decode_batch test)."""
    specs = [(3, 1, 64, 101), (4, 1, 64, 202), (5, 3, 120, 303), (6, 0, 64, 9)]
    payloads = [_payload(n, 20 + i) for i, (_, _, n, _) in enumerate(specs)]
    bodies = [mod.modulate_frame(pkt(meta(seq, mcs), p), seed)[pre_len:]
              for (seq, mcs, _, seed), p in zip(specs, payloads)]
    rng = np.random.default_rng(0xBA7C4)
    bad = bodies[0].copy()
    bad[:2000] = (rng.standard_normal(2000) + 1j * rng.standard_normal(2000)
                  ).astype(np.complex64)
    rows = bodies + [bad]
    n = max(len(b) for b in rows)
    batch = np.zeros((len(rows), n), np.complex64)
    for i, b in enumerate(rows):
        sig = float(np.mean(np.abs(b) ** 2))
        noise = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
                 ).astype(np.complex64) * np.sqrt(sig * 0.02 / 2)
        batch[i, :len(b)] = b
        batch[i] += noise
    return specs, payloads, batch


def _check_batch(out, specs, payloads, rx_error):
    assert len(out) == len(specs) + 1
    for got, (seq, mcs, _, _), p in zip(out, specs, payloads):
        assert not isinstance(got, rx_error), got
        assert np.array_equal(got.payload, p)
        assert (got.metadata.sequence_num, got.metadata.mcs_index) == (seq, mcs)
    assert isinstance(out[-1], rx_error)


def test_cross_decode_batch_jax_to_port():
    jc, pc, jp, _ = _links()
    specs, payloads, batch = _batch(
        J.OfdmFrameMod(jc, J.McsTable.default_ladder(), jp), J.FramePacket,
        J.FrameMetadata, jp.total_len())
    out = P.OfdmFrameDemod(pc, P.McsTable.default_ladder(),
                           device="cpu").decode_batch(batch)
    _check_batch(out, specs, payloads, P.RxError)


def test_cross_decode_batch_port_to_jax():
    jc, pc, _, pp = _links()
    specs, payloads, batch = _batch(
        P.OfdmFrameMod(pc, P.McsTable.default_ladder(), pp, device="cpu"),
        P.FramePacket, P.FrameMetadata, pp.total_len())
    out = J.OfdmFrameDemod(jc, J.McsTable.default_ladder()).decode_batch(batch)
    _check_batch(out, specs, payloads, J.RxError)
    # the port agrees with itself on the same batch, rule by rule
    for rule in ("sum_product", "scaled_min_sum"):
        ours = P.OfdmFrameDemod(pc.with_ldpc_decode_rule(rule),
                                P.McsTable.default_ladder(),
                                device="cpu").decode_batch(batch)
        _check_batch(ours, specs, payloads, P.RxError)


@pytest.fixture(scope="module")
def stream_capture():
    """A JAX-modulated frame at an unknown offset, 37 Hz CFO, noise 0.01."""
    jc, _, jp, _ = _links("none")
    payload = _payload(200, 12)
    iq = J.OfdmFrameMod(jc, J.McsTable.default_ladder(), jp).modulate_frame(
        J.FramePacket(J.FrameMetadata(7, 1), payload), 0xDEAD)
    buf = np.concatenate([np.zeros(3000, np.complex64), iq,
                          np.zeros(2000, np.complex64)])
    z, _ = jax_rotate(buf, 37.0, FS)
    rng = np.random.default_rng(13)
    buf = (np.asarray(z) + (rng.standard_normal(len(buf))
                            + 1j * rng.standard_normal(len(buf))
                            ).astype(np.complex64) * 0.01).astype(np.complex64)
    return payload, buf


def _stream(buf, chunk):
    _, pc, _, pp = _links("none")
    s = P.OfdmFrameStreamDemod(pc, P.McsTable.default_ladder(), pp,
                               device="cpu")
    res = []
    for i in range(0, len(buf), chunk):
        res += s.feed(buf[i:i + chunk])
    return res + s.flush()


def test_stream_recovers_frame_at_unknown_offset(stream_capture):
    payload, buf = stream_capture
    ok = [r for r in _stream(buf, 20000) if isinstance(r, P.RxFrame)]
    assert len(ok) == 1 and np.array_equal(ok[0].packet.payload, payload)
    assert ok[0].packet.metadata.sequence_num == 7
    assert abs(ok[0].diagnostics.cfo_hz - 37.0) < 2.0
    assert ok[0].diagnostics.timing_offset_samples == 3000


@pytest.mark.parametrize("chunk", [1777, 6000])
def test_stream_chunk_boundary_invariant(stream_capture, chunk):
    payload, buf = stream_capture
    whole = _stream(buf, len(buf))
    split = _stream(buf, chunk)
    assert [type(r) for r in split] == [type(r) for r in whole]
    for a, b in zip(split, whole):
        if isinstance(a, P.RxFrame):
            assert np.array_equal(a.packet.payload, b.packet.payload)
            assert a.diagnostics.cfo_hz == pytest.approx(b.diagnostics.cfo_hz,
                                                         abs=1e-3)
    assert np.array_equal(
        [r for r in split if isinstance(r, P.RxFrame)][0].packet.payload,
        payload)


def test_stream_takes_frames_in_order():
    """Four frames, the first straddling a 20000-sample chunk boundary: the
    port decodes the earliest preamble first, so none is drained unread."""
    jc, _, jp, _ = _links("none")
    jmod = J.OfdmFrameMod(jc, J.McsTable.default_ladder(), jp)
    payloads = [_payload(400, 40 + i) for i in range(4)]
    parts = []
    for i, (gap, p) in enumerate(zip((3808, 2266, 2414, 4361), payloads)):
        parts.append(np.zeros(gap, np.complex64))
        parts.append(jmod.modulate_frame(
            J.FramePacket(J.FrameMetadata(i, i % 2), p), 77 + i))
    buf = np.concatenate(parts + [np.zeros(3000, np.complex64)])
    z, _ = jax_rotate(buf, 37.0, FS)
    rng = np.random.default_rng(41)
    buf = (np.asarray(z) + 0.01 * (rng.standard_normal(len(buf))
                                   + 1j * rng.standard_normal(len(buf)))
           ).astype(np.complex64)
    got = [r for r in _stream(buf, 20000) if isinstance(r, P.RxFrame)]
    assert [r.packet.metadata.sequence_num for r in got] == [0, 1, 2, 3]
    for r, p in zip(got, payloads):
        assert np.array_equal(r.packet.payload, p)
