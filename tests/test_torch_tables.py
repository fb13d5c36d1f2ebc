"""Torch port: state carried across from the JAX package — LDPC graphs,
carrier grids, S&C preamble, CRCs, PN scrambler, BCH — must be bit-exact, and
the converters must rebuild the port's objects from the JAX package's
fields."""

import dataclasses
import os
import subprocess
import sys

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch  # noqa: F401  (the port under test is torch; both frameworks load)

from orion_sdr_tpu.fec.ldpc import ldpc_graph as jax_ldpc_graph
from orion_sdr_tpu.fec import crc16 as jax_crc16, crc32 as jax_crc32, \
    pn_sequence as jax_pn_sequence
from orion_sdr_tpu.frame import McsTable as JaxMcsTable, \
    shortened_bch_for as jax_shortened_bch_for, ScramblerKind as JaxScrambler
from orion_sdr_tpu.multicarrier import CarrierPlan as JaxPlan, \
    CarrierGrid as JaxGrid
from orion_sdr_tpu.ofdm import OfdmConfig as JaxOfdmConfig
from orion_sdr_tpu.sync.ofdm_sync import (
    OfdmPreamble as JaxPreamble, _SEED_REPEAT, _SEED_TRAINING,
    _xorshift64_signs as jax_xorshift64_signs,
    generate_ofdm_preamble as jax_generate_ofdm_preamble)

from orion_sdr_tpu_torch import convert
from orion_sdr_tpu_torch.fec import crc16, crc32, pn_sequence
from orion_sdr_tpu_torch.fec.ldpc import LDPC_CODES, ldpc_graph
from orion_sdr_tpu_torch.frame import McsTable, ScramblerKind, \
    shortened_bch_for
from orion_sdr_tpu_torch.multicarrier import CarrierPlan, CarrierGrid
from orion_sdr_tpu_torch.ofdm import OfdmConfig
from orion_sdr_tpu_torch.sync.ofdm_sync import (
    OfdmPreamble, _xorshift64_signs, generate_ofdm_preamble)

# The plain torch versions run thousands of tiny ops; with one test worker
# per core, a torch thread pool as wide as the machine in every worker
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", sorted(LDPC_CODES))
def test_ldpc_graph_matches(name):
    j, p = jax_ldpc_graph(name), ldpc_graph(name)
    assert (p.n, p.k, p.m, p.max_deg) == (j.n, j.k, j.m, j.max_deg)
    assert np.array_equal(p.A, j.A)
    assert np.array_equal(p.check_bits, j.check_bits)
    assert np.array_equal(p.check_mask, j.check_mask)


@pytest.mark.parametrize("args,guard", [((256, 64), 16), ((64, 16), 4),
                                         ((128, 32), 0)])
def test_carrier_grid_bins_match(args, guard):
    pilots = [(-30, 1 + 0j), (30, -1 + 0j)] if args[0] >= 128 else []
    jp = JaxPlan(*args).with_pilot_carriers(pilots) \
        .with_contiguous_data(edge_guard=guard)
    pp = CarrierPlan(*args).with_pilot_carriers(pilots) \
        .with_contiguous_data(edge_guard=guard)
    assert dataclasses.asdict(pp) == dataclasses.asdict(jp)
    jg, pg = JaxGrid(jp), CarrierGrid(pp)
    assert np.array_equal(pg.data_bins, jg.data_bins)
    assert np.array_equal(pg.pilot_bins, jg.pilot_bins)
    assert np.array_equal(pg.pilot_values, jg.pilot_values)


def test_xorshift_signs_and_preamble_match():
    for seed in (_SEED_REPEAT, _SEED_TRAINING, 12345):
        assert np.array_equal(_xorshift64_signs(700, seed),
                              jax_xorshift64_signs(700, seed))
    for reps, rlen, ts in ((4, 128, (256, 64)), (2, 64, None)):
        jpre = JaxPreamble(reps, rlen)
        ppre = OfdmPreamble(reps, rlen)
        if ts:
            jpre, ppre = jpre.with_training_symbol(*ts), \
                ppre.with_training_symbol(*ts)
        a = generate_ofdm_preamble(ppre)
        b = jax_generate_ofdm_preamble(jpre)
        assert a.dtype == np.complex64 and a.shape == b.shape
        # both are numpy's float64 IFFT rounded to complex64
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_crc_and_pn_match():
    rng = np.random.default_rng(0)
    for n in (0, 1, 9, 200):
        data = rng.integers(0, 256, n).astype(np.uint8)
        assert crc16(data) == jax_crc16(data)
        assert crc32(data) == jax_crc32(data)
    assert crc16(b"123456789") == 0x29B1 and crc32(b"123456789") == 0xCBF43926
    for taps, width, seed in ((0b110, 7, 5), (0b1001, 15, 0x5A5A),
                              ((1 << 14) | (1 << 13), 15, 0x4A80)):
        assert np.array_equal(pn_sequence(taps, width, seed, 300),
                              jax_pn_sequence(taps, width, seed, 300))


def test_scramble_bytes_match():
    from orion_sdr_tpu.frame import scramble_bytes as jax_scramble_bytes
    from orion_sdr_tpu_torch.frame import scramble_bytes
    data = np.random.default_rng(1).integers(0, 256, 77).astype(np.uint8)
    for seed in (0, 111, 0xDEADBEEF):
        a = scramble_bytes(ScramblerKind.additive(0b110, 7, 0, per_frame=True),
                           seed, data)
        b = jax_scramble_bytes(JaxScrambler.additive(0b110, 7, 0,
                                                     per_frame=True),
                               seed, data)
        assert np.array_equal(a, b)


@pytest.mark.parametrize("rows", [1, 3, 40])
def test_bch_encode_and_decode_match(rows):
    p, j = shortened_bch_for(8), jax_shortened_bch_for(8)
    assert (p.n, p.k, p.t) == (j.n, j.k, j.t) == (184, 120, 8)
    rng = np.random.default_rng(rows)
    msg = rng.integers(0, 2, (rows, 120)).astype(np.uint8)
    cw = p.encode(msg)
    assert np.array_equal(cw, j.encode(msg))
    bad = cw.copy()
    for r in range(rows):
        bad[r, rng.choice(184, r % 10, replace=False)] ^= 1
    out, ok = p.decode_batch(bad)
    jout, jok = j.decode_batch(bad)
    assert np.array_equal(out, jout) and np.array_equal(ok, jok)
    fixable = np.arange(rows) % 10 <= 8
    assert ok[fixable].all()
    assert np.array_equal(out[fixable], msg[fixable])


@pytest.mark.parametrize("name", sorted(LDPC_CODES))
def test_convert_ldpc_graph(name):
    g = convert.ldpc_graph_from_fields(
        dataclasses.asdict(jax_ldpc_graph(name)))
    assert g == ldpc_graph(name)


def test_convert_link_config():
    jplan = JaxPlan(256, 64).with_contiguous_data(edge_guard=16)
    jcfg = JaxOfdmConfig(jplan, fs=1e6).with_scrambler(
        JaxScrambler.additive(0b110, 7, 0, per_frame=True)) \
        .with_ldpc_decode_rule("scaled_min_sum").with_symbol_window(8)
    pcfg = OfdmConfig(CarrierPlan(256, 64).with_contiguous_data(edge_guard=16),
                      fs=1e6).with_scrambler(
        ScramblerKind.additive(0b110, 7, 0, per_frame=True)) \
        .with_ldpc_decode_rule("scaled_min_sum").with_symbol_window(8)
    assert convert.ofdm_config_from_fields(dataclasses.asdict(jcfg)) == pcfg
    assert convert.mcs_table_from_fields(
        dataclasses.asdict(JaxMcsTable.default_ladder())) == \
        McsTable.default_ladder()
    jpre = JaxPreamble(128, 4).with_training_symbol(256, 64)
    assert convert.preamble_from_fields(dataclasses.asdict(jpre)) == \
        OfdmPreamble(128, 4).with_training_symbol(256, 64)


def test_import_loads_no_jax():
    code = ("import sys, orion_sdr_tpu_torch, orion_sdr_tpu_torch.convert, "
            "orion_sdr_tpu_torch.ops.ldpc_bp, orion_sdr_tpu_torch.ops.viterbi, "
            "orion_sdr_tpu_torch.modulate, orion_sdr_tpu_torch.demodulate, "
            "orion_sdr_tpu_torch.sync.dvb_t_gi_sync; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'orion_sdr_tpu.')) or m == 'orion_sdr_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr



def test_port_sources_import_no_jax():
    pkg = os.path.join(REPO, "orion_sdr_tpu_torch")
    bad = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            for i, line in enumerate(open(path), 1):
                s = line.strip()
                if s.startswith(("import ", "from ")) and (
                        "jax" in s.split() or "jax." in s
                        or "orion_sdr_tpu " in s + " "
                        or "orion_sdr_tpu." in s):
                    bad.append(f"{path}:{i}: {s}")
    assert not bad, bad


# ── DVB-T and conv tables ────────────────────────────────────────────────────


@pytest.mark.parametrize("code", ["k5", "dvb_k7"])
def test_conv_tables_and_puncture_masks_match(code):
    from orion_sdr_tpu.fec import conv as jconv
    from orion_sdr_tpu_torch.fec import conv
    for a, b in zip(conv._tables(code), jconv._tables(code)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert conv.tail_bits(code) == jconv.tail_bits(code)
    for rate in conv.PUNCTURE:
        for n in (1, 7, 100):
            assert np.array_equal(conv._puncture_mask(rate, n),
                                  jconv._puncture_mask(rate, n))


def test_dvb_t_grid_tables_match():
    from orion_sdr_tpu.waveform import dvb_t as jd
    from orion_sdr_tpu_torch.waveform import dvb_t as pd
    jg, pg = jd.scattered_grid(), pd.scattered_grid()
    assert np.array_equal(pg.data_bins, jg.data_bins)
    for name in ("pilot_bins", "pilot_vals", "ref_bins", "ref_vals"):
        for a, b in zip(getattr(pg, name), getattr(jg, name)):
            assert np.array_equal(a, b)
    assert np.array_equal(pd.wk_prbs(), jd.wk_prbs())
    assert np.array_equal(pd.tps_carrier_bins(), jd.tps_carrier_bins())
    assert np.array_equal(pd.continual_pilot_bins(), jd.continual_pilot_bins())
    assert np.array_equal(pd.dvb_t_prbs_bits(3000), jd.dvb_t_prbs_bits(3000))
    assert pd.dvb_t_prbs_bytes(1)[0] == 0x03
    for guard in ("1/32", "1/8"):
        assert [dataclasses.asdict(p) for p in pd.dvb_t_2k_plans(guard)] == \
            [dataclasses.asdict(p) for p in jd.dvb_t_2k_plans(guard)]
        assert dataclasses.asdict(pd.dvb_t_2k_plan(guard)) == \
            dataclasses.asdict(jd.dvb_t_2k_plan(guard))


@pytest.mark.parametrize("v", [2, 4, 6])
def test_figure_9a_point_tables_match(v):
    from orion_sdr_tpu.waveform import dvb_t as jd
    from orion_sdr_tpu_torch.waveform import dvb_t as pd
    for alpha in (1, 2, 4):
        if v == 2 and alpha != 1:
            for mod in (pd, jd):
                with pytest.raises(ValueError):
                    mod.dvb_t_axis(v, alpha)
            continue
        assert np.array_equal(pd.dvb_t_axis(v, alpha), jd.dvb_t_axis(v, alpha))
        assert pd.axis_scale(v, alpha) == jd.axis_scale(v, alpha)
        assert np.array_equal(pd._point_table(v, alpha),
                              jd._point_table(v, alpha))


def test_dvb_t_block_plans_match():
    from orion_sdr_tpu.frame import block_plan as jax_block_plan
    from orion_sdr_tpu.waveform import dvb_t as jd
    from orion_sdr_tpu_torch.frame import block_plan
    from orion_sdr_tpu_torch.waveform import dvb_t as pd
    jn, pn = (jd.DvbTFrameParams(jd.DvbTLinkParams("1/8", "qpsk", "1/2")),
              pd.DvbTFrameParams(pd.DvbTLinkParams("1/8", "qpsk", "1/2")))
    for n_pkt in range(1, 53):
        a = block_plan(n_pkt * 188, "none", pd.dvb_t_frame_outer(), pn.inner(),
                       pd.dvb_t_frame_outer_il(),
                       pd.dvb_t_frame_outer_il().none())
        b = jax_block_plan(n_pkt * 188, "none", jd.dvb_t_frame_outer(),
                           jn.inner(), jd.dvb_t_frame_outer_il(),
                           jd.dvb_t_frame_outer_il().none())
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("n,n_parity", [(204, 16), (60, 8)])
def test_rs_encode_and_decode_match(n, n_parity):
    from orion_sdr_tpu.fec.galois import ReedSolomon as JaxRs
    from orion_sdr_tpu_torch.fec import ReedSolomon, RsError
    p, j = ReedSolomon(n, n_parity), JaxRs(n, n_parity)
    assert (p.n, p.k, p.t) == (j.n, j.k, j.t)
    assert np.array_equal(p.gen, j.gen)
    rng = np.random.default_rng(n)
    msg = rng.integers(0, 256, (12, p.k)).astype(np.uint8)
    cw = p.encode(msg)
    assert np.array_equal(cw, j.encode(msg))
    assert np.array_equal(p.encode(msg[0]), j.encode(msg[0]))
    bad = cw.copy()
    for r in range(12):
        pos = rng.choice(n, r, replace=False)
        bad[r, pos] ^= rng.integers(1, 256, r).astype(np.uint8)
    out, ok = p.decode_batch(bad)
    jout, jok = j.decode_batch(bad)
    assert np.array_equal(out, jout) and np.array_equal(ok, jok)
    assert ok[: p.t + 1].all() and np.array_equal(out[: p.t + 1],
                                                  msg[: p.t + 1])
    assert np.array_equal(p.decode(bad[1]), msg[1])
    if not ok[-1]:
        with pytest.raises(RsError):
            p.decode(bad[-1])


def test_scramble_stream_and_dvb_taps_match():
    """``scramble``, ``PnScramblerStream`` and ``DVB_TAPS`` (bit-exact)."""
    from orion_sdr_tpu.fec import scramble as j_scramble, \
        PnScramblerStream as JStream, DVB_TAPS as J_TAPS
    from orion_sdr_tpu_torch.fec import scramble, PnScramblerStream, \
        DVB_TAPS
    assert DVB_TAPS == J_TAPS
    data = np.random.default_rng(4).integers(0, 256, (3, 77)).astype(
        np.uint8)
    for taps, width, seed in ((DVB_TAPS, 15, 0x4A80), (0b1001, 7, 0x5B)):
        out = scramble(data, taps, width, seed)
        assert np.array_equal(out, j_scramble(data, taps, width, seed))
        assert np.array_equal(scramble(out, taps, width, seed), data)
        ours, ref = PnScramblerStream(taps, width, seed), \
            JStream(taps, width, seed)
        for a, b in ((0, 10), (10, 11), (11, 77)):
            assert np.array_equal(ours.feed(data[0, a:b]),
                                  ref.feed(data[0, a:b]))
        ours.reset()
        assert np.array_equal(ours.feed(data[0]), out[0])


def test_gf_inverse_power_and_single_codeword_bch_decode():
    """``gf_inv``, ``gf_pow_alpha`` and ``Bch.decode`` against the JAX
    package's (bit-exact; an uncorrectable word raises BchError in both)."""
    from orion_sdr_tpu.fec.galois import gf_inv as j_inv, \
        gf_pow_alpha as j_pow, Bch as JBch, BchError as JBchError
    from orion_sdr_tpu_torch.fec import gf_inv, gf_pow_alpha, gf_mul, Bch, \
        BchError
    a = np.arange(1, 256, dtype=np.uint8)
    assert np.array_equal(gf_inv(a), j_inv(a))
    assert np.all(gf_mul(a, gf_inv(a)) == 1)
    e = np.arange(-300, 600)
    assert np.array_equal(gf_pow_alpha(e), j_pow(e))
    rng = np.random.default_rng(9)
    for t, n in ((4, 255), (8, 184)):
        ours, ref = Bch(t, n), JBch(t, n)
        msg = rng.integers(0, 2, (3, ours.k)).astype(np.uint8)
        cw = ours.encode(msg)
        for errs in (0, 1, t):
            r = cw.copy()
            for row in r:
                row[rng.choice(n, errs, replace=False)] ^= 1
            assert np.array_equal(ours.decode(r), ref.decode(r))
            assert np.array_equal(ours.decode(r[0]), msg[0])
        r = cw[0].copy()
        r[rng.choice(n, 3 * t, replace=False)] ^= 1
        try:
            ref.decode(r)
            raised = False
        except JBchError:
            raised = True
        if raised:
            with pytest.raises(BchError):
                ours.decode(r)
        else:
            assert np.array_equal(ours.decode(r), ref.decode(r))
