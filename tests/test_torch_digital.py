"""Torch port, the single-carrier burst modem (constellation.decide,
modulate/digital.py, demodulate/digital.py, ops/dd_pll.py, ops/gardner.py)
against the JAX package on the CPU, with the same numpy inputs.

Tolerances: exact for decisions (threshold ties and signed zeros
included), constellation points, mapped symbols, baseband IQ, recovered
bits and the energy-timing phase. The RRC-shaped burst within 1e-6 of its
peak (both packages run one float32 correlation a row; measured 0). The
DD-PLL's and the Gardner loop's plain versions against the JAX scans
within 1e-5 absolute on unit-scale symbols (the port rounds every product
and sum apart where XLA fuses some into multiply-adds, and its cos, sin
and atan2 are torch's: measured 1.3e-7 over 64 symbols), with the
decisions of the DD-PLL's output exact on these clean inputs. IQ through
a carrier within 1e-5 (the phase ramp's rounding), the CFO estimate
within 1e-3 Hz, the SC-FDE output within 1e-4 of its peak (FFT and sum
orders; measured 2e-6), and energy-timed symbols within 1e-5."""

import jax.numpy as jnp  # (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from orion_sdr_tpu import constellation as JC
from orion_sdr_tpu.demodulate import digital as JD
from orion_sdr_tpu.dsp.fir import fir_filter_aligned as jfir
from orion_sdr_tpu.dsp.osc import rotate as jrotate
from orion_sdr_tpu.modulate import digital as JM

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch import constellation as PC
from orion_sdr_tpu_torch.modulate import digital as PM
from orion_sdr_tpu_torch.ops import dd_pll as DP
from orion_sdr_tpu_torch.ops import gardner as GA

torch.set_num_threads(1)
CPU = "cpu"
FS = 48_000.0
ORDERS = ["bpsk", "qpsk", "qam16", "qam64", "qam256"]
LOOP_ATOL = 1e-5


def bits_for(order, n_syms, seed):
    bps = JC.BITS_PER_SYMBOL[order]
    return np.random.default_rng(seed).integers(0, 2, n_syms * bps).astype(
        np.uint8)


@pytest.mark.parametrize("order", ORDERS)
def test_decide_exact_with_ties(order):
    """Random symbols plus every threshold on both axes, ±0 and the
    levels themselves: the port's decisions equal the JAX package's."""
    rng = np.random.default_rng(1)
    z = (rng.standard_normal(400) + 1j * rng.standard_normal(400)) * 0.7
    bps = JC.BITS_PER_SYMBOL[order]
    thr = (JC._axis_thresholds(bps) if bps > 2 else np.zeros(1, np.float32))
    lv = JC._axis_levels(max(bps, 2))
    edge = [complex(a, b) for a in thr for b in thr[::-1]]
    edge += [complex(a, -0.0) for a in thr] + [complex(-0.0, 0.0), 0j]
    edge += [complex(a, b) for a in lv for b in lv]
    z = np.concatenate([z, np.asarray(edge)]).astype(np.complex64)
    got = PC.decide(torch.as_tensor(z), order).numpy()
    assert np.array_equal(got, np.asarray(JC.decide(z, order)))
    assert np.array_equal(PC.constellation_points(order),
                          JC.constellation_points(order))
    if bps > 2:
        assert np.array_equal(PC._axis_thresholds(bps), thr)


@pytest.mark.parametrize("order", ORDERS)
def test_decide_tables_give_map_of_decide(order):
    """The kernel's tables: each axis level at each decision equals
    map_bits(decide(y)) on random symbols."""
    thr, lv, sign = PC.decide_tables(order)
    z = torch.as_tensor((np.random.default_rng(2).standard_normal((2, 300))
                         * 0.8).astype(np.float32))
    y = torch.complex(z[0], z[1])
    ref = PC.map_bits(PC.decide(y[:, None], order), order)[:, 0]
    t, l_ = torch.as_tensor(thr), torch.as_tensor(lv)
    rr = DP._axis_level(y.real, t, l_, sign)
    ri = torch.zeros(300) if order == "bpsk" else \
        DP._axis_level(y.imag, t, l_, sign)
    assert torch.equal(rr, ref.real) and torch.equal(ri, ref.imag)


@pytest.mark.parametrize("order", ORDERS)
def test_digital_mod_demod_baseband(order):
    bits = bits_for(order, 120, 3)
    j_iq, _ = JM.digital_mod(bits, order, FS, 0.0, 1.0)
    p_iq, _ = P.digital_mod(bits, order, FS, 0.0, 1.0, device=CPU)
    assert np.array_equal(p_iq.numpy(), np.asarray(j_iq))
    got, _ = P.digital_demod(np.asarray(j_iq), order, FS, device=CPU)
    assert np.array_equal(got.numpy(), bits)
    back, _ = JD.digital_demod(p_iq.numpy(), order, FS)
    assert np.array_equal(np.asarray(back), bits)


@pytest.mark.parametrize("order", ["qpsk", "qam64"])
def test_digital_mod_demod_with_carrier(order):
    """tests/test_digital.py's 12 kHz carrier: IQ within 1e-5, bits back
    across packages."""
    bits = bits_for(order, 120, 4)
    j_iq, jp = JM.digital_mod(bits, order, FS, 12_000.0, 1.0)
    p_iq, pp = P.digital_mod(bits, order, FS, 12_000.0, 1.0, device=CPU)
    assert np.abs(p_iq.numpy() - np.asarray(j_iq)).max() <= 1e-5
    assert abs(float(pp) - float(jp)) <= 1e-5
    got, _ = P.digital_demod(np.asarray(j_iq), order, FS, 12_000.0,
                             device=CPU)
    assert np.array_equal(got.numpy(), bits)
    back, _ = JD.digital_demod(p_iq.numpy(), order, FS, 12_000.0)
    assert np.array_equal(np.asarray(back), bits)


def test_batched_channels():
    bits = np.random.default_rng(5).integers(0, 2, (8, 512)).astype(np.uint8)
    iq, _ = P.digital_mod(bits, "qpsk", FS, device=CPU)
    assert tuple(iq.shape) == (8, 256)
    out, _ = P.digital_demod(iq, "qpsk", FS, device=CPU)
    assert np.array_equal(out.numpy(), bits)


def _rotated(order, n, seed, cfo=0.02, ph=0.3, noise=0.01):
    rng = np.random.default_rng(seed)
    s = np.asarray(JC.map_bits(bits_for(order, n, seed), order))
    k = np.arange(n)
    return (s * np.exp(1j * (ph + cfo * k)) + noise * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


@pytest.mark.parametrize("order", ORDERS)
def test_dd_pll_plain_version_matches_jax_scan(order):
    """64 symbols with a 0.3 rad offset and a 0.02 rad/symbol ramp, three
    rows at once (the JAX bench's vmap written out)."""
    z = np.stack([_rotated(order, 64, s) for s in (6, 7, 8)])
    got = DP.dd_pll(torch.as_tensor(z), order, 0.03).numpy()
    for r in range(3):
        ref = np.asarray(JD._dd_pll_kernel(z[r].real.copy(),
                                           z[r].imag.copy(), order, 0.03))
        assert np.abs(got[r] - ref).max() <= LOOP_ATOL
        assert np.array_equal(np.asarray(JC.decide(ref, order)),
                              PC.decide(torch.as_tensor(got[r]),
                                        order).numpy())
    out = P.carrier_sync_dd(z[0], order, 0.03, device=CPU).numpy()
    assert np.array_equal(out, got[0])


@pytest.mark.parametrize("mu0", [3.0, -2.5])
def test_gardner_plain_version_matches_jax_scan(mu0):
    """tests/test_digital.py's Gardner setup at 64 symbols, and a start
    before the capture (the interpolator extrapolates there)."""
    bits = bits_for("qpsk", 256, 9)
    iq = np.asarray(JM.burst_mod(bits, "qpsk", 8))
    zf = np.asarray(jfir(jnp.asarray(iq), JM.rrc_taps(8)))
    js, jpos = JD.symbol_sync_gardner(zf, 8.0, 64, mu0=mu0)
    ps, ppos = P.symbol_sync_gardner(zf, 8.0, 64, mu0=mu0, device=CPU)
    assert np.abs(ps.numpy() - np.asarray(js)).max() <= LOOP_ATOL
    assert abs(float(ppos) - float(jpos)) <= 1e-3
    rows = np.stack([zf, zf[::-1].copy()])
    bs, bpos = GA.gardner(torch.as_tensor(rows), 8.0, 64, 0.02, mu0)
    assert torch.equal(bs[0], ps) and float(bpos[0]) == float(ppos)


def test_gardner_runs_off_the_end_and_takes_empty_rows():
    """More symbols than the capture holds: the index clips to n − 2 and
    the interpolator extrapolates, as the JAX scan does."""
    z = _rotated("qpsk", 40, 10)
    js, jpos = JD.symbol_sync_gardner(z, 4.0, 30, mu0=1.0)
    ps, ppos = P.symbol_sync_gardner(z, 4.0, 30, mu0=1.0, device=CPU)
    assert np.abs(ps.numpy() - np.asarray(js)).max() <= LOOP_ATOL * max(
        1.0, float(np.abs(np.asarray(js)).max()))
    assert abs(float(ppos) - float(jpos)) <= 1e-3 * abs(float(jpos))
    s, pos = GA.gardner(torch.zeros((0, 16), dtype=torch.complex64), 4.0, 5)
    assert tuple(s.shape) == (0, 5) and tuple(pos.shape) == (0,)
    s, pos = GA.gardner(torch.zeros((3, 0), dtype=torch.complex64), 4.0, 0)
    assert tuple(s.shape) == (3, 0) and float(pos[0]) == 4.0
    with pytest.raises(ValueError):
        GA.gardner(torch.zeros((3, 1), dtype=torch.complex64), 4.0, 2)


def test_dd_pll_empty_rows():
    assert tuple(DP.dd_pll(torch.zeros((0, 8), dtype=torch.complex64),
                           "qpsk", 0.03).shape) == (0, 8)
    assert tuple(DP.dd_pll(torch.zeros((4, 0), dtype=torch.complex64),
                           "qam16", 0.03).shape) == (4, 0)


@pytest.mark.parametrize("order", ["qpsk", "qam16"])
def test_burst_mod_matches(order):
    pre = JM.burst_preamble(32)
    assert np.array_equal(PM.burst_preamble(32), pre)
    assert np.array_equal(PM.rrc_taps(8), JM.rrc_taps(8))
    bits = bits_for(order, 200, 11)
    ref = np.asarray(JM.burst_mod(bits, order, 8, preamble_syms=pre))
    got = P.burst_mod(bits, order, 8, preamble_syms=pre, device=CPU).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def _impaired(iq, sps, seed):
    """tests/test_digital.py:142-169: 37-sample delay, CFO of 0.21 % of
    the baud rate, 1.1 rad, noise at 0.02 (about 34 dB)."""
    rng = np.random.default_rng(seed)
    z = np.concatenate([np.zeros(37, np.complex64), iq,
                        np.zeros(50, np.complex64)])
    z, _ = jrotate(z, 0.0021 * sps, float(sps))
    z = np.asarray(z) * np.exp(1j * 1.1)
    return (z + 0.02 * (rng.standard_normal(len(z))
                        + 1j * rng.standard_normal(len(z)))
            ).astype(np.complex64)


@pytest.mark.parametrize("order,nb", [("qpsk", 512), ("qam16", 1024),
                                      ("qam64", 1536), ("qam256", 2048)])
def test_burst_roundtrip_across_packages(order, nb):
    """A burst modulated by either package decodes in the other, every
    bit, and the two receivers give the same bits on the same capture."""
    sps, pre = 8, JM.burst_preamble(32)
    bits = np.random.default_rng(nb).integers(0, 2, nb).astype(np.uint8)
    zj = _impaired(np.asarray(JM.burst_mod(bits, order, sps,
                                           preamble_syms=pre)), sps, 1)
    got, payload = P.burst_demod(zj, order, sps, pre, device=CPU)
    n = min(len(got), nb)
    assert np.array_equal(got.numpy()[:n], bits[:n])
    ref, _ = JD.burst_demod(zj, order, sps, pre)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    zp = _impaired(P.burst_mod(bits, order, sps, preamble_syms=pre,
                               device=CPU).numpy(), sps, 2)
    back, _ = JD.burst_demod(zp, order, sps, pre)
    assert np.array_equal(np.asarray(back)[:n], bits[:n])


def test_burst_demod_qam256_draw_both_packages_lose():
    """256-QAM at ~34 dB is not error-free on every noise draw, in the JAX
    package too: numpy seed 39, after the burst modem bench's inputs (4 and
    64 rows of 16384 float32 normals, real then imaginary) and the draws
    of BPSK to 64-QAM, loses 13 bits. Both receivers give the same bits on
    that capture (the port's impairments as chip_smoke's burst phase draws
    them, on the CPU)."""
    from orion_sdr_tpu_torch.dsp.osc import rotate
    sps, pre = 8, PM.burst_preamble(32)
    rng = np.random.default_rng(39)
    for rows in (4, 64):
        rng.standard_normal((rows, 2048 * sps)).astype(np.float32)
        rng.standard_normal((rows, 2048 * sps)).astype(np.float32)
    for order, nb in (("bpsk", 256), ("qpsk", 512), ("qam16", 1024),
                      ("qam64", 1536), ("qam256", 2048)):
        bits = rng.integers(0, 2, nb).astype(np.uint8)
        iq = P.burst_mod(bits, order, sps, preamble_syms=pre, device=CPU)
        z = torch.cat([torch.zeros(37, dtype=torch.complex64), iq,
                       torch.zeros(50, dtype=torch.complex64)])
        z = rotate(z, 0.0021 * sps, float(sps))[0] * np.exp(1j * 1.1)
        z = (z + torch.as_tensor((0.02 * (
            rng.standard_normal(z.shape[0])
            + 1j * rng.standard_normal(z.shape[0]))).astype(np.complex64))
             ).to(torch.complex64).numpy()
    got, _ = P.burst_demod(z, "qam256", sps, pre, device=CPU)
    ref, _ = JD.burst_demod(z, "qam256", sps, pre)
    got, ref = got.numpy(), np.asarray(ref)
    assert np.array_equal(got, ref)
    n = min(len(got), nb)
    assert int((got[:n] != bits[:n]).sum()) + (nb - n) == 13


def test_burst_demod_rejects_short_bursts():
    with pytest.raises(ValueError):
        P.burst_demod(np.zeros(64, np.complex64), "qpsk", 8,
                      JM.burst_preamble(32), device=CPU)


def test_symbol_sync_energy_matches():
    bits = bits_for("qam16", 300, 12)
    iq = np.asarray(JM.burst_mod(bits, "qam16", 8))
    zf = np.concatenate([np.zeros(3, np.complex64), iq])
    js, jph = JD.symbol_sync_energy(zf, 8)
    ps, pph = P.symbol_sync_energy(zf, 8, device=CPU)
    assert pph == jph
    assert np.abs(ps.numpy() - js).max() <= 1e-5


def test_cfo_estimate_and_fde_match():
    """tests/test_digital.py's blind CFO burst and deep-ISI SC-FDE."""
    rng = np.random.default_rng(0)
    fs = 100_000.0
    b = rng.integers(0, 2, 4096).astype(np.int64)
    sym = ((1 - 2 * b[0::2]) + 1j * (1 - 2 * b[1::2])) / np.sqrt(2)
    z = np.asarray(jrotate(np.repeat(sym, 8).astype(np.complex64), 1234.5,
                           fs)[0])
    z = (z + 0.05 * (rng.standard_normal(len(z))
                     + 1j * rng.standard_normal(len(z)))).astype(np.complex64)
    got = P.estimate_cfo_mpsk(z, fs, 4, device=CPU)
    assert abs(got - JD.estimate_cfo_mpsk(z, fs, 4)) <= 1e-3
    assert abs(got - 1234.5) < 2.0
    x = sym[:2048].astype(np.complex64)
    h = np.zeros(6, np.complex64)
    h[0], h[1], h[4] = 1.0, 0.9 * np.exp(1j * 2.1), 0.35 * np.exp(-1j * 0.7)
    y = np.convolve(x, h)[:len(x)].astype(np.complex64)
    y = (y + 0.03 * (rng.standard_normal(len(y))
                     + 1j * rng.standard_normal(len(y)))).astype(np.complex64)
    ref = JD.fde_equalize(y, x[:512], block=256, noise_var=2e-3)
    eq = P.fde_equalize(y, x[:512], block=256, noise_var=2e-3, device=CPU)
    assert eq.shape[-1] == len(y)
    assert np.abs(eq.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    with pytest.raises(ValueError):
        P.fde_equalize(y, x[:4], device=CPU)


def test_flat_namespace_has_the_slice_names():
    import orion_sdr_tpu as J
    names = ["map_bits", "decide", "soft_llr", "BITS_PER_SYMBOL",
             "estimate_cfo_mpsk", "fde_equalize", "burst_demod",
             "symbol_sync_gardner", "symbol_sync_energy", "carrier_sync_dd",
             "burst_mod", "burst_preamble", "rrc_taps", "psk_qam_mod",
             "digital_mod", "psk_qam_demod", "digital_demod",
             "GPS_NAV_PREAMBLE", "GpsAcquisition", "GpsTrack", "gps_ca_code",
             "gps_ca_mod", "gps_acquire", "gps_track", "gps_nav_frame_sync",
             "GpsEphemeris", "GpsNavFrame", "GpsSubframe", "GpsAlmanac",
             "GpsIono", "GpsUtc", "nav_word_encode", "nav_word_check",
             "nav_subframes_encode", "nav_subframes_decode",
             "almanac_page_words", "iono_utc_page_words", "eph_sat_pos",
             "alm_sat_pos", "klobuchar_delay", "gps_fix",
             "gps_decode_ephemeris", "AisPosition", "ais_mod", "ais_decode",
             "PocsagPage", "pocsag_codeword", "pocsag_check", "pocsag_mod",
             "pocsag_decode", "Ax25Frame", "ax25_crc", "hdlc_encode",
             "hdlc_decode", "afsk1200_mod", "ax25_beacon", "nrzi_encode",
             "nrzi_decode", "AFSK_BAUD", "rtty_mod", "afsk1200_demod",
             "ax25_decode", "rtty_decode", "Afsk1200Stream",
             "baudot_encode", "baudot_decode"]
    for nm in names:
        assert hasattr(J, nm) and hasattr(P, nm), nm
