"""Twins of the reason-(c) cases of ``torch_contracts.EXCLUDED``: a JAX test
that applies a numpy-only method to what the port returns (a tensor where
the JAX package returns an array), or compares it element-wise with a numpy
array, runs here with the same inputs and the same assertions on
``np.asarray(...)`` of the port's result. Each twin is exported into the
contract module of its JAX file and into the card file."""

import numpy as np
import pytest

import orion_sdr_tpu_torch as sdr
from torch_contracts import loaded, twin


def A(x):
    """What the port returned, as the JAX package returns it."""
    return np.asarray(x)


# ── (a) the cases that build their input with jnp.asarray: the same
# assertions on the numpy input the port takes ─────────────────────────────


@twin("test_digital.py::test_symbol_sync_gardner_tracks_offset")
def gardner_tracks_offset():
    from orion_sdr_tpu_torch.demodulate.digital import symbol_sync_gardner
    from orion_sdr_tpu_torch.dsp.fir import fir_filter_aligned
    from orion_sdr_tpu_torch.modulate.digital import burst_mod, rrc_taps
    rng = np.random.default_rng(1)
    sps = 8
    bits = rng.integers(0, 2, 2048).astype(np.uint8)
    iq = burst_mod(bits, "qpsk", sps)
    zf = A(fir_filter_aligned(A(iq), rrc_taps(sps)))
    syms, _ = symbol_sync_gardner(zf, sps + 0.0, len(zf) // sps - 10,
                                  mu0=3.0)
    mags = np.abs(A(syms)[200:])
    assert float(np.std(mags)) < 0.25 * float(np.mean(mags))


@twin("test_dsp.py::test_atan2_approx_accuracy")
def atan2_approx_accuracy():
    rng = np.random.default_rng(0)
    y = rng.standard_normal(20000).astype(np.float32) * 3
    x = rng.standard_normal(20000).astype(np.float32) * 3
    got = A(sdr.util.atan2_approx(y, x))
    err = np.abs(np.angle(np.exp(1j * (got - np.arctan2(y, x)))))
    assert float(err.max()) < 2e-3, float(err.max())


@twin("test_dvb_t.py::test_integer_cfo_on_frame_spectrum")
def integer_cfo_on_frame_spectrum():
    F = loaded("test_dvb_t.py")
    frame = sdr.DvbTFrameMod(sdr.DvbTFrameParams(F.LINK, 0, 0)).modulate(
        F._payload(184, 6))
    freq = A(sdr.multicarrier.symbol_fft(A(frame.iq), 2048, 64,
                                         n_symbols=4))
    accum = np.sum(np.abs(freq) ** 2, axis=0).astype(np.complex64)
    est = F.dvb_t_integer_cfo(accum, 2048, 32)
    assert est.bins == 0 and est.confidence > 1.5
    for k in (-7, 3):
        assert F.dvb_t_integer_cfo(np.roll(accum, k), 2048, 32).bins == k


@twin("test_fec_matrix.py::test_block_interleaver_inverse_u8")
@pytest.mark.parametrize("rows,cols", [(8, 8), (16, 32), (3, 97)])
def block_interleaver_inverse_u8(rows, cols):
    from orion_sdr_tpu_torch.fec.interleave import (block_deinterleave,
                                                    block_interleave)
    rng = np.random.default_rng(rows * cols)
    x = rng.integers(0, 256, (rows * cols,)).astype(np.uint8)
    y = A(block_interleave(x, rows, cols))
    assert not np.array_equal(y, x) or rows == 1 or cols == 1
    assert np.array_equal(A(block_deinterleave(y, rows, cols)), x)


@twin("test_fec_matrix.py::test_block_interleaver_inverse_f32")
def block_interleaver_inverse_f32():
    from orion_sdr_tpu_torch.fec.interleave import (block_deinterleave,
                                                    block_interleave)
    x = np.random.default_rng(5).standard_normal(16 * 32).astype(np.float32)
    y = A(block_interleave(x, 16, 32))
    assert np.array_equal(A(block_deinterleave(y, 16, 32)), x)


@twin("test_fec_matrix.py::test_ldpc_code_rule_error_injected")
@pytest.mark.parametrize("code", ["N512R12", "N576R23", "N512R34"])
@pytest.mark.parametrize("rule", ["sum_product", "min_sum", "scaled_min_sum"])
def ldpc_code_rule_error_injected(code, rule):
    from orion_sdr_tpu_torch.fec.ldpc import (ldpc_decode, ldpc_encode,
                                              ldpc_graph)
    g = ldpc_graph(code)
    rng = np.random.default_rng(len(code) * 100 + len(rule))
    msg = rng.integers(0, 2, (8, g.k)).astype(np.uint8)
    cw = A(ldpc_encode(code, msg))
    llr = (1.0 - 2.0 * cw).astype(np.float32) * 4.0
    n_flip = {"N512R12": 8, "N576R23": 4, "N512R34": 3}[code]
    for i in range(len(llr)):
        pos = rng.choice(g.n, n_flip, replace=False)
        llr[i, pos] = -llr[i, pos]
    bits, unsat = ldpc_decode(code, llr, 50, rule)
    assert np.array_equal(A(bits), msg)
    assert not np.any(A(unsat))


@twin("test_fec_matrix.py::test_ldpc_uncorrectable_flagged")
@pytest.mark.parametrize("code", ["N512R12", "N576R23", "N512R34"])
def ldpc_uncorrectable_flagged(code):
    from orion_sdr_tpu_torch.fec.ldpc import ldpc_decode, ldpc_graph
    g = ldpc_graph(code)
    llr = np.random.default_rng(7).standard_normal((4, g.n)).astype(
        np.float32) * 0.5
    _, unsat = ldpc_decode(code, llr, 20)
    assert np.any(A(unsat)), "random noise should not be a codeword"


@twin("test_multicarrier_matrix.py::test_fft_unity_roundtrip")
@pytest.mark.parametrize("n_fft", [64, 256, 1024, 2048])
def fft_unity_roundtrip(n_fft):
    from orion_sdr_tpu_torch.multicarrier import ofdm_assemble, symbol_fft
    rng = np.random.default_rng(n_fft)
    freq = (rng.standard_normal((3, n_fft)) +
            1j * rng.standard_normal((3, n_fft))).astype(np.complex64)
    back = symbol_fft(ofdm_assemble(freq, n_fft // 8), n_fft, n_fft // 8,
                      n_symbols=3)
    np.testing.assert_allclose(A(back), freq, atol=2e-4)


@twin("test_multicarrier_matrix.py::test_cyclic_prefix_is_tail_copy")
@pytest.mark.parametrize("cp_frac", [4, 8, 16, 32])
def cyclic_prefix_is_tail_copy(cp_frac):
    from orion_sdr_tpu_torch.multicarrier import ofdm_assemble
    n_fft = 256
    cp = n_fft // cp_frac
    rng = np.random.default_rng(cp)
    freq = (rng.standard_normal((1, n_fft)) +
            1j * rng.standard_normal((1, n_fft))).astype(np.complex64)
    t = A(ofdm_assemble(freq, cp))
    np.testing.assert_allclose(t[:cp], t[n_fft:], atol=1e-6)


@twin("test_multicarrier_matrix.py::test_grid_map_extract_roundtrip_with_pilots")
def grid_map_extract_roundtrip_with_pilots():
    from orion_sdr_tpu_torch.multicarrier import (CarrierGrid, CarrierPlan,
                                                  grid_extract, grid_map)
    plan = (CarrierPlan(64, 16)
            .with_pilot_carriers([(-8, 1.0), (8, -1.0)])
            .with_contiguous_data(edge_guard=2))
    g = CarrierGrid(plan)
    rng = np.random.default_rng(0)
    syms = (rng.standard_normal((2, 4, g.num_data_carriers)) +
            1j * rng.standard_normal((2, 4, g.num_data_carriers))
            ).astype(np.complex64)
    freq = A(grid_map(g, syms))
    assert np.allclose(freq[..., g.pilot_bins], [1.0, -1.0])
    assert np.allclose(freq[..., 0], 0.0)
    np.testing.assert_allclose(A(grid_extract(g, freq)), syms, atol=1e-6)


@twin("test_multicarrier_matrix.py::test_taper_rx_transparent_within_budget")
def taper_rx_transparent_within_budget():
    from orion_sdr_tpu_torch.multicarrier import (ofdm_assemble, symbol_fft,
                                                  symbol_taper)
    n_fft, cp, b, roll = 256, 64, 32, 16
    rng = np.random.default_rng(3)
    freq = (rng.standard_normal((4, n_fft)) +
            1j * rng.standard_normal((4, n_fft))).astype(np.complex64)
    plain = A(symbol_fft(ofdm_assemble(freq, cp), n_fft, cp, backoff=b,
                         n_symbols=4))
    taper = A(symbol_taper(n_fft + cp, roll))
    shaped = A(symbol_fft(ofdm_assemble(freq, cp, taper=taper), n_fft, cp,
                          backoff=b, n_symbols=4))
    np.testing.assert_allclose(shaped, plain, atol=2e-4)


@twin("test_multicarrier_matrix.py::test_figure9a_map_llr_roundtrip")
@pytest.mark.parametrize("v", [2, 4, 6])
def figure9a_map_llr_roundtrip(v):
    from orion_sdr_tpu_torch.waveform.dvb_t import (dvb_t_map_symbols,
                                                    dvb_t_soft_llrs)
    bits = np.random.default_rng(v).integers(0, 2, 1024 * v).astype(np.uint8)
    syms = dvb_t_map_symbols(bits, v)
    assert float(np.mean(np.abs(A(syms)) ** 2)) == pytest.approx(1.0,
                                                                 rel=0.1)
    hard = (A(dvb_t_soft_llrs(syms, v)) <= 0).astype(np.uint8)
    assert np.array_equal(hard, bits)


@twin("test_multicarrier_matrix.py::test_qpsk_figure9a_exact_points")
def qpsk_figure9a_exact_points():
    from orion_sdr_tpu_torch.waveform.dvb_t import dvb_t_map_symbols
    bits = np.array([0, 0, 0, 1, 1, 0, 1, 1], np.uint8)
    pts = A(dvb_t_map_symbols(bits, 2)) * np.sqrt(2)
    np.testing.assert_allclose(pts, [1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j],
                               atol=1e-6)


@twin("test_sync_matrix.py::test_sc_metric_plateau_has_peak_at_start")
def sc_metric_plateau_has_peak_at_start():
    F = loaded("test_sync_matrix.py")
    pre = F.OfdmPreamble(repeat_len=128, num_repeats=4)
    m, _ = F.sc_metric(F._preamble_capture(pre, offset=300), 128, 4)
    assert np.argmax(A(m)[:600]) <= 310


# ── (b) a name the port lacks: the same contract on the port's own code ──


@twin("test_digital.py::TestConstellation::test_qam16_gray_adjacency")
@pytest.mark.parametrize("order", ["qam16", "qam64", "qam256"])
def gray_adjacency(order):
    """Adjacent amplitude levels of an axis differ in exactly one bit: the
    I-axis bits of every natural level index, read off the port's
    ``map_bits``."""
    k = sdr.BITS_PER_SYMBOL[order] // 2
    words = [[(g >> (k - 1 - i)) & 1 for i in range(k)] * 2
             for g in range(1 << k)]
    amp = A(sdr.map_bits(np.array(words, np.uint8), order)).real[:, 0]
    order_idx = np.argsort(amp)
    for a, b in zip(order_idx[:-1], order_idx[1:]):
        assert bin(int(a) ^ int(b)).count("1") == 1


# ── (c) numpy methods on the port's tensors: the assertions on arrays ────


@twin("test_digital.py::test_fde_equalize_deep_isi")
def fde_equalize_deep_isi():
    from orion_sdr_tpu_torch.demodulate.digital import fde_equalize
    rng = np.random.default_rng(0)
    n_sym = 8192
    bits = rng.integers(0, 2, 2 * n_sym).astype(np.int64)
    sym = ((1 - 2 * bits[0::2]) + 1j * (1 - 2 * bits[1::2])) / np.sqrt(2)
    x = sym.astype(np.complex64)

    def ber(rx, off):
        got = np.empty(2 * len(rx), np.int64)
        got[0::2] = (rx.real < 0).astype(np.int64)
        got[1::2] = (rx.imag < 0).astype(np.int64)
        return np.mean(got != bits[2 * off: 2 * off + len(got)])

    h = np.zeros(6, np.complex64)
    h[0], h[1], h[4] = 1.0, 0.9 * np.exp(1j * 2.1), 0.35 * np.exp(-1j * 0.7)
    y = np.convolve(x, h)[:len(x)].astype(np.complex64)
    y = y + 0.03 * (rng.standard_normal(len(y))
                    + 1j * rng.standard_normal(len(y))).astype(np.complex64)
    eq = A(fde_equalize(y, x[:512], block=256, noise_var=2e-3))
    assert ber(y[512:7000], 512) > 0.1
    assert ber(eq[512:7000], 512) < 0.001
    with pytest.raises(ValueError):
        fde_equalize(y, x[:4])


@twin("test_digital.py::test_burst_modem_qam_orders")
def burst_modem_qam_orders():
    from orion_sdr_tpu_torch.demodulate.digital import burst_demod
    from orion_sdr_tpu_torch.dsp.osc import rotate
    from orion_sdr_tpu_torch.modulate.digital import burst_mod, burst_preamble
    rng = np.random.default_rng(0)
    sps = 8
    pre = burst_preamble(32)
    for order, nb in (("qpsk", 512), ("qam16", 1024), ("qam64", 1536),
                      ("qam256", 2048)):
        bits = rng.integers(0, 2, nb).astype(np.uint8)
        iq = burst_mod(bits, order, sps, preamble_syms=pre)
        z = np.concatenate([np.zeros(37, np.complex64), A(iq),
                            np.zeros(50, np.complex64)])
        z, _ = rotate(z, 0.0021 * sps, float(sps))
        z = A(z) * np.exp(1j * 1.1)
        z = z + 0.02 * (rng.standard_normal(len(z))
                        + 1j * rng.standard_normal(len(z))
                        ).astype(np.complex64)
        got, _ = burst_demod(z, order, sps, pre)
        got = A(got)
        n = min(len(got), len(bits))
        assert np.mean(got[:n] != bits[:n]) == 0.0, order


@twin("test_property_fuzz.py::test_random_chain_scheme_roundtrip")
@pytest.mark.parametrize("seed", range(6))
def random_chain_scheme_roundtrip(seed):
    from orion_sdr_tpu_torch.frame.chain import (block_plan, decode_chain,
                                                 encode_chain)
    from orion_sdr_tpu_torch.frame.types import (
        SCRAMBLER_BEFORE_OUTER, InnerFec, InterleaverKind, OuterFec,
        ScramblerKind)
    rng = np.random.default_rng(2000 + seed)
    outer = [OuterFec.none(), OuterFec.bch(int(rng.choice([2, 4, 8]))),
             OuterFec.reed_solomon(int(rng.choice([60, 204])),
                                   int(rng.choice([8, 16])))][
                                       int(rng.integers(0, 3))]
    inner = [InnerFec.ldpc(str(rng.choice(["N512R12", "N576R23"]))),
             InnerFec.convolutional(str(rng.choice(["1/2", "2/3", "3/4"])),
                                    str(rng.choice(["k5", "dvb_k7"])))][
                                        int(rng.integers(0, 2))]
    oil = [InterleaverKind.none(), InterleaverKind.block(8, 16),
           InterleaverKind.convolutional(4, 3)][int(rng.integers(0, 3))]
    iil = [InterleaverKind.none(),
           InterleaverKind.block(16, 32)][int(rng.integers(0, 2))]
    scr = [ScramblerKind.none(),
           ScramblerKind.additive(0b1001, 15, 0x3C3)][
               int(rng.integers(0, 2))]
    crc = str(rng.choice(["none", "crc16", "crc32"]))
    n_bytes = int(rng.integers(20, 400))
    data = rng.integers(0, 256, n_bytes).astype(np.uint8)
    plan = block_plan(n_bytes, crc, outer, inner, oil, iil)
    coded = A(encode_chain(data, crc, outer, inner, oil, iil, scr,
                           SCRAMBLER_BEFORE_OUTER, 5))
    assert len(coded) == plan.coded_bits, (outer, inner, oil, iil)
    llrs = (1.0 - 2.0 * coded.astype(np.float32)) * 4.0
    out, ok = decode_chain(llrs, plan, crc, outer, inner, oil, iil, scr,
                           SCRAMBLER_BEFORE_OUTER, 5)
    assert ok and np.array_equal(A(out)[:n_bytes], data), \
        (outer, inner, oil, iil, scr, crc)


@twin("test_dsp.py::test_band_compose_grid_exact_and_mixback")
def band_compose_grid_exact_and_mixback():
    dsp = sdr.dsp
    fs_in, m = 100_000.0, 8
    fs_out = fs_in * m
    n = 2048
    rng = np.random.default_rng(0)
    taps_bl = dsp.kaiser_lowpass_taps(63, 0.15, 60.0)
    x = A(dsp.fir_filter_aligned(
        (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64), taps_bl))[None]
    wide = A(dsp.band_compose(x, [0.0], fs_out, fs_in))
    assert wide.shape == (n * m,) and wide.dtype == np.complex64
    err = np.sqrt(np.mean(np.abs(wide[::m][100:-100] - x[0][100:-100]) ** 2))
    assert err < 1e-2 * np.sqrt(np.mean(np.abs(x) ** 2))
    c = 300e3
    wide2 = A(dsp.band_compose(x, [c], fs_out, fs_in))
    k = np.arange(1, len(wide2) + 1)
    down = wide2 * np.exp(-2j * np.pi * c / fs_out * k)
    err2 = np.sqrt(np.mean(np.abs(down[::m][100:-100] - x[0][100:-100]) ** 2))
    assert err2 < 2e-2 * np.sqrt(np.mean(np.abs(x) ** 2))


@twin("test_dsp.py::test_pfb_channelizer_tone_mapping_and_leakage")
def pfb_channelizer_tone_mapping_and_leakage():
    from orion_sdr_tpu_torch.dsp.pfb import pfb_channel_freqs, pfb_channelize
    fs, C, n = 1_024_000.0, 32, 1 << 17
    t = np.arange(n) / fs
    freqs = A(pfb_channel_freqs(C, fs))
    x = (np.exp(2j * np.pi * (freqs[5] + 2000.0) * t)
         + 0.5 * np.exp(2j * np.pi * (freqs[-3] - 1500.0) * t)
         ).astype(np.complex64)
    y = A(pfb_channelize(x, C))
    pw = np.mean(np.abs(y) ** 2, axis=-1)
    order = np.argsort(pw)[::-1]
    assert set(order[:2]) == {5, C - 3}
    assert abs(np.sqrt(pw[5]) - 1.0) < 0.01
    assert abs(np.sqrt(pw[C - 3]) - 0.5) < 0.01
    assert 10 * np.log10(pw[order[2]] / pw[5]) < -60.0
    row = y[5]
    dphi = np.angle(row[1:] * np.conj(row[:-1]))
    assert abs(np.median(dphi) * (fs / C) / (2 * np.pi) - 2000.0) < 20.0
    row2 = y[C - 3]
    dphi2 = np.angle(row2[1:] * np.conj(row2[:-1]))
    assert abs(np.median(dphi2) * (fs / C) / (2 * np.pi) + 1500.0) < 20.0


@twin("test_ofdm.py::TestEqualizer::test_estimate_denoise_shrinks_noise")
def estimate_denoise_shrinks_noise():
    from orion_sdr_tpu_torch.ofdm import channel_estimate_denoise
    rng = np.random.default_rng(7)
    n_fft, cp = 256, 64
    truth = np.fft.fft(np.concatenate([
        [1.0, 0.4], np.zeros(n_fft - 2)])).astype(np.complex64)
    noise = 0.2 * (rng.standard_normal(n_fft) +
                   1j * rng.standard_normal(n_fft)).astype(np.complex64)
    den = A(channel_estimate_denoise(truth + noise, cp))
    assert np.mean(np.abs(den - truth) ** 2) < 0.4 * np.mean(
        np.abs(noise) ** 2)


def _tone(n=20000, f=500.0, fs=8000.0):
    return np.exp(2j * np.pi * f * np.arange(n) / fs).astype(np.complex64)


@twin("test_channel.py::test_phase_noise_identity_power_and_walk_variance")
def phase_noise_identity_power_and_walk_variance():
    fs = 8000.0
    rng = np.random.default_rng(3)
    x = _tone()
    assert np.abs(A(sdr.phase_noise_apply(rng, x, 0.0, fs)) - x).max() == 0.0
    y = A(sdr.phase_noise_apply(rng, x, 2.0, fs))
    assert abs(float(np.mean(np.abs(y) ** 2)) - 1.0) < 1e-3
    incr = np.diff(np.unwrap(np.angle(y * np.conj(x))))
    assert abs(incr.var() / (2 * np.pi * 2.0 / fs) - 1.0) < 0.1


@twin("test_channel.py::test_multipath_normalized_unit_power")
def multipath_normalized_unit_power():
    x = sdr.awgn(np.random.default_rng(0), 1 << 16, 1.0)
    y = A(sdr.multipath_apply(x, [0, 11, 23], [1.0, 0.6, 0.3j]))
    assert abs(float(np.mean(np.abs(y) ** 2)) - 1.0) < 0.05


@twin("test_channel.py::test_watterson_power_and_empty")
def watterson_power_and_empty():
    rng = np.random.default_rng(21)
    x = _tone(40000)
    y = A(sdr.watterson_apply(rng, x, 8000.0, 1e-3, 0.5))
    assert y.shape == x.shape and y.dtype == np.complex64
    assert 0.3 < float(np.mean(np.abs(y) ** 2)) < 3.0
    assert A(sdr.watterson_apply(rng, np.zeros(0, np.complex64),
                                 8000.0)).size == 0


@twin("test_channel.py::test_ft8_through_watterson_moderate")
def ft8_through_watterson_moderate():
    from orion_sdr_tpu_torch.codec.ft8 import ft8_encode, ft8_frame_llr_hard
    from orion_sdr_tpu_torch.demodulate.ft8 import ft8_demod
    from orion_sdr_tpu_torch.modulate.ft8 import ft8_mod
    fs = 12000.0
    rng = np.random.default_rng(42)
    p = rng.integers(0, 256, 10).astype(np.uint8)
    p[9] &= 0xF8
    x = A(ft8_mod(ft8_encode(p), fs, 1000.0))
    ok = 0
    for seed in (0, 1):
        r = np.random.default_rng(seed)
        y = A(sdr.watterson_apply(r, x, fs, 1e-3, 0.5))
        sig = float(np.mean(np.abs(y) ** 2))
        y = y + A(sdr.awgn(r, len(y), np.sqrt(sig * 0.5)))
        rx = ft8_demod(y, fs, 1000.0)
        assert rx is not None
        dec = sdr.ft8_decode_soft(ft8_frame_llr_hard(A(rx)))
        if dec is not None and np.array_equal(A(dec).astype(np.uint8), p):
            ok += 1
    assert ok == 2


@twin("test_css.py::test_css_crc_guards_corruption")
def css_crc_guards_corruption():
    from orion_sdr_tpu_torch.demodulate.css import css_demod
    from orion_sdr_tpu_torch.modulate.css import (css_mod,
                                                  css_samples_per_symbol)
    msg = loaded("test_css.py").MSG
    iq = A(css_mod(msg, sf=7)).copy()
    spsym = css_samples_per_symbol(7, 125_000.0, 125_000.0)
    k = (8 + 2 + 3) * spsym
    iq[k:k + 2 * spsym] = 0
    out = css_demod(iq, sf=7)
    assert out is None or not out.crc_ok or out.payload == msg


@twin("test_ax25.py::test_afsk_end_to_end_two_frames_awgn")
def afsk_end_to_end_two_frames_awgn():
    from orion_sdr_tpu_torch.codec.ax25 import Ax25Frame
    from orion_sdr_tpu_torch.demodulate.afsk import ax25_decode
    from orion_sdr_tpu_torch.modulate.afsk import ax25_beacon
    fs = 48_000.0
    f1 = Ax25Frame(dest="APRS", src="W1AW-5", digis=("WIDE1-1",),
                   payload=b"!4237.14N/07120.83W-orion test")
    f2 = Ax25Frame(dest="CQ", src="N0CALL", payload=b"hello packet")
    audio = A(ax25_beacon([f1, f2], fs))
    assert ax25_decode(audio, fs) == [f1, f2]
    rng = np.random.default_rng(0)
    sig_p = float(np.mean(audio ** 2))
    noisy = audio + rng.standard_normal(len(audio)).astype(np.float32) \
        * np.sqrt(sig_p / 10 ** 0.6)
    assert ax25_decode(noisy, fs) == [f1, f2]


@twin("test_ax25.py::test_rtty_end_to_end_awgn")
def rtty_end_to_end_awgn():
    from orion_sdr_tpu_torch.demodulate.afsk import rtty_decode
    from orion_sdr_tpu_torch.modulate.afsk import rtty_mod
    fs = 11025.0
    msg = "CQ CQ DE W1AW W1AW K 599 #73!"
    audio = A(rtty_mod(msg, fs))
    assert rtty_decode(audio, fs) == msg
    rng = np.random.default_rng(0)
    sig_p = float(np.mean(audio ** 2))
    noisy = audio + rng.standard_normal(len(audio)).astype(np.float32) \
        * np.sqrt(sig_p / 10 ** 0.8)
    assert rtty_decode(noisy, fs) == msg


@twin("test_sstv.py::test_sstv_under_noise")
def sstv_under_noise():
    from orion_sdr_tpu_torch.demodulate.sstv import sstv_demod
    from orion_sdr_tpu_torch.modulate.sstv import MARTIN_M1, sstv_mod
    F = loaded("test_sstv.py")
    img = F._test_image()
    audio = A(sstv_mod(img, F.FS))
    rng = np.random.default_rng(0)
    noisy = audio + rng.standard_normal(len(audio)).astype(np.float32) \
        * np.sqrt(np.mean(audio ** 2) / 10 ** 2)
    out = sstv_demod(noisy, F.FS)
    assert out.vis == MARTIN_M1["vis"]
    assert F._psnr(A(out.image), img) > 25.0


@twin("test_resample.py::test_batched_and_empty")
def resample_batched_and_empty():
    dsp = sdr.dsp
    x = np.random.default_rng(4).standard_normal((3, 500)).astype(np.float32)
    y = A(dsp.resample(x, 2, 3))
    assert y.shape == (3, -(-500 * 2 // 3))
    for i in range(3):
        np.testing.assert_allclose(y[i], A(dsp.resample(x[i], 2, 3)),
                                   atol=1e-5)
    r = dsp.Resampler(2, 3)
    assert A(r.feed(np.zeros(0, np.float32))).size == 0
    with pytest.raises(ValueError):
        dsp.Resampler(0, 3)
