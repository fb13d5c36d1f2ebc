"""Torch port: the TX lowpass (dsp/fir.py design and aligned filtering,
multicarrier/txlp.py) against the JAX package. Design numbers equal, taps
within 1e-6; filtered unit-RMS signals within 1e-5 on both of the port's
filter paths (direct convolution and FFT overlap-save, which round
differently from XLA's); the COFDM and DVB-T modulators with a mask within
1e-5 of the JAX modulators' IQ (FFT rounding), and a masked DVB-T frame
decoding in the port."""

import dataclasses

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import orion_sdr_tpu.frame as J
from orion_sdr_tpu.dsp import fir as JF
from orion_sdr_tpu.modulate.dvb_t_frame import DvbTFrameMod as JMod
from orion_sdr_tpu.modulate.dvb_t_frame import tx_lowpass_for_2k as jax_2k
from orion_sdr_tpu.multicarrier import CarrierPlan as JaxPlan
from orion_sdr_tpu.multicarrier import TxLowpass as JaxLowpass
from orion_sdr_tpu.ofdm import OfdmConfig as JaxOfdmConfig
from orion_sdr_tpu.sync.ofdm_sync import OfdmPreamble as JaxPreamble
from orion_sdr_tpu.waveform import dvb_t as JD

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch import convert
from orion_sdr_tpu_torch.dsp import fir as PF
from orion_sdr_tpu_torch.modulate.dvb_t_frame import tx_lowpass_for_2k
from orion_sdr_tpu_torch.multicarrier import TxLowpass

# The plain torch versions run thousands of tiny ops; with one test worker
# per core, a torch thread pool as wide as the machine in every worker
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

NULL_BANDS = [(256, 96, 65, 60.0), (256, 97, 45, 60.0), (2048, 852, 89, 60.0),
              (64, 30, 45, 40.0), (512, 250, 201, 70.0)]


@pytest.mark.parametrize("n_fft,occ,taps,a_db", NULL_BANDS)
def test_lowpass_design_matches(n_fft, occ, taps, a_db):
    ours = TxLowpass.for_null_band(n_fft, occ, taps, a_db)
    ref = JaxLowpass.for_null_band(n_fft, occ, taps, a_db)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert TxLowpass.taps_for_null_band(n_fft, occ, a_db) == \
        JaxLowpass.taps_for_null_band(n_fft, occ, a_db)
    assert ours.group_delay() == ref.group_delay()
    assert ours.transition_norm() == ref.transition_norm()
    assert ours.stopband_edge_norm() == ref.stopband_edge_norm()
    assert ours.transition_fits(n_fft, occ) == ref.transition_fits(n_fft, occ)
    for cp, roll, backoff in ((256, 20, 85), (64, 40, 32), (256, 40, 64),
                              (64, 0, 44)):
        assert ours.fits_guard(cp, roll, backoff) == \
            ref.fits_guard(cp, roll, backoff)
    np.testing.assert_allclose(ours.taps(), np.asarray(ref.taps()), rtol=0,
                               atol=1e-6)
    for a in (10.0, 30.0, 60.0):
        assert PF.kaiser_beta(a) == JF.kaiser_beta(a)


def _signal(shape, seed, cplx=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if cplx:
        x = (x + 1j * rng.standard_normal(shape)) / np.sqrt(2)
    return x.astype(np.complex64 if cplx else np.float32)


# each package picks its filter path by tap count (the JAX package's
# crossover is 160 taps, the port's _FFT_MIN_TAPS), so both of the port's
# paths are also checked at every count; 1 is the pass-through
@pytest.mark.parametrize("n_taps", [1, 65, 89, 201])
@pytest.mark.parametrize("cplx", [True, False])
def test_fir_filter_aligned_matches(n_taps, cplx):
    x = _signal((2, 3000), n_taps, cplx)
    taps = JF.kaiser_lowpass_taps(n_taps, 0.3, 60.0)
    ref = np.asarray(JF.fir_filter_aligned(x, taps))
    ours = PF.fir_filter_aligned(torch.as_tensor(x), taps)
    assert ours.shape == ref.shape and ours.numpy().dtype == ref.dtype
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)
    if n_taps > 1:
        # both of the port's paths, whichever the crossover picks
        xp = torch.nn.functional.pad(torch.as_tensor(x.real),
                                     (n_taps - 1, n_taps // 2))
        for path in (PF._conv_direct, PF._fft_overlap_save):
            y = path(xp, taps)[:, n_taps // 2:n_taps // 2 + 3000]
            np.testing.assert_allclose(y.numpy(), ref.real, rtol=0,
                                       atol=1e-5)


def test_fft_path_takes_more_than_one_block():
    # longer than one 65 536-sample block: the overlap-save seams
    x = _signal((70000,), 3, cplx=False)
    taps = JF.kaiser_lowpass_taps(255, 0.2, 60.0)
    xp = torch.nn.functional.pad(torch.as_tensor(x), (254, 0))[None]
    ours = PF._fft_overlap_save(xp, taps)[0].numpy()
    ref = np.asarray(JF._conv_valid_f32(np.pad(x, (254, 0))[None], taps))[0]
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def _cofdm_links():
    jc = JaxOfdmConfig(JaxPlan(256, 64).with_contiguous_data(edge_guard=16),
                       fs=1e6).with_symbol_window(8)
    pc = P.OfdmConfig(P.CarrierPlan(256, 64).with_contiguous_data(
        edge_guard=16), fs=1e6).with_symbol_window(8)
    jp = JaxPreamble(repeat_len=128, num_repeats=4).with_training_symbol(256,
                                                                         64)
    pp = P.OfdmPreamble(repeat_len=128, num_repeats=4).with_training_symbol(
        256, 64)
    return jc, pc, jp, pp


def test_ofdm_frame_mod_with_lowpass_matches():
    jc, pc, jp, pp = _cofdm_links()
    jc = jc.with_tx_lowpass_null_band(65, 60.0)
    pc = pc.with_tx_lowpass_null_band(65, 60.0)
    assert convert.ofdm_config_from_fields(dataclasses.asdict(jc)) == pc
    jmod = J.OfdmFrameMod(jc, J.McsTable.default_ladder(), jp)
    pmod = P.OfdmFrameMod(pc, P.McsTable.default_ladder(), pp, device="cpu")
    for mcs in (0, 2):
        data = np.random.default_rng(mcs).integers(0, 256, 90).astype(
            np.uint8)
        ref = jmod.modulate_frame(J.FramePacket(J.FrameMetadata(4, mcs),
                                                data), 77)
        ours = pmod.modulate_frame(P.FramePacket(P.FrameMetadata(4, mcs),
                                                 data), 77)
        assert ours.dtype == np.complex64 and ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_ofdm_frame_with_lowpass_round_trips_in_the_port():
    _, pc, _, pp = _cofdm_links()
    # the mask's group delay (32) needs the RX window backed off into the
    # guard (roll_off + delay <= min(cp − backoff, backoff)), and the
    # backed-off window's phase ramp needs the training-symbol estimate of
    # the stream receiver
    pc = pc.with_symbol_window(0).with_tx_lowpass_null_band(
        65, 60.0).with_rx_window_backoff(32)
    assert pc.tx_lowpass.fits_guard(64, 0, 32)
    table = P.McsTable.default_ladder()
    data = np.random.default_rng(5).integers(0, 256, 200).astype(np.uint8)
    iq = P.OfdmFrameMod(pc, table, pp, device="cpu").modulate_frame(
        P.FramePacket(P.FrameMetadata(9, 1), data), 1)
    rx = P.OfdmFrameStreamDemod(pc, table, pp, device="cpu")
    got = rx.feed(np.concatenate([np.zeros(700, np.complex64), iq,
                                  np.zeros(2000, np.complex64)])) + rx.flush()
    frames = [r for r in got if isinstance(r, P.RxFrame)]
    assert len(frames) == 1
    assert np.array_equal(frames[0].packet.payload, data)


def test_dvb_t_frame_mod_with_lowpass_matches_and_decodes():
    # the setup of the JAX package's tests/test_dvb_t.py spectral-shaping
    # case: taper 40, an 89-tap mask, RX back-off 64
    jp = JD.DvbTFrameParams(JD.DvbTLinkParams("1/8", "qpsk", "1/2"), 0, 0)
    pp = P.DvbTFrameParams(P.DvbTLinkParams("1/8", "qpsk", "1/2"), 0, 0)
    mask = tx_lowpass_for_2k(89, 60.0)
    assert dataclasses.asdict(mask) == dataclasses.asdict(jax_2k(89, 60.0))
    payload = np.random.default_rng(17).integers(0, 256, 300).astype(np.uint8)
    ref = JMod(jp).with_symbol_window(40).with_tx_lowpass(
        jax_2k(89, 60.0)).modulate(payload)
    ours = P.DvbTFrameMod(pp, device="cpu").with_symbol_window(
        40).with_tx_lowpass(mask).modulate(payload)
    assert ours.iq.shape == ref.iq.shape and ours.n_symbols == ref.n_symbols
    np.testing.assert_allclose(ours.iq, ref.iq, rtol=0, atol=1e-5)
    rx = P.DvbTFrameDemod(pp, device="cpu").with_rx_window_backoff(
        64).decode(ours.iq, ours.n_symbols, len(payload))
    assert np.array_equal(rx.payload, payload)


def test_hier_and_super_frame_mods_apply_the_mask():
    mask = tx_lowpass_for_2k(89, 60.0)
    hp = P.DvbTHierFrameParams(P.DvbTHierLinkParams("1/8", "qam16", 2,
                                                    "1/2", "3/4"))
    a = P.DvbTHierFrameMod(hp, device="cpu").modulate(b"hp", b"lp")
    b = P.DvbTHierFrameMod(hp, device="cpu").with_tx_lowpass(mask).modulate(
        b"hp", b"lp")
    want = mask.apply(torch.as_tensor(a.iq)).numpy()
    np.testing.assert_allclose(b.iq, want, rtol=0, atol=1e-6)
    sp = P.DvbTSuperFrameParams(P.DvbTLinkParams("1/8", "qpsk", "1/2"),
                                cell_id=7)
    a = P.DvbTSuperFrameMod(sp, device="cpu").modulate(b"abcd")
    b = P.DvbTSuperFrameMod(sp, device="cpu").with_tx_lowpass(
        mask).with_symbol_window(0).modulate(b"abcd")
    want = mask.apply(torch.as_tensor(a.iq)).numpy()
    np.testing.assert_allclose(b.iq, want, rtol=0, atol=1e-6)
