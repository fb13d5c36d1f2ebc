"""Torch port: the drop-in Block classes (``blocks.py``) against the JAX
package's on the same numpy inputs, fed in the same pieces, mirroring
tests/test_blocks.py (the input-validation tier too); and the block
converters of ``convert.py``: a JAX block fed the first part of a capture
hands its state to the port's, which finishes with the uninterrupted JAX
block's output.

Tolerances: bits, tones, texts and payloads bit-exact; IQ and audio within
1e-5 of the output's peak (the port's scans, products and FFTs sum in
another order than XLA's, as in tests/test_torch_analog.py), except the
FM modulator's IQ at 5e-4 absolute (its phase is a cumulative sum that
torch accumulates on the CPU in float64 and XLA in float32, as there);
where an oscillator phase is carried from one call to the next, four ulps
of the largest phase of a call (the carry's float32 rounding, as in
tests/test_torch_analog.py); FT8/FT4 IQ four ulps of a symbol's phase
span (the CPFSK phase within a symbol reaches ~1 000 rad); PSK31 soft
symbols within 1e-4 of the peak (the PLL's float32 steps, as in
tests/test_torch_psk31.py)."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import orion_sdr_tpu as J
import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch import convert

torch.set_num_threads(1)

FS = 48_000.0
CPU = "cpu"
FM_MOD_ATOL = 5e-4


def _tone(n, hz, fs=FS, amp=0.5):
    return (amp * np.sin(2 * np.pi * hz * np.arange(n) / fs)
            ).astype(np.float32)


def _iq(n, seed, f=1300.0):
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    return (np.exp(2j * np.pi * f * k / FS) * (1 + 0.3 * np.sin(
        2 * np.pi * 400.0 * k / FS)) + 0.05 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    ).astype(np.complex64)


def phase_tol(f_hz, n, fs=FS):
    """Four ulps of the float32 phase 2π·f·n/fs."""
    return 4 * float(np.spacing(np.float32(2 * np.pi * f_hz * n / fs)))


def close(ours, ref, tol=1e-5, atol=None):
    ref = np.asarray(ref)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_allclose(
        ours, ref, rtol=0,
        atol=atol if atol is not None
        else tol * max(float(np.abs(ref).max()), 1e-30))


def pieces(x, cuts):
    edges = [0, *cuts, len(x)]
    return [np.ascontiguousarray(x[a:b]) for a, b in zip(edges, edges[1:])]


def run_both(jb, pb, x, cuts=(), method="process"):
    """Both blocks fed ``x`` in the same pieces: → (port, JAX) outputs
    concatenated."""
    ours, ref = [], []
    for part in pieces(x, cuts):
        ours.append(getattr(pb, method)(part))
        ref.append(np.asarray(getattr(jb, method)(part)))
    return np.concatenate(ours), np.concatenate(ref)


# ── analog ───────────────────────────────────────────────────────────────────

# name → (block, carrier Hz whose phase carries from call to call)
ANALOG_MODS = {
    "am": (lambda m, d: m.AmDsbMod(FS, 2000.0, 1.0, 0.8, **d), 2000.0),
    "ssb": (lambda m, d: m.SsbPhasingMod(FS, 3000.0, 1500.0, 0.0, True, **d),
            1500.0),
    "pm": (lambda m, d: m.PmDirectPhaseMod(FS, 1.0, 1000.0, **d), 1000.0),
    "fm": (lambda m, d: m.FmPhaseAccumMod(FS, 5000.0, **d), 0.0),
}


@pytest.mark.parametrize("name", sorted(ANALOG_MODS))
def test_analog_mod_blocks_stream_like_the_jax_ones(name):
    make, carrier = ANALOG_MODS[name]
    audio = _tone(1 << 13, 700.0)
    ours, ref = run_both(make(J, {}), make(P, {"device": CPU}), audio,
                         (3001, 5555))
    assert ours.dtype == np.complex64
    close(ours, ref, atol=FM_MOD_ATOL if name == "fm" else max(
        1e-5 * float(np.abs(ref).max()), phase_tol(carrier, 3001)))


def test_cw_keyed_mod_streams_like_the_jax_one():
    key = np.zeros(1 << 12, np.float32)
    key[500:3000] = 1.0
    jb, pb = J.CwKeyedMod(FS, 800.0), P.CwKeyedMod(FS, 800.0, device=CPU)
    jb.set_gain(0.7)
    pb.set_gain(0.7)
    ours, ref = run_both(jb, pb, key, (1234,))
    close(ours, ref)


ANALOG_DEMODS = {
    "fm": lambda m, d: m.FmQuadratureDemod(FS, 5000.0, 3000.0, **d),
    "pm": lambda m, d: m.PmQuadratureDemod(FS, 1.0, 3000.0, **d),
    "am": lambda m, d: m.AmEnvelopeDemod(FS, 3000.0, **d),
    "am_abs": lambda m, d: m.AmEnvelopeDemod(FS, 3000.0, True, **d),
    "ssb": lambda m, d: m.SsbProductDemod(FS, 1500.0, 3000.0, **d),
    "cw": lambda m, d: m.CwEnvelopeDemod(FS, 800.0, 200.0, **d),
}
BFO_HZ = {"ssb": 1500.0}     # the one demodulator with a carried phase


@pytest.mark.parametrize("name", sorted(ANALOG_DEMODS))
def test_analog_demod_blocks_stream_like_the_jax_ones(name):
    make = ANALOG_DEMODS[name]
    x = _iq(1 << 13, 3)
    ours, ref = run_both(make(J, {}), make(P, {"device": CPU}), x,
                         (2000, 5001))
    assert ours.dtype == np.float32
    tol = max(1e-5 * float(np.abs(ref).max()),
              phase_tol(BFO_HZ.get(name, 0.0), 3191))
    close(ours, ref, atol=tol)
    one = make(P, {"device": CPU}).process(x)
    np.testing.assert_allclose(ours, one, rtol=0, atol=2 * tol)


def test_analog_roundtrips():
    """tests/test_blocks.py's analog roundtrips on the port's blocks."""
    from helpers import tone_snr_db
    audio = _tone(1 << 14, 1000.0)
    iq = P.FmPhaseAccumMod(FS, 5000.0, device=CPU).process(audio)
    out = P.FmQuadratureDemod(FS, 5000.0, 3000.0, device=CPU).process(iq)
    assert tone_snr_db(FS, 1000.0, out[4000:]) > 20.0
    a = _tone(1 << 14, 700.0)
    iq = P.AmDsbMod(FS, 0.0, 1.0, 0.8, device=CPU).process(a)
    for approx in (False, True):
        out = P.AmEnvelopeDemod(FS, 3000.0, approx, device=CPU).process(iq)
        assert tone_snr_db(FS, 700.0, out[4000:]) > 15.0
    key = np.zeros(1 << 13, np.float32)
    key[1000:6000] = 1.0
    iq = P.CwKeyedMod(FS, 800.0, device=CPU).process(key)
    env = P.CwEnvelopeDemod(FS, 800.0, 200.0, device=CPU).process(iq)
    assert env[4000] > 0.5 and env[500] < 0.1


# ── single-carrier digital ───────────────────────────────────────────────────


@pytest.mark.parametrize("order", ["bpsk", "qpsk", 16, 64, 256])
def test_digital_blocks_match(order):
    bps = {"bpsk": 1, "qpsk": 2, 16: 4, 64: 6, 256: 8}[order]
    bits = np.random.default_rng(bps).integers(0, 2, 96 * bps
                                               ).astype(np.uint8)
    if isinstance(order, int):
        jm, pm = J.QamMod(order, FS, 1000.0), P.QamMod(order, FS, 1000.0,
                                                       device=CPU)
        jd = J.QamDemod(order, 1.0, FS, 1000.0)
        pd = P.QamDemod(order, 1.0, FS, 1000.0, device=CPU)
    else:
        cm, cd = ("BpskMod", "BpskDemod") if order == "bpsk" else \
            ("QpskMod", "QpskDemod")
        jm, pm = getattr(J, cm)(FS, 1000.0), getattr(P, cm)(FS, 1000.0,
                                                             device=CPU)
        jd = getattr(J, cd)(1.0, FS, 1000.0)
        pd = getattr(P, cd)(1.0, FS, 1000.0, device=CPU)
    cut = (37 * bps,)
    iq, j_iq = run_both(jm, pm, bits, cut)
    close(iq, j_iq)
    out, ref = run_both(jd, pd, iq, (41,))
    assert np.array_equal(out, ref) and np.array_equal(out, bits)


def test_qam_rejects_bad_order():
    with pytest.raises(ValueError):
        P.QamMod(32, FS, device=CPU)
    with pytest.raises(ValueError):
        P.QamDemod(5, device=CPU)


# ── FT8 / FT4 ────────────────────────────────────────────────────────────────


@pytest.mark.parametrize("mode", ["ft8", "ft4"])
def test_ft_blocks_match(mode):
    pre = "Ft8" if mode == "ft8" else "Ft4"
    payload = J.ft8_pack_free_text("TNX 73 OM")
    jc, pc = getattr(J, pre + "Codec")(), getattr(P, pre + "Codec")(
        device=CPU)
    tones = pc.encode(payload)
    assert np.array_equal(tones, np.asarray(jc.encode(payload)))
    iq = getattr(P, pre + "Mod")(12000.0, 1000.0, device=CPU).modulate(tones)
    sps = 1920 if mode == "ft8" else 576
    close(iq, getattr(J, pre + "Mod")(12000.0, 1000.0).modulate(tones),
          atol=phase_tol(1050.0, sps, 12000.0))
    got = getattr(P, pre + "Demod")(12000.0, 1000.0,
                                    device=CPU).demodulate(iq)
    assert np.array_equal(got, tones)
    assert pc.decode_hard(got) == jc.decode_hard(got) == payload


def test_ft8_decode_soft_matches():
    rng = np.random.default_rng(6)
    payload = J.ft8_pack_standard("CQ", "KA1ABC", "FN42")
    jc, pc = J.Ft8Codec(), P.Ft8Codec(device=CPU)
    from orion_sdr_tpu_torch.codec.ft8 import _payload_to_codeword_bits
    cw = _payload_to_codeword_bits(np.frombuffer(payload, np.uint8), CPU)
    for flips in (0, 8, 60):
        llr = np.where(cw == 0, 4.0, -4.0).astype(np.float32)
        llr[rng.choice(174, flips, replace=False)] *= -1
        llr += rng.standard_normal(174).astype(np.float32)
        assert pc.decode_soft(llr) == jc.decode_soft(llr)
    assert pc.decode_soft(np.where(cw == 0, 4.0, -4.0).astype(
        np.float32)) == payload


# ── PSK31 ────────────────────────────────────────────────────────────────────


@pytest.mark.parametrize("rf", [0.0, 1001.5625])
def test_bpsk31_blocks_stream_like_the_jax_ones(rf):
    fs = 8000.0
    text = "hello blocks"
    iq = P.Bpsk31Mod(fs, rf, device=CPU).modulate_text(text)
    close(iq, J.Bpsk31Mod(fs, rf).modulate_text(text))
    jd, pd = J.Bpsk31Demod(fs, rf), P.Bpsk31Demod(fs, rf, device=CPU)
    soft, ref = run_both(jd, pd, iq, (10_000, 30_011))
    close(soft, ref, tol=1e-4)
    bits = P.Bpsk31Decider(device=CPU).process(soft)
    assert np.array_equal(bits, J.Bpsk31Decider().process(soft))
    assert text in P.VaricodeDecoder().push_bits(bits)
    one = P.Bpsk31Demod(fs, rf, device=CPU).process(iq)
    np.testing.assert_allclose(soft[:len(one)], one[:len(soft)], atol=1e-4)


def test_bpsk31_mod_bits_matches():
    bits = np.random.default_rng(2).integers(0, 2, 64).astype(np.uint8)
    close(P.Bpsk31Mod(8000.0, 500.0, device=CPU).modulate_bits(bits),
          J.Bpsk31Mod(8000.0, 500.0).modulate_bits(bits))
    close(P.Qpsk31Mod(8000.0, device=CPU).modulate_bits(bits),
          J.Qpsk31Mod(8000.0).modulate_bits(bits))


def test_qpsk31_flush_matches():
    fs = 8000.0
    iq = P.Qpsk31Mod(fs, 600.0, device=CPU).modulate_text("qpsk blocks")
    close(iq, J.Qpsk31Mod(fs, 600.0).modulate_text("qpsk blocks"))
    jd, pd = J.Qpsk31Demod(fs, 600.0), P.Qpsk31Demod(fs, 600.0, device=CPU)
    soft, ref = run_both(jd, pd, iq, (7777,))
    assert soft.shape == ref.shape and soft.shape[1] == 2
    close(soft, ref, tol=1e-4)
    bits = pd.flush()
    assert np.array_equal(bits, np.asarray(jd.flush()))
    assert "qpsk blocks" in P.VaricodeDecoder().push_bits(bits)
    assert pd.flush().size == 0


# ── OFDM ─────────────────────────────────────────────────────────────────────


def _ofdm_cfgs(pilots=False, **kw):
    def plan(m):
        p = m.CarrierPlan(256, 64)
        if pilots:
            p = p.with_pilot_carriers([(i, 1.0 + 0j)
                                       for i in range(-100, 101, 8)])
        return p.with_contiguous_data(edge_guard=27)
    return (J.OfdmConfig(plan(J), fs=FS, constellation="qpsk", **kw),
            P.OfdmConfig(plan(P), fs=FS, constellation="qpsk", **kw))


@pytest.mark.parametrize("rf", [0.0, 1000.0])
def test_ofdm_blocks_training_symbol(rf):
    jc, pc = _ofdm_cfgs(rf_hz=rf)
    bits = np.random.default_rng(7).integers(
        0, 2, pc.bits_per_ofdm_symbol() * 6).astype(np.uint8)
    iq, j_iq = run_both(J.OfdmMod(jc), P.OfdmMod(pc, device=CPU), bits,
                        (pc.bits_per_ofdm_symbol() * 2,))
    close(iq, j_iq)
    jd, pd = J.OfdmDemod(jc), P.OfdmDemod(pc, device=CPU)
    h = 0.8 * np.exp(0.3j)
    from orion_sdr_tpu_torch.sync.ofdm_sync import \
        training_symbol_freq_pattern
    known = training_symbol_freq_pattern(256)
    train = (known * h).astype(np.complex64)
    jd.estimate_channel(train)
    pd.estimate_channel(train)
    out, ref = run_both(jd, pd, (iq * h).astype(np.complex64), (640,))
    assert np.array_equal(out, ref) and np.array_equal(out, bits)


@pytest.mark.parametrize("rf", [0.0, 1000.0])
def test_ofdm_blocks_pilot_interp(rf):
    jc, pc = _ofdm_cfgs(pilots=True, rf_hz=rf)
    bits = np.random.default_rng(8).integers(
        0, 2, pc.bits_per_ofdm_symbol() * 4).astype(np.uint8)
    iq = P.OfdmMod(pc, device=CPU).process(bits)
    close(iq, J.OfdmMod(jc).process(bits))
    h = np.zeros(8, np.complex64)
    h[0], h[5] = 1.0, 0.4 * np.exp(1j * 1.1)
    rx = np.convolve(iq, h)[:len(iq)].astype(np.complex64)
    jd = J.OfdmDemod(jc, equalizer="pilot_interp")
    pd = P.OfdmDemod(pc, equalizer="pilot_interp", device=CPU)
    out, ref = run_both(jd, pd, rx, (640,))
    assert np.array_equal(out, ref) and np.array_equal(out, bits)
    with pytest.raises(ValueError):
        P.OfdmDemod(pc, equalizer="nope", device=CPU)


# ── the input contract ───────────────────────────────────────────────────────

BAD_INPUTS = {
    "complex128": (lambda: P.CwEnvelopeDemod(FS, 700.0, 300.0, device=CPU),
                   "process", np.zeros(256, np.complex128)),
    "float64": (lambda: P.AmDsbMod(FS, 0.0, 1.0, 0.8, device=CPU),
                "process", np.zeros(256, np.float64)),
    "2-D": (lambda: P.FmQuadratureDemod(FS, 2500.0, 5000.0, device=CPU),
            "process", np.zeros((2, 128), np.complex64)),
    "strided": (lambda: P.FmQuadratureDemod(FS, 2500.0, 5000.0, device=CPU),
                "process", np.zeros(512, np.complex64)[::2]),
    "list": (lambda: P.BpskMod(FS, device=CPU), "process", [0, 1, 0, 1]),
    "tones int64": (lambda: P.Ft8Mod(device=CPU), "modulate",
                    np.zeros(79, np.int64)),
    "llr float64": (lambda: P.Ft8Codec(device=CPU), "decode_soft",
                    np.zeros(174, np.float64)),
    "soft float64": (lambda: P.Bpsk31Decider(device=CPU), "process",
                     np.zeros(8, np.float64)),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_input_contract_rejects(case):
    make, method, x = BAD_INPUTS[case]
    with pytest.raises(ValueError):
        getattr(make(), method)(x)


def test_correct_dtypes_and_sliced_views_pass():
    iq = P.FmPhaseAccumMod(FS, 5000.0, device=CPU).process(
        np.zeros(1024, np.float32))
    d = P.FmQuadratureDemod(FS, 5000.0, 3000.0, device=CPU)
    assert d.process(iq).dtype == np.float32
    assert d.process(iq[:512]).dtype == np.float32


def test_constructors_default_to_the_card():
    import inspect
    for name in P.blocks.__all__:
        sig = inspect.signature(getattr(P, name))
        assert sig.parameters["device"].default == "cuda", name


# ── state carried across packages (convert.py) ──────────────────────────────

CONVERTERS = {
    "fm": ("FmQuadratureDemod", convert.fm_quadrature_demod_from_jax),
    "pm": ("PmQuadratureDemod", convert.pm_quadrature_demod_from_jax),
    "am": ("AmEnvelopeDemod", convert.am_envelope_demod_from_jax),
    "ssb": ("SsbProductDemod", convert.ssb_product_demod_from_jax),
    "cw": ("CwEnvelopeDemod", convert.cw_envelope_demod_from_jax),
}


@pytest.mark.parametrize("name", sorted(CONVERTERS))
def test_analog_demod_state_crosses_from_jax(name):
    _, conv = CONVERTERS[name]
    make = ANALOG_DEMODS[name]
    x = _iq(1 << 13, 4)
    cut = 3001
    jb = make(J, {})
    jb.process(np.ascontiguousarray(x[:cut]))
    pb = conv(vars(jb), CPU)
    ours = pb.process(np.ascontiguousarray(x[cut:]))
    close(ours, jb.process(np.ascontiguousarray(x[cut:])))


@pytest.mark.parametrize("qpsk", [False, True])
def test_psk31_demod_state_crosses_from_jax(qpsk):
    fs, rf = 8000.0, 1001.5625
    text = "carry across"
    iq = np.asarray((J.Qpsk31Mod if qpsk else J.Bpsk31Mod)(
        fs, rf).modulate_text(text))
    cut = len(iq) // 2 + 77
    jb = (J.Qpsk31Demod if qpsk else J.Bpsk31Demod)(fs, rf)
    jb.process(np.ascontiguousarray(iq[:cut]))
    pb = (convert.qpsk31_demod_from_jax if qpsk
          else convert.bpsk31_demod_from_jax)(vars(jb), CPU)
    ours = pb.process(np.ascontiguousarray(iq[cut:]))
    ref = np.asarray(jb.process(np.ascontiguousarray(iq[cut:])))
    close(ours, ref, tol=1e-4)
    if qpsk:
        bits = pb.flush()
        assert np.array_equal(bits, np.asarray(jb.flush()))
        assert text in P.VaricodeDecoder().push_bits(bits)
