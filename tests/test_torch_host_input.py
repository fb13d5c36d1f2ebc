"""Torch port: the public functions of ``fec/`` and ``dsp/`` that have a
JAX counterpart and take signal or code data take host data as the JAX
functions do. ``fec/conv.py`` (conv_encode, conv_encode_punctured,
depuncture_llrs, viterbi_decode_soft, viterbi_decode_soft_chunked),
``fec/ldpc.py`` (ldpc_encode, bp_decode, ldpc_decode),
``fec/bch_device.py`` (the batch encoders and decoders), ``dsp/fir.py``
(fir_filter_aligned, fir_apply, fir_decimate, fir_filter_aligned_bank),
``dsp/agc.py`` (agc_rms), ``dsp/iir.py`` (biquad, lp_cascade, dc_blocker,
lp_dc_cascade), ``dsp/osc.py`` (rotate, rotate_host, mix_usb,
mix_usb_host), ``dsp/device.py`` (sanitize_iq), ``dsp/recurrence.py``
(first_order, affine2) and ``dsp/resample.py`` (resample) follow the
port's entry-point rule (``dsp.device.on_device``): with no device, numpy
input asks for the card (a spy on ``on_device`` records the device each
call resolves, and sends it to the CPU here); with ``device="cpu"`` the
result equals the JAX function on the same numpy input; a tensor keeps its
device. The same three checks hold ``SWEPT``: the frame chain
(scramble_bits, apply_pn_to_llrs with the JAX contract, inner_encode,
inner_decode, inner_decode_batch, encode_chain, decode_chain,
decode_chain_batch) and ``frame/demodulator.py::soft_demap``, and the
functions of modulate/, demodulate/, codec/, sync/, multicarrier/,
waveform/ and ofdm.py that raised on numpy before they took host data
through ``dsp.device.takes_host_data``.

Tolerances: bits, codewords, decoded messages, blanked IQ and depunctured
LLRs exact (Viterbi on integer-valued LLRs, BP on a clean-enough channel);
filtered, resampled, mixed and scanned values within 1e-5 of the output's
largest magnitude, as tests/test_torch_dsp_misc.py and
tests/test_torch_dsp_iir.py state for the same functions."""

import dataclasses
import importlib
import inspect

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from test_torch_dsp_iir import close, jrun

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch.dsp import agc as PA
from orion_sdr_tpu_torch.dsp import device as PDV
from orion_sdr_tpu_torch.dsp import fir as PF
from orion_sdr_tpu_torch.dsp import iir as PI
from orion_sdr_tpu_torch.dsp import osc as PO
from orion_sdr_tpu_torch.dsp import recurrence as PR
from orion_sdr_tpu_torch.fec import bch_device as PB
from orion_sdr_tpu_torch.fec import conv as PC
from orion_sdr_tpu_torch.fec import ldpc as PL
from orion_sdr_tpu_torch.fec.galois import ReedSolomon

JC = importlib.import_module("orion_sdr_tpu.fec.conv")
JL = importlib.import_module("orion_sdr_tpu.fec.ldpc")
JB = importlib.import_module("orion_sdr_tpu.fec.bch_device")
PRS = importlib.import_module("orion_sdr_tpu_torch.dsp.resample")
JF = importlib.import_module("orion_sdr_tpu.dsp.fir")
JA = importlib.import_module("orion_sdr_tpu.dsp.agc")
JDV = importlib.import_module("orion_sdr_tpu.dsp.device")
JI = importlib.import_module("orion_sdr_tpu.dsp.iir")
JO = importlib.import_module("orion_sdr_tpu.dsp.osc")
JR = importlib.import_module("orion_sdr_tpu.dsp.recurrence")
JRS = importlib.import_module("orion_sdr_tpu.dsp.resample")

torch.set_num_threads(1)

RNG = np.random.default_rng(16)
BITS = RNG.integers(0, 2, (2, 61)).astype(np.uint8)
LLR = (RNG.integers(1, 6, (2, 2 * (61 + 6))) * RNG.choice(
    [-1, 1], (2, 2 * (61 + 6)))).astype(np.float32)
MSG = RNG.integers(0, 2, (3, 256)).astype(np.uint8)
TAPS = JF.fir_lowpass_design(8000.0, 1000.0, 300.0)
IQ = (RNG.standard_normal((2, 700))
      + 1j * RNG.standard_normal((2, 700))).astype(np.complex64)


def _bp_llrs():
    """N512R12 codewords of MSG through BPSK at a clean-enough SNR that
    both packages decode every row."""
    cw = np.asarray(JL.ldpc_encode("N512R12", MSG)).astype(np.float32)
    rng = np.random.default_rng(161)
    return (4.0 * (1.0 - 2.0 * cw)
            + 1.5 * rng.standard_normal(cw.shape)).astype(np.float32)


BP_LLR = _bp_llrs()
G = PL.ldpc_graph("N512R12")
JG = JL.ldpc_graph("N512R12")
AUDIO = RNG.standard_normal((2, 800)).astype(np.float32)
NAN_IQ = IQ.copy()
NAN_IQ[0, [3, 50]] = np.nan
NAN_IQ[1, 7] = np.inf
PH0 = np.array([0.1, 0.2], np.float32)
F3 = np.array([100.0, -250.5, 1234.25], np.float32)
AGC = JA.design_agc(8000.0, 5.0, 50.0, 0.3)
LP = JI.design_butter_lp(8000.0, 1000.0)
DC = JI.dc_pole(8000.0, 2.0)
A2 = np.array([[0.9, 0.1], [-0.2, 0.8]], np.float32)
B2 = np.array([1.0, 0.5], np.float32)


def _outer_words():
    """Four BCH(184, 120) t=8 and RS(204, 188) codewords, row i with 3·i
    bit or byte errors (the last one past t)."""
    bch = P.shortened_bch_for(8)
    rs = ReedSolomon(204, 16)
    rng = np.random.default_rng(162)
    bmsg = rng.integers(0, 2, (4, bch.k)).astype(np.uint8)
    rmsg = rng.integers(0, 256, (4, rs.k)).astype(np.uint8)
    bw, rw = bch.encode(bmsg), rs.encode(rmsg)
    for i in range(4):
        bw[i, rng.choice(bch.n, 3 * i, replace=False)] ^= 1
        rw[i, rng.choice(204, 3 * i, replace=False)] ^= 0x5A
    return bch, bmsg, rmsg, bw, rw


BCH, BMSG, RMSG, BWORDS, RWORDS = _outer_words()


def _first(out):
    return [out[0]]


# name: (module, port call on x with **kw, JAX result, host input, how to
# compare: "exact" or "close"[, which outputs to compare])
CASES = {
    "conv_encode": (PC, lambda x, **kw: PC.conv_encode(x, "dvb_k7", **kw),
                    lambda: JC.conv_encode(BITS, "dvb_k7"), BITS, "exact"),
    "conv_encode_punctured": (
        PC, lambda x, **kw: PC.conv_encode_punctured(x, "3/4", "dvb_k7",
                                                     **kw),
        lambda: JC.conv_encode_punctured(BITS, "3/4", "dvb_k7"), BITS,
        "exact"),
    "depuncture_llrs": (
        PC, lambda x, **kw: PC.depuncture_llrs(x, 61, "2/3", "k5", **kw),
        lambda: JC.depuncture_llrs(LLR, 61, "2/3", "k5"), LLR, "exact"),
    "viterbi_decode_soft": (
        PC, lambda x, **kw: PC.viterbi_decode_soft(x, 61, "1/2", "dvb_k7",
                                                   **kw),
        lambda: JC.viterbi_decode_soft(LLR, 61, "1/2", "dvb_k7"), LLR,
        "exact"),
    "viterbi_decode_soft_chunked": (
        PC, lambda x, **kw: PC.viterbi_decode_soft_chunked(
            x, 61, "1/2", "dvb_k7", **kw),
        lambda: JC.viterbi_decode_soft_chunked(LLR, 61, "1/2", "dvb_k7"),
        LLR, "exact"),
    "ldpc_encode": (PL, lambda x, **kw: PL.ldpc_encode("N512R12", x, **kw),
                    lambda: JL.ldpc_encode("N512R12", MSG), MSG, "exact"),
    "bp_decode": (PL, lambda x, **kw: PL.bp_decode(G, x, 20, **kw),
                  lambda: JL.bp_decode(JG, BP_LLR, 20), BP_LLR, "exact"),
    "ldpc_decode": (PL, lambda x, **kw: PL.ldpc_decode("N512R12", x, 20,
                                                       **kw),
                    lambda: JL.ldpc_decode("N512R12", BP_LLR, 20), BP_LLR,
                    "exact"),
    "fir_filter_aligned": (
        PF, lambda x, **kw: PF.fir_filter_aligned(x, TAPS, **kw),
        lambda: jrun(lambda x: JF.fir_filter_aligned(x, TAPS), IQ), IQ,
        "close"),
    "fir_apply": (PF, lambda x, **kw: PF.fir_apply(x, TAPS, **kw),
                  lambda: jrun(lambda x: JF.fir_apply(x, TAPS), IQ), IQ,
                  "close"),
    "fir_decimate": (PF, lambda x, **kw: PF.fir_decimate(x, TAPS, 3, **kw),
                     lambda: jrun(lambda x: JF.fir_decimate(x, TAPS, 3), IQ),
                     IQ, "close"),
    "fir_filter_aligned_bank": (
        PF, lambda x, **kw: PF.fir_filter_aligned_bank(
            [(x, TAPS), (x.real, TAPS[5:-5])], **kw),
        lambda: JF.fir_filter_aligned_bank([(IQ, TAPS),
                                            (IQ.real, TAPS[5:-5])]),
        IQ, "close"),
    "bch_encode_batch_device": (
        PB, lambda x, **kw: PB.bch_encode_batch_device(184, 120, 8, x, **kw),
        lambda: JB.bch_encode_batch_device(184, 120, 8, BMSG), BMSG,
        "exact"),
    "rs_encode_batch_device": (
        PB, lambda x, **kw: PB.rs_encode_batch_device(204, 16, x, **kw),
        lambda: JB.rs_encode_batch_device(204, 16, RMSG), RMSG, "exact"),
    "bch_decode_batch_device": (
        PB, lambda x, **kw: PB.bch_decode_batch_device(184, 120, 8, x, **kw),
        lambda: JB.bch_decode_batch_device(184, 120, 8, BWORDS), BWORDS,
        "exact"),
    "rs_decode_batch_device": (
        PB, lambda x, **kw: PB.rs_decode_batch_device(204, 16, x, **kw),
        lambda: JB.rs_decode_batch_device(204, 16, RWORDS), RWORDS,
        "exact"),
    "agc_rms": (PA, lambda x, **kw: PA.agc_rms(x, AGC, **kw),
                lambda: jrun(JA.agc_rms, AUDIO, AGC), AUDIO, "close"),
    "biquad": (PI, lambda x, **kw: PI.biquad(x, LP, **kw),
               lambda: jrun(JI.biquad, AUDIO, LP), AUDIO, "close", _first),
    "lp_cascade": (PI, lambda x, **kw: PI.lp_cascade(x, LP, **kw),
                   lambda: jrun(JI.lp_cascade, AUDIO, LP), AUDIO, "close",
                   _first),
    "dc_blocker": (PI, lambda x, **kw: PI.dc_blocker(x, DC, **kw),
                   lambda: jrun(JI.dc_blocker, AUDIO + 0.7, DC),
                   AUDIO + 0.7, "close"),
    "lp_dc_cascade": (PI, lambda x, **kw: PI.lp_dc_cascade(x, LP, DC, **kw),
                      lambda: jrun(JI.lp_dc_cascade, AUDIO, LP, DC), AUDIO,
                      "close", _first),
    # per-row frequencies, as tests/test_torch_dsp_misc.py rotates
    "rotate": (PO, lambda x, **kw: PO.rotate(
        x, -torch.as_tensor(F3)[:, None], 8000.0, **kw),
        lambda: jrun(lambda z, f: JO.rotate(z, -f[:, None], 8000.0),
                     IQ[:1], F3), IQ[:1], "close"),
    "rotate_host": (PO, lambda x, **kw: PO.rotate_host(
        x, np.float32(700.0), 8000.0, **kw),
        lambda: JO.rotate_host(IQ, np.float32(700.0), 8000.0), IQ, "close",
        _first),
    "mix_usb": (PO, lambda x, **kw: PO.mix_usb(x, 700.0, 8000.0,
                                               torch.as_tensor(PH0), **kw),
                lambda: jrun(JO.mix_usb, IQ, 700.0, 8000.0, PH0), IQ,
                "close"),
    "mix_usb_host": (PO, lambda x, **kw: PO.mix_usb_host(
        x, np.float32(700.0), 8000.0, **kw),
        lambda: JO.mix_usb_host(IQ, np.float32(700.0), 8000.0), IQ, "close",
        _first),
    "sanitize_iq": (PDV, lambda x, **kw: PDV.sanitize_iq(x, **kw),
                    lambda: JDV.sanitize_iq(NAN_IQ), NAN_IQ, "exact"),
    "first_order": (PR, lambda x, **kw: PR.first_order(0.95, x, **kw),
                    lambda: jrun(JR.first_order, 0.95, AUDIO), AUDIO,
                    "close"),
    "affine2": (PR, lambda x, **kw: PR.affine2(A2, B2, x, **kw),
                lambda: jrun(JR.affine2, A2, B2, AUDIO), AUDIO, "close"),
    "resample": (PRS, lambda x, **kw: PRS.resample(x, 3, 2, **kw),
                 lambda: jrun(JRS.resample, AUDIO, 3, 2), AUDIO, "close"),
}


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _agree(ref, got, how, pick=_leaves):
    ref, got = pick(ref), pick(got)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        if how == "exact":
            assert np.array_equal(np.asarray(r), g.numpy())
        elif how == "close":
            close(r, g)
        else:                               # an absolute tolerance
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                       atol=how)


@pytest.mark.parametrize("name", sorted(CASES))
def test_numpy_input_asks_for_the_card_by_default(name, monkeypatch):
    """With no device, host data resolves to "cuda" in ``on_device`` (the
    spy then runs the call on the CPU, where there is no card) and the
    result is what the CPU call gives."""
    mod, call, _, x, how, *pick = CASES[name]
    real = mod.on_device
    asked = []

    def spy(x, device=None, dtype=None):
        if device is None:
            device = x.device if isinstance(x, torch.Tensor) else "cuda"
        asked.append(torch.device(device).type)
        return real(x, "cpu" if asked[-1] == "cuda" else device, dtype)
    monkeypatch.setattr(mod, "on_device", spy)
    got = call(x)
    assert asked and asked[0] == "cuda"
    monkeypatch.setattr(mod, "on_device", real)
    _agree(call(x, device="cpu"), got, how, *pick)


@pytest.mark.parametrize("name", sorted(CASES))
def test_numpy_input_on_the_cpu_equals_jax(name):
    _, call, jax_call, x, how, *pick = CASES[name]
    _agree(jax_call(), call(x, device="cpu"), how, *pick)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_input_keeps_its_device(name):
    """A CPU tensor decodes on the CPU with no device given, as before:
    the same result as numpy input with ``device="cpu"``."""
    _, call, _, x, how, *pick = CASES[name]
    _agree(call(x, device="cpu"), call(torch.as_tensor(x)), how, *pick)


# ── frame/ and the rest of the package ───────────────────────────────────────
#
# Each public function outside fec/ and dsp/ that takes signal, bit or LLR
# data and raised on numpy before: the frame chain and its demapper (their
# own ``device=None``: the spy sits on the chain's or the demodulator's
# ``on_device``, and on the chain's ``_outer_device`` for encode_chain, whose
# device rule is the outer coders'), and the functions that take host data
# through ``dsp.device.takes_host_data`` (the spy sits on dsp.device's
# ``on_device``). Tolerances as above: bits, codewords, bytes, hard
# decisions and detected offsets exact; IQ, spectra, LLRs and scores within
# 1e-5 of the largest magnitude; the CPFSK modulators 1e-4 and 2e-3 absolute,
# the tolerances of tests/test_torch_ft8_modem.py.

JCH = importlib.import_module("orion_sdr_tpu.frame.chain")
JDM = importlib.import_module("orion_sdr_tpu.frame.demodulator")
JMC = importlib.import_module("orion_sdr_tpu.multicarrier.ops")
JOF = importlib.import_module("orion_sdr_tpu.ofdm")
JDT = importlib.import_module("orion_sdr_tpu.waveform.dvb_t")
JDTF = importlib.import_module("orion_sdr_tpu.demodulate.dvb_t_frame")
JPD = importlib.import_module("orion_sdr_tpu.demodulate.psk31")
JFT = importlib.import_module("orion_sdr_tpu.modulate.ft8")
JFL = importlib.import_module("orion_sdr_tpu.codec.ft8_ldpc")
JCO = importlib.import_module("orion_sdr_tpu.sync.costas")
JGI = importlib.import_module("orion_sdr_tpu.sync.dvb_t_gi_sync")
JOS = importlib.import_module("orion_sdr_tpu.sync.ofdm_sync")
JWF = importlib.import_module("orion_sdr_tpu.sync.waterfall")
import orion_sdr_tpu as J  # noqa: E402
PCH = importlib.import_module("orion_sdr_tpu_torch.frame.chain")
PDM = importlib.import_module("orion_sdr_tpu_torch.frame.demodulator")
PMC = importlib.import_module("orion_sdr_tpu_torch.multicarrier.ops")
POF = importlib.import_module("orion_sdr_tpu_torch.ofdm")
PDT = importlib.import_module("orion_sdr_tpu_torch.waveform.dvb_t")
PDTF = importlib.import_module("orion_sdr_tpu_torch.demodulate.dvb_t_frame")
PPD = importlib.import_module("orion_sdr_tpu_torch.demodulate.psk31")
PFT = importlib.import_module("orion_sdr_tpu_torch.modulate.ft8")
PFL = importlib.import_module("orion_sdr_tpu_torch.codec.ft8_ldpc")
PCO = importlib.import_module("orion_sdr_tpu_torch.sync.costas")
PGI = importlib.import_module("orion_sdr_tpu_torch.sync.dvb_t_gi_sync")
POS = importlib.import_module("orion_sdr_tpu_torch.sync.ofdm_sync")
PWF = importlib.import_module("orion_sdr_tpu_torch.sync.waterfall")

R2 = np.random.default_rng(17)
JCFG = J.OfdmConfig(J.CarrierPlan(64, 16).with_contiguous_data(), fs=48e3)
PCFG = P.OfdmConfig(P.CarrierPlan(64, 16).with_contiguous_data(), fs=48e3)
JGRID = J.CarrierGrid(JCFG.carrier_plan)
PGRID = P.CarrierGrid(PCFG.carrier_plan)
ND = PGRID.num_data_carriers
CELLS = (R2.standard_normal((3, ND))
         + 1j * R2.standard_normal((3, ND))).astype(np.complex64)
FREQ = (R2.standard_normal((3, 64))
        + 1j * R2.standard_normal((3, 64))).astype(np.complex64)
H = (1.0 + 0.3 * R2.standard_normal(64)
     + 0.3j * R2.standard_normal(64)).astype(np.complex64)
GBITS = R2.integers(0, 2, 3 * ND * 2).astype(np.uint8)
# three OFDM symbols with their 16-sample prefixes after 50 samples of noise
STREAM = np.concatenate([
    (0.05 * R2.standard_normal(50)).astype(np.complex64),
    np.asarray(JMC.ofdm_assemble(FREQ, 16)).reshape(-1)]).astype(np.complex64)
DVB_CELLS = (R2.standard_normal((4, 2048))
             + 1j * R2.standard_normal((4, 2048))).astype(np.complex64)
DVB_DATA = (R2.standard_normal((4, 1512))
            + 1j * R2.standard_normal((4, 1512))).astype(np.complex64)
DBITS = R2.integers(0, 2, 4 * 24).astype(np.uint8)
TONES = R2.integers(0, 8, (2, 79))
WF = R2.random((2, 79, 40)).astype(np.float32)
COSTAS = [3, 1, 4, 0, 6, 5, 2]
D_RE = R2.standard_normal(16).astype(np.float32)
D_IM = R2.standard_normal(16).astype(np.float32)
FT8_MSG = R2.integers(0, 2, 91).astype(np.uint8)
IL = P.InterleaverKind.block(8, 12)
JIL = J.InterleaverKind.block(8, 12)


def _link():
    """One COFDM frame body's arguments in both packages: conv 1/2 K=7 (dvb_k7)
    inner code over RS(204, 188)-less framing, a block inner interleaver
    and the additive scrambler after the inner code, and the frame's
    noiseless ±4 LLRs."""
    jin, pin = (J.InnerFec.convolutional("1/2", "dvb_k7"),
                P.InnerFec.convolutional("1/2", "dvb_k7"))
    jsc, psc = (J.ScramblerKind.additive(0b1001, 15, per_frame=True),
                P.ScramblerKind.additive(0b1001, 15, per_frame=True))
    none_o = (J.OuterFec.none(), P.OuterFec.none())
    none_il = (J.InterleaverKind.none(), P.InterleaverKind.none())
    data = R2.integers(0, 256, 40).astype(np.uint8)
    jargs = ("crc16", none_o[0], jin, none_il[0], JIL, jsc,
             JCH.SCRAMBLER_AFTER_INNER)
    pargs = ("crc16", none_o[1], pin, none_il[1], IL, psc,
             P.SCRAMBLER_AFTER_INNER)
    coded = JCH.encode_chain(data, *jargs, 77)
    llr = np.where(np.asarray(coded) == 0, 4.0, -4.0).astype(np.float32)
    plan = JCH.block_plan(len(data), "crc16", none_o[0], jin, none_il[0], JIL)
    pplan = PCH.block_plan(len(data), "crc16", none_o[1], pin, none_il[1], IL)
    return data, jargs, pargs, llr, plan, pplan, jsc, psc


DATA, JARGS, PARGS, LINK_LLR, JPLAN, PPLAN, JSC, PSC = _link()
CONV_LLR = np.where(np.asarray(JCH.inner_encode(
    J.InnerFec.convolutional("1/2", "dvb_k7"), BITS[0])) == 0, 3.0,
    -3.0).astype(np.float32)
LDPC_LLR = BP_LLR[0]
PN_LLR = R2.standard_normal(300).astype(np.float32)
DEMAP_IQ = np.asarray(JOF.ofdm_mod(JCFG, GBITS)[0]).astype(np.complex64)


def _pair(out):
    """(tensor, host ok/flag) results: the tensor, and the flag as one."""
    return [out[0], torch.as_tensor(np.asarray(out[1]))]


def _bytes_ok(out):
    return [torch.as_tensor(np.asarray(out[0])),
            torch.as_tensor(np.asarray(out[1]))]


def _cands(out):
    return [torch.as_tensor(np.array([[c.time_sym, c.freq_bin, c.score]
                                      for c in out], np.float64))]


def _gi(out):
    return [torch.as_tensor(np.array([out.start_sample, out.cfo_hz,
                                      out.score], np.float64))]


def _sync(out):
    return [torch.as_tensor(np.array([[c.start_sample, c.cfo_hz,
                                       c.integer_cfo_bins, c.score]
                                      for c in out], np.float64))]


# name: (module whose resolver the spy wraps, that resolver's name, port
# call on x with **kw, JAX result, host input, "exact" or "close"[, pick])
SWEPT = {
    # frame/chain.py and frame/demodulator.py
    "scramble_bits": (PCH, "on_device", lambda x, **kw: PCH.scramble_bits(
        PSC, 77, x, **kw), lambda: JCH.scramble_bits(JSC, 77, BITS[0]),
        BITS[0], "exact"),
    "apply_pn_to_llrs": (PCH, "on_device", lambda x, **kw: PCH.apply_pn_to_llrs(
        PSC, 77, x, **kw), lambda: JCH.apply_pn_to_llrs(JSC, 77, PN_LLR),
        PN_LLR, "exact"),
    "inner_encode": (PCH, "on_device", lambda x, **kw: PCH.inner_encode(
        P.InnerFec.ldpc(), x, **kw),
        lambda: JCH.inner_encode(J.InnerFec.ldpc(), MSG[0]), MSG[0], "exact"),
    "inner_decode": (PCH, "on_device", lambda x, **kw: PCH.inner_decode(
        P.InnerFec.ldpc(), x, 256, **kw),
        lambda: JCH.inner_decode(J.InnerFec.ldpc(), LDPC_LLR, 256), LDPC_LLR,
        "exact", _pair),
    "inner_decode_batch": (PCH, "on_device", lambda x, **kw:
                           PCH.inner_decode_batch(
                               P.InnerFec.convolutional("1/2", "dvb_k7"), x, 61,
                               **kw),
                           lambda: JCH.inner_decode_batch(
                               J.InnerFec.convolutional("1/2", "dvb_k7"),
                               CONV_LLR[None], 61), CONV_LLR[None], "exact",
                           _pair),
    "encode_chain": (PCH, "_outer_device", lambda x, **kw: PCH.encode_chain(
        x, *PARGS, 77, **kw), lambda: JCH.encode_chain(DATA, *JARGS, 77),
        DATA, "exact"),
    "decode_chain": (PCH, "on_device", lambda x, **kw: PCH.decode_chain(
        x, PPLAN, *PARGS, 77, **kw),
        lambda: JCH.decode_chain(LINK_LLR, JPLAN, *JARGS, 77), LINK_LLR,
        "exact", _bytes_ok),
    "decode_chain_batch": (PCH, "on_device", lambda x, **kw:
                           PCH.decode_chain_batch(x, PPLAN, *PARGS, [77, 77],
                                                  **kw),
                           lambda: JCH.decode_chain_batch(
                               np.stack([LINK_LLR, LINK_LLR]), JPLAN, *JARGS,
                               [77, 77]), np.stack([LINK_LLR, LINK_LLR]),
                           "exact", lambda out: [torch.as_tensor(
                               np.stack(out[0])), torch.as_tensor(out[1])]),
    "soft_demap": (PDM, "on_device", lambda x, **kw: PDM.soft_demap(
        PCFG, "qpsk", x, 3, **kw),
        lambda: JDM.soft_demap(JCFG, "qpsk", DEMAP_IQ, 3), DEMAP_IQ, "close"),
    # modulate/, demodulate/, codec/, sync/
    "cpfsk_mod": (PDV, "on_device", lambda x, **kw: PFT.cpfsk_mod(
        x, 64, 12000.0, 1000.0, 6.25, **kw),
        lambda: JFT.cpfsk_mod(tuple(int(t) for t in TONES[0]), 64, 12000.0,
                              1000.0, 6.25), TONES[0], 1e-4),
    "cpfsk_mod_batch": (PDV, "on_device", lambda x, **kw: PFT.cpfsk_mod_batch(
        x, 64, 12000.0, 1000.0, 6.25, **kw),
        lambda: JFT.cpfsk_mod_batch(TONES, 64, 12000.0, 1000.0, 6.25),
        TONES, 2e-3),
    "scattered_equalize": (PDV, "on_device", lambda x, **kw:
                           PDTF.scattered_equalize(x, 1, **kw),
                           lambda: JDTF.scattered_equalize(DVB_CELLS, 1),
                           DVB_CELLS, "close"),
    "scattered_equalize_csi": (PDV, "on_device", lambda x, **kw:
                               PDTF.scattered_equalize_csi(x, 1, **kw),
                               lambda: JDTF.scattered_equalize_csi(
                                   DVB_CELLS, 1), DVB_CELLS, "close"),
    "hard_decide_dbpsk": (PDV, "on_device", lambda x, **kw:
                          PPD.hard_decide_dbpsk(x, **kw),
                          lambda: JPD.hard_decide_dbpsk(D_RE), D_RE,
                          "exact"),
    "hard_decide_dqpsk": (PDV, "on_device", lambda x, **kw:
                          PPD.hard_decide_dqpsk(x, D_IM, **kw),
                          lambda: JPD.hard_decide_dqpsk(D_RE, D_IM), D_RE,
                          "exact"),
    "ft8_ldpc_encode": (PDV, "on_device", lambda x, **kw: PFL.ldpc_encode(
        x, **kw), lambda: JFL.ldpc_encode(FT8_MSG), FT8_MSG, "exact"),
    "candidate_score_grid": (PDV, "on_device", lambda x, **kw:
                             PCO.candidate_score_grid(x, COSTAS, [0, 36, 72],
                                                      8, -2, 6, **kw),
                             lambda: JCO.candidate_score_grid(
                                 WF, COSTAS, [0, 36, 72], 8, -2, 6), WF,
                             "close"),
    "find_candidates": (PDV, "on_device", lambda x, **kw:
                        PCO.find_candidates(x, COSTAS, [0, 36, 72], 8, -2, 6,
                                            5, **kw),
                        lambda: JCO.find_candidates(WF[0], COSTAS,
                                                    [0, 36, 72], 8, -2, 6, 5),
                        WF[0], "close", _cands),
    "dvb_t_gi_sync": (PDV, "on_device", lambda x, **kw: PGI.dvb_t_gi_sync(
        x, 64, 16, 48e3, 80, **kw),
        lambda: JGI.dvb_t_gi_sync(STREAM, 64, 16, 48e3, 80), STREAM, "close",
        _gi),
    "dvb_t_gi_refine": (PDV, "on_device", lambda x, **kw:
                        PGI.dvb_t_gi_refine(x, 64, 16, 48e3, 48, 6, **kw),
                        lambda: JGI.dvb_t_gi_refine(STREAM, 64, 16, 48e3, 48,
                                                    6), STREAM, "close", _gi),
    "sc_metric": (PDV, "on_device", lambda x, **kw: POS.sc_metric(
        x, 16, 2, **kw), lambda: JOS.sc_metric(STREAM, 16, 2), STREAM,
        "close"),
    "ofdm_sync": (PDV, "on_device", lambda x, **kw: POS.ofdm_sync(
        x, 48e3, P.OfdmPreamble(32, 2), **kw),
        lambda: JOS.ofdm_sync(STREAM, 48e3, J.OfdmPreamble(32, 2)), STREAM,
        "close", _sync),
    "compute_waterfall": (PDV, "on_device", lambda x, **kw:
                          PWF.compute_waterfall(x, 12000.0, 1000.0, 6.25, 64,
                                                3, 8, **kw),
                          lambda: JWF.compute_waterfall(
                              STREAM[:192], 12000.0, 1000.0, 6.25, 64, 3, 8),
                          STREAM[:192], "close"),
    # multicarrier/, waveform/, ofdm.py
    "grid_map": (PDV, "on_device", lambda x, **kw: PMC.grid_map(
        PGRID, x, **kw), lambda: JMC.grid_map(JGRID, CELLS), CELLS, "exact"),
    "map_bits_grid": (PDV, "on_device", lambda x, **kw: PMC.map_bits_grid(
        PGRID, x, "qpsk", **kw),
        lambda: JMC.map_bits_grid(JGRID, GBITS, "qpsk"), GBITS, "close"),
    "ofdm_assemble": (PDV, "on_device", lambda x, **kw: PMC.ofdm_assemble(
        x, 16, **kw), lambda: JMC.ofdm_assemble(FREQ, 16), FREQ, "close"),
    "symbol_fft": (PDV, "on_device", lambda x, **kw: PMC.symbol_fft(
        x, 64, 16, **kw), lambda: JMC.symbol_fft(STREAM[50:], 64, 16),
        STREAM[50:], "close"),
    "dvb_t_map_symbols": (PDV, "on_device", lambda x, **kw:
                          PDT.dvb_t_map_symbols(x, 4, **kw),
                          lambda: JDT.dvb_t_map_symbols(DBITS, 4), DBITS,
                          "exact"),
    "dvb_t_demap_symbols": (PDV, "on_device", lambda x, **kw:
                            PDT.dvb_t_demap_symbols(x, 4, **kw),
                            lambda: JDT.dvb_t_demap_symbols(CELLS[0], 4),
                            CELLS[0], "exact"),
    "dvb_t_soft_llrs": (PDV, "on_device", lambda x, **kw:
                        PDT.dvb_t_soft_llrs(x, 4, **kw),
                        lambda: JDT.dvb_t_soft_llrs(CELLS[0], 4), CELLS[0],
                        "close"),
    "scattered_map_frame": (PDV, "on_device", lambda x, **kw:
                            PDT.scattered_map_frame(x, 2, **kw),
                            lambda: JDT.scattered_map_frame(DVB_DATA, 2),
                            DVB_DATA, "exact"),
    "scattered_extract_frame": (PDV, "on_device", lambda x, **kw:
                                PDT.scattered_extract_frame(x, 2, **kw),
                                lambda: JDT.scattered_extract_frame(
                                    DVB_CELLS, 2), DVB_CELLS, "exact"),
    "channel_estimate_denoise": (PDV, "on_device", lambda x, **kw:
                                 POF.channel_estimate_denoise(x, 16, **kw),
                                 lambda: JOF.channel_estimate_denoise(H, 16),
                                 H, "close"),
    "cpe_correct": (PDV, "on_device", lambda x, **kw: POF.cpe_correct(
        x, "qpsk", **kw), lambda: JOF.cpe_correct(CELLS, "qpsk"), CELLS,
        "close"),
    "cpe_raw_phases": (PDV, "on_device", lambda x, **kw: POF.cpe_raw_phases(
        x, "qpsk", **kw), lambda: JOF.cpe_raw_phases(CELLS, "qpsk"), CELLS,
        "close"),
    "cpe_unwrap": (PDV, "on_device", lambda x, **kw: POF.cpe_unwrap(
        x, "qpsk", **kw), lambda: JOF.cpe_unwrap(D_RE, "qpsk"), D_RE,
        "close"),
    "dft_precode": (PDV, "on_device", lambda x, **kw: POF.dft_precode(
        x, **kw), lambda: JOF.dft_precode(CELLS), CELLS, "close"),
    "dft_deprecode": (PDV, "on_device", lambda x, **kw: POF.dft_deprecode(
        x, **kw), lambda: JOF.dft_deprecode(CELLS), CELLS, "close"),
    "zf_equalize": (PDV, "on_device", lambda x, **kw: POF.zf_equalize(
        x, H, **kw), lambda: JOF.zf_equalize(FREQ, H), FREQ, "close"),
    "mmse_equalize": (PDV, "on_device", lambda x, **kw: POF.mmse_equalize(
        x, H, 0.1, **kw), lambda: JOF.mmse_equalize(FREQ, H, 0.1), FREQ,
        "close"),
}


def _resolver_spy(mod, attr, asked, monkeypatch):
    """Wrap ``mod.attr`` (an ``on_device`` or the chain's
    ``_outer_device``) so that each call records the device it resolves
    and then runs on the CPU."""
    real = getattr(mod, attr)
    if attr == "on_device":
        def spy(x, device=None, dtype=None):
            if device is None:
                device = x.device if isinstance(x, torch.Tensor) else "cuda"
            asked.append(torch.device(device).type)
            return real(x, "cpu" if asked[-1] == "cuda" else device, dtype)
    else:
        def spy(x, device):
            d = real(x, device)
            asked.append(d.type)
            return torch.device("cpu") if d.type == "cuda" else d
    monkeypatch.setattr(mod, attr, spy)


@pytest.mark.parametrize("name", sorted(SWEPT))
def test_swept_numpy_input_asks_for_the_card_by_default(name, monkeypatch):
    mod, attr, call, _, x, how, *pick = SWEPT[name]
    asked = []
    _resolver_spy(mod, attr, asked, monkeypatch)
    got = call(x)
    assert asked and asked[0] == "cuda"
    monkeypatch.undo()
    _agree(call(x, device="cpu"), got, how, *pick)


@pytest.mark.parametrize("name", sorted(SWEPT))
def test_swept_numpy_input_on_the_cpu_equals_jax(name):
    _, _, call, jax_call, x, how, *pick = SWEPT[name]
    _agree(jax_call(), call(x, device="cpu"), how, *pick)


@pytest.mark.parametrize("name", sorted(SWEPT))
def test_swept_tensor_input_keeps_its_device(name):
    _, _, call, _, x, how, *pick = SWEPT[name]
    _agree(call(x, device="cpu"), call(torch.as_tensor(x)), how, *pick)



def _placed(x, y=None, scale=1.0):
    """A decorated probe: where its array arguments ended up."""
    return x, y, scale


_probe = PDV.takes_host_data("x", "y")(_placed)
_HOST = np.arange(4, dtype=np.float64)
_T = torch.arange(4, dtype=torch.float32)

# call → the devices its host arguments resolve to (none: the fast path)
PATHS = {
    "tensor": (lambda: _probe(_T), []),
    "tensors": (lambda: _probe(_T, _T, 2.0), []),
    "keywords": (lambda: _probe(x=_T, y=_T), []),
    "device_given": (lambda: _probe(_T, device="cpu"), []),
    "host": (lambda: _probe(_HOST), ["cuda"]),
    "host_device_given": (lambda: _probe(_HOST, device="cpu"), ["cpu"]),
    "host_after_tensor": (lambda: _probe(_T, _HOST), ["cpu"]),
    "host_by_keyword": (lambda: _probe(x=_HOST, y=_T), ["cpu"]),
}


@pytest.mark.parametrize("name", sorted(PATHS))
def test_takes_host_data_fast_and_bound_paths(name, monkeypatch):
    """A call whose named arguments are all tensors skips the binding and
    passes them through untouched; host data goes by ``on_device``'s rule
    to the given device, else to the first tensor's, else to the card,
    float64 narrowed to float32."""
    call, want = PATHS[name]
    asked = []
    _resolver_spy(PDV, "on_device", asked, monkeypatch)
    x, y, _ = call()
    assert asked == want
    for v in (x, y):
        assert v is None or v is _T or (v.dtype == torch.float32
                                        and torch.equal(v, _T))
    if not want:
        assert x is _T and (y is None or y is _T)


# ── constellation.py and util.py ───────────────────────────────────────────
#
# Added to SWEPT: the three constellation functions and the FM
# discriminator's arctangent take host data through takes_host_data (the
# spy sits on dsp.device's on_device), spectrum_scan through util's own
# on_device. Hard decisions and mapped points exact; LLRs, angles and the
# scanned segments within 1e-5 of the largest magnitude.

JCON = importlib.import_module("orion_sdr_tpu.constellation")
JU = importlib.import_module("orion_sdr_tpu.util")
PCON = importlib.import_module("orion_sdr_tpu_torch.constellation")
PU = importlib.import_module("orion_sdr_tpu_torch.util")

QBITS = R2.integers(0, 2, (2, 48)).astype(np.uint8)
QSYMS = (0.3 * R2.standard_normal((2, 40))
         + 0.3j * R2.standard_normal((2, 40))).astype(np.complex64)
SCAN = ((0.01 * (R2.standard_normal(8192) + 1j * R2.standard_normal(8192)))
        + np.exp(2j * np.pi * 0.1 * np.arange(8192))).astype(np.complex64)


def _segments(out):
    return [torch.as_tensor(np.array([[s.center_hz, s.bw_hz, s.power_db,
                                       s.snr_db] for s in out], np.float64))]


SWEPT.update({
    "map_bits": (PDV, "on_device", lambda x, **kw: PCON.map_bits(
        x, "qam16", **kw), lambda: JCON.map_bits(QBITS, "qam16"), QBITS,
        "exact"),
    "soft_llr": (PDV, "on_device", lambda x, **kw: PCON.soft_llr(
        x, "qam64", 2.0, **kw), lambda: JCON.soft_llr(QSYMS, "qam64", 2.0),
        QSYMS, "close"),
    "decide": (PDV, "on_device", lambda x, **kw: PCON.decide(
        x, "qam256", **kw), lambda: JCON.decide(QSYMS, "qam256"), QSYMS,
        "exact"),
    "atan2_approx": (PDV, "on_device", lambda x, **kw: PU.atan2_approx(
        x, D_IM, **kw), lambda: JU.atan2_approx(D_RE, D_IM), D_RE, "close"),
    "spectrum_scan": (PU, "on_device", lambda x, **kw: PU.spectrum_scan(
        x, 48e3, **kw), lambda: JU.spectrum_scan(SCAN, 48e3), SCAN, "close",
        _segments),
})


# ── the streaming classes' feed and push ─────────────────────────────────
#
# Each streaming receiver with a JAX counterpart takes host chunks as the
# JAX one does: built with its defaults it asks for the card (the
# Resampler, which has no device of its own, resolves host data by
# takes_host_data: the spy sits on dsp.device's on_device; the others run
# on the device they are built with, whose default is "cuda"); built on the
# CPU and fed numpy chunks it gives the JAX stream's results on the same
# chunks; fed tensor chunks it gives the same results, its tensors on the
# tensor's device (the CPU). Tolerances as above: texts, frames and
# payloads exact, resampled and channelized samples within 1e-5 of the
# largest magnitude. DvbTBandStreamDemod's host chunks are held to the JAX
# receiver by tests/test_torch_band.py::test_dvb_t_band_two_muxes (a DVB-T
# band capture is too long for this sweep).

from orion_sdr_tpu_torch.dsp.channelizer import Channelizer as PChan  # noqa: E402
from orion_sdr_tpu_torch.fec.scrambler import PnScramblerStream as PPn  # noqa: E402

JChan = importlib.import_module("orion_sdr_tpu.dsp.channelizer").Channelizer
JPn = importlib.import_module("orion_sdr_tpu.fec.scrambler").PnScramblerStream


def _chunks(x, n):
    return [x[i:i + n] for i in range(0, len(x), n)]


def _afsk_audio():
    f = J.Ax25Frame(dest="APRS", src="N0CALL", payload=b"host chunks")
    return np.asarray(J.ax25_beacon([f], 48_000.0), np.float32)


def _psk31_audio():
    return np.asarray(J.bpsk31_mod_text("cq de n0call", 8000.0, 800.0),
                      np.complex64)


def _ft8_frame():
    p = J.pack77(J.Ft8Standard("CQ", "KA1ABC", "FN42"),
                 J.CallsignHashTable())
    x = np.asarray(J.ft8_mod(J.ft8_encode(p), 12000.0, base_hz=1012.5))
    return np.concatenate([x, np.zeros(180_000 - len(x), np.complex64)])


def _ofdm_link(pkg):
    plan = pkg.CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    cfg = pkg.OfdmConfig(plan, fs=1e6)
    pre = pkg.OfdmPreamble(repeat_len=128, num_repeats=4) \
        .with_training_symbol(256, 64)
    return cfg, pkg.McsTable.default_ladder(), pre


def _ofdm_stream_iq():
    from orion_sdr_tpu.frame.types import FrameMetadata
    cfg, table, pre = _ofdm_link(J)
    mod = J.OfdmFrameMod(cfg, table, pre)
    frame = np.asarray(mod.modulate_frame(J.FramePacket(
        FrameMetadata(1, 1), np.arange(120, dtype=np.uint8)), 5))
    gap = np.zeros(700, np.complex64)
    return np.concatenate([gap, frame, gap]).astype(np.complex64)


DVB_LINK = ("1/32", "qpsk", "1/2")


def _dvb_t_stream_iq():
    params = J.DvbTFrameParams(J.DvbTLinkParams(*DVB_LINK), 0, 0)
    f = J.DvbTFrameMod(params).modulate(np.arange(184, dtype=np.uint8))
    return np.concatenate([f.iq, np.zeros(f.samples_per_symbol,
                                          np.complex64)]), f.n_symbols


HIER_FIELDS = ("1/32", "qam16", 2, "1/2", "2/3")


def _hier_make(pkg, **kw):
    params = pkg.DvbTHierFrameParams(pkg.DvbTHierLinkParams(*HIER_FIELDS))
    return pkg.DvbTHierFrameStreamDemod(params, _hier_iq()[1], 100, 200,
                                        **kw)


def _hier_iq():
    params = J.DvbTHierFrameParams(J.DvbTHierLinkParams(*HIER_FIELDS))
    f = J.DvbTHierFrameMod(params).modulate(np.arange(100, dtype=np.uint8),
                                            np.arange(200, dtype=np.uint8))
    return np.concatenate([np.zeros(500, np.complex64), f.iq,
                           np.zeros(300, np.complex64)]), f.n_symbols


BAND_CENTER, BAND_FS_WIDE = 0.5e6, 4e6


def _band_iq():
    """The COFDM stream's frame composed at BAND_CENTER into a 4 Msps
    capture (the channelizer's TX mirror)."""
    x = _ofdm_stream_iq()
    return np.asarray(J.dsp.band_compose(x[None], [BAND_CENTER],
                                         BAND_FS_WIDE, 1e6)).astype(
        np.complex64)


def _band_view(out):
    return sum((_payload_view(o.get(0, [])) for o in out), [])


def _hier_view(out):
    return [(bytes(np.asarray(r.hp_payload, np.uint8)),
             None if r.lp_payload is None else
             bytes(np.asarray(r.lp_payload, np.uint8)))
            for o in out for r in o if hasattr(r, "hp_payload")]


def _frames(out):
    return [vars(f) for f in out]


def _payload_view(out):
    """The payloads of the frames of a COFDM (RxFrame.packet) or DVB-T
    stream."""
    return [bytes(np.asarray(getattr(r, "packet", r).payload, np.uint8))
            for r in out if hasattr(getattr(r, "packet", r), "payload")]


def _ft8_view(out):
    return [(type(r.message).__name__, tuple(
        bytes(np.asarray(v, np.uint8)) if isinstance(v, np.ndarray) else v
        for v in dataclasses.astuple(r.message)), r.carrier_hz) for r in out]


def _dvb_t_make(pkg, n_sym, **kw):
    params = pkg.DvbTFrameParams(pkg.DvbTLinkParams(*DVB_LINK), 0, 0)
    return pkg.DvbTFrameStreamDemod(params, n_sym, 184, **kw)


# name: (the port class whose "device" default is checked, "feed" where the
# device goes with each call (the Resampler: the spy's check), or None for
# host bits in both packages; make(pkg, **kw) → a stream; the method; the
# chunks; what the outputs of one run compare as; "exact" or "close")
STREAMS = {
    "Resampler.feed": ("feed", lambda pkg, **kw: pkg.dsp.Resampler(3, 2),
                       "feed", lambda: _chunks(AUDIO[0], 300),
                       lambda outs: [torch.cat([torch.as_tensor(np.array(
                           o)) for o in outs])], "close"),
    "Channelizer.push": (PChan, lambda pkg, **kw: (JChan if pkg is J
                                                   else PChan)(
        48e3, 12e3, [-9e3, 6e3], **kw), "push",
        lambda: _chunks(np.tile(IQ[0], 20), 1111),
        lambda outs: [torch.cat([torch.as_tensor(np.array(o))
                                 for o in outs], dim=-1)], "close"),
    "PnScramblerStream.feed": (None, lambda pkg, **kw: (
        JPn if pkg is J else PPn)(0b1001, 15, 0x3C3), "feed",
        lambda: _chunks(BITS[0], 17),
        lambda outs: [torch.as_tensor(np.concatenate([np.asarray(o)
                                                      for o in outs]))],
        "exact"),
    "Afsk1200Stream.feed": (P.Afsk1200Stream, lambda pkg, **kw:
                            pkg.Afsk1200Stream(48_000.0, **kw), "feed",
                            lambda: _chunks(_afsk_audio(), 9_000),
                            lambda outs: sum((_frames(o) for o in outs), []),
                            "exact"),
    "Psk31Stream.feed": (P.Psk31Stream, lambda pkg, **kw:
                         pkg.Psk31Stream.new_bpsk(8000.0, 800.0, **kw),
                         "feed", lambda: _chunks(_psk31_audio(), 3_001),
                         lambda outs: ["".join(outs)], "exact"),
    "Ft8StreamDecoder.feed": (P.Ft8StreamDecoder, lambda pkg, **kw:
                              pkg.Ft8StreamDecoder(12000.0, 950.0, 1150.0,
                                                   **kw), "feed",
                              lambda: _chunks(_ft8_frame(), 60_000),
                              lambda outs: sum((_ft8_view(o) for o in outs),
                                               []), "exact"),
    "OfdmFrameStreamDemod.feed": (P.OfdmFrameStreamDemod, lambda pkg, **kw:
                                  pkg.OfdmFrameStreamDemod(*_ofdm_link(pkg),
                                                           **kw), "feed",
                                  lambda: _chunks(_ofdm_stream_iq(), 2_500),
                                  lambda outs: sum((_payload_view(o)
                                                    for o in outs), []),
                                  "exact"),
    "DvbTFrameStreamDemod.feed": (P.DvbTFrameStreamDemod, lambda pkg, **kw:
                                  _dvb_t_make(pkg, _dvb_t_stream_iq()[1],
                                              **kw), "feed",
                                  lambda: _chunks(_dvb_t_stream_iq()[0],
                                                  40_000),
                                  lambda outs: sum((_payload_view(o)
                                                    for o in outs), []),
                                  "exact"),
    "DvbTHierFrameStreamDemod.feed": (P.DvbTHierFrameStreamDemod, _hier_make,
                                      "feed", lambda: _chunks(_hier_iq()[0],
                                                              40_000),
                                      _hier_view, "exact"),
    "OfdmFrameBandStreamDemod.feed": (P.OfdmFrameBandStreamDemod,
                                      lambda pkg, **kw:
                                      pkg.OfdmFrameBandStreamDemod(
                                          *_ofdm_link(pkg), [BAND_CENTER],
                                          BAND_FS_WIDE, **kw), "feed",
                                      lambda: _chunks(_band_iq(), 7_001),
                                      _band_view, "exact"),
}


def _run_stream(name, pkg, chunks, device=None):
    """The outputs of every chunk, and of ``flush`` where the stream holds
    a tail (the FT8 decoder's flush decodes its buffer again); ``device``
    goes where the stream takes it."""
    where, make, method, _, view, _ = STREAMS[name]
    kw = {} if device is None else {"device": device}
    st = make(pkg, **(kw if where not in ("feed", None) else {}))
    call = getattr(st, method)
    outs = [call(c, **kw) if where == "feed" else call(c) for c in chunks]
    if hasattr(st, "flush") and not name.startswith("Ft8"):
        outs.append(st.flush())
    return view(outs)


def _same(ref, got, how):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        if isinstance(g, torch.Tensor):
            assert g.device.type == "cpu"
            close(r, g) if how == "close" else \
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        else:
            assert g == r


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_asks_for_the_card_by_default(name, monkeypatch):
    where, make, method, chunks, _, _ = STREAMS[name]
    if where is None:                       # host bits in both packages
        assert isinstance(make(P).feed(BITS[0][:8]), np.ndarray)
        return
    if where != "feed":
        assert inspect.signature(where).parameters["device"].default == \
            "cuda"
        return
    asked = []
    _resolver_spy(PDV, "on_device", asked, monkeypatch)
    getattr(make(P), method)(chunks()[0])
    assert asked and asked[0] == "cuda"


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_numpy_chunks_on_the_cpu_equal_jax(name):
    where, _, _, chunks, _, how = STREAMS[name]
    c = chunks()
    ref = _run_stream(name, J, c)
    got = _run_stream(name, P, c, None if where is None else "cpu")
    assert ref or name.startswith(("Resampler", "Channelizer", "Pn"))
    _same(ref, got, how)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_tensor_chunks_keep_the_device(name):
    where, _, _, chunks, _, how = STREAMS[name]
    c = chunks()
    dev = None if where in ("feed", None) else "cpu"
    host = _run_stream(name, P, c, None if where is None else "cpu")
    got = _run_stream(name, P, [torch.as_tensor(np.array(x)) for x in c],
                      dev)
    _same(host, got, how)
