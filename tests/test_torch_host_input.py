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
device.

Tolerances: bits, codewords, decoded messages, blanked IQ and depunctured
LLRs exact (Viterbi on integer-valued LLRs, BP on a clean-enough channel);
filtered, resampled, mixed and scanned values within 1e-5 of the output's
largest magnitude, as tests/test_torch_dsp_misc.py and
tests/test_torch_dsp_iir.py state for the same functions."""

import importlib

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
from orion_sdr_tpu_torch.dsp import resample as PRS
from orion_sdr_tpu_torch.fec import bch_device as PB
from orion_sdr_tpu_torch.fec import conv as PC
from orion_sdr_tpu_torch.fec import ldpc as PL
from orion_sdr_tpu_torch.fec.galois import ReedSolomon

JC = importlib.import_module("orion_sdr_tpu.fec.conv")
JL = importlib.import_module("orion_sdr_tpu.fec.ldpc")
JB = importlib.import_module("orion_sdr_tpu.fec.bch_device")
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
        else:
            close(r, g)


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
