"""Torch port, PSK31 (codec/varicode.py, codec/psk31.py, modulate/psk31.py,
demodulate/psk31.py, sync/psk31_sync.py, codec/psk31_stream.py) against the
JAX package on the CPU, with the same numpy inputs.

Tolerances: exact for varicode, the convolutional code, both batch
Viterbi decoders, hard decisions, detected runs and every decoded text;
the modulators' IQ exact at baseband (unit phasors times Hann weights) and
1e-5 of the peak with a carrier (the phase ramp); soft symbols 1e-4 of the
peak (the PLL kernel's plain version against the JAX scan: its cos, sin and
rsqrt are torch's and its products and sums are rounded apart, where XLA
fuses some into multiply-adds; measured at most 5e-7 on these captures,
the bound leaves room for the feedback loop to carry a difference);
refined carriers 1e-3 Hz. The SNR floors are the JAX test's: every one of
five seeds decodes at −5 dB (BPSK31) and −6 dB (QPSK31)."""

import importlib
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_sdr_tpu.codec import psk31 as JC
from orion_sdr_tpu.codec import psk31_stream as JS
from orion_sdr_tpu.codec import varicode as JV
from orion_sdr_tpu.demodulate import psk31 as JD
from orion_sdr_tpu.modulate import psk31 as JM

from orion_sdr_tpu_torch import convert
from orion_sdr_tpu_torch.codec import psk31 as PC
from orion_sdr_tpu_torch.codec import psk31_stream as PS
from orion_sdr_tpu_torch.codec import varicode as PV
from orion_sdr_tpu_torch.demodulate import psk31 as PD
from orion_sdr_tpu_torch.modulate import psk31 as PM
from orion_sdr_tpu_torch.ops import psk31_viterbi as PVK
from orion_sdr_tpu_torch.ops.psk31_pll import psk31_pll

PY = importlib.import_module("orion_sdr_tpu_torch.sync.psk31_sync")
JY = importlib.import_module("orion_sdr_tpu.sync.psk31_sync")

torch.set_num_threads(1)
CPU = "cpu"
FS = 8000.0
BAUD = 31.25
SOFT_RTOL = 1e-4


def soft_close(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= SOFT_RTOL * max(np.abs(ref).max(), 1.0)


def awgn(rng, n, power):
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * np.sqrt(power / 2)).astype(np.complex64)


def snr_to_noise_power(snr_db, ref_bw=2500.0):
    return FS / (ref_bw * 10.0 ** (snr_db / 10.0))


# ── varicode and the convolutional code ──────────────────────────────────────

def test_varicode_equal():
    assert PV.VARICODE == JV.VARICODE
    text = "CQ CQ de TPU1 <0123456789> ~ all of ASCII: " + "".join(
        chr(c) for c in range(32, 127))
    bits = PV.encode_text(text, 40, 24)
    assert np.array_equal(bits, JV.encode_text(text, 40, 24))
    assert PV.decode_bits(bits) == JV.decode_bits(bits) == text
    a, b = PV.VaricodeDecoder(), JV.VaricodeDecoder()
    out_a = "".join(a.push_bits(bits[i:i + 7]) for i in range(0, len(bits), 7))
    out_b = "".join(b.push_bits(bits[i:i + 7]) for i in range(0, len(bits), 7))
    assert out_a == out_b
    for byte in (0, 10, 65, 127, 200):
        assert PV.varicode_encode(byte) == JV.varicode_encode(byte)


def test_conv_code_equal():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, 300).astype(np.uint8)
    for sr in (0, 5, 15):
        assert np.array_equal(PC.conv_encode(bits, sr),
                              JC.conv_encode(bits, sr))
        assert PC.conv_encode_final_sr(bits, sr) == \
            JC.conv_encode_final_sr(bits, sr)
    assert [np.array_equal(a, b) for a, b in zip(PC._trellis(),
                                                 JC._trellis())] == [True] * 3


@pytest.mark.parametrize("noise", [0.0, 0.45])
def test_batch_viterbis_equal(noise):
    """Both soft decoders on three rows at once, each row against the JAX
    decoder of that row: the non-coherent one on differential products,
    the coherent one on absolute symbols (its input); clean rows decode
    to the sent bits. The hard decoder on the clean coded bits."""
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (3, 120)).astype(np.uint8)
    diff, absolute = [], []
    for row in bits:
        c = JC.conv_encode(row)
        d = JC.DQPSK_EXP[c[0::2] * 2 + c[1::2]]
        for sym, out in ((d, diff), (np.cumprod(d), absolute)):
            sym = sym + noise * (rng.standard_normal(len(d))
                                 + 1j * rng.standard_normal(len(d)))
            out.append(np.stack([sym.real, sym.imag], -1).astype(np.float32))
    for jfn, pfn, pairs in (
            (JC.viterbi_decode, PC.viterbi_decode, np.stack(diff)),
            (JC.viterbi_decode_coherent, PC.viterbi_decode_coherent,
             np.stack(absolute))):
        got = pfn(pairs, device=CPU).numpy()
        ref = np.stack([np.asarray(jfn(jnp.asarray(p))) for p in pairs])
        assert np.array_equal(got, ref)
        if noise == 0.0:
            assert np.array_equal(got, bits)
    c = JC.conv_encode(bits[0])
    assert np.array_equal(PC.viterbi_decode_hard(c, device=CPU).numpy(),
                          JC.viterbi_decode_hard(c))


DECODERS = {False: (JC.viterbi_decode, PC.viterbi_decode),
            True: (JC.viterbi_decode_coherent, PC.viterbi_decode_coherent)}


def coded_pairs(rng, rows, n, coherent, flip=0.0, noise=0.0):
    """(rows, n, 2) float32 pairs of random bits through the code, a coded
    bit flipped at rate ``flip``, complex noise of ``noise`` a component:
    differential products, or absolute symbols for the coherent decoder."""
    out = []
    for row in rng.integers(0, 2, (rows, n)).astype(np.uint8):
        c = JC.conv_encode(row) ^ (rng.random(2 * n) < flip).astype(np.uint8)
        sym = JC.DQPSK_EXP[c[0::2] * 2 + c[1::2]]
        sym = (np.cumprod(sym) if coherent else sym) + noise * (
            rng.standard_normal(n) + 1j * rng.standard_normal(n))
        out.append(np.stack([sym.real, sym.imag], -1))
    return np.asarray(out, dtype=np.float32).reshape(rows, n, 2)


def decode_against_jax(pairs, coherent):
    """The port's decoder on the CPU (the kernel's plain version) on all rows
    at once; each row held to the JAX decoder of that row."""
    jfn, pfn = DECODERS[coherent]
    got = pfn(pairs, device=CPU)
    assert got.dtype == torch.uint8 and got.shape == pairs.shape[:-1]
    ref = np.stack([np.asarray(jfn(jnp.asarray(p))) for p in pairs])
    assert np.array_equal(got.numpy(), ref.reshape(got.shape))
    return got


@pytest.mark.parametrize("coherent", [False, True])
def test_batch_viterbi_exact_ties_match_jax(coherent):
    """Hard phasors with 8 % of the coded bits flipped: every branch metric
    is 0, |1 ± j|² or 4, so candidates tie exactly and the tie rules decide,
    and so does how a candidate rounds (the coherent one once, as XLA's
    fused multiply-add; rounded twice, as the port's torch loop did, some
    of these coherent rows read other bits than the JAX decoder)."""
    rng = np.random.default_rng(11)
    for _ in range(4):
        decode_against_jax(coded_pairs(rng, 3, 120, coherent, flip=0.08),
                           coherent)


def _loop_decode(pairs: torch.Tensor, coherent: bool) -> torch.Tensor:
    """The port's decoders as they were before the kernel: torch loops with
    a table of predecessors a step and a gather traceback."""
    pred, bit_of_ns, dibit = PC._trellis()
    pred = torch.as_tensor(pred, dtype=torch.int64)
    trans = torch.as_tensor(dibit[pred, bit_of_ns[:, None]],
                            dtype=torch.int64)
    exp = torch.as_tensor(PC.DQPSK_EXP)
    z = torch.complex(pairs[..., 0], pairs[..., 1])
    pm = torch.full(z.shape[:-1] + (16,), float(PC._INF))
    pm[..., 0] = 0.0
    hyp = torch.ones(pm.shape, dtype=torch.complex64)
    choices = []
    for t in range(z.shape[-1]):
        if coherent:
            nh = hyp[..., pred] * exp[trans]
            cand = pm[..., pred] + (z[..., t, None, None] - nh).abs() ** 2
        else:
            bm4 = (z[..., t, None] - exp).abs() ** 2
            cand = pm[..., pred] + bm4[..., trans]
        j = cand[..., 1] < cand[..., 0]
        new = torch.where(j, cand[..., 1], cand[..., 0])
        if coherent:
            hyp = torch.where(j, nh[..., 1], nh[..., 0])
        choices.append(pred[:, 0] + j.to(torch.int64))
        pm = new - new.min(dim=-1, keepdim=True).values
    state = torch.argmin(pm, dim=-1, keepdim=True)
    bits = []
    for tbl in reversed(choices):
        bits.append(((state[..., 0] >> 3) & 1).to(torch.uint8))
        state = torch.gather(tbl, -1, state)
    return torch.stack(bits[::-1], dim=-1)


@pytest.mark.parametrize("coherent", [False, True])
def test_batch_viterbi_non_finite_rows(coherent):
    """Noisy rows with a NaN pair at the first, a middle or the last symbol,
    or an infinite one: every metric is NaN from there on (torch.min and
    argmin propagate it, and so do the kernel's min and argmin); each row's
    bits equal what the port's torch loops returned before the kernel, and
    the JAX decoder's."""
    pairs = coded_pairs(np.random.default_rng(12), 4, 120, coherent,
                        noise=0.3)
    pairs[0, 0, 0] = pairs[1, 60, 1] = pairs[2, 119, 0] = np.nan
    pairs[3, 40, 0] = np.inf
    got = decode_against_jax(pairs, coherent)
    assert torch.equal(got, _loop_decode(torch.as_tensor(pairs), coherent))


@pytest.mark.parametrize("n", [0, 1])
def test_batch_viterbi_short_rows(n):
    """n = 0 and n = 1 against the JAX decoders, leading axes kept; an empty
    batch returns its empty shape."""
    pairs = np.random.default_rng(13).standard_normal((2, n, 2))
    for coherent in (False, True):
        decode_against_jax(pairs.astype(np.float32), coherent)
        empty = DECODERS[coherent][1](np.zeros((0, 3, 2), np.float32),
                                      device=CPU)
        assert empty.shape == (0, 3) and empty.dtype == torch.uint8


def _f32_exact(x: Fraction) -> np.float32:
    """The float32 nearest ``x`` (ties to even)."""
    c = np.float32(float(x))
    near = [np.nextafter(c, np.float32(-np.inf)), c,
            np.nextafter(c, np.float32(np.inf))]
    return min(near, key=lambda v: (abs(Fraction(float(v)) - x),
                                    int(v.view(np.uint32)) & 1))


def test_coherent_candidates_round_once():
    """The coherent candidate h·h + pm of the plain version
    (``ops.psk31_viterbi._fma``, fmaf on the card) against the exact sum
    rounded once, on random magnitudes and on sums at and a hair off a
    float32 midpoint (1 + 2^-24)."""
    rng = np.random.default_rng(14)
    h = (2.0 ** rng.uniform(-40, 60, 400)).astype(np.float32)
    a = (2.0 ** rng.uniform(-60, 126, 400) * (rng.random(400) < 0.9)
         ).astype(np.float32)
    mid = np.float32(2.0 ** -12)
    h = np.concatenate([h, [mid, np.nextafter(mid, np.float32(1)),
                            np.nextafter(mid, np.float32(0)), 0.0]])
    a = np.concatenate([a, [1.0, 1.0, 1.0, 0.0]]).astype(np.float32)
    got = PVK._fma(torch.as_tensor(h).double() ** 2,
                   torch.as_tensor(a)).numpy()
    want = [_f32_exact(Fraction(float(x)) ** 2 + Fraction(float(y)))
            for x, y in zip(h, a)]
    assert got.tobytes() == np.asarray(want, np.float32).tobytes()


def test_streaming_viterbi_equal():
    rng = np.random.default_rng(3)
    d = rng.standard_normal((300, 2)).astype(np.float32)
    a, b = PC.StreamingViterbi(), JC.StreamingViterbi()
    assert [a.feed_symbol(*s) for s in d] == [b.feed_symbol(*s) for s in d]
    assert a.flush() == b.flush()


# ── modulators ───────────────────────────────────────────────────────────────

def test_modulators_equal():
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, 100).astype(np.uint8)
    for jfn, pfn in ((JM.bpsk31_mod_bits, PM.bpsk31_mod_bits),
                     (JM.qpsk31_mod_bits, PM.qpsk31_mod_bits)):
        ref, rf = jfn(bits, FS, phase0=-1.0 + 0j)
        got, gf = pfn(bits, FS, phase0=-1.0 + 0j, device=CPU)
        assert np.array_equal(got.numpy(), ref) and gf == rf
        ref, _ = jfn(bits, FS, rf_hz=1000.0, gain=0.5)
        got, _ = pfn(bits, FS, rf_hz=1000.0, gain=0.5, device=CPU)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    for jfn, pfn in ((JM.bpsk31_mod_text, PM.bpsk31_mod_text),
                     (JM.qpsk31_mod_text, PM.qpsk31_mod_text)):
        assert np.array_equal(pfn("CQ", 12000.0, device=CPU).numpy(),
                              jfn("CQ", 12000.0))
    batch = rng.integers(0, 2, (4, 64)).astype(np.uint8)
    got = PM.bpsk31_mod_bits_batch(torch.as_tensor(batch), FS)
    for row, g in zip(batch, got):
        assert np.array_equal(g.numpy(), JM.bpsk31_mod_bits(row, FS)[0])
    assert PM.psk31_sps(FS) == JM.psk31_sps(FS) == 256
    assert np.array_equal(PM.psk31_hann(256), JM.psk31_hann(256))


# ── demodulators ─────────────────────────────────────────────────────────────

@pytest.mark.parametrize("qpsk", [False, True])
def test_pll_plain_version_against_the_jax_scan(qpsk):
    """The PLL kernel's plain version (the CPU path) against the JAX
    ``_pll_scan`` on the same dots, two rows with their own carries."""
    rng = np.random.default_rng(5)
    k = np.arange(150)
    base = np.exp(1j * (0.02 * k + 0.4)) * 120.0
    flips = np.where(rng.integers(0, 2, (2, 150)) == 1, 1.0, -1.0)
    dots = (base * flips + 15.0 * (rng.standard_normal((2, 150)) + 1j
                                   * rng.standard_normal((2, 150)))
            ).astype(np.complex64)
    prev = np.array([1.0 + 0j, -0.5 + 0.3j], np.complex64)
    acc = np.array([0.0, 0.3], np.float32)
    ref, (rp, ra) = jax.jit(lambda d, p, a: JD._pll_scan(
        d, 256, 1.0, qpsk, p, a))(dots, prev, acc)
    c_fb, scale = PD.pll_constants(256, 1.0)
    got, gp, ga = psk31_pll(torch.as_tensor(dots), torch.as_tensor(prev),
                            torch.as_tensor(acc), c_fb, scale, 0.05, qpsk)
    soft_close(ref, got)
    soft_close(rp, gp)
    soft_close(ra, ga)
    assert np.array_equal(np.asarray(ref)[..., 0] >= 0 if qpsk
                          else np.asarray(ref) >= 0,
                          got.numpy()[..., 0] >= 0 if qpsk
                          else got.numpy() >= 0)


@pytest.mark.parametrize("qpsk", [False, True])
def test_pll_tile_schedule_gives_the_whole_call(qpsk):
    """The kernel's data flow, modelled with the plain version: rows in
    blocks of 32 (a block's rows past the batch run on zero dots from a
    zero carry) and symbols in tiles of 32, each tile from the carry the
    last left. The tiled, padded run equals one call over the whole batch
    bit for bit, and the padding rows stay at zero (no slow path)."""
    from orion_sdr_tpu_torch.ops.psk31_pll import psk31_pll_reference
    rows, n, tile, block = 37, 70, 32, 32
    rng = np.random.default_rng(9)
    dots = torch.as_tensor((120.0 * np.exp(1j * rng.uniform(
        0, 6, (rows, n))) + 20.0 * (rng.standard_normal((rows, n)) + 1j
        * rng.standard_normal((rows, n)))).astype(np.complex64))
    prev = torch.as_tensor(np.exp(1j * rng.uniform(0, 6, rows)).astype(
        np.complex64))
    acc = torch.as_tensor(rng.uniform(-40, 40, rows).astype(np.float32))
    c_fb, scale = PD.pll_constants(256, 1.0)
    args = (c_fb, scale, 0.05, qpsk)
    whole = psk31_pll_reference(dots, prev, acc, *args)
    pad = -rows % block
    d = torch.cat([dots, dots.new_zeros((pad, n))])
    p = torch.cat([prev, prev.new_zeros(pad)])
    a = torch.cat([acc, acc.new_zeros(pad)])
    soft = []
    for b0 in range(0, rows + pad, block):
        pb, ab = p[b0:b0 + block], a[b0:b0 + block]
        parts = []
        for k0 in range(0, n, tile):
            s, pb, ab = psk31_pll_reference(d[b0:b0 + block, k0:k0 + tile],
                                            pb, ab, *args)
            parts.append(s)
        soft.append(torch.cat(parts, dim=1))
        p[b0:b0 + block], a[b0:b0 + block] = pb, ab
    soft = torch.cat(soft)
    assert torch.equal(soft[:rows], whole[0])
    assert torch.equal(p[:rows], whole[1]) and torch.equal(a[:rows], whole[2])
    assert not soft[rows:].any() and not p[rows:].any() \
        and not a[rows:].any()


def test_bpsk_and_qpsk_demod():
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2, 100).astype(np.uint8)
    iq, _ = JM.bpsk31_mod_bits(bits, FS, rf_hz=1000.0)
    ref = JD.bpsk31_demod(iq, FS, 1000.0, offset=5)
    got = PD.bpsk31_demod(iq, FS, 1000.0, offset=5, device=CPU)
    soft_close(ref, got)
    got = PD.bpsk31_demod(iq, FS, 1000.0, device=CPU)
    assert np.array_equal(PD.bpsk31_decide(got), bits)
    assert np.array_equal(PD.bpsk31_decide(got),
                          JD.bpsk31_decide(JD.bpsk31_demod(iq, FS, 1000.0)))
    iq, _ = JM.qpsk31_mod_bits(bits, FS, rf_hz=1000.0)
    noisy = iq + awgn(rng, len(iq), 0.2)
    ref = JD.qpsk31_demod(noisy, FS, 1000.5)
    got = PD.qpsk31_demod(noisy, FS, 1000.5, device=CPU)
    soft_close(ref, got)
    assert PD.bpsk31_demod(iq[:100], FS, device=CPU).shape == (0,)
    assert PD.qpsk31_demod(iq[:100], FS, device=CPU).shape == (0, 2)


def three_carrier_band():
    """tests/test_psk31.py:265-292's capture: three BPSK31 texts off the
    waterfall grid, at random starts, 1e-4 noise."""
    base = 900.0
    msgs = {base + 4 * BAUD + 12.5: "CQ DX ALPHA",
            base + 12 * BAUD + 12.5: "HELLO BAND",
            base + 22 * BAUD + 12.5: "TEST 73"}
    n = int(FS * 6)
    buf = np.zeros(n, np.complex64)
    rng = np.random.default_rng(21)
    for (hz, msg), a in zip(msgs.items(), [1.0, 0.4, 0.15]):
        iq = a * np.asarray(JM.bpsk31_mod_text(msg, FS, rf_hz=hz,
                                               preamble_bits=64))
        start = int(rng.integers(0, FS // 4))
        buf[start:start + len(iq)] += iq[: n - start]
    buf += awgn(rng, n, 1e-4)
    return buf, msgs, base


def test_demod_multi_refine_and_band_decode():
    buf, msgs, base = three_carrier_band()
    f = np.array(list(msgs), np.float32)
    ref, roff = JD.psk31_demod_multi(buf, FS, f)
    got, goff = PD.psk31_demod_multi(buf, FS, f, device=CPU)
    assert np.array_equal(goff.numpy(), np.asarray(roff))
    soft_close(ref, got)
    starts = np.array([100, 900, 2000], np.int32)
    ref = JD.psk31_refine_carriers(buf, FS, f - 3.0, starts=starts,
                                   length=16 * 256, max_df_hz=0.55 * BAUD)
    got = PD.psk31_refine_carriers(buf, FS, f - 3.0, starts=starts,
                                   length=16 * 256, max_df_hz=0.55 * BAUD,
                                   device=CPU)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3)
    ref = JS.psk31_decode_band(buf, FS, base, base + 30 * BAUD)
    got = PS.psk31_decode_band(buf, FS, base, base + 30 * BAUD, device=CPU)
    assert [(r.text, r.time_sym) for r in got] == \
        [(r.text, r.time_sym) for r in ref]
    for hz, msg in msgs.items():
        near = [r for r in got if abs(r.carrier_hz - hz) < 40.0]
        assert near and msg in near[0].text
    assert PS.psk31_decode_band(np.zeros(int(FS * 2), np.complex64), FS,
                                900.0, 1500.0, device=CPU) == []
    assert PS.psk31_decode_band(np.zeros(0, np.complex64), FS, 900.0,
                                1500.0, device=CPU) == []


def test_qpsk_band_decode():
    hz = 900.0 + 6 * BAUD
    iq = np.asarray(JM.qpsk31_mod_text("QPSK BAND", FS, rf_hz=hz,
                                       preamble_bits=64))
    buf = np.concatenate([iq, np.zeros(int(FS), np.complex64)])
    got = PS.psk31_decode_band(buf, FS, 900.0, 1100.0, qpsk=True,
                               device=CPU)
    ref = JS.psk31_decode_band(buf, FS, 900.0, 1100.0, qpsk=True)
    assert [r.text for r in got] == [r.text for r in ref]
    assert got and "QPSK BAND" in got[0].text


def test_sync_and_best_sync():
    base = 900.0
    carrier = base + 3 * BAUD
    iq = np.asarray(JM.bpsk31_mod_text("CQ TEST", FS, rf_hz=carrier,
                                       preamble_bits=64))
    rng = np.random.default_rng(7)
    buf = np.concatenate([iq, np.zeros(int(FS), np.complex64)])
    buf += awgn(rng, len(buf), snr_to_noise_power(-5.0))
    ref = JY.psk31_sync(buf, FS, base, base + 200.0, 4, 3.0, 32, 5)
    got = PY.psk31_sync(buf, FS, base, base + 200.0, 4, 3.0, 32, 5,
                        device=CPU)
    assert [(r.time_sym, r.freq_bin, r.carrier_hz) for r in got] == \
        [(r.time_sym, r.freq_bin, r.carrier_hz) for r in ref]
    for a, b in zip(got, ref):
        assert abs(a.score - b.score) < 1e-4
        soft_close(b.soft_bits, a.soft_bits)
    assert PY.best_sync(got, carrier, BAUD) == JY.best_sync(ref, carrier,
                                                            BAUD)
    assert PY.best_sync([], carrier, BAUD) is None


# ── the stream decoder ───────────────────────────────────────────────────────

def test_stream_chunk_invariance_and_afc():
    iq = np.asarray(JM.bpsk31_mod_text("chunk boundary invariance", FS,
                                       rf_hz=800.0))
    one = PS.Psk31Stream.new_bpsk(FS, 800.0, device=CPU)
    t_one = one.feed(iq) + one.flush()
    chunked = PS.Psk31Stream.new_bpsk(FS, 800.0, device=CPU)
    t_chunks = "".join(chunked.feed(iq[i:i + 777])
                       for i in range(0, len(iq), 777)) + chunked.flush()
    assert t_one == t_chunks == "chunk boundary invariance"
    iq = np.asarray(JM.qpsk31_mod_text("afc test msg", FS, rf_hz=1000.0))
    st = PS.Psk31Stream.new_qpsk(FS, carrier_hz=1001.5, device=CPU)
    assert "afc test msg" in st.feed(iq) + st.flush()


@pytest.mark.parametrize("qpsk,snr_db", [(False, -5.0), (True, -6.0)])
def test_stream_decodes_at_the_snr_floor(qpsk, snr_db):
    msg = "CQ TEST"
    mod = JM.qpsk31_mod_text if qpsk else JM.bpsk31_mod_text
    carrier = 993.75
    iq = np.asarray(mod(msg, FS, rf_hz=carrier, preamble_bits=64))
    for seed in range(5):
        rng = np.random.default_rng(1000 + seed)
        noisy = iq + awgn(rng, len(iq), snr_to_noise_power(snr_db))
        st = (PS.Psk31Stream.new_qpsk if qpsk else PS.Psk31Stream.new_bpsk)(
            FS, carrier, device=CPU)
        assert msg in st.feed(noisy) + st.flush(), seed


@pytest.mark.parametrize("qpsk", [False, True])
def test_stream_state_from_the_jax_package_continues_in_the_port(qpsk):
    """Half a capture through the JAX stream, its carry converted, the rest
    through the port: the same text as one JAX stream."""
    mod = JM.qpsk31_mod_text if qpsk else JM.bpsk31_mod_text
    iq = np.asarray(mod("HANDOVER TEST 73", FS, rf_hz=1100.0))
    rng = np.random.default_rng(9)
    iq = iq + awgn(rng, len(iq), 0.05)
    mk = JS.Psk31Stream.new_qpsk if qpsk else JS.Psk31Stream.new_bpsk
    whole = mk(FS, 1100.0)
    ref = whole.feed(iq) + whole.flush()
    half = mk(FS, 1100.0)
    cut = len(iq) // 2 + 100
    text = half.feed(iq[:cut])
    fields = {**vars(half), "vdec": vars(half.vdec),
              "viterbi": vars(half.viterbi) if half.viterbi else None}
    port = convert.psk31_stream_from_fields(fields, CPU)
    text += port.feed(iq[cut:]) + port.flush()
    assert text == ref and "HANDOVER TEST 73" in text


def test_hard_decisions_match():
    """``hard_decide_dbpsk``/``_dqpsk`` (exact), zeros and ties included."""
    rng = np.random.default_rng(17)
    re = np.concatenate([rng.standard_normal(200), [0.0, -0.0, 1.0, -1.0]]
                        ).astype(np.float32)
    im = np.concatenate([rng.standard_normal(200), [0.0, 0.5, 1.0, 1.0]]
                        ).astype(np.float32)
    assert np.array_equal(PD.hard_decide_dbpsk(torch.as_tensor(re)).numpy(),
                          np.asarray(JD.hard_decide_dbpsk(re)))
    ours = PD.hard_decide_dqpsk(torch.as_tensor(re), torch.as_tensor(im))
    ref = JD.hard_decide_dqpsk(re, im)
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float32
        assert np.array_equal(o.numpy(), np.asarray(r))
