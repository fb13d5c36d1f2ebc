"""Torch port: the convolutional codes and the Viterbi decoder against the JAX
package. Integer-valued LLRs (−8…8, exact in bf16 too) must give the same
bits as the JAX jnp decoders and the Pallas kernels run in interpret mode,
in radix 2 and radix 4; float LLRs the same bits up to a stated handful of
near-ties (≤ 1e-4 of bits, also between the radices). Also the radix
dispatch, the wrappers' checks and CPU dispatch."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from orion_sdr_tpu.fec import conv as jconv
from orion_sdr_tpu.ops import viterbi as jviterbi
from orion_sdr_tpu.ops.viterbi import (_chunks_jnp, viterbi_chunks_pallas,
                                       viterbi_decode_soft_pallas)

from orion_sdr_tpu_torch.fec import conv
from orion_sdr_tpu_torch.ops import viterbi

# The plain torch versions run thousands of tiny ops; with one test worker
# per core, a torch thread pool as wide as the machine in every worker
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

CODES = ("k5", "dvb_k7")
RATES = tuple(conv.PUNCTURE)


def _int_llrs(rng, shape):
    return rng.integers(-8, 9, shape).astype(np.float32)


def _coded(code, rate, info):
    return np.asarray(jconv.conv_encode_punctured(info, rate, code))


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("code", CODES)
def test_encode_matches(code, rate):
    info = np.random.default_rng(1).integers(0, 2, (3, 97)).astype(np.uint8)
    ours = conv.conv_encode_punctured(torch.as_tensor(info), rate, code)
    assert ours.dtype == torch.uint8
    assert np.array_equal(ours.numpy(), _coded(code, rate, info))
    assert ours.shape[-1] == conv.punctured_coded_len(97, rate, code) == \
        jconv.punctured_coded_len(97, rate, code)
    llr = _int_llrs(np.random.default_rng(2), (3, ours.shape[-1] - 5))
    assert np.array_equal(
        conv.depuncture_llrs(torch.as_tensor(llr), 97, rate, code).numpy(),
        np.asarray(jconv.depuncture_llrs(llr, 97, rate, code)))


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("code", CODES)
def test_terminated_exact_on_integer_llrs(code, rate):
    # a seed fixed per case (str hashes change from run to run)
    rng = np.random.default_rng([CODES.index(code), RATES.index(rate)])
    n = 150
    info = rng.integers(0, 2, (3, n)).astype(np.uint8)
    clean = np.where(_coded(code, rate, info) == 0, 4.0, -4.0)
    for llr in (_int_llrs(rng, clean.shape),
                np.where(rng.random(clean.shape) < 0.01, -clean,
                         clean).astype(np.float32)):
        ref = np.asarray(jconv.viterbi_decode_soft(llr, n, rate, code))
        pallas = np.asarray(viterbi_decode_soft_pallas(llr, n, rate, code,
                                                       interpret=True))
        ours = conv.viterbi_decode_soft(torch.as_tensor(llr), n, rate, code)
        assert ours.dtype == torch.uint8 and ours.shape == (3, n)
        assert np.array_equal(ours.numpy(), ref)
        assert np.array_equal(ours.numpy(), pallas)
    if rate in ("1/2", "2/3"):      # 1 % flips: the strong rates correct them
        assert np.array_equal(ours.numpy(), info)


@pytest.mark.parametrize("n", [151, 4501])
@pytest.mark.parametrize("code", CODES)
def test_terminated_odd_and_long_lengths(code, n):
    # an odd trellis (the Pallas kernel falls back to jnp) and one over the
    # 4096-bit terminated limit of the frame chain
    rng = np.random.default_rng(n)
    info = rng.integers(0, 2, (2, n)).astype(np.uint8)
    llr = _int_llrs(rng, _coded(code, "2/3", info).shape)
    ref = np.asarray(jconv.viterbi_decode_soft(llr, n, "2/3", code))
    ours = conv.viterbi_decode_soft(torch.as_tensor(llr[0]), n, "2/3", code)
    assert ours.shape == (n,)
    assert np.array_equal(ours.numpy(), ref[0])


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("code", CODES)
def test_chunked_exact_on_integer_llrs(code, rate):
    # 4501 info bits: five chunks, the last one short (not a multiple of the
    # 1024-step chunk), all through the chunk decoder in one batch
    rng = np.random.default_rng([CODES.index(code), RATES.index(rate)])
    n = 4501
    info = rng.integers(0, 2, (2, n)).astype(np.uint8)
    clean = np.where(_coded(code, rate, info) == 0, 3.0, -3.0)
    llr = np.where(rng.random(clean.shape) < 0.01, -clean, clean
                   ).astype(np.float32)
    llr[1] = _int_llrs(rng, llr[1].shape)
    ref = np.asarray(jconv.viterbi_decode_soft_chunked(llr, n, rate, code))
    ours = conv.viterbi_decode_soft_chunked(torch.as_tensor(llr), n, rate,
                                            code)
    assert ours.shape == (2, n)
    assert np.array_equal(ours.numpy(), ref)
    if rate == "1/2":
        assert np.array_equal(ours[0].numpy(), info[0])
    # the chunk lanes through the Pallas kernel (interpret mode) and the port
    c0, c1, pm0, nchunk = conv.chunk_llrs(torch.as_tensor(llr), n, rate, code)
    assert nchunk == 5 and c0.shape == (10, conv.CHUNK_STEPS
                                        + 2 * conv.CHUNK_OVERLAP)
    pallas = np.asarray(viterbi_chunks_pallas(c0.numpy(), c1.numpy(),
                                              pm0.numpy(), code,
                                              interpret=True))
    plain = viterbi.viterbi_chunks_reference(c0, c1, pm0, code)
    assert np.array_equal(plain.numpy(), pallas.astype(np.uint8))


@pytest.mark.parametrize("code", CODES)
def test_chunk_lanes_odd_span_and_pinned_rows(code):
    rng = np.random.default_rng(7)
    S = 64 if code == "dvb_k7" else 16
    L, T = 5, 37
    c0, c1 = _int_llrs(rng, (L, T)), _int_llrs(rng, (L, T))
    pm0 = rng.integers(-20, 1, (L, S)).astype(np.float32)
    pm0[0] = -1e30
    pm0[0, 0] = 0.0
    ref = np.asarray(_chunks_jnp(c0, c1, pm0, code)).astype(np.uint8)
    got = viterbi.viterbi_chunks_kernel(torch.as_tensor(c0),
                                        torch.as_tensor(c1),
                                        torch.as_tensor(pm0), code)
    assert np.array_equal(got.numpy(), ref)


def test_float_llrs_agree_but_for_near_ties():
    # ROADMAP queue 3: on non-integer LLRs a near-tie may pick another
    # maximum-likelihood path; allow at most 1e-4 of the bits to differ
    rng = np.random.default_rng(11)
    n, total, diff = 3000, 0, 0
    for code, rate in (("dvb_k7", "1/2"), ("dvb_k7", "3/4"), ("k5", "2/3")):
        info = rng.integers(0, 2, (2, n)).astype(np.uint8)
        llr = (np.where(_coded(code, rate, info) == 0, 1.0, -1.0)
               + 0.7 * rng.standard_normal(_coded(code, rate, info).shape)
               ).astype(np.float32)
        for jf, pf in ((jconv.viterbi_decode_soft, conv.viterbi_decode_soft),
                       (jconv.viterbi_decode_soft_chunked,
                        conv.viterbi_decode_soft_chunked)):
            ref = np.asarray(jf(llr, n, rate, code))
            ours = pf(torch.as_tensor(llr), n, rate, code).numpy()
            diff += int((ref != ours).sum())
            total += ref.size
    assert diff <= 1e-4 * total, (diff, total)


def test_wrappers_check_inputs_and_run_the_plain_version_on_cpu():
    c = torch.zeros((4, 40))
    pm = torch.zeros((4, 64))
    before = viterbi.viterbi_chunks_kernel.launches
    assert viterbi.viterbi_chunks_kernel(c, c, pm, "dvb_k7").shape == (4, 40)
    llr = torch.zeros((2, conv.punctured_coded_len(30, "1/2", "k5")))
    assert viterbi.viterbi_decode_soft_kernel(llr, 30, "1/2", "k5").shape == \
        (2, 30)
    assert viterbi.viterbi_chunks_kernel.launches == before   # no kernel here
    with pytest.raises(TypeError):
        viterbi.viterbi_chunks_kernel(c.double(), c, pm, "dvb_k7")
    with pytest.raises(ValueError):
        viterbi.viterbi_chunks_kernel(c, c, pm[:, :16], "dvb_k7")
    with pytest.raises(ValueError):
        viterbi.viterbi_chunks_kernel(c, c[:, :39], pm, "dvb_k7")
    with pytest.raises(ValueError):
        viterbi.viterbi_chunks_kernel(torch.zeros((40, 4)).t(), c, pm,
                                      "dvb_k7")
    with pytest.raises(ValueError):
        viterbi.viterbi_decode_soft_kernel(llr, 30, "1/2", "k9")
    with pytest.raises(ValueError):
        viterbi.viterbi_decode_soft_kernel(llr[0], 30, "1/2", "k5")


def test_kernel_source_replaces_the_tpu_kernel():
    src = open(viterbi._SRC).read()
    assert "orion_sdr_tpu/ops/viterbi.py:200 _make_kernel" in src
    assert "orion_sdr_tpu/ops/viterbi.py:347 _make_kernel4" in src
    assert "-fmad=false" in " ".join(viterbi.NVCC_FLAGS)
    # the note says what bounds the kernels and what the design does
    assert "What bounds them on this card" in src
    assert "This design:" in src
    assert "__reduce_max_sync" in src and "radix4_sum_table" in src


def _lanes(rng, code, L, T):
    S = 64 if code == "dvb_k7" else 16
    c0, c1 = _int_llrs(rng, (L, T)), _int_llrs(rng, (L, T))
    pm0 = rng.integers(-20, 1, (L, S)).astype(np.float32)
    pm0[0] = -1e30                    # a chunk-0 row, pinned at state 0
    pm0[0, 0] = 0.0
    return c0, c1, pm0


@pytest.mark.parametrize("code", CODES)
def test_radix4_exact_on_integer_llrs(code):
    # kernel 4 (ops/viterbi.py:347) in interpret mode, the port's radix-4
    # plain version and its radix-2 plain version: equal bits, chunked lanes
    # (argmax start) and a terminated trellis (state-0 start)
    rng = np.random.default_rng(41 + len(code))
    L, T = 6, 128
    c0, c1, pm0 = _lanes(rng, code, L, T)
    t = [torch.as_tensor(x) for x in (c0, c1, pm0)]
    jax4 = np.asarray(jviterbi._run_kernel(c0, c1, pm0, code, True,
                                           radix=4)).astype(np.uint8)
    r4 = viterbi.viterbi_chunks_reference(*t, code, radix=4)
    r2 = viterbi.viterbi_chunks_reference(*t, code, radix=2)
    assert r4.dtype == torch.uint8 and r4.shape == (L, T)
    assert np.array_equal(r4.numpy(), jax4)
    assert np.array_equal(r4.numpy(), r2.numpy())
    info = T - conv.tail_bits(code)
    full = np.stack([c0, c1], axis=-1).reshape(L, 2 * T)
    jax4t = np.asarray(jviterbi._run_kernel(c0, c1, None, code, True,
                                            radix=4))[:, :info]
    r4t = viterbi.viterbi_terminated_reference(torch.as_tensor(full), info,
                                               "1/2", code, radix=4)
    ref = np.asarray(jconv.viterbi_decode_soft(full, info, "1/2", code))
    assert np.array_equal(r4t.numpy(), jax4t.astype(np.uint8))
    assert np.array_equal(r4t.numpy(), ref)


def test_radix4_dispatch_follows_the_jax_condition(monkeypatch):
    assert viterbi.pick_radix(1216, "dvb_k7") == 2          # not forced
    monkeypatch.setattr(viterbi, "FORCE_RADIX4", True)
    monkeypatch.setattr(jviterbi, "_FORCE_RADIX4", True)
    assert viterbi.pick_radix(1216, "dvb_k7") == 4          # DVB-T span
    assert viterbi.pick_radix(4096 + 6, "dvb_k7") == 2      # T % 4 != 0
    assert viterbi.pick_radix(4096 + 4, "k5") == 4          # S = 16
    assert viterbi.pick_radix(1217, "k5") == 2
    rng = np.random.default_rng(5)
    # forced, the JAX Pallas decoders run radix 4 (interpret mode) and the
    # port's radix=None wrappers too: equal bits on integer LLRs
    for code, info in (("k5", 124), ("dvb_k7", 122)):
        for rate in ("1/2", "3/4"):
            bits = rng.integers(0, 2, (3, info)).astype(np.uint8)
            llr = _int_llrs(rng, _coded(code, rate, bits).shape)
            want = np.asarray(viterbi_decode_soft_pallas(llr, info, rate, code,
                                                         interpret=True))
            got = conv.viterbi_decode_soft(torch.as_tensor(llr), info, rate,
                                           code)
            assert np.array_equal(got.numpy(), want)
        c0, c1, pm0 = _lanes(rng, code, 5, 96)
        want = np.asarray(viterbi_chunks_pallas(c0, c1, pm0, code,
                                                interpret=True))
        got = viterbi.viterbi_chunks_kernel(
            *(torch.as_tensor(x) for x in (c0, c1, pm0)), code)
        assert np.array_equal(got.numpy(), want.astype(np.uint8))
    # the chunked stream decode (span 1216) with radix 4 forced equals the
    # jnp chunked decode on integer LLRs
    n = 2500
    llr = _int_llrs(rng, (2, conv.punctured_coded_len(n, "2/3", "dvb_k7")))
    assert np.array_equal(
        conv.viterbi_decode_soft_chunked(torch.as_tensor(llr), n, "2/3",
                                         "dvb_k7").numpy(),
        np.asarray(jconv.viterbi_decode_soft_chunked(llr, n, "2/3",
                                                     "dvb_k7")))


def test_radix4_float_llrs_agree_with_radix2_but_for_near_ties():
    # the radices renormalise at other steps and sum branch metrics in
    # another order, so a float near-tie may pick another ML path: ≤ 1e-4
    rng = np.random.default_rng(13)
    total, diff = 0, 0
    for code in CODES:
        S = 64 if code == "dvb_k7" else 16
        c0, c1 = (torch.as_tensor(rng.standard_normal((4, 1216)),
                                  dtype=torch.float32) for _ in range(2))
        pm0 = torch.as_tensor(rng.integers(-30, 1, (4, S)),
                              dtype=torch.float32)
        a = viterbi.viterbi_chunks_reference(c0, c1, pm0, code, radix=4)
        b = viterbi.viterbi_chunks_reference(c0, c1, pm0, code, radix=2)
        diff += int((a != b).sum())
        total += a.numel()
        info = 1020 if code == "k5" else 1018         # 1024 steps
        llr = torch.as_tensor(rng.standard_normal(
            (2, conv.punctured_coded_len(info, "1/2", code))) * 2.0,
            dtype=torch.float32)
        a = viterbi.viterbi_terminated_reference(llr, info, "1/2", code, 4)
        b = viterbi.viterbi_terminated_reference(llr, info, "1/2", code, 2)
        diff += int((a != b).sum())
        total += a.numel()
    assert diff <= 1e-4 * total, (diff, total)


def test_radix4_wrappers_count_apart_and_check_the_radix():
    c = torch.zeros((3, 40))
    pm = torch.zeros((3, 64))
    before = (viterbi.viterbi_chunks_kernel.launches,
              viterbi.viterbi_chunks_kernel.launches_radix4)
    assert viterbi.viterbi_chunks_kernel(c, c, pm, "dvb_k7",
                                         radix=4).shape == (3, 40)
    assert (viterbi.viterbi_chunks_kernel.launches,
            viterbi.viterbi_chunks_kernel.launches_radix4) == before  # CPU
    with pytest.raises(ValueError):
        viterbi.viterbi_chunks_kernel(c[:, :38], c[:, :38], pm, "dvb_k7",
                                      radix=4)
    with pytest.raises(ValueError):
        viterbi.viterbi_chunks_kernel(c, c, pm, "dvb_k7", radix=3)
    llr = torch.zeros((2, conv.punctured_coded_len(30, "1/2", "k5")))
    with pytest.raises(ValueError):               # 34 steps: not radix 4
        viterbi.viterbi_decode_soft_kernel(llr, 30, "1/2", "k5", radix=4)
    assert viterbi.viterbi_decode_soft_kernel(llr[:, :-4].contiguous(), 28,
                                              "1/2", "k5",
                                              radix=4).shape == (2, 28)
