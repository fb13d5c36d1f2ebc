"""Torch port, FT8/FT4 channel codec against the JAX package: LDPC(174, 91)
(``generator()`` and ``ft8_ldpc_graph()`` field by field, the graph carried
across by ``convert.ldpc_graph_from_fields``, ``ldpc_encode``), BP on the
real graph (the port's plain version against the JAX XLA ``bp_decode`` on
decodable rows — bits and unsatisfied checks equal — and against the
Pallas kernel in interpret mode on the rows where both converge; garbage
rows converge in neither), the frame codecs (``ft8/ft4_encode`` tones,
``ft8_ap_prior``, ``apply_ap_prior``, the soft and hard decoders with and
without a prior) and the batched decode, which gives each row what the
single decode gives it. Tolerance: exact (bits, tones, payloads; the
clamped LLRs of ``apply_ap_prior`` equal as float32)."""

import dataclasses

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from orion_sdr_tpu.codec import ft8 as JF, ft8_ldpc as JL
from orion_sdr_tpu.fec.ldpc import bp_decode as jax_bp_decode, _graph_key
from orion_sdr_tpu.message import CallsignHashTable, Standard, pack77
from orion_sdr_tpu.ops.ldpc_bp import bp_decode_pallas

from orion_sdr_tpu_torch import convert
from orion_sdr_tpu_torch.codec import ft8 as TF, ft8_ldpc as TL
from orion_sdr_tpu_torch.fec.ldpc import bp_decode
from orion_sdr_tpu_torch.ops import ldpc_bp

torch.set_num_threads(1)
CPU = "cpu"


def test_generator_and_graph_equal_field_by_field():
    assert np.array_equal(TL.generator(), JL.generator())
    assert TL.generator().dtype == np.uint8
    jg, tg = JL.ft8_ldpc_graph(), TL.ft8_ldpc_graph()
    for f in dataclasses.fields(jg):
        a, b = getattr(tg, f.name), getattr(jg, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    assert (tg.n, tg.k, tg.m, tg.max_deg) == (174, 91, 83, 7)
    assert sorted(set(tg.check_mask.sum(1))) == [6, 7]


def test_graph_carried_across_equals_the_ports():
    jg = JL.ft8_ldpc_graph()
    g = convert.ldpc_graph_from_fields(dataclasses.asdict(jg))
    assert g == TL.ft8_ldpc_graph()
    assert ldpc_bp.graph_key(g) == ldpc_bp.graph_key(TL.ft8_ldpc_graph())
    assert ldpc_bp.graph_tables(g, CPU) is \
        ldpc_bp.graph_tables(TL.ft8_ldpc_graph(), CPU)


def test_ldpc_encode_bit_exact():
    msg = np.random.default_rng(1).integers(0, 2, (6, 91)).astype(np.uint8)
    ours = TL.ldpc_encode(torch.as_tensor(msg)).numpy()
    assert ours.dtype == np.uint8 and ours.shape == (6, 174)
    assert np.array_equal(ours, np.asarray(JL.ldpc_encode(msg)))
    assert (TL.ldpc_count_errors(ours) == 0).all()
    assert np.array_equal(TL.ldpc_count_errors(ours ^ 1),
                          JL.ldpc_count_errors(ours ^ 1))


def _rows(B, flips, seed, garbage=0):
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 2, (B, 91)).astype(np.uint8)
    cw = np.asarray(JL.ldpc_encode(msg))
    llr = np.where(cw == 0, 4.0, -4.0).astype(np.float32)
    for b in range(B):
        llr[b, rng.choice(174, flips, replace=False)] *= -1
    junk = rng.standard_normal((garbage, 174)).astype(np.float32)
    return msg, np.concatenate([llr, junk])


@pytest.mark.parametrize("rule", ["sum_product", "min_sum",
                                  "scaled_min_sum"])
def test_bp_plain_matches_jax_on_the_ft8_graph(rule):
    B = 8
    msg, llr = _rows(B, 6 if rule == "sum_product" else 3, 7, garbage=3)
    jbits, junsat = jax_bp_decode(JL.ft8_ldpc_graph(), llr, 20, rule)
    bits, unsat = bp_decode(TL.ft8_ldpc_graph(), torch.as_tensor(llr), 20,
                            rule)
    junsat = np.asarray(junsat)
    assert np.array_equal(unsat.numpy()[:B], junsat[:B])
    assert np.array_equal(bits.numpy()[:B], np.asarray(jbits)[:B])
    assert np.array_equal(bits.numpy()[:B], msg)
    # garbage rows converge in neither package
    assert (unsat.numpy()[B:] > 0).all() and (junsat[B:] > 0).all()


def test_bp_plain_matches_pallas_interpret_on_converged_rows():
    msg, llr = _rows(4, 6, 0)
    jg = JL.ft8_ldpc_graph()
    best, mu = bp_decode_pallas(_graph_key(jg), llr, 20, interpret=True)
    bits, unsat = TL.ldpc_decode_soft(torch.as_tensor(llr), 20)
    done = np.asarray(mu) == 0
    assert done.sum() >= 3 and (unsat.numpy() == 0).all()
    assert np.array_equal(bits.numpy()[done],
                          np.asarray(best)[done, :91].astype(np.uint8))
    assert np.array_equal(bits.numpy(), msg)


def _payloads(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 256, (n, 10)).astype(np.uint8)
    p[:, 9] &= 0xF8
    return p


def test_encode_tones_equal():
    for p in _payloads(6, 4):
        t8 = TF.ft8_encode(p, device=CPU)
        t4 = TF.ft4_encode(p, device=CPU)
        assert t8.dtype == np.uint8 and t8.shape == (58,)
        assert np.array_equal(t8, JF.ft8_encode(p))
        assert np.array_equal(t4, JF.ft4_encode(p))
        assert np.array_equal(TF.ft8_frame_llr_hard(t8),
                              JF.ft8_frame_llr_hard(t8))
        assert np.array_equal(TF.ft4_frame_llr_hard(t4),
                              JF.ft4_frame_llr_hard(t4))
        assert np.array_equal(TF.ft8_decode_hard(t8, device=CPU), p)
        assert np.array_equal(TF.ft4_decode_hard(t4, device=CPU), p)
    assert np.array_equal(TF.FT4_XOR, JF.FT4_XOR)


@pytest.mark.parametrize("args", [("CQ",), (None, "KA1ABC"),
                                  ("W9XYZ", "KA1ABC"), ("CQ", None, True),
                                  ("CQ DX", "K1ABC/P")])
def test_ap_prior_equal(args):
    call_a, call_b = args[0], args[1] if len(args) > 1 else None
    ft4 = len(args) > 2
    a = TF.ft8_ap_prior(call_a, call_b, ft4=ft4)
    b = JF.ft8_ap_prior(call_a, call_b, ft4=ft4)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    with pytest.raises(ValueError):
        TF.ft8_ap_prior()


def test_apply_ap_prior_equal():
    rng = np.random.default_rng(5)
    llr = rng.standard_normal((3, 174)).astype(np.float32) * 3
    ap = JF.ft8_ap_prior("CQ", "KA1ABC")
    for amp in (None, 7.5):
        got = TF.apply_ap_prior(torch.as_tensor(llr), ap, amp).numpy()
        assert np.array_equal(got, JF.apply_ap_prior(llr, ap, amp))
        assert np.array_equal(TF.apply_ap_prior(llr[0], ap, amp).numpy(),
                              JF.apply_ap_prior(llr[0], ap, amp))


def _noisy_llrs(tones_llr, sigma, seed):
    rng = np.random.default_rng(seed)
    return (tones_llr + rng.normal(0, sigma, tones_llr.shape)
            ).astype(np.float32)


@pytest.mark.parametrize("ft4", [False, True])
def test_soft_decode_equal_with_and_without_prior(ft4):
    ht = CallsignHashTable()
    enc, hard = ((JF.ft4_encode, JF.ft4_frame_llr_hard) if ft4
                 else (JF.ft8_encode, JF.ft8_frame_llr_hard))
    jdec = JF.ft4_decode_soft if ft4 else JF.ft8_decode_soft
    tdec = TF.ft4_decode_soft if ft4 else TF.ft8_decode_soft
    rows, priors = [], [None, JF.ft8_ap_prior("CQ", ft4=ft4),
                        JF.ft8_ap_prior("W9XYZ", ft4=ft4)]
    for i, (to, de) in enumerate((("CQ", "KA1ABC"), ("W9XYZ", "K1ABC"),
                                  ("CQ", "G4AAA"))):
        p = pack77(Standard(to, de, "FN42"), ht)
        for sigma in (3.0, 6.0, 9.0):
            rows.append(_noisy_llrs(hard(enc(p)), sigma, 10 * i + int(sigma)))
    rows.append(np.random.default_rng(3).standard_normal(174)
                .astype(np.float32))
    batch = TF.decode_soft_batch(torch.as_tensor(np.stack(rows)), 20,
                                 priors, ft4=ft4)
    for ap, got_rows in zip(priors, batch):
        for llr, got in zip(rows, got_rows):
            want = jdec(llr, ap=ap)
            single = tdec(llr, ap=ap, device=CPU)
            assert (want is None) == (got is None) == (single is None)
            if want is not None:
                assert np.array_equal(got, want)
                assert np.array_equal(single, want)
    # the priors decode rows the plain decode does not, and reject the
    # rows that contradict them
    n_ok = [sum(g is not None for g in r) for r in batch]
    assert n_ok[0] < len(rows) and n_ok[1] >= 1 and n_ok[2] >= 1


def test_decode_llr_keeps_ft4_payload_scrambled():
    p = _payloads(1, 9)[0]
    llr = JF.ft4_frame_llr_hard(JF.ft4_encode(p))
    got = TF._decode_llr(llr, device=CPU)
    assert np.array_equal(got, JF._decode_llr(llr))
    assert got is not None and not np.array_equal(got, p)
    # all LLRs 0 (every hard bit 1) and the all-zero codeword (which
    # passes the CRC: the stream decoders reject its payload themselves)
    for llr in (np.zeros(174, np.float32), np.full(174, 5.0, np.float32)):
        a, b = TF._decode_llr(llr, device=CPU), JF._decode_llr(llr)
        assert (a is None) == (b is None)
        assert a is None or np.array_equal(a, b)
    assert not np.any(TF._decode_llr(np.full(174, 5.0, np.float32),
                                     device=CPU))
