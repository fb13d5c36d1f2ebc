"""Torch port: the three ``ops`` names of the JAX package with its
arguments and results. ``bp_decode_pallas(graph_key, llr, max_iter,
interpret, *, rule, alpha, stall_iters)`` returns the (B, N) float32 hard
plane of each row's best snapshot and (B,) int32 unsatisfied checks; held
against the JAX Pallas kernel in interpret mode on decodable N512R12 and
FT8 rows (±4 LLRs with a few flips, where both converge) with
``stall_iters = max_iter``: the plane exact (the JAX plane's first N
columns; it pads N to a multiple of 128) and ``min_unsat`` equal.
``viterbi_chunks_pallas`` and ``viterbi_decode_soft_pallas`` are held to
the JAX ones (interpret mode) on integer-valued LLRs: bits exact, odd spans
included. On the CPU the three run their plain versions under
``interpret=True`` or for a CPU tensor; host data with ``interpret`` None
asks for the card, which is not here."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from orion_sdr_tpu.codec import ft8_ldpc as JFL
from orion_sdr_tpu.fec import conv as jconv
from orion_sdr_tpu.fec.ldpc import _graph_key, ldpc_encode as jax_encode, \
    ldpc_graph as jax_graph
from orion_sdr_tpu.ops import bp_decode_pallas as jax_bp
from orion_sdr_tpu.ops import viterbi_chunks_pallas as jax_chunks
from orion_sdr_tpu.ops import viterbi_decode_soft_pallas as jax_soft

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch.fec import conv
from orion_sdr_tpu_torch.ops import ldpc_bp

torch.set_num_threads(1)


def _rows(cw, n_flips, seed):
    rng = np.random.default_rng(seed)
    llr = np.where(cw == 0, 4.0, -4.0).astype(np.float32)
    for b in range(llr.shape[0]):
        llr[b, rng.choice(cw.shape[1], n_flips, replace=False)] *= -1
    return llr


def _n512_case():
    msg = np.random.default_rng(5).integers(0, 2, (4, 256)).astype(np.uint8)
    g = jax_graph("N512R12")
    return _graph_key(g), g.n, _rows(np.asarray(jax_encode("N512R12", msg)),
                                     4, 51)


def _ft8_case():
    msg = np.random.default_rng(6).integers(0, 2, (4, 91)).astype(np.uint8)
    g = JFL.ft8_ldpc_graph()
    return _graph_key(g), g.n, _rows(np.asarray(JFL.ldpc_encode(msg)), 3, 61)


@pytest.mark.parametrize("case", [_n512_case, _ft8_case],
                         ids=["N512R12", "ft8_174_91"])
@pytest.mark.parametrize("rule", ["sum_product", "min_sum"])
def test_bp_decode_pallas_matches_jax(case, rule):
    key, n, llr = case()
    best, mu = jax_bp(key, llr, 30, interpret=True, rule=rule,
                      stall_iters=30)
    pbest, pmu = P.ops.bp_decode_pallas(key, llr, 30, True, rule=rule,
                                        stall_iters=30)
    assert pbest.dtype == torch.float32 and pbest.shape == (4, n)
    assert pmu.dtype == torch.int32 and pmu.shape == (4,)
    assert (np.asarray(mu) == 0).all()
    assert np.array_equal(pbest.numpy(), np.asarray(best)[:, :n])
    assert np.array_equal(pmu.numpy(), np.asarray(mu))


def test_bp_decode_pallas_placement():
    key, n, llr = _n512_case()
    g = ldpc_bp.graph_by_key(key)
    a = P.ops.bp_decode_pallas(key, torch.as_tensor(llr), 30)  # a CPU tensor
    b = P.ops.bp_decode_pallas(key, llr, 30, interpret=True)
    bits, unsat = ldpc_bp.bp_decode_kernel(g, torch.as_tensor(llr), 30,
                                           store="codeword")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[0], bits.to(torch.float32))
    assert torch.equal(a[1], unsat)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            P.ops.bp_decode_pallas(key, llr, 30)      # host data: the card
    with pytest.raises(KeyError):
        P.ops.bp_decode_pallas("N512R12:1:1", llr, 30, True)


def test_bp_graph_fits_the_ports_kernel():
    for name in ("N512R12", "N576R23", "N512R34"):
        g = jax_graph(name)
        assert P.ops.ldpc_bp.bp_graph_fits(f"{g.name}:{g.n}:{g.k}")
    assert P.ops.ldpc_bp.bp_graph_fits("ft8_174_91:174:91")
    # no card here: the answer rests on the 16-bit tables (the card test
    # reads the launch plan's shared memory)
    assert not torch.cuda.is_available()
    with pytest.raises(KeyError):
        P.ops.ldpc_bp.bp_graph_fits("N512R12:512:1")


def _int_llrs(rng, shape):
    return rng.integers(-8, 9, shape).astype(np.float32)


@pytest.mark.parametrize("span", [64, 37])
@pytest.mark.parametrize("code", ["k5", "dvb_k7"])
def test_viterbi_chunks_pallas_matches_jax(code, span):
    rng = np.random.default_rng(span)
    S = 64 if code == "dvb_k7" else 16
    c0, c1 = _int_llrs(rng, (6, span)), _int_llrs(rng, (6, span))
    pm0 = rng.integers(-20, 1, (6, S)).astype(np.float32)
    want = np.asarray(jax_chunks(c0, c1, pm0, code, interpret=True))
    got = P.ops.viterbi_chunks_pallas(c0, c1, pm0, code, interpret=True)
    assert got.dtype == torch.float32 and got.shape == (6, span)
    assert np.array_equal(got.numpy(), want)
    t = P.ops.viterbi_chunks_pallas(*(torch.as_tensor(x)
                                      for x in (c0, c1, pm0)), code)
    assert torch.equal(t, got)


@pytest.mark.parametrize("info", [96, 97])
@pytest.mark.parametrize("rate", ["1/2", "3/4"])
def test_viterbi_decode_soft_pallas_matches_jax(rate, info):
    rng = np.random.default_rng(info)
    bits = rng.integers(0, 2, (3, info)).astype(np.uint8)
    n_coded = np.asarray(jconv.conv_encode_punctured(bits, rate, "k5")
                         ).shape[-1]
    llr = _int_llrs(rng, (3, n_coded))
    want = np.asarray(jax_soft(llr, info, rate, interpret=True))
    got = P.ops.viterbi_decode_soft_pallas(llr, info, rate, interpret=True)
    assert got.dtype == torch.uint8 and got.shape == (3, info)
    assert np.array_equal(got.numpy(), want)
    one = P.ops.viterbi_decode_soft_pallas(torch.as_tensor(llr[0]), info,
                                           rate)
    assert one.shape == (info,) and torch.equal(one, got[0])
    assert torch.equal(got, conv.viterbi_decode_soft(
        torch.as_tensor(llr), info, rate, "k5"))
