"""Torch port: LDPC encode and belief propagation against the JAX package.

On the CPU the port's BP wrapper runs its plain torch version, which is held
to the JAX f32 ``bp_decode`` row by row: equal message bits and unsatisfied
checks on decodable batches (±4 LLRs with 6–8 flips), and no convergence in
either on random-normal garbage rows. The Pallas kernels (interpret mode)
round their messages through bf16, so they are compared on converged rows
only: bits equal and unsat 0, for the slab kernel and for the edge-layout
``sum_product_edge`` kernel, which only ``bp_decode_pallas`` reaches.
"""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from orion_sdr_tpu.fec.ldpc import bp_decode as jax_bp_decode, \
    ldpc_encode as jax_ldpc_encode, ldpc_graph as jax_ldpc_graph, _graph_key
from orion_sdr_tpu.ops.ldpc_bp import bp_decode_pallas

from orion_sdr_tpu_torch.fec.ldpc import DECODE_RULES, LDPC_CODES, \
    bp_decode, ldpc_decode, ldpc_encode, ldpc_graph
from orion_sdr_tpu_torch.ops import bp_decode_pallas as port_bp_decode_pallas
from orion_sdr_tpu_torch.ops import ldpc_bp

# The plain torch versions run thousands of tiny ops; with one test worker
# per core, a torch thread pool as wide as the machine in every worker
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

FLIPS = {"N512R12": 8, "N576R23": 6, "N512R34": 6}


def _case(name, B, n_flips, seed, garbage=0):
    g = ldpc_graph(name)
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 2, (B, g.k)).astype(np.uint8)
    cw = np.asarray(jax_ldpc_encode(name, msg))
    llr = np.where(cw == 0, 4.0, -4.0).astype(np.float32)
    for b in range(B):
        llr[b, rng.choice(g.n, n_flips, replace=False)] *= -1
    junk = rng.standard_normal((garbage, g.n)).astype(np.float32)
    return msg, np.concatenate([llr, junk])


@pytest.mark.parametrize("name", sorted(LDPC_CODES))
def test_ldpc_encode_bit_exact(name):
    g = ldpc_graph(name)
    msg = np.random.default_rng(1).integers(0, 2, (5, g.k)).astype(np.uint8)
    ours = ldpc_encode(name, torch.as_tensor(msg)).numpy()
    assert ours.dtype == np.uint8
    assert np.array_equal(ours, np.asarray(jax_ldpc_encode(name, msg)))
    assert np.array_equal(ours[:, :g.k], msg)


@pytest.mark.parametrize("rule", DECODE_RULES)
@pytest.mark.parametrize("name", sorted(LDPC_CODES))
def test_bp_plain_matches_jax(name, rule):
    B = 6
    msg, llr = _case(name, B, FLIPS[name], 7, garbage=2)
    jbits, junsat = jax_bp_decode(jax_ldpc_graph(name), llr, 50, rule)
    bits, unsat = bp_decode(ldpc_graph(name), torch.as_tensor(llr), 50, rule)
    assert bits.dtype == torch.uint8 and unsat.dtype == torch.int32
    junsat = np.asarray(junsat)
    assert np.array_equal(unsat.numpy()[:B], junsat[:B])
    assert np.array_equal(bits.numpy()[:B], np.asarray(jbits)[:B])
    assert np.array_equal(bits.numpy()[:B], msg)
    assert (unsat.numpy()[:B] == 0).all()
    # garbage rows do not converge in either package; their trajectories are
    # chaotic, so float summation order may leave different counts
    assert (unsat.numpy()[B:] > 0).all() and (junsat[B:] > 0).all()


def test_bp_plain_matches_pallas_interpret_on_converged_rows():
    msg, llr = _case("N512R12", 3, 8, 0)
    g = jax_ldpc_graph("N512R12")
    best, mu = bp_decode_pallas(_graph_key(g), llr, 30, interpret=True)
    bits, unsat = bp_decode(ldpc_graph("N512R12"), torch.as_tensor(llr), 30)
    done = np.asarray(mu) == 0
    assert done.all() and (unsat.numpy() == 0).all()
    assert np.array_equal(bits.numpy()[done],
                          np.asarray(best)[done, :g.k].astype(np.uint8))
    assert np.array_equal(bits.numpy(), msg)


def test_ldpc_decode_leading_dims_and_iteration_cap():
    msg, llr = _case("N512R12", 4, 8, 3)
    bits, unsat = ldpc_decode("N512R12", torch.as_tensor(llr.reshape(2, 2, -1)))
    assert bits.shape == (2, 2, 256) and unsat.shape == (2, 2)
    assert np.array_equal(bits.numpy().reshape(4, -1), msg)
    # max_iter=0 returns the channel's hard decisions and their syndrome
    hard, unsat0 = ldpc_decode("N512R12", torch.as_tensor(llr), max_iter=0)
    jb, ju = jax_bp_decode(jax_ldpc_graph("N512R12"), llr, 0)
    assert np.array_equal(hard.numpy(), np.asarray(jb))
    assert np.array_equal(unsat0.numpy(), np.asarray(ju))


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    g = ldpc_graph("N576R23")
    _, llr = _case("N576R23", 3, 5, 4, garbage=1)
    x = torch.as_tensor(llr)
    before = ldpc_bp.bp_decode_kernel.launches
    bits, unsat = ldpc_bp.bp_decode_kernel(g, x, 50, "min_sum")
    rbits, runsat = ldpc_bp.bp_decode_reference(g, x, 50, "min_sum")
    assert ldpc_bp.bp_decode_kernel.launches == before
    assert torch.equal(bits, rbits) and torch.equal(unsat, runsat)
    empty_bits, empty_unsat = ldpc_bp.bp_decode_kernel(g, x[:0])
    assert empty_bits.shape == (0, g.k) and empty_unsat.shape == (0,)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    g = ldpc_graph("N512R12")
    x = torch.zeros((4, g.n))
    with pytest.raises(TypeError):
        ldpc_bp.bp_decode_kernel(g, x.double())
    with pytest.raises(ValueError):
        ldpc_bp.bp_decode_kernel(g, torch.zeros((4, g.n + 1)))
    with pytest.raises(ValueError):
        ldpc_bp.bp_decode_kernel(g, torch.zeros((g.n, 8)).t())
    with pytest.raises(ValueError):
        ldpc_bp.bp_decode_kernel(g, x, rule="bogus")


@pytest.mark.parametrize("name", ["N512R12", "N512R34"])
def test_edge_rule_plain_matches_pallas_interpret(name):
    # kernel 2 (ops/ldpc_bp.py:200, edge-on-lane log-domain sum-product)
    # through the JAX ops entry point in interpret mode; it rounds its
    # one-hot contractions to bf16 (so a row near threshold may stall
    # there), the port sums in f32: rows the TPU kernel converged on must
    # give the same message, and every row converges in the port
    msg, llr = _case(name, 6, FLIPS[name] - 2, 22)
    g = jax_ldpc_graph(name)
    best, mu = bp_decode_pallas(_graph_key(g), llr, 30, interpret=True,
                                rule="sum_product_edge")
    pbest, unsat = port_bp_decode_pallas(_graph_key(g), torch.as_tensor(llr),
                                         30, rule="sum_product_edge")
    bits = pbest[:, :g.k].to(torch.uint8)
    done = np.asarray(mu) == 0
    assert done.sum() >= 5 and (unsat.numpy() == 0).all()
    assert np.array_equal(bits.numpy()[done],
                          np.asarray(best)[done, :g.k].astype(np.uint8))
    assert np.array_equal(bits.numpy(), msg)


@pytest.mark.parametrize("name", sorted(LDPC_CODES))
def test_edge_rule_plain_version(name):
    # the log-domain rule converges to the same codewords as sum-product on
    # decodable rows, and leaves garbage rows unconverged
    msg, llr = _case(name, 6, FLIPS[name], 7, garbage=2)
    g = ldpc_graph(name)
    x = torch.as_tensor(llr)
    bits, unsat = ldpc_bp.bp_decode_kernel(g, x, 50, "sum_product_edge")
    sbits, sunsat = bp_decode(g, x, 50, "sum_product")
    assert bits.dtype == torch.uint8 and unsat.dtype == torch.int32
    assert (unsat.numpy()[:6] == 0).all()
    assert np.array_equal(bits.numpy()[:6], msg)
    assert np.array_equal(bits.numpy()[:6], sbits.numpy()[:6])
    assert (unsat.numpy()[6:] > 0).all()
    # the JAX entry point takes every rule by graph key and gives what the
    # wrapper gives, on the whole codeword plane
    for rule in ldpc_bp.RULES:
        a = port_bp_decode_pallas(f"{g.name}:{g.n}:{g.k}", x, 20, rule=rule,
                                  alpha=0.6)
        b = ldpc_bp.bp_decode_kernel(g, x, 20, rule, 0.6)
        assert a[0].shape == (x.shape[0], g.n) and a[0].dtype == torch.float32
        assert torch.equal(a[0][:, :g.k].to(torch.uint8), b[0])
        assert torch.equal(a[1], b[1])


def test_jax_bp_decode_takes_the_edge_rule_as_min_sum_and_the_port_refuses():
    # the reference fault (orion_sdr_tpu/fec/ldpc.py:335-347): the XLA
    # bp_decode's else-branch decodes any unknown rule string as min-sum
    _, llr = _case("N576R23", 4, 7, 9, garbage=2)
    jg = jax_ldpc_graph("N576R23")
    eb, eu = jax_bp_decode(jg, llr, 30, "sum_product_edge")
    mb, mu = jax_bp_decode(jg, llr, 30, "min_sum")
    assert np.array_equal(np.asarray(eb), np.asarray(mb))
    assert np.array_equal(np.asarray(eu), np.asarray(mu))
    g = ldpc_graph("N576R23")
    for call in (lambda: bp_decode(g, torch.as_tensor(llr), 30,
                                   "sum_product_edge"),
                 lambda: ldpc_decode("N576R23", torch.as_tensor(llr), 30,
                                     "sum_product_edge")):
        with pytest.raises(ValueError, match="bp_decode_pallas"):
            call()


@pytest.mark.parametrize("name", sorted(LDPC_CODES))
def test_syndrome_weight_matches(name):
    """``ldpc_syndrome_weight`` on codewords, flipped codewords and random
    words, batched (exact counts)."""
    from orion_sdr_tpu.fec.ldpc import ldpc_syndrome_weight as j_weight, \
        ldpc_encode as j_encode
    from orion_sdr_tpu_torch.fec.ldpc import ldpc_syndrome_weight
    n, k, _ = LDPC_CODES[name]
    rng = np.random.default_rng(31)
    msg = rng.integers(0, 2, (4, k)).astype(np.uint8)
    cw = np.asarray(j_encode(name, msg))
    words = np.concatenate([cw, cw ^ (rng.random(cw.shape) < 0.01),
                            rng.integers(0, 2, (2, n))]).astype(np.uint8)
    ours = ldpc_syndrome_weight(name, torch.as_tensor(words))
    assert ours.dtype == torch.int32
    assert np.array_equal(ours.numpy(), np.asarray(j_weight(name, words)))
    assert not ours[:4].any()
