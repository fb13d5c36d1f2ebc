"""Torch port: the BP kernel's schedule, modelled in plain torch on the CPU.

``csrc/ldpc_bp.cu`` stages the compact slot-major tables of
``ops/ldpc_bp.py::graph_tables`` (check → bit as uint16 at j·m + c, padded
slots marked ``NO_BIT``; bit → edge as uint16 at i·n + b, padded with the
edge slot m·D that holds 0) and runs each codeword as passes of one fused
check phase and one bit phase. A check phase reads the D totals of a check
once: their hard decisions give the syndrome, total − old extrinsic is the
message, and the check update writes the new extrinsic. A row starts with
the channel's syndrome alone (a codeword, or ``max_iter`` 0, stops there);
the first pass reads the LLRs with no old extrinsic; the update of the pass
whose syndrome ends the row at zero is computed and thrown away (the pass
after the ``max_iter``-th iteration computes only its syndrome).

``schedule_model`` below is that schedule, row by row, over the same
tables. It must equal ``bp_decode_reference`` bit for bit (bits and
unsatisfied counts), which holds the kernel's table layout and schedule to
the plain version before any card runs them.
"""

import numpy as np
import pytest
import torch

from orion_sdr_tpu_torch.codec import ft8_ldpc
from orion_sdr_tpu_torch.fec.ldpc import LDPC_CODES, LdpcGraph, \
    _build_msg_col_rows, ldpc_encode, ldpc_graph
from orion_sdr_tpu_torch.ops import ldpc_bp

# one thread per test worker, as in every tests/test_torch_*.py
torch.set_num_threads(1)

FLIPS = {"N512R12": 6, "N576R23": 4, "N512R34": 3, "test_174_91": 3,
         "ft8_174_91": 3}
# every graph the kernel decodes: the three codes, FT8/FT4's LDPC(174, 91)
# (D = 7, the kernel's exact width 7) and a staircase graph of its size
GRAPHS = sorted(LDPC_CODES) + ["test_174_91", "ft8_174_91"]


def graph_174_91() -> LdpcGraph:
    """A (174, 91) staircase graph, FT8's size: 59 of its 83 checks are
    short, so the padded slots are spread over the table."""
    n, k = 174, 91
    m = n - k
    rows = [[] for _ in range(m)]
    for c, rs in enumerate(_build_msg_col_rows(k, m, 0x1234_5678)):
        for r in rs:
            rows[r].append(c)
    for i in range(m):
        rows[i] += [k + i] + ([k + i - 1] if i else [])
    D = max(len(r) for r in rows)
    cb = np.full((m, D), n, np.int32)
    mask = np.zeros((m, D), bool)
    A = np.zeros((m, k), np.uint8)
    for i, r in enumerate(rows):
        cb[i, :len(r)] = r
        mask[i, :len(r)] = True
        A[i, [c for c in r if c < k]] = 1
    return LdpcGraph("test_174_91", n, k, m, A, cb, mask, D)


def _graph(name):
    if name == "ft8_174_91":
        return ft8_ldpc.ft8_ldpc_graph()
    return graph_174_91() if name == "test_174_91" else ldpc_graph(name)


def _codewords(g, msg):
    if g.name in LDPC_CODES:
        return ldpc_encode(g.name, torch.as_tensor(msg)).numpy()
    if g.name == "ft8_174_91":
        return ft8_ldpc.ldpc_encode(torch.as_tensor(msg)).numpy()
    s = (msg.astype(np.int64) @ g.A.T.astype(np.int64)) & 1
    return np.concatenate([msg, np.cumsum(s, -1) & 1], -1).astype(np.uint8)


def _llrs(g, seed):
    """5 decodable rows (±4 with flips), 2 random-normal rows, 1 codeword row
    with no flip (its syndrome is zero at the start), and 1 row with ±0.0
    and ±1e30 entries."""
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 2, (8, g.k)).astype(np.uint8)
    llr = np.where(_codewords(g, msg) == 0, 4.0, -4.0).astype(np.float32)
    for b in range(5):
        llr[b, rng.choice(g.n, FLIPS[g.name], replace=False)] *= -1
    llr[5:7] = rng.standard_normal((2, g.n))
    odd = llr[0].copy()
    pick = rng.choice(g.n, 12, replace=False)
    odd[pick[:6]] = np.array([0.0, -0.0, 0.0, -0.0, 1e30, -1e30])[
        rng.permutation(6)]
    return torch.as_tensor(np.concatenate([llr, odd[None]]))


def schedule_model(g, llr, max_iter, rule, alpha=0.75):
    """The kernel's schedule over its compact tables, in plain torch."""
    t = ldpc_bp.graph_tables(g, llr.device)
    n, m, D, C = t.n, t.m, t.D, t.C
    B = llr.shape[0]
    cs = t.check_slots.to(torch.int64) & 0xFFFF              # (D·m,)
    valid = (cs != ldpc_bp.NO_BIT).reshape(D, m)
    gather_idx = torch.where(cs == ldpc_bp.NO_BIT, n, cs)     # pad → 0.0
    bs = (t.bit_slots.to(torch.int64) & 0xFFFF).reshape(C, n)
    ext = llr.new_zeros((B, D * m + 1))                       # [m·D] = 0
    tot = llr.clone()

    def gather(src):
        v = torch.cat([src, src.new_zeros((B, 1))], -1)[:, gather_idx]
        return torch.where(valid.reshape(-1), v, 0.0).reshape(B, D, m)

    def syndrome(v):
        par = ((v <= 0.0) & valid).to(torch.int32).sum(1) & 1
        return par.sum(-1).to(torch.int32)

    # the channel's syndrome first: a row that arrives as a codeword, or
    # max_iter 0, stops before any check update
    best = llr <= 0.0
    min_unsat = syndrome(gather(llr))
    live = (min_unsat > 0) & (max_iter > 0)
    for p in range(max_iter + 1):
        if not bool(live.any()):
            break
        # fused check phase: the totals read once
        v = gather(llr if p == 0 else tot)
        unsat = syndrome(v)
        msg = v if p == 0 else v - ext[:, :D * m].reshape(B, D, m)
        msg = torch.where(valid, msg, 0.0)
        new = ldpc_bp._check_update(msg.transpose(1, 2), valid.T, rule,
                                    alpha).transpose(1, 2)
        # syndrome (pass 0's is the channel's), snapshot and exit of the
        # rows still running; the update of a row that stops is dropped
        if p > 0:
            better = live & (unsat < min_unsat)
            best = torch.where(better[:, None], tot <= 0.0, best)
            min_unsat = torch.where(better, unsat, min_unsat)
        live = live & (min_unsat > 0) & (p < max_iter)
        ext[:, :D * m] = torch.where(live[:, None, None] & valid, new,
                                     ext[:, :D * m].reshape(B, D, m)
                                     ).reshape(B, -1)
        # bit phase, each bit's extrinsics in the plain version's order
        s = ext[:, bs[0]]
        for i in range(1, C):
            s = s + ext[:, bs[i]]
        tot = torch.where(live[:, None], llr + s, tot)
    return best[:, :t.k].to(torch.uint8), min_unsat


@pytest.mark.parametrize("max_iter", [0, 1, 2, 50])
@pytest.mark.parametrize("rule", ldpc_bp.RULES)
@pytest.mark.parametrize("name", GRAPHS)
def test_schedule_equals_plain_version(name, rule, max_iter):
    g = _graph(name)
    llr = _llrs(g, 11)
    bits, unsat = schedule_model(g, llr, max_iter, rule)
    rbits, runsat = ldpc_bp.bp_decode_reference(g, llr, max_iter, rule)
    assert torch.equal(unsat, runsat)
    assert torch.equal(bits, rbits)
    assert int(unsat[7]) == 0            # the codeword row: zero at the start
    if max_iter == 50:
        assert (unsat[:5] == 0).all() and (unsat[5:7] > 0).all()


@pytest.mark.parametrize("name", GRAPHS)
def test_compact_tables(name):
    g = _graph(name)
    t = ldpc_bp.graph_tables(g, "cpu")
    m, D = g.m, g.max_deg
    cs = (t.check_slots.numpy().view(np.uint16)).reshape(D, m).T
    assert np.array_equal(cs != ldpc_bp.NO_BIT, g.check_mask)
    assert np.array_equal(cs[g.check_mask], g.check_bits[g.check_mask])
    bs = t.bit_slots.numpy().view(np.uint16).reshape(t.C, g.n).T
    old = t.bit_edge_slots.numpy()
    # the same edges in the same order, renumbered c·D + j → j·m + c
    real = old < m * D
    assert np.array_equal(bs[real], (old[real] % D) * m + old[real] // D)
    assert (bs[~real] == m * D).all()
    assert t.C == 3


def test_graph_tables_refuse_what_16_bits_cannot_hold():
    n = 65536
    cb = np.array([[0, n - 1]], np.int32)
    big = LdpcGraph("too_long", n, n - 1, 1, np.zeros((1, n - 1), np.uint8),
                    cb, np.ones((1, 2), bool), 2)
    with pytest.raises(ValueError, match="16-bit"):
        ldpc_bp.graph_tables(big, "cpu")
    D = 33
    wide = LdpcGraph("too_wide", 64, 63, 1, np.zeros((1, 63), np.uint8),
                     np.arange(D, dtype=np.int32)[None],
                     np.ones((1, D), bool), D)
    with pytest.raises(ValueError, match="check degree"):
        ldpc_bp.graph_tables(wide, "cpu")


def test_graph_tables_keyed_on_content():
    """An equal graph built anew shares the first one's tables, and the key
    cached for a graph object goes with it."""
    g = ldpc_graph("N576R23")
    copy = LdpcGraph(g.name, g.n, g.k, g.m, g.A.copy(), g.check_bits.copy(),
                     g.check_mask.copy(), g.max_deg)
    assert ldpc_bp.graph_tables(copy, "cpu") is ldpc_bp.graph_tables(g, "cpu")
    assert ldpc_bp.graph_key(copy) == ldpc_bp.graph_key(g)
    cb = g.check_bits.copy()
    cb[0, 0] = (cb[0, 0] + 1) % g.n
    other = LdpcGraph(g.name, g.n, g.k, g.m, g.A, cb, g.check_mask, g.max_deg)
    assert ldpc_bp.graph_key(other) != ldpc_bp.graph_key(g)
    ident = id(copy)
    assert ident in ldpc_bp._KEYS
    del copy
    assert ident not in ldpc_bp._KEYS
