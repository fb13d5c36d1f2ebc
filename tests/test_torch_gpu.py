"""Card-only tests of the torch port's CUDA kernels: the LDPC BP kernel against
its plain torch version for each code and rule (the edge-layout rule
included; batch sizes around the persistent grid, max_iter 0/1/2, rows
converged at the start, ±0.0 and ±1e30 LLRs, back-to-back launches,
unaligned rows, FT8/FT4's LDPC(174, 91) graph at its exact width 7, a
staircase graph of its size and a (1200, 600) one), the Viterbi kernel
against its plain version in both modes and both radices, the BCH/RS
outer-code kernel against its plain version and the native host decoders
(every t, an empty batch, one row, exactly t errors, rows that all fail, RS
rows where the error locator's derivative vanishes, each lane width at the
batch sizes where its launch plan changes), and frame decodes
(COFDM, DVB-T, hierarchical DVB-T with radix 4 forced) through the kernels;
then the FT8 receive's device code (waterfall and Costas grid against the
CPU, the stable top-k on a tied grid, the many-window decode through the BP
kernel); and slice 4's two recurrence kernels (the PSK31 PLL against its
plain version, decisions exact and soft values within 1e-5 of the peak;
the two-rate one-pole exact) with the entry points that launch them, the
FM chain on the card against the CPU, and the float32 products unmoved by
a caller's TF32 switches; and slice 5a on the card against the CPU path
(the channelizer on both FIR routes and under two chunkings, the PFB,
band_compose, AM/SSB band audio, the FM stereo program and RDS, the CSS
dechirp and WSPR energy grid) with the band receivers' BP and Viterbi
launches, and the CSS and WSPR receivers on the card; and slice 5b's
recurrence kernels against their plain versions, exact (the DD-PLL on every
order and on a 16 384-symbol burst whose tracked phase passes 3 000 rad,
with sincosf against cosf and sinf on all 2^32 float32 inputs; the Gardner
loop; the tracking loops at each width, at the capture's edges and with
the code leaving the prefetched window, their window misses equal to the
window model's) with the entry points that launch them; and slice 6a (each
channel impairment, the SSTV discriminator and the ADS-B score on the card
against the CPU, SSTV, ADS-B, Morse and the band decode on the card, the
top-level names); and slice 6b (the generic OFDM receive and OTFS on the
card against the CPU, the Block classes through their kernels, and
checkpoints moving between the card and the CPU); and slice 7 (a mesh of
eight shards of the card: the sharded FIR and OFDM demap, the sharded
Viterbi's one launch a shard, and the sharded link metrics, each against
the one-device path). They skip without a CUDA card.

Run on a card with ``python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py`` (the repository's conftest pins JAX, which a card
machine need not have; nothing here imports JAX).
"""

import numpy as np
import pytest
import torch

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch.codec import ft8_ldpc
from orion_sdr_tpu_torch.dsp.osc import rotate
from orion_sdr_tpu_torch.fec.ldpc import LDPC_CODES, LdpcGraph, \
    _build_msg_col_rows, ldpc_encode, ldpc_graph
from orion_sdr_tpu_torch.fec import conv
from orion_sdr_tpu_torch.fec import bch_device
from orion_sdr_tpu_torch.fec.galois import Bch, ReedSolomon
from orion_sdr_tpu_torch.frame import chain
from orion_sdr_tpu_torch.ops import ldpc_bp, outer_fec, viterbi

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _llrs(g, encode, B, flips, garbage, seed, device):
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 2, (B, g.k)).astype(np.uint8)
    cw = encode(torch.as_tensor(msg, device=device)).cpu().numpy()
    llr = np.where(cw == 0, 4.0, -4.0).astype(np.float32)
    for b in range(B):
        llr[b, rng.choice(g.n, flips, replace=False)] *= -1
    junk = rng.standard_normal((garbage, g.n)).astype(np.float32)
    return msg, torch.as_tensor(np.concatenate([llr, junk]), device=device)


def _check(g, llr, rule, B):
    kb, ku = ldpc_bp.bp_decode_kernel(g, llr, 50, rule)
    rb, ru = ldpc_bp.bp_decode_reference(g, llr, 50, rule)
    torch.cuda.synchronize()
    # same float operations in the same order: equal on every row
    assert torch.equal(kb, rb) and torch.equal(ku, ru)
    assert (ku[B:] > 0).all()
    return kb.cpu().numpy(), ku.cpu().numpy()


@pytest.mark.parametrize("rule", ldpc_bp.RULES)
@pytest.mark.parametrize("name", sorted(LDPC_CODES))
def test_kernel_matches_plain_version(cuda, name, rule):
    g = ldpc_graph(name)
    B = 256
    flips = {"N512R12": 6, "N576R23": 4, "N512R34": 3}[name]
    msg, llr = _llrs(g, lambda m: ldpc_encode(name, m), B, flips, 32, 1, cuda)
    counter = "launches_edge" if rule == "sum_product_edge" else "launches"
    before = getattr(ldpc_bp.bp_decode_kernel, counter)
    bits, unsat = _check(g, llr, rule, B)
    assert getattr(ldpc_bp.bp_decode_kernel, counter) == before + 1
    # the high-rate codes' small distances let a rare row converge to
    # another codeword, so count rows that recovered the sent message
    right = (unsat[:B] == 0) & (bits[:B] == msg).all(axis=1)
    assert right.mean() > 0.95


def _staircase_graph(n, k):
    # (174, 91), FT8's size: D = 6, 59 short checks, and rows of 696 bytes,
    # which the kernel copies 4 bytes at a time; (1200, 600): 600 checks on
    # 256 threads, up to three a thread, so each syndrome count takes two
    # barriers
    m = n - k
    cols = _build_msg_col_rows(k, m, 0x1234_5678)
    rows = [[] for _ in range(m)]
    for c, rs in enumerate(cols):
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
    g = LdpcGraph(f"test_{n}_{k}", n, k, m, A, cb, mask, D)

    def encode(msg):
        s = (msg.to(torch.float64) @ torch.as_tensor(A.T, dtype=torch.float64,
                                                     device=msg.device))
        p = torch.cumsum(s.to(torch.int64) & 1, -1) & 1
        return torch.cat([msg.to(torch.int64), p], -1).to(torch.uint8)
    return g, encode


def _graph_174_91(kind):
    """FT8/FT4's LDPC(174, 91) graph (D = 7: checks of 6 and 7 bits, the
    kernel's exact width 7) or the staircase graph of its size."""
    if kind == "ft8":
        return ft8_ldpc.ft8_ldpc_graph(), ft8_ldpc.ldpc_encode
    return _staircase_graph(174, 91)


def test_kernel_takes_other_graph_sizes(cuda):
    graphs = [_graph_174_91("ft8"), _staircase_graph(174, 91),
              _staircase_graph(1200, 600)]
    for g, encode in graphs:
        for rule in ldpc_bp.RULES:
            _check(g, _llrs(g, encode, 64, 3, 8, 2, cuda)[1], rule, 64)


def _equal_to_plain(g, llr, max_iter, rule):
    kb, ku = ldpc_bp.bp_decode_kernel(g, llr, max_iter, rule)
    rb, ru = ldpc_bp.bp_decode_reference(g, llr, max_iter, rule)
    torch.cuda.synchronize()
    assert torch.equal(kb, rb) and torch.equal(ku, ru)
    return kb, ku


def _edge_rows(g, encode, B, seed, device):
    """B rows: decodable, random-normal, clean codewords (zero syndrome at
    the start) and rows with ±0.0 and ±1e30 entries, in turn."""
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 2, (B, g.k)).astype(np.uint8)
    cw = encode(torch.as_tensor(msg, device=device)).cpu().numpy()
    llr = np.where(cw == 0, 4.0, -4.0).astype(np.float32)
    for b in range(B):
        kind = b % 4
        if kind == 0:
            llr[b, rng.choice(g.n, 3, replace=False)] *= -1
        elif kind == 1:
            llr[b] = rng.standard_normal(g.n)
        elif kind == 3:
            pick = rng.choice(g.n, 8, replace=False)
            llr[b, pick] = np.array([0.0, -0.0, 1e30, -1e30, 0.0, -0.0,
                                     1e30, -1e30], np.float32)
    return torch.as_tensor(llr, device=device)


@pytest.mark.parametrize("rule", ldpc_bp.RULES)
def test_kernel_at_the_edges_of_the_persistent_loop(cuda, rule):
    # batch sizes around the resident grid (launch_plan's), each row at
    # max_iter 0, 1 and 2; the rows come in turns of decodable, garbage,
    # clean codewords and ±0.0/±1e30 entries
    g = ldpc_graph("N512R12")
    encode = lambda m: ldpc_encode("N512R12", m)
    grid = ldpc_bp.launch_plan(g, rule, 10**6)["grid"]
    for B in sorted({1, 131, grid - 1, grid, grid + 1, 3 * grid + 7}):
        plan = ldpc_bp.launch_plan(g, rule, B)
        assert plan["grid"] == min(B, grid)
        assert plan["codewords_per_block"] == -(-B // plan["grid"])
        llr = _edge_rows(g, encode, B, B, cuda)
        for max_iter in (0, 1, 2):
            _, unsat = _equal_to_plain(g, llr, max_iter, rule)
            assert (unsat[2::4] == 0).all()


@pytest.mark.parametrize("kind", ["ft8", "staircase"])
@pytest.mark.parametrize("rule", ldpc_bp.RULES)
def test_kernel_edge_cases_on_the_174_91_graph(cuda, rule, kind):
    g, encode = _graph_174_91(kind)
    grid = ldpc_bp.launch_plan(g, rule, 10**6)["grid"]
    for B in (1, 131, grid + 1):
        llr = _edge_rows(g, encode, B, 50 + B, cuda)
        for max_iter in (0, 1, 2):
            _equal_to_plain(g, llr, max_iter, rule)
        # 50 iterations without the ±1e30 rows, whose min-sum messages can
        # grow to inf - inf = NaN there (NaN orders differently in argmin)
        finite = llr[torch.arange(B, device=cuda) % 4 != 3].contiguous()
        _equal_to_plain(g, finite, 50, rule)


@pytest.mark.parametrize("rule", ldpc_bp.RULES)
def test_kernel_all_rows_converged_at_the_start(cuda, rule):
    g = ldpc_graph("N576R23")
    rng = np.random.default_rng(12)
    msg = torch.as_tensor(rng.integers(0, 2, (300, g.k)), dtype=torch.uint8,
                          device=cuda)
    llr = (1.0 - 2.0 * ldpc_encode("N576R23", msg).to(torch.float32)) * 4.0
    for max_iter in (0, 1, 50):
        bits, unsat = _equal_to_plain(g, llr, max_iter, rule)
        assert (unsat == 0).all() and torch.equal(bits, msg)


def test_kernel_launches_back_to_back(cuda):
    # two launches on one stream with no synchronisation between them, each
    # on the persistent grid: the second decodes every row again
    g = ldpc_graph("N512R34")
    grid = ldpc_bp.launch_plan(g, "min_sum", 10**6)["grid"]
    _, llr = _llrs(g, lambda m: ldpc_encode("N512R34", m), 2 * grid + 5, 3,
                   40, 4, cuda)
    rb, ru = ldpc_bp.bp_decode_reference(g, llr, 50, "min_sum")
    before = ldpc_bp.bp_decode_kernel.launches
    a = ldpc_bp.bp_decode_kernel(g, llr, 50, "min_sum")
    b = ldpc_bp.bp_decode_kernel(g, llr, 50, "min_sum")
    torch.cuda.synchronize()
    assert ldpc_bp.bp_decode_kernel.launches == before + 2
    for bits, unsat in (a, b):
        assert torch.equal(bits, rb) and torch.equal(unsat, ru)


def test_kernel_takes_an_unaligned_row_start(cuda):
    # a view that starts one float into its storage: the rows are not
    # 16-byte aligned, so the kernel copies them 4 bytes at a time
    g = ldpc_graph("N512R12")
    _, llr = _llrs(g, lambda m: ldpc_encode("N512R12", m), 200, 6, 20, 5,
                   cuda)
    flat = torch.cat([llr.new_zeros(1), llr.reshape(-1)])
    view = flat[1:].view(llr.shape)
    assert view.data_ptr() % 16 != 0
    for rule in ldpc_bp.RULES:
        _equal_to_plain(g, view, 50, rule)


def test_decode_batch_runs_through_the_kernel(cuda):
    plan = P.CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    cfg = P.OfdmConfig(plan, fs=1e6)
    pre = P.OfdmPreamble(repeat_len=128, num_repeats=4).with_training_symbol(
        256, 64)
    table = P.McsTable.default_ladder()
    mod = P.OfdmFrameMod(cfg, table, pre, device=cuda)
    rng = np.random.default_rng(3)
    payloads = [rng.integers(0, 256, 300).astype(np.uint8) for _ in range(4)]
    bodies = [mod.modulate_frame(P.FramePacket(P.FrameMetadata(i, i), p), i)
              [pre.total_len():] for i, p in enumerate(payloads)]
    batch = np.zeros((4, max(len(b) for b in bodies)), np.complex64)
    for i, b in enumerate(bodies):
        batch[i, :len(b)] = b
    before = ldpc_bp.bp_decode_kernel.launches
    out = P.OfdmFrameDemod(cfg, table, device=cuda).decode_batch(batch)
    assert ldpc_bp.bp_decode_kernel.launches >= before + 5   # header + 4 groups
    for i, (got, p) in enumerate(zip(out, payloads)):
        assert isinstance(got, P.FramePacket), got
        assert np.array_equal(got.payload, p)
        assert got.metadata.mcs_index == i


# ── Viterbi ──────────────────────────────────────────────────────────────────

LANES = (1, 33, 3168)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("rate", ["1/2", "3/4", "7/8"])
@pytest.mark.parametrize("code", ["k5", "dvb_k7"])
def test_viterbi_terminated_matches_plain_version(cuda, code, rate, lanes):
    # 1001 info bits: an odd trellis length for both codes
    n = 1001
    rng = np.random.default_rng(lanes)
    llr = torch.as_tensor(rng.standard_normal(
        (lanes, conv.punctured_coded_len(n, rate, code))) * 2.0,
        dtype=torch.float32, device=cuda)
    before = viterbi.viterbi_decode_soft_kernel.launches
    got = viterbi.viterbi_decode_soft_kernel(llr, n, rate, code)
    want = viterbi.viterbi_terminated_reference(llr, n, rate, code)
    torch.cuda.synchronize()
    assert viterbi.viterbi_decode_soft_kernel.launches == before + 1
    assert got.shape == (lanes, n) and torch.equal(got, want)


@pytest.mark.parametrize("span", [1216, 1217])
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("code", ["k5", "dvb_k7"])
def test_viterbi_chunks_match_plain_version(cuda, code, lanes, span):
    S = 64 if code == "dvb_k7" else 16
    rng = np.random.default_rng(span + lanes)
    for llr in (rng.integers(-8, 9, (2, lanes, span)),
                rng.standard_normal((2, lanes, span))):
        c0, c1 = (torch.as_tensor(x, dtype=torch.float32, device=cuda)
                  for x in llr)
        pm0 = torch.as_tensor(rng.integers(-30, 1, (lanes, S)),
                              dtype=torch.float32, device=cuda)
        pm0[::99] = -1e30
        pm0[::99, 0] = 0.0
        before = viterbi.viterbi_chunks_kernel.launches
        got = viterbi.viterbi_chunks_kernel(c0, c1, pm0, code)
        want = viterbi.viterbi_chunks_reference(c0, c1, pm0, code)
        torch.cuda.synchronize()
        assert viterbi.viterbi_chunks_kernel.launches == before + 1
        assert torch.equal(got, want)


@pytest.mark.parametrize("rate", ["1/2", "3/4", "7/8"])
def test_viterbi_chunked_stream_decode_matches_cpu(cuda, rate):
    # the whole chunked decode (depuncture, chunking, kernel, margins) on the
    # card equals the same decode on the CPU's plain version
    n = 20001
    rng = np.random.default_rng(5)
    llr = rng.standard_normal((3, conv.punctured_coded_len(n, rate,
                                                           "dvb_k7")))
    llr = torch.as_tensor(llr, dtype=torch.float32)
    got = conv.viterbi_decode_soft_chunked(llr.to(cuda), n, rate, "dvb_k7")
    want = conv.viterbi_decode_soft_chunked(llr, n, rate, "dvb_k7")
    assert torch.equal(got.cpu(), want)


def test_dvb_t_decode_batch_runs_through_the_kernel(cuda):
    params = P.DvbTFrameParams(P.DvbTLinkParams("1/8", "qpsk", "1/2"), 1, 9)
    rng = np.random.default_rng(6)
    payloads = [rng.integers(0, 256, 2000).astype(np.uint8) for _ in range(3)]
    frames = [P.DvbTFrameMod(params, device=cuda).modulate(p)
              for p in payloads]
    batch = np.stack([f.iq for f in frames])
    sig = float(np.mean(np.abs(batch) ** 2))
    batch = batch + ((rng.standard_normal(batch.shape)
                      + 1j * rng.standard_normal(batch.shape))
                     * np.sqrt(sig / 10 ** 0.8 / 2)).astype(np.complex64)
    before = viterbi.viterbi_chunks_kernel.launches
    out = P.DvbTFrameDemod(params, device=cuda).decode_batch(
        batch, frames[0].n_symbols, 2000)
    assert viterbi.viterbi_chunks_kernel.launches == before + 1
    for o, p in zip(out, payloads):
        assert np.array_equal(o.payload, p)
        assert o.tps == params.tps_word()


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("code", ["k5", "dvb_k7"])
def test_viterbi_radix4_chunks_match_plain_version(cuda, code, lanes):
    S = 64 if code == "dvb_k7" else 16
    rng = np.random.default_rng(40 + lanes)
    for llr in (rng.integers(-8, 9, (2, lanes, 1216)),
                rng.standard_normal((2, lanes, 1216))):
        c0, c1 = (torch.as_tensor(x, dtype=torch.float32, device=cuda)
                  for x in llr)
        pm0 = torch.as_tensor(rng.integers(-30, 1, (lanes, S)),
                              dtype=torch.float32, device=cuda)
        pm0[::99] = -1e30
        pm0[::99, 0] = 0.0
        before = viterbi.viterbi_chunks_kernel.launches_radix4
        got = viterbi.viterbi_chunks_kernel(c0, c1, pm0, code, radix=4)
        want = viterbi.viterbi_chunks_reference(c0, c1, pm0, code, radix=4)
        torch.cuda.synchronize()
        assert viterbi.viterbi_chunks_kernel.launches_radix4 == before + 1
        assert torch.equal(got, want)


@pytest.mark.parametrize("rate", ["1/2", "3/4"])
@pytest.mark.parametrize("code,n", [("k5", 4096), ("dvb_k7", 4098),
                                    ("k5", 30000)])
def test_viterbi_radix4_terminated_matches_plain_version(cuda, code, n, rate):
    # 30 000 info bits: past the shared-memory limit, global scratch
    rng = np.random.default_rng(n)
    llr = torch.as_tensor(rng.standard_normal(
        (33, conv.punctured_coded_len(n, rate, code))) * 2.0,
        dtype=torch.float32, device=cuda)
    got = viterbi.viterbi_decode_soft_kernel(llr, n, rate, code, radix=4)
    want = viterbi.viterbi_terminated_reference(llr, n, rate, code, radix=4)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_hier_decode_runs_through_radix4_when_forced(cuda, monkeypatch):
    link = P.DvbTHierLinkParams("1/8", "qam16", 2, "1/2", "3/4")
    params = P.DvbTHierFrameParams(link, 1, 0x42)
    rng = np.random.default_rng(8)
    hp = rng.integers(0, 256, 400).astype(np.uint8)
    lp = rng.integers(0, 256, 1200).astype(np.uint8)
    frame = P.DvbTHierFrameMod(params, device=cuda).modulate(hp, lp)
    iq = np.concatenate([np.zeros(913, np.complex64), frame.iq])
    demod = P.DvbTHierFrameDemod(params, device=cuda)
    for forced, counter in ((False, "launches"), (True, "launches_radix4")):
        monkeypatch.setattr(viterbi, "FORCE_RADIX4", forced)
        before = getattr(viterbi.viterbi_chunks_kernel, counter)
        rx = demod.decode(iq, frame.n_symbols, len(hp), len(lp))
        assert getattr(viterbi.viterbi_chunks_kernel, counter) == before + 2
        assert np.array_equal(rx.hp_payload, hp)
        assert np.array_equal(rx.lp_payload, lp)
        assert rx.tps == params.tps_word()


def _chunk_inputs(rng, lanes, span, S, device, ints=False):
    if ints:
        llr = rng.integers(-8, 9, (2, lanes, span))
    else:
        llr = rng.standard_normal((2, lanes, span))
    c0, c1 = (torch.as_tensor(x, dtype=torch.float32, device=device)
              for x in llr)
    pm0 = torch.as_tensor(rng.integers(-30, 1, (lanes, S)),
                          dtype=torch.float32, device=device)
    pm0[::99] = -1e30
    pm0[::99, 0] = 0.0
    return c0, c1, pm0


@pytest.mark.parametrize("offset", [-1, 0, 1])
@pytest.mark.parametrize("radix", [2, 4])
def test_viterbi_at_one_wave_of_lanes(cuda, radix, offset):
    # the lane counts around what one wave holds, as the occupancy query
    # reports it for this launch
    plan = viterbi.launch_plan(3168, 1216, "dvb_k7", radix)
    lanes = plan["lanes_per_sm"] * plan["sms"] + offset
    assert viterbi.launch_plan(lanes, 1216, "dvb_k7", radix)["waves"] == \
        (2 if offset > 0 else 1)
    rng = np.random.default_rng(70 + offset)
    c0, c1, pm0 = _chunk_inputs(rng, lanes, 1216, 64, cuda)
    got = viterbi.viterbi_chunks_kernel(c0, c1, pm0, "dvb_k7", radix=radix)
    want = viterbi.viterbi_chunks_reference(c0, c1, pm0, "dvb_k7",
                                            radix=radix)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("code", ["k5", "dvb_k7"])
def test_viterbi_exact_ties_and_signed_zeros(cuda, code, radix):
    # integer LLRs with many zeros (both signs), metric rows of equal values
    # and of ±0.0: every comparison meets exact ties, and the maximum of a
    # row of zeros is +0.0 against -0.0
    S = 64 if code == "dvb_k7" else 16
    rng = np.random.default_rng(80 + S + radix)
    lanes, span = 40, 1216
    llr = rng.integers(-2, 3, (2, lanes, span)).astype(np.float32)
    llr[rng.random(llr.shape) < 0.2] = -0.0
    c0, c1 = (torch.as_tensor(x, device=cuda) for x in llr)
    pm0 = np.zeros((lanes, S), np.float32)
    pm0[::4] = -0.0
    pm0[1::4] = -3.0
    pm0[2::4] = np.where(rng.random((len(pm0[2::4]), S)) < 0.5, 0.0, -0.0)
    pm0 = torch.as_tensor(pm0, device=cuda)
    got = viterbi.viterbi_chunks_kernel(c0, c1, pm0, code, radix=radix)
    want = viterbi.viterbi_chunks_reference(c0, c1, pm0, code, radix=radix)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # on integer LLRs the radices agree
    other = viterbi.viterbi_chunks_kernel(c0, c1, pm0, code, radix=6 - radix)
    assert torch.equal(got, other)
    full = torch.stack([c0, c1], dim=-1).reshape(lanes, 2 * span)
    info = span - conv.tail_bits(code)
    got = viterbi.viterbi_decode_soft_kernel(full, info, "1/2", code,
                                             radix=radix)
    want = viterbi.viterbi_terminated_reference(full, info, "1/2", code,
                                                radix=radix)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("radix,span", [(2, 25633), (4, 25604)])
def test_viterbi_chunks_through_global_scratch(cuda, radix, span):
    # past MAX_SMEM_STEPS the decisions go to a global scratch buffer
    assert span > viterbi.MAX_SMEM_STEPS
    rng = np.random.default_rng(span)
    c0, c1, pm0 = _chunk_inputs(rng, 3, span, 64, cuda)
    got = viterbi.viterbi_chunks_kernel(c0, c1, pm0, "dvb_k7", radix=radix)
    want = viterbi.viterbi_chunks_reference(c0, c1, pm0, "dvb_k7",
                                            radix=radix)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("span", [36, 1220])
def test_viterbi_radix4_k5_chunks_at_33_lanes(cuda, span):
    # K = 5: 8 of a warp's 32 threads own states, the rest repeat them
    rng = np.random.default_rng(90 + span)
    for ints in (True, False):
        c0, c1, pm0 = _chunk_inputs(rng, 33, span, 16, cuda, ints)
        got = viterbi.viterbi_chunks_kernel(c0, c1, pm0, "k5", radix=4)
        want = viterbi.viterbi_chunks_reference(c0, c1, pm0, "k5", radix=4)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_viterbi_code_without_end_taps(cuda, monkeypatch):
    # a generator that skips the last stage: radix 4 reads any code's sums
    # from its table; radix 2 forms its candidates from the end-tap symmetry
    # that every code of fec/conv.py has, and refuses such a code
    codes = dict(conv.CONV_CODES, test_k6={"K": 6, "g0": 0b110110,
                                           "g1": 0b101011})
    monkeypatch.setattr(conv, "CONV_CODES", codes)
    monkeypatch.setattr(viterbi, "CONV_CODES", codes)
    rng = np.random.default_rng(95)
    c0, c1, pm0 = _chunk_inputs(rng, 33, 1216, 32, cuda)
    got = viterbi.viterbi_chunks_kernel(c0, c1, pm0, "test_k6", radix=4)
    want = viterbi.viterbi_chunks_reference(c0, c1, pm0, "test_k6", radix=4)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with pytest.raises(RuntimeError):
        viterbi.viterbi_chunks_kernel(c0, c1, pm0, "test_k6", radix=2)


# ── the BCH/RS outer-code kernel ─────────────────────────────────────────────


def _outer_check(kind, code, words, cuda):
    """Kernel vs plain version vs native host decoder on ``words`` (numpy):
    messages and ok flags equal on every row. Returns (messages, ok)."""
    x = torch.as_tensor(words, device=cuda)
    if kind == "bch":
        args = (code.n, code.k, code.t)
        before = outer_fec.bch_decode_kernel.launches
        kb, kok = outer_fec.bch_decode_kernel(*args, x)
        launched = outer_fec.bch_decode_kernel.launches - before
        rb, rok = bch_device.bch_decode_batch_reference(*args, x)
    else:
        args = (code.n, code.n_parity)
        before = outer_fec.rs_decode_kernel.launches
        kb, kok = outer_fec.rs_decode_kernel(*args, x)
        launched = outer_fec.rs_decode_kernel.launches - before
        rb, rok = bch_device.rs_decode_batch_reference(*args, x)
    torch.cuda.synchronize()
    assert launched == (1 if len(words) else 0)
    assert torch.equal(kb, rb) and torch.equal(kok, rok)
    hb, hok = code.decode_batch(words)
    assert np.array_equal(kb.cpu().numpy(), hb)
    assert np.array_equal(kok.cpu().numpy().astype(bool), hok.astype(bool))
    return kb.cpu().numpy(), kok.cpu().numpy().astype(bool)


def _bch_words(t, B, errors, seed):
    code = chain.shortened_bch_for(t)
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, (B, code.k)).astype(np.uint8)
    words = code.encode(msgs)
    for i in range(B):
        ne = errors(i, rng)
        if ne:
            words[i, rng.choice(code.n, ne, replace=False)] ^= 1
    return code, msgs, words


def _rs_words(n, p, B, errors, seed):
    rs = ReedSolomon(n, p)
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 256, (B, rs.k)).astype(np.uint8)
    words = rs.encode(msgs)
    for i in range(B):
        ne = errors(i, rng)
        if ne:
            words[i, rng.choice(n, ne, replace=False)] ^= rng.integers(
                1, 256, ne).astype(np.uint8)
    return rs, msgs, words


@pytest.mark.parametrize("t", range(1, 9))
def test_outer_bch_kernel_matches_plain_version(cuda, t):
    # 0..t+3 errors a row, 1 000 rows: a partial last block
    code, msgs, words = _bch_words(t, 1000, lambda i, r: i % (t + 4), t)
    out, ok = _outer_check("bch", code, words, cuda)
    within = np.arange(1000) % (t + 4) <= t
    assert ok[within].all() and np.array_equal(out[within], msgs[within])


@pytest.mark.parametrize("p", [2, 4, 8, 12, 16])
def test_outer_rs_kernel_matches_plain_version(cuda, p):
    rs, msgs, words = _rs_words(204, p, 999, lambda i, r: i % (p // 2 + 4),
                                p)
    out, ok = _outer_check("rs", rs, words, cuda)
    within = np.arange(999) % (p // 2 + 4) <= p // 2
    assert ok[within].all() and np.array_equal(out[within], msgs[within])


def test_outer_kernels_take_an_empty_batch_and_one_row(cuda):
    code, _, words = _bch_words(8, 1, lambda i, r: 8, 1)
    _outer_check("bch", code, words[:0], cuda)
    out, ok = _outer_check("bch", code, words, cuda)
    assert ok.all()
    rs, _, words = _rs_words(204, 16, 1, lambda i, r: 8, 2)
    _outer_check("rs", rs, words[:0], cuda)
    assert _outer_check("rs", rs, words, cuda)[1].all()


def test_outer_bch_kernel_at_exactly_t_errors(cuda):
    code, msgs, words = _bch_words(8, 4096, lambda i, r: 8, 3)
    out, ok = _outer_check("bch", code, words, cuda)
    assert ok.all() and np.array_equal(out, msgs)


def test_outer_kernels_on_rows_that_all_fail(cuda):
    code, _, words = _bch_words(8, 640, lambda i, r: int(r.integers(12, 40)),
                                4)
    _, ok = _outer_check("bch", code, words, cuda)
    rs, _, words = _rs_words(204, 16, 640, lambda i, r: int(r.integers(
        20, 60)), 5)
    _, rok = _outer_check("rs", rs, words, cuda)
    assert not ok.any() and not rok.any()


def test_outer_rs_kernel_where_the_derivative_vanishes(cuda):
    # seed 0's 4 096 rows of 9..13 byte errors hold 12 rows whose error
    # locator has a root at which its derivative is 0 (bad_dv), found by
    # tests/test_torch_bch_device.py
    rs, _, words = _rs_words(204, 16, 4096, lambda i, r: int(r.integers(
        9, 14)), 0)
    _outer_check("rs", rs, words, cuda)


@pytest.mark.parametrize("kind,n,p", [("bch", 255, 8), ("bch", 70, 2),
                                      ("rs", 255, 16), ("rs", 20, 16),
                                      ("rs", 255, 2)])
def test_outer_kernel_other_code_lengths(cuda, kind, n, p):
    if kind == "bch":
        code = Bch(p, n)
        rng = np.random.default_rng(n)
        words = code.encode(rng.integers(0, 2, (129, code.k)).astype(
            np.uint8))
        for i in range(129):
            words[i, rng.choice(n, i % (p + 3), replace=False)] ^= 1
        _outer_check("bch", code, words, cuda)
    else:
        rs, _, words = _rs_words(n, p, 129, lambda i, r: i % (p // 2 + 3), n)
        _outer_check("rs", rs, words, cuda)


def _plan_edges(kind, lanes, sms):
    """Batch sizes at the edges of ops.outer_fec.plan_for's choices: one
    warp of codewords, the first grid of BLOCKS_PER_SM blocks an SM, each
    step up of codewords a block, and the largest blocks."""
    per_warp = 32 // lanes
    full = sms * outer_fec.BLOCKS_PER_SM
    edges = {1, per_warp - 1, per_warp, per_warp + 1, sms, full - 1, full,
             full + 1, full * per_warp + 1, full * 2 * per_warp + 1,
             full * (outer_fec.MAX_THREADS // lanes) + 1}
    return sorted(b for b in edges if b >= 1)


@pytest.mark.parametrize("kind", ["bch", "rs"])
@pytest.mark.parametrize("lanes", [16, 32])
def test_outer_kernel_at_the_plan_edges(cuda, monkeypatch, kind, lanes):
    # every lane width the plan can pick, at the batch sizes where the
    # groups a block and the grid change; rows 0..t+3 errors
    monkeypatch.setitem(outer_fec.LANES, kind, lanes)
    sms = outer_fec.launch_plan(kind, 1, cuda)["sms"]
    for B in _plan_edges(kind, lanes, sms):
        plan = outer_fec.launch_plan(kind, B, cuda)
        assert plan["lanes"] == lanes
        assert plan["grid"] * plan["groups_per_block"] >= B
        if kind == "bch":
            code, _, words = _bch_words(8, B, lambda i, r: i % 12, B)
        else:
            code, _, words = _rs_words(204, 16, B, lambda i, r: i % 12, B)
        _outer_check(kind, code, words, cuda)


def test_decode_chain_batch_runs_the_outer_kernel(cuda):
    # enough frames that the payload's BCH blocks reach the threshold: the
    # kernel runs once for them; the header (no outer code) never
    cfg = P.OfdmConfig(P.CarrierPlan(256, 64).with_contiguous_data(
        edge_guard=16), fs=1e6)
    pre = P.OfdmPreamble(repeat_len=128, num_repeats=4).with_training_symbol(
        256, 64)
    table = P.McsTable.default_ladder()
    mod = P.OfdmFrameMod(cfg, table, pre, device=cuda)
    rng = np.random.default_rng(9)
    per_frame = -(-(1500 + 4) * 8 // chain.BCH_INFO_BITS)
    n_frames = max(-(-chain._DEVICE_OUTER_MIN_BLOCKS // per_frame), 2)
    frames = [(P.FrameMetadata(i, 1), rng.integers(0, 256, 1500).astype(
        np.uint8)) for i in range(n_frames)]
    iq = np.stack([mod.modulate_frame(P.FramePacket(m, d), i)[
        pre.total_len():] for i, (m, d) in enumerate(frames)])
    before = outer_fec.bch_decode_kernel.launches
    out = P.OfdmFrameDemod(cfg, table, device=cuda).decode_batch(iq)
    assert outer_fec.bch_decode_kernel.launches == before + 1
    for (meta, data), got in zip(frames, out):
        assert got.metadata == meta and np.array_equal(got.payload, data)
    before = outer_fec.bch_decode_kernel.launches
    got = P.OfdmFrameDemod(cfg, table, device=cuda).decode(iq[0])
    if per_frame < chain._DEVICE_OUTER_MIN_BLOCKS:
        assert outer_fec.bch_decode_kernel.launches == before
    assert np.array_equal(got.payload, frames[0][1])


# ── the FT8 receive's device code ────────────────────────────────────────────


def _ft8_windows(n_win, seed):
    """``n_win`` noisy FT8 windows at -12 dB in 2500 Hz, one frame each
    (carriers 1000 + 25·i Hz), and their messages."""
    from orion_sdr_tpu_torch.message import CallsignHashTable, Standard, pack77
    rng = np.random.default_rng(seed)
    calls = [f"K{i}ABC" for i in range(n_win)]
    ht = CallsignHashTable()
    tones = np.stack([P.ft8_encode(pack77(Standard("CQ", c, "FN42"), ht),
                                   device="cpu") for c in calls])
    iq = np.stack([P.ft8_mod(t, 12000.0, 1000.0 + 25 * i, device="cpu")
                   .numpy() for i, t in enumerate(tones)])
    p = 12000.0 / (2500.0 * 10 ** (-12.0 / 10))
    iq = iq + ((rng.standard_normal(iq.shape) + 1j * rng.standard_normal(
        iq.shape)) * np.sqrt(p / 2)).astype(np.complex64)
    return iq.astype(np.complex64), calls


def test_waterfall_and_costas_grid_on_the_card_match_the_cpu(cuda):
    from orion_sdr_tpu_torch.sync.costas import candidate_score_grid
    from orion_sdr_tpu_torch.sync.waterfall import compute_waterfall
    from orion_sdr_tpu_torch.modulate.ft8 import FT8_COSTAS
    iq, _ = _ft8_windows(3, 1)
    x = torch.as_tensor(iq)
    wf_cpu = compute_waterfall(x, 12000.0, 200.0, 6.25, 1920, 79, 458)
    wf_gpu = compute_waterfall(x.to(cuda), 12000.0, 200.0, 6.25, 1920, 79,
                               458)
    # log-power to 1e-3 absolute (complex64 products, other sum orders)
    assert float((wf_gpu.cpu() - wf_cpu).abs().max()) < 1e-3
    args = (FT8_COSTAS, [0, 36, 72], 8, 0, 0)
    s_cpu = candidate_score_grid(wf_cpu, *args)
    s_gpu = candidate_score_grid(wf_cpu.to(cuda), *args)
    # the same waterfall: the same sums in the same order
    assert float((s_gpu.cpu() - s_cpu).abs().max()) <= 1e-3 * float(
        s_cpu.abs().max())


def test_stable_top_k_on_the_card_on_a_tied_grid(cuda):
    from orion_sdr_tpu_torch.sync.costas import top_k_stable
    flat = torch.zeros((4, 451), device=cuda)
    flat[1, 7] = flat[1, 300] = 2.0
    vals, idx = top_k_stable(flat, 4)
    assert idx[0].tolist() == [0, 1, 2, 3]
    assert idx[1].tolist() == [7, 300, 0, 1]
    assert vals[1].tolist() == [2.0, 2.0, 0.0, 0.0]


def test_ft8_decode_windows_runs_through_the_kernel(cuda):
    iq, calls = _ft8_windows(4, 2)
    iq = np.concatenate([iq, np.zeros_like(iq[:1])])
    before = ldpc_bp.bp_decode_kernel.launches
    out = P.ft8_decode_windows(iq, 12000.0, 950.0, 1150.0, device=cuda)
    assert ldpc_bp.bp_decode_kernel.launches == before + 1
    ref = P.ft8_decode_windows(iq, 12000.0, 950.0, 1150.0, device="cpu")
    assert [o.message.call_de if o else None for o in out] == calls + [None]
    assert [(o.message, o.carrier_hz) if o else None for o in out] == \
        [(o.message, o.carrier_hz) if o else None for o in ref]


# ── slice 4: the PSK31 PLL and the two-rate one-pole kernels ─────────────────

def _pll_dots(rows, n, seed):
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    flips = np.where(rng.integers(0, 2, (rows, n)) == 1, 1.0, -1.0)
    qpsk_steps = np.exp(0.5j * np.pi * rng.integers(0, 4, (rows, n)))
    base = np.exp(1j * (0.01 * k + rng.uniform(0, 6, (rows, 1)))) * 120.0
    noise = 30.0 * (rng.standard_normal((rows, n))
                    + 1j * rng.standard_normal((rows, n)))
    return ((base * flips).astype(np.complex64),
            (base * qpsk_steps + noise).astype(np.complex64))


@pytest.mark.parametrize("rows,n", [(1, 1), (16, 2048), (33, 300), (5, 0)])
@pytest.mark.parametrize("qpsk", [False, True])
def test_psk31_pll_kernel_matches_plain_version(cuda, rows, n, qpsk):
    """Decisions exact; soft values, symbols and phases within 1e-5 of the
    peak (the kernel's cosf/sinf/rsqrtf against torch's own calls of them
    on the card; every product and sum rounds apart in both)."""
    from orion_sdr_tpu_torch.demodulate.psk31 import pll_constants
    from orion_sdr_tpu_torch.ops import psk31_pll as K
    clean, noisy = _pll_dots(rows, n, rows + n)
    dots = torch.as_tensor(noisy if qpsk else clean, device=cuda)
    rng = np.random.default_rng(3)
    prev = torch.as_tensor(np.exp(1j * rng.uniform(0, 6, rows)).astype(
        np.complex64), device=cuda)
    acc = torch.as_tensor(rng.uniform(-3, 3, rows).astype(np.float32),
                          device=cuda)
    c_fb, scale = pll_constants(256, 1.0)
    before = K.psk31_pll.launches
    soft, p, a = K.psk31_pll(dots, prev, acc, c_fb, scale, 0.05, qpsk)
    rs, rp, ra = K.psk31_pll_reference(dots, prev, acc, c_fb, scale, 0.05,
                                       qpsk)
    torch.cuda.synchronize()
    assert K.psk31_pll.launches == before + (1 if rows and n else 0)
    assert soft.shape == rs.shape
    if n:
        assert torch.equal(soft[..., 0] >= 0 if qpsk else soft >= 0,
                           rs[..., 0] >= 0 if qpsk else rs >= 0)
        peak = float(rs.abs().max())
        assert float((soft - rs).abs().max()) <= 1e-5 * peak
    assert float((p - rp).abs().max()) <= 1e-5
    assert float((a - ra).abs().max()) <= 1e-5


@pytest.mark.parametrize("rows,n", [(1, 1), (33, 5000), (64, 8192), (3, 0)])
@pytest.mark.parametrize("ge", [False, True])
def test_onepole_two_rate_kernel_is_exact(cuda, rows, n, ge):
    from orion_sdr_tpu_torch.ops import onepole_two_rate as K
    rng = np.random.default_rng(rows + n)
    x = rng.uniform(0, 1, (rows, n)).astype(np.float32)
    x[:, n // 3:n // 2] = 0.5                        # runs of ties
    x = torch.as_tensor(x, device=cuda)
    env0 = torch.as_tensor(rng.uniform(0, 1, rows).astype(np.float32),
                           device=cuda)
    before = K.onepole_two_rate.launches
    env, last = K.onepole_two_rate(x, env0, 0.9, 0.999, ge)
    renv, rlast = K.onepole_two_rate_reference(x, env0, 0.9, 0.999, ge)
    torch.cuda.synchronize()
    assert K.onepole_two_rate.launches == before + (1 if rows and n else 0)
    assert torch.equal(env, renv) and torch.equal(last, rlast)


def test_slice4_entry_points_run_through_the_kernels(cuda):
    """agc_rms (two rates), cw_mod, bpsk31_demod and Psk31Stream on the
    card launch their kernels and agree with the CPU path."""
    from orion_sdr_tpu_torch.dsp.agc import agc_rms, design_agc
    from orion_sdr_tpu_torch.ops import onepole_two_rate, psk31_pll
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((4, 3000)) + 1j * rng.standard_normal(
        (4, 3000))).astype(np.complex64)
    p = design_agc(8000.0, 5.0, 50.0, 0.3)
    b0 = onepole_two_rate.onepole_two_rate.launches
    yg, eg = agc_rms(torch.as_tensor(x, device=cuda), p)
    yc, ec = agc_rms(torch.as_tensor(x), p)
    key = (np.arange(4000) // 500 % 2).astype(np.float32)
    cg, _ = P.cw_mod(key, 8000.0, 700.0, device=cuda)
    cc, _ = P.cw_mod(key, 8000.0, 700.0, device="cpu")
    torch.cuda.synchronize()
    assert onepole_two_rate.onepole_two_rate.launches == b0 + 2
    # the envelope is exact; the gain's sqrt/divide and the phase ramp's
    # cos/sin round on the card as torch rounds them there
    assert torch.equal(eg.cpu(), ec)
    assert float((yg.cpu() - yc).abs().max()) <= 1e-5 * float(yc.abs().max())
    assert float((cg.cpu() - cc).abs().max()) <= 1e-5
    bits = rng.integers(0, 2, 200).astype(np.uint8)
    iq, _ = P.bpsk31_mod_bits(bits, 8000.0, rf_hz=1000.0, device="cpu")
    b1 = psk31_pll.psk31_pll.launches
    soft = P.bpsk31_demod(iq, 8000.0, 1000.0, device=cuda)
    assert np.array_equal(P.bpsk31_decide(soft), bits)
    text = P.bpsk31_mod_text("CUDA PSK31", 8000.0, rf_hz=900.0, device="cpu")
    st = P.Psk31Stream.new_bpsk(8000.0, 900.0, device=cuda)
    out = "".join(st.feed(text[i:i + 5000].numpy())
                  for i in range(0, len(text), 5000)) + st.flush()
    assert "CUDA PSK31" in out
    assert psk31_pll.psk31_pll.launches > b1 + 1


def test_fm_chain_on_the_card_matches_the_cpu(cuda):
    """fm_demod (delay-conjugate product, atan2_approx, the chunked LR4
    matmuls) on the card against the CPU on the same IQ: 1e-5 of the
    peak."""
    audio = (0.5 * np.sin(2 * np.pi * 1000.0 * np.arange(1 << 16) / 480e3)
             ).astype(np.float32)
    iq, _ = P.fm_mod(np.stack([audio, -audio]), 480e3, 75e3, device="cpu")
    out = {}
    for dev in (cuda, "cpu"):
        out[str(dev)], _ = P.fm_demod(iq, 480e3, 75e3, 5e3, device=dev)
    ref = out["cpu"]
    assert float((out[str(cuda)].cpu() - ref).abs().max()) <= 1e-5 * float(
        ref.abs().max())


def test_float32_products_ignore_the_callers_tf32(cuda):
    """With the caller's TF32 switches on, the chunked LR4 matmuls of
    fm_demod and the PSK31 matched filter give what they give with TF32
    off, bit for bit: every float32 product runs under full_f32."""
    from orion_sdr_tpu_torch.demodulate.psk31 import matched_filter_dots
    from orion_sdr_tpu_torch.modulate.psk31 import psk31_hann
    rng = np.random.default_rng(5)
    iq = torch.as_tensor((rng.standard_normal((4, 1 << 14))
                          + 1j * rng.standard_normal((4, 1 << 14)))
                         .astype(np.complex64), device=cuda)
    h = torch.as_tensor(psk31_hann(256), device=cuda)
    seg = iq.reshape(4, -1, 256)
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    out = {}
    try:
        for on in (False, True):
            for f in flags:
                f.allow_tf32 = on
            audio, _ = P.fm_demod(iq, 480e3, 75e3, 5e3, device=cuda)
            out[on] = (audio, matched_filter_dots(seg, h))
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])


# ── slice 5a: channelizers, band receivers, FM stereo + RDS, CSS, WSPR ──────

def _noise_iq(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * scale
            ).astype(np.complex64)


def _close_on_card(got, ref, rtol=1e-5):
    ref = ref.cpu() if isinstance(ref, torch.Tensor) else torch.as_tensor(ref)
    assert got.shape == ref.shape
    scale = max(float(ref.abs().max()), 1e-30)
    assert float((got.cpu() - ref).abs().max()) <= rtol * scale


@pytest.mark.parametrize("passband", [None, 0.49e6])
def test_channelizer_on_the_card_matches_the_cpu(cuda, passband):
    """Both FIR routes (291 taps by conv1d, 2897 by FFT overlap-save): the
    card within 1e-5 of the CPU's peak, carried phases exact, and the
    card's output equal under two chunkings (the fixed internal block)."""
    from orion_sdr_tpu_torch.dsp.channelizer import Channelizer
    x = _noise_iq(70_001, 2)
    outs = {}
    for dev, chunk in ((cuda, 20_000), (cuda, 7_001), ("cpu", 70_001)):
        ch = Channelizer(8e6, 1e6, [-2.1e6, 0.3e6, 1.5e6],
                         passband_hz=passband, device=dev)
        parts = [ch.push(x[i:i + chunk]) for i in range(0, len(x), chunk)]
        outs[str(dev), chunk] = (torch.cat(parts + [ch.flush()], dim=-1),
                                 ch._phase)
    ref, ph = outs["cpu", 70_001]
    got, gph = outs[str(cuda), 20_000]
    _close_on_card(got, ref)
    assert torch.equal(gph.cpu(), ph)
    assert torch.equal(got, outs[str(cuda), 7_001][0])


def test_pfb_and_band_compose_on_the_card_match_the_cpu(cuda):
    x = _noise_iq(1 << 16, 3)
    _close_on_card(P.pfb_channelize(x, 64, device=cuda),
                   P.pfb_channelize(x, 64, device="cpu"), rtol=2e-6)
    chans = _noise_iq(3 * 3000, 4).reshape(3, 3000)
    _close_on_card(P.band_compose(chans, [-2e6, 0.1e6, 3e6], 8e6, 1e6,
                                  device=cuda),
                   P.band_compose(chans, [-2e6, 0.1e6, 3e6], 8e6, 1e6,
                                  device="cpu"))


def _upsample(x, m):
    x = np.concatenate([np.zeros(256), np.asarray(x, np.complex128),
                        np.zeros(256)])
    X = np.fft.fft(x)
    n = len(x)
    Y = np.zeros(m * n, np.complex128)
    Y[: n // 2] = X[: n // 2]
    Y[-(n - n // 2):] = X[n // 2:]
    return m * np.fft.ifft(Y)


def _wideband(parts, centers, starts, n_wide, fs_wide, m, seed, noise):
    wide = np.zeros(n_wide, np.complex128)
    k = np.arange(n_wide)
    for x, fc, start in zip(parts, centers, starts):
        u = _upsample(x, m)
        wide[start:start + len(u)] += u * np.exp(
            2j * np.pi * fc * k[start:start + len(u)] / fs_wide)
    wide = wide.astype(np.complex64)
    sig = float(np.mean(np.abs(wide) ** 2))
    return wide + _noise_iq(n_wide, seed, np.sqrt(sig * noise / 2))


def _band_run(rx, wide, chunk):
    got = {}
    for i in range(0, len(wide), chunk):
        for c, res in rx.feed(wide[i:i + chunk]).items():
            got.setdefault(c, []).extend(res)
    for c, res in rx.flush().items():
        got.setdefault(c, []).extend(res)
    return got


def test_cofdm_band_receive_launches_the_bp_kernel(cuda):
    """tests/test_frame.py:487's three links at 8 MS/s on the card: every
    payload back under two chunkings, BP launches counted."""
    cfg = P.OfdmConfig(P.CarrierPlan(256, 64).with_contiguous_data(
        edge_guard=16), fs=1e6)
    pre = P.OfdmPreamble(repeat_len=128, num_repeats=4).with_training_symbol(
        256, 64)
    table = P.McsTable.default_ladder()
    payloads = [np.random.default_rng(40 + i).integers(0, 256, 120).astype(
        np.uint8) for i in range(3)]
    mod = P.OfdmFrameMod(cfg, table, pre, device=cuda)
    frames = [mod.modulate_frame(P.FramePacket(P.FrameMetadata(i, 1), p), i)
              for i, p in enumerate(payloads)]
    centers = [-2.1e6, 0.3e6, 1.5e6]
    wide = _wideband([f / 8.0 for f in frames], centers,
                     [3000 + 9000 * i for i in range(3)], 120_000, 8e6, 8,
                     50, 0.001)
    for chunk in (37_003, 50_000):
        b0 = ldpc_bp.bp_decode_kernel.launches
        rx = P.OfdmFrameBandStreamDemod(cfg, table, pre, centers, 8e6,
                                        device=cuda)
        got = _band_run(rx, wide, chunk)
        torch.cuda.synchronize()
        assert ldpc_bp.bp_decode_kernel.launches > b0
        for c, p in enumerate(payloads):
            ok = [r for r in got.get(c, []) if isinstance(r, P.RxFrame)]
            assert ok and np.array_equal(ok[0].packet.payload, p), c


def test_dvb_t_band_receive_launches_the_viterbi_kernel(cuda):
    """tests/test_dvb_t.py:377's two muxes on the card: both payloads and
    cell ids back, radix-2 Viterbi launches counted, none of radix 4."""
    params = P.DvbTFrameParams(P.DvbTLinkParams("1/32", "qpsk", "1/2"), 0, 5)
    rng = np.random.default_rng(3)
    payloads = [rng.integers(0, 256, 300).astype(np.uint8) for _ in range(2)]
    mod = P.DvbTFrameMod(params, device=cuda)
    frames = [mod.modulate(p) for p in payloads]
    fs = 1201173.0205278592           # dvb_t_fs_for_bandwidth(1 MHz)
    centers = [-1.4e6, 1.1e6]
    n_wide = max(len(_upsample(f.iq, 4)) for f in frames) + 40_000
    wide = _wideband([f.iq for f in frames], centers, [8_000, 12_000],
                     n_wide, 4 * fs, 4, 3, 0.002)
    k = viterbi.viterbi_chunks_kernel
    r2, r4 = k.launches, k.launches_radix4
    rx = P.DvbTBandStreamDemod(params, frames[0].n_symbols, 300, centers, fs,
                               4 * fs, device=cuda)
    got = _band_run(rx, wide, 120_000)
    torch.cuda.synchronize()
    assert k.launches > r2 and k.launches_radix4 == r4
    for c, p in enumerate(payloads):
        ok = [r for r in got.get(c, []) if isinstance(r, P.DvbTRxFrame)]
        assert ok and np.array_equal(ok[0].payload, p), c
        assert ok[0].tps.cell_id == 5


def test_am_ssb_band_on_the_card_match_the_cpu(cuda):
    fs = 480_000.0
    t = np.arange(1 << 16) / fs
    a = (0.5 * np.sin(2 * np.pi * 900 * t)).astype(np.float32)
    ssb, _ = P.ssb_mod(a, fs, 2800.0, 1500.0, 0.0, device="cpu")
    am, _ = P.am_mod(a, fs, device="cpu")
    band = (rotate(ssb, -40e3, fs)[0] + rotate(am, 100e3, fs)[0]
            ).numpy() + _noise_iq(len(t), 6, 0.005)
    for fn, centers in ((P.ssb_band_demod, [-40e3]),
                        (P.am_band_demod, [100e3])):
        got = fn(band, fs, centers, device=cuda)
        ref = fn(band, fs, centers, device="cpu")
        assert len(got) == len(ref) == 1
        _close_on_card(got[0].audio, ref[0].audio)


def _stereo_iq(n, fs, rds=True, seed=None):
    t = np.arange(n) / fs
    left = (0.8 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32)
    right = (0.8 * np.sin(2 * np.pi * 2500 * t)).astype(np.float32)
    bits = P.rds_encode_groups(P.rds_groups_0a(0x52A1, ps_name="ORIONFM ")
                               + P.rds_groups_2a(0x52A1,
                                                 radiotext="CUDA SDR"))
    iq, _ = P.fm_stereo_mod(left, right, fs, rds_bits=bits if rds else None,
                            device="cpu")
    iq = iq.numpy()
    if seed is not None:
        iq = iq + _noise_iq(n, seed, np.sqrt(1.0 / 10 ** 1.5 / 2))
    return iq


def test_fm_stereo_on_the_card_matches_the_cpu(cuda):
    """The stereo program on the card against the CPU (mono, difference,
    pilot, RDS baseband within 1e-5 of their peaks), and the RDS bits and
    text of a 15 dB capture equal on both."""
    from orion_sdr_tpu_torch.demodulate.fm_stereo import _stereo_device
    fs = 240_000.0
    iq = _stereo_iq(1 << 18, fs, seed=5)
    z = torch.as_tensor(iq)
    args = (fs, 75e3, 15e3, 0.9, True)
    ref = _stereo_device(z.real.contiguous(), z.imag.contiguous(), *args)
    zg = z.to(cuda)
    got = _stereo_device(zg.real.contiguous(), zg.imag.contiguous(), *args)
    for g, r in zip(got, ref):
        _close_on_card(g, r)
    a = P.fm_stereo_demod(iq, fs, decode_rds=True, device=cuda)
    b = P.fm_stereo_demod(iq, fs, decode_rds=True, device="cpu")
    assert np.array_equal(a.rds_bits, b.rds_bits)
    assert a.rds.ps_name == "ORIONFM " and a.rds.radiotext == "CUDA SDR"


def test_css_on_the_card(cuda):
    """The dechirp FFT on the card against the CPU; the roundtrip at an
    unknown offset at 10 dB for SF 7 and 12 on the card."""
    from orion_sdr_tpu_torch.demodulate.css import _base_tensor, _dechirp_fft
    z = _noise_iq(128 * 512, 7)
    got = _dechirp_fft(torch.as_tensor(z, device=cuda),
                       _base_tensor(9, 125e3, 125e3, False, cuda), 128, 512,
                       512)
    ref = _dechirp_fft(torch.as_tensor(z),
                       _base_tensor(9, 125e3, 125e3, False, "cpu"), 128, 512,
                       512)
    _close_on_card(got, ref)
    for sf in (7, 12):
        iq = P.css_mod(b"hello chirp world", sf=sf, device=cuda).cpu().numpy()
        buf = np.concatenate([np.zeros(777, np.complex64), iq,
                              np.zeros(500, np.complex64)])
        buf = buf + _noise_iq(len(buf), sf, np.sqrt(0.1 / 2))
        out = P.css_demod(buf, sf=sf, device=cuda)
        assert out is not None and out.crc_ok
        assert out.payload == b"hello chirp world"


def test_wspr_on_the_card(cuda):
    """The energy grid on the card against the CPU (2e-5 of its peak) and
    tests/test_wspr.py's three-beacon band decoded on the card."""
    from orion_sdr_tpu_torch.demodulate.wspr import _energy_grid
    b = [P.wspr_mod(c, g, d, base_hz=f, device=cuda).cpu().numpy() * a
         for c, g, d, f, a in (("K1ABC", "FN42", 30, 1420.0, 1.0),
                               ("W1AW", "FN31", 37, 1500.0, 0.5),
                               ("DL2XYZ", "JO62", 23, 1570.0, 0.25))]
    n = len(b[0]) + 30000
    band = np.zeros(n, np.complex64)
    for x, start in zip(b, (0, 8000, 20000)):
        band[start:start + len(x)] += x
    band += _noise_iq(n, 0, 0.05)
    dts = tuple(int(d) for d in np.arange(-4, 5) * 1024)
    dfs = np.linspace(-2.0, 2.0, 7).astype(np.float32)
    got = _energy_grid(torch.as_tensor(band, device=cuda), dts, dfs,
                       12_000.0, 1500.0)
    ref = _energy_grid(torch.as_tensor(band), dts, dfs, 12_000.0, 1500.0)
    _close_on_card(got, ref, rtol=2e-5)
    out = {m.callsign: (m.grid, m.dbm)
           for m in P.wspr_decode_band(band, device=cuda)}
    assert out == {"K1ABC": ("FN42", 30), "W1AW": ("FN31", 37),
                   "DL2XYZ": ("JO62", 23)}


# ── slice 5b: the DD-PLL, Gardner and GNSS tracking kernels ─────────────────

def _ramped_symbols(order, rows, n, seed, cfo=0.013):
    """Constellation symbols of ``order`` behind a phase offset and a
    ramp (rows, n), with light noise: φ grows to hundreds of radians on
    the long rows, so cosf/sinf take large arguments."""
    from orion_sdr_tpu_torch.constellation import bits_per_symbol
    rng = np.random.default_rng(seed)
    bits = torch.as_tensor(rng.integers(0, 2, (
        max(rows, 1), n * bits_per_symbol(order))).astype(np.uint8))
    s = P.map_bits(bits, order).numpy()[:rows]
    k = np.arange(n)
    z = s * np.exp(1j * (rng.uniform(0, 6, (rows, 1)) + cfo * k)) + 0.02 * (
        rng.standard_normal((rows, n)) + 1j * rng.standard_normal((rows, n)))
    return z.astype(np.complex64)


@pytest.mark.parametrize("shape", [(1, 1), (4, 1024), (33, 200), (5, 0),
                                   (0, 7), (65, 33)])
@pytest.mark.parametrize("order", ["bpsk", "qpsk", "qam16", "qam64",
                                   "qam256"])
def test_dd_pll_kernel_is_exact(cuda, order, shape):
    from orion_sdr_tpu_torch.ops import dd_pll as K
    z = torch.as_tensor(_ramped_symbols(order, *shape, seed=shape[0]),
                        device=cuda)
    before = K.dd_pll.launches
    got = K.dd_pll(z, order, 0.03)
    ref = K.dd_pll_reference(z, order, 0.03)
    torch.cuda.synchronize()
    assert K.dd_pll.launches == before + (1 if z.numel() else 0)
    assert got.shape == ref.shape and torch.equal(got, ref)


def test_dd_pll_kernel_exact_on_a_long_tracked_burst(cuda):
    """16 384 QPSK symbols behind a 0.2 rad/symbol carrier offset that the
    loop (bandwidth 0.1) tracks: φ grows past 3 000 rad, so the kernel's
    sincosf and the plain version's cos and sin take large arguments; two
    rows, exact, and locked (the derotated symbols sit on the grid up to a
    quarter turn)."""
    from orion_sdr_tpu_torch.ops import dd_pll as K
    n = 16384
    z = _ramped_symbols("qpsk", 2, n, seed=5, cfo=0.2)
    zc = torch.as_tensor(z, device=cuda)
    got = K.dd_pll(zc, "qpsk", 0.1)
    ref = K.dd_pll_reference(zc, "qpsk", 0.1)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    y = got.cpu().numpy()
    phi = np.unwrap(np.angle(z * np.conj(y)), axis=-1)
    assert np.all(np.abs(phi[:, -1]) > 3000.0)
    rot = np.angle(y[:, 2000:] ** 4) / 4      # the quarter-turn ambiguity
    assert float(np.abs(rot - np.pi / 4 * np.sign(rot)).max()) < 0.2


def test_sincosf_gives_the_bits_of_cosf_and_sinf(cuda):
    """The DD-PLL and tracking kernels take cos and sin from one sincosf;
    their plain versions call torch.cos and torch.sin (cosf, sinf on the
    card). Every float32 input, all 2^32 bit patterns: the same bits."""
    from orion_sdr_tpu_torch.ops import dd_pll as K
    assert K.sincos_mismatches(cuda) == 0


@pytest.mark.parametrize("mu0,n_out", [(3.0, 120), (-2.5, 120),
                                       (1.0, 160)])
def test_gardner_kernel_is_exact_at_the_edges(cuda, mu0, n_out):
    """A start before the capture (the interpolator extrapolates from
    samples 0 and 1) and more symbols than the capture holds (the index
    clips at n − 2 and extrapolates past the end)."""
    from orion_sdr_tpu_torch.ops import gardner as K
    bits = np.random.default_rng(7).integers(0, 2, (3, 2 * 150)).astype(
        np.uint8)
    z = P.burst_mod(bits, "qpsk", 8, device=cuda)[:, :1000]
    before = K.gardner.launches
    s, pos = K.gardner(z, 8.0, n_out, 0.02, mu0)
    zn = K.normalise(z.reshape(3, -1)).contiguous()
    rs, rpos = K.gardner_reference(zn, 8.0, n_out, 0.02, mu0)
    torch.cuda.synchronize()
    assert K.gardner.launches == before + 1
    assert torch.equal(s, rs) and torch.equal(pos, rpos)
    if n_out == 160:
        assert float(pos.min()) > 1000       # it ran off the end


def test_gardner_kernel_takes_empty_batches(cuda):
    from orion_sdr_tpu_torch.ops import gardner as K
    before = K.gardner.launches
    s, pos = K.gardner(torch.zeros((0, 64), dtype=torch.complex64,
                                   device=cuda), 8.0, 5)
    assert tuple(s.shape) == (0, 5) and tuple(pos.shape) == (0,)
    s, pos = K.gardner(torch.zeros((4, 0), dtype=torch.complex64,
                                   device=cuda), 8.0, 0)
    assert tuple(s.shape) == (4, 0) and float(pos[0]) == 8.0
    assert K.gardner.launches == before


def _track_case(device):
    """PRN 5 at 615 samples, PRN 6 with its epoch at sample 0 (its early
    slice starts at −1 and wraps, as lax.dynamic_slice's does), PRN 7
    absent; 90 epochs over a 70 ms capture, so every satellite runs past
    the end, where the slices clamp at n − spms."""
    from orion_sdr_tpu_torch.gnss import _ca_pm_sampled
    fs = 2.048e6
    rng = np.random.default_rng(3)
    nav = rng.integers(0, 2, 6).astype(np.uint8)
    z = P.gps_ca_mod(5, fs, 70, 1840.0, 300.4, nav_bits=nav) \
        + P.gps_ca_mod(6, fs, 70, 2500.0, 0.0, amplitude=0.8)
    z = (z + 0.3 * (rng.standard_normal(len(z))
                    + 1j * rng.standard_normal(len(z)))).astype(np.complex64)
    codes = np.stack([_ca_pm_sampled(p, fs) for p in (5, 6, 7)])
    return (torch.as_tensor(z, device=device), torch.as_tensor(
        codes, device=device), torch.tensor([615, 0, 1000], dtype=torch.int32,
                                            device=device),
            torch.tensor([1900.0, 2450.0, -300.0], device=device), fs)


def test_gnss_track_kernel_is_exact_at_the_edges(cuda):
    from orion_sdr_tpu_torch.ops import gnss_track as K
    z, codes, starts, f0, fs = _track_case(cuda)
    before = K.gnss_track.launches
    got = K.gnss_track(z, codes, starts, f0, fs, 90, 7.2, 0.9, 0.12)
    ref = K.track_reference(z, codes, starts, f0, fs, 90, 7.2, 0.9, 0.12)
    torch.cuda.synchronize()
    assert K.gnss_track.launches == before + 1
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert int(got[2][:, -1].min()) > z.shape[0]


def test_gnss_track_kernel_takes_empty_batches(cuda):
    from orion_sdr_tpu_torch.ops import gnss_track as K
    z, codes, starts, f0, fs = _track_case(cuda)
    before = K.gnss_track.launches
    out = K.gnss_track(z, codes[:0], starts[:0], f0[:0], fs, 5, 7.2, 0.9,
                       0.12)
    assert tuple(out[0].shape) == (0, 5)
    out = K.gnss_track(z, codes, starts, f0, fs, 0, 7.2, 0.9, 0.12)
    assert tuple(out[2].shape) == (3, 0)
    assert K.gnss_track.launches == before


def _track_exact(K, z, codes, starts, f0, fs, n_ep, k_dll):
    """One launch against the plain version, exact; its window misses
    equal the window model's. Returns (outputs, misses)."""
    got = K.gnss_track(z, codes, starts, f0, fs, n_ep, 7.2, 0.9, k_dll)
    misses = K.gnss_track.last_misses
    ref = K.track_reference(z, codes, starts, f0, fs, n_ep, 7.2, 0.9, k_dll)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    d_el = K.loop_constants(fs, codes.shape[1], 7.2, 0.9, k_dll)["d_el"]
    want = K.window_misses(starts, got[2], z.shape[0], codes.shape[1], d_el)
    assert torch.equal(misses.cpu(), want.cpu())
    return got, misses.cpu()


def test_gnss_track_window_misses_at_the_capture_edges(cuda):
    """PRN 6's first epoch wraps its early slice to the capture's end and
    every satellite's last epochs clamp at n − spms: those epochs read
    device memory, counted, and the result stays exact."""
    from orion_sdr_tpu_torch.ops import gnss_track as K
    z, codes, starts, f0, fs = _track_case(cuda)
    _, misses = _track_exact(K, z, codes, starts, f0, fs, 90, 0.12)
    assert int(misses.min()) > 0 and int(misses.max()) < 90


def test_gnss_track_exact_when_the_code_leaves_the_window(cuda):
    """A DLL gain of 5 moves the code NCO up to ~10 samples an epoch, past
    the window's margin M: epochs inside the capture read device memory,
    and the result stays exact."""
    from orion_sdr_tpu_torch.ops import gnss_track as K
    z, codes, starts, f0, fs = _track_case(cuda)
    got, misses = _track_exact(K, z, codes, starts, f0, fs, 60, 5.0)
    steps = torch.diff(torch.cat([starts[:, None], got[2]], 1).long(), dim=1)
    assert bool(((steps - codes.shape[1]).abs() > K.WINDOW_MARGIN + 1).any())
    assert int(misses.sum()) > 0 and int(misses.max()) < 60


@pytest.mark.parametrize("threads", [128, 256, 512])
def test_gnss_track_kernel_is_exact_at_each_width(cuda, threads,
                                                  monkeypatch):
    """The widths chip_smoke [41] sweeps: kernel and plain version follow
    ``THREADS`` together."""
    from orion_sdr_tpu_torch.ops import gnss_track as K
    monkeypatch.setattr(K, "THREADS", threads)
    z, codes, starts, f0, fs = _track_case(cuda)
    _track_exact(K, z, codes, starts, f0, fs, 40, 0.12)


def test_burst_demod_runs_through_the_dd_pll_kernel(cuda):
    """tests/test_digital.py's burst on the card: every bit back, one
    DD-PLL launch, and the payload symbols equal the CPU path's within
    1e-5 (the matched filter and normalisation on the card)."""
    from orion_sdr_tpu_torch.dsp.osc import rotate as prot
    from orion_sdr_tpu_torch.ops import dd_pll as K
    sps, pre = 8, P.burst_preamble(32)
    bits = np.random.default_rng(0).integers(0, 2, 1024).astype(np.uint8)
    iq = P.burst_mod(bits, "qam16", sps, preamble_syms=pre, device="cpu")
    z = torch.cat([torch.zeros(37, dtype=torch.complex64), iq,
                   torch.zeros(50, dtype=torch.complex64)])
    z = prot(z, 0.0021 * sps, float(sps))[0] * np.exp(1j * 1.1)
    z = (z + torch.as_tensor(_noise_iq(z.shape[0], 1, 0.02))).to(
        torch.complex64).numpy()
    before = K.dd_pll.launches
    got, payload = P.burst_demod(z, "qam16", sps, pre, device=cuda)
    torch.cuda.synchronize()
    assert K.dd_pll.launches == before + 1
    assert np.array_equal(got.cpu().numpy()[:1024], bits)
    _, ref = P.burst_demod(z, "qam16", sps, pre, device="cpu")
    _close_on_card(payload, ref)


def test_symbol_sync_gardner_runs_through_the_kernel(cuda):
    from orion_sdr_tpu_torch.ops import gardner as K
    bits = np.random.default_rng(1).integers(0, 2, 2048).astype(np.uint8)
    zf = P.burst_mod(bits, "qpsk", 8, device=cuda)
    before = K.gardner.launches
    syms, _ = P.symbol_sync_gardner(zf, 8.0, zf.shape[-1] // 8 - 10,
                                    mu0=3.0, device=cuda)
    torch.cuda.synchronize()
    assert K.gardner.launches == before + 1
    mags = syms[200:].abs()
    assert float(mags.std()) < 0.25 * float(mags.mean())


def test_gps_track_runs_through_the_kernel(cuda):
    """tests/test_gnss.py's tracking case on the card: one kernel launch,
    the nav bits sent, and the same bits and epoch positions as the CPU
    path."""
    from orion_sdr_tpu_torch.ops import gnss_track as K
    fs = 2.048e6
    rng = np.random.default_rng(3)
    nav = rng.integers(0, 2, 40).astype(np.uint8)
    z = P.gps_ca_mod(5, fs, len(nav) * 20 + 30, 1840.0, 300.4, nav_bits=nav)
    z = (z + 0.7 / np.sqrt(2) * (rng.standard_normal(len(z))
                                 + 1j * rng.standard_normal(len(z)))
         ).astype(np.complex64)
    acq = P.gps_acquire(z, fs, prns=[5], device=cuda)
    assert acq and acq[0].prn == 5
    assert [a[:3] for a in acq] == [
        a[:3] for a in P.gps_acquire(z, fs, prns=[5], device="cpu")]
    args = (z, fs, 5, acq[0].doppler_hz + 150.0, acq[0].code_phase_samples)
    before = K.gnss_track.launches
    tr = P.gps_track(*args, device=cuda)
    assert K.gnss_track.launches == before + 1
    ref = P.gps_track(*args, device="cpu")
    assert np.array_equal(tr.nav_bits, ref.nav_bits)
    assert np.abs(tr.code_phase - ref.code_phase).max() <= 1e-3
    core = tr.nav_bits[1:-1]
    s = "".join(map(str, nav.tolist()))
    assert ("".join(map(str, core.tolist())) in s
            or "".join(map(str, (1 - core).tolist())) in s)


def test_fsk2_family_on_the_card(cuda):
    """The decision waveform on the card against the CPU (1e-5 of its
    peak) and an AX.25 beacon, POCSAG pages and AIS reports decoded on
    the card."""
    x = _noise_iq(1 << 14, 9).real.reshape(2, -1).copy()
    _close_on_card(P.demodulate.fsk2_decision(x, 48_000.0, 40, device=cuda),
                   P.demodulate.fsk2_decision(x, 48_000.0, 40, device="cpu"))
    f = P.Ax25Frame(dest="APRS", src="K1ABC-9", payload=b">on the card")
    audio = P.ax25_beacon([f], 48_000.0, device=cuda)
    assert P.ax25_decode(audio, 48_000.0, device=cuda) == [f]
    pages = [P.PocsagPage(address=0x12345, function=3, text="CARD PAGE")]
    iq = P.pocsag_mod(pages, 38_400.0, device=cuda)
    assert P.pocsag_decode(iq, 38_400.0, device=cuda) == pages
    ship = [P.AisPosition(mmsi=211234567, lat=53.5421, lon=9.9845,
                          sog_kt=12.3, cog_deg=87.5, heading_deg=88)]
    iq = P.ais_mod(ship, device=cuda)
    assert P.ais_decode(iq, 96_000.0, device=cuda) == ship


# ── slice 6a: the channel simulator, SSTV, ADS-B, Morse, band decode ────────

_CHANNEL_CASES = {
    "cfo": lambda x, d: P.cfo_apply(x, -1234.5, 48e3, 0.3, device=d),
    "phase_noise": lambda x, d: P.phase_noise_apply(
        np.random.default_rng(3), x, 20.0, 48e3, device=d),
    "iq_imbalance": lambda x, d: P.iq_imbalance_apply(x, 1.0, 5.0, device=d),
    "multipath": lambda x, d: P.multipath_apply(
        x, [0, 7, 300], [1.0, 0.5j, 0.2 - 0.1j], device=d),
    "fading": lambda x, d: P.fading_apply(
        x, 48e3, P.fading_taps(np.random.default_rng(7), 64, 16.0, 2.0,
                               n_paths=2), 16.0, [0, 11], [0.0, -3.0],
        device=d),
    "watterson": lambda x, d: P.watterson_apply(
        np.random.default_rng(21), x, 48e3, 2e-3, 1.0, device=d),
}


@pytest.mark.parametrize("name", sorted(_CHANNEL_CASES))
def test_channel_impairment_on_the_card_matches_the_cpu(cuda, name):
    """(4, 2^16) IQ through each impairment (the same numpy draws): the
    card within 1e-5 of the CPU's peak."""
    x = _noise_iq(4 << 16, 31).reshape(4, -1)
    fn = _CHANNEL_CASES[name]
    got = fn(x, cuda)
    assert got.device.type == torch.device(cuda).type
    assert got.dtype == torch.complex64
    _close_on_card(got, fn(x, "cpu"))


def test_sstv_on_the_card(cuda):
    """The discriminator on the card against the CPU (1e-5 of its peak),
    and a Martin M1 picture modulated and decoded on the card: VIS 44 and
    PSNR above 35 dB."""
    from orion_sdr_tpu_torch.demodulate.sstv import _instantaneous_freq
    rng = np.random.default_rng(2)
    audio = rng.standard_normal((2, 1 << 16)).astype(np.float32)
    for fs in (11025.0, 48000.0):
        _close_on_card(_instantaneous_freq(torch.as_tensor(audio, device=cuda),
                                           fs),
                       _instantaneous_freq(torch.as_tensor(audio), fs))
    img = np.zeros((256, 320, 3), np.uint8)
    img[:, :, 0] = np.linspace(0, 255, 320)[None, :]
    img[:, :, 1] = np.linspace(0, 255, 256)[:, None]
    img[:128, :, 2] = 200
    out = P.sstv_demod(P.sstv_mod(img, 11025.0, device=cuda), 11025.0,
                       device=cuda)
    err = np.abs(out.image.astype(float) - img.astype(float))[3:-3, 6:-6]
    assert out.vis == 44
    assert 20 * np.log10(255 / np.sqrt(np.mean(err ** 2))) > 35.0


def test_adsb_on_the_card(cuda):
    """The preamble score on the card against the CPU (1e-5), and a busy
    sky decoded on the card with the CPU path's messages."""
    from orion_sdr_tpu_torch.demodulate.adsb import _envelope_and_score
    frames = [P.adsb_encode_identification(0x4840D6, "KLM1023"),
              P.adsb_encode_position(0x4840D6, 52.2572, 3.91937, 38000, 0),
              P.adsb_encode_position(0x4840D6, 52.2572, 3.91937, 38000, 1),
              P.adsb_encode_velocity(0x4840D6, 450.0, 245.0)]
    iq = P.adsb_mod(frames, 8e6, amplitudes=[1.0, 0.8, 0.8, 0.5],
                    device="cpu").numpy() + 0.05 * _noise_iq(
        int(round((3 * 200e-6 + 220e-6) * 8e6)), 4)
    for m in (1, 4):
        for got, ref in zip(_envelope_and_score(torch.as_tensor(
                iq, device=cuda), m), _envelope_and_score(
                torch.as_tensor(iq), m)):
            _close_on_card(got, ref)
    got = P.adsb_decode_capture(iq, 8e6, device=cuda)
    assert len(got) == 4 and got == P.adsb_decode_capture(iq, 8e6,
                                                          device="cpu")
    assert got[2].position is not None


def test_morse_band_decode_on_the_card(cuda):
    """Three keyed signals through cw_mod on the card (the two-rate
    one-pole kernel) decoded on the card: every text back."""
    fs, n = 8000.0, 8000 * 12
    buf = 0.02 * _noise_iq(n, 5)
    for text, wpm, tone, amp in (("CQ DX", 15.0, 500.0, 1.0),
                                 ("HELLO WORLD", 28.0, 900.0, 0.3),
                                 ("73 GL", 35.0, 1300.0, 0.1)):
        env = P.MorseEncoder(fs, wpm).with_jitter(10.0).encode_text(text)
        iq = P.cw_mod(env, fs, tone, device=cuda)[0].cpu().numpy()
        buf[4000:4000 + len(iq)] += amp * iq[:n - 4000]
    got = P.morse_decode_band(buf, fs, 400.0, 1500.0, device=cuda)
    assert sorted(r.text for r in got) == ["73 GL", "CQ DX", "HELLO WORLD"]


def test_band_decode_on_the_card(cuda):
    """AM and POCSAG in one 500 kHz capture, classified and decoded on the
    card: the labels, the page text and the AM tone; a torch error inside
    a receiver is not swallowed."""
    from orion_sdr_tpu_torch.dsp.osc import rotate as prot
    fs, n = 500_000.0, 1 << 19
    t = np.arange(n) / fs
    am = P.am_mod((0.6 * np.sin(2 * np.pi * 800 * t)).astype(np.float32),
                  fs, device="cpu")[0]
    pg = P.pocsag_mod([P.PocsagPage(address=0x123, function=3,
                                    text="PAGE ME NOW")] * 4, fs,
                      device="cpu")[:n]
    pg = torch.nn.functional.pad(pg, (0, n - pg.shape[0]))
    band = prot(am, -150e3, fs)[0] + 0.8 * prot(pg, 100e3, fs)[0]
    band = band + torch.as_tensor(_noise_iq(n, 0, 0.004))
    got = P.band_decode(band, fs, device=cuda)
    assert [e.signal.label for e in got] == ["am", "fsk"]
    assert got[1].text == "PAGE ME NOW"
    audio = got[0].audio.cpu().numpy()[2000:]
    f = np.fft.rfftfreq(len(audio), 1 / got[0].fs_audio)
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
    assert abs(f[np.argmax(spec[5:]) + 5] - 800.0) < 10.0


def test_top_level_has_the_slice_6a_names(cuda):
    """The port's top level on the card machine carries every name the
    JAX package's ``__init__`` exports from the modules of slice 6a (read
    from its source, not imported)."""
    import ast
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "orion_sdr_tpu", "__init__.py")) as f:
        tree = ast.parse(f.read())
    mods = ("io", "channel", "classify", "codec.morse", "codec.adsb",
            "modulate.adsb", "demodulate.adsb", "modulate.sstv",
            "demodulate.sstv")
    names = [a.asname or a.name for node in tree.body
             if isinstance(node, ast.ImportFrom) and node.level == 1
             and node.module in mods for a in node.names]
    assert len(names) == 36 and hasattr(P, "io")
    assert [n for n in names if not hasattr(P, n)] == []


def test_ofdm_receive_and_otfs_on_the_card_match_the_cpu(cuda):
    """``ofdm_demod`` with a held estimate, ``mmse_equalize`` and OTFS
    under LMMSE on the card against the CPU path: soft symbols within 1e-5
    of the peak, hard bits equal."""
    cfg = P.dvb_t_config("1/4", 7.61e6)
    rng = np.random.default_rng(48)
    bits = rng.integers(0, 2, (4, 8 * cfg.bits_per_ofdm_symbol())
                        ).astype(np.uint8)
    est = (1 + 0.3 * rng.standard_normal(2048)
           + 0.3j * rng.standard_normal(2048)).astype(np.complex64)
    for dev in ("cpu", cuda):
        iq, _ = P.ofdm_mod(cfg, bits, device=dev)
        soft, _ = P.ofdm_demod(cfg, iq * torch.as_tensor(
            np.complex64(0.7 - 0.2j), device=iq.device),
            estimate=np.full(2048, 0.7 - 0.2j, np.complex64))
        dd, _ = P.otfs_demod(cfg, P.otfs_mod(cfg, bits, 8, device=dev)[0]
                             * torch.as_tensor(est[:1], device=iq.device),
                             8, estimate=est[:1].repeat(2048),
                             noise_var=0.01)
        if dev == "cpu":
            ref_soft, ref_dd = soft, dd
    for got, ref in ((soft, ref_soft), (dd, ref_dd)):
        assert got.device.type == "cuda"
        err = float((got.cpu() - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max())
    assert torch.equal(P.ofdm_decide(cfg, soft).cpu(),
                       P.ofdm_decide(cfg, ref_soft))
    assert torch.equal(P.ofdm_decide(cfg, soft).cpu(),
                       torch.as_tensor(bits))


def test_blocks_launch_their_kernels_on_the_card(cuda):
    """Bpsk31Demod (PSK31 PLL), CwKeyedMod (two-rate one-pole) and
    Ft8Codec.decode_soft (BP) on the card: one launch a call, output equal
    to the CPU block's (texts, payloads exact; IQ within 1e-5)."""
    from orion_sdr_tpu_torch.ops import onepole_two_rate, psk31_pll
    iq = P.Bpsk31Mod(8000.0, 700.0, device="cpu").modulate_text("card")
    psk31_pll.psk31_pll.launches = 0
    card = P.Bpsk31Demod(8000.0, 700.0, device=cuda)
    soft = np.concatenate([card.process(iq[:20_000]),
                           card.process(iq[20_000:])])
    assert psk31_pll.psk31_pll.launches == 2
    host = P.Bpsk31Demod(8000.0, 700.0, device="cpu")
    ref = np.concatenate([host.process(iq[:20_000]),
                          host.process(iq[20_000:])])
    assert np.array_equal(soft >= 0, ref >= 0)
    assert "card" in P.VaricodeDecoder().push_bits(
        P.Bpsk31Decider(device=cuda).process(soft))
    key = np.zeros(48_000, np.float32)
    key[1000:30_000] = 1.0
    onepole_two_rate.onepole_two_rate.launches = 0
    out = P.CwKeyedMod(48e3, 700.0, device=cuda).process(key)
    assert onepole_two_rate.onepole_two_rate.launches == 1
    np.testing.assert_allclose(out, P.CwKeyedMod(48e3, 700.0, device="cpu")
                               .process(key), rtol=0, atol=1e-5)
    payload = P.ft8_pack_free_text("CARD 73")
    codec = P.Ft8Codec(device=cuda)
    tones = codec.encode(payload)
    llr = P.codec.ft8.ft8_frame_llr_hard(tones)
    ldpc_bp.bp_decode_kernel.launches = 0
    assert codec.decode_soft(llr) == payload
    assert ldpc_bp.bp_decode_kernel.launches == 1


def test_checkpoint_moves_between_the_card_and_the_cpu(cuda, tmp_path):
    """A QPSK31 stream checkpointed on the card finishes on the CPU with
    the uninterrupted text, and a COFDM stream checkpointed on the CPU
    resumes on the card with its buffer there."""
    msg = "from the card"
    iq = P.qpsk31_mod_text(msg, 8000.0, 1000.0, device="cpu").numpy()
    one = P.Psk31Stream.new_qpsk(8000.0, 1000.0, device="cpu")
    want = one.feed(iq) + one.flush()
    a = P.Psk31Stream.new_qpsk(8000.0, 1000.0, device=cuda)
    got = a.feed(iq[:len(iq) // 2 + 99])
    path = str(tmp_path / "q.npz")
    P.save_checkpoint(path, a)
    b = P.load_checkpoint(path, P.Psk31Stream.new_qpsk(8000.0, 1000.0,
                                                       device="cpu"))
    assert got + b.feed(iq[len(iq) // 2 + 99:]) + b.flush() == want
    assert msg in want
    plan = P.CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    cfg = P.OfdmConfig(plan, fs=1e6)
    pre = P.OfdmPreamble(repeat_len=128, num_repeats=4
                         ).with_training_symbol(256, 64)
    table = P.McsTable.default_ladder()
    payload = np.arange(150, dtype=np.uint8)
    fr = P.OfdmFrameMod(cfg, table, pre, device="cpu").modulate_frame(
        P.FramePacket(P.FrameMetadata(3, 1), payload), 5)
    buf = np.concatenate([np.zeros(500, np.complex64), fr,
                          np.zeros(100, np.complex64)])
    s = P.OfdmFrameStreamDemod(cfg, table, pre, device="cpu")
    assert s.feed(buf[:len(buf) // 2]) == []
    P.save_checkpoint(path, s)
    r = P.load_checkpoint(path, P.OfdmFrameStreamDemod(cfg, table, pre,
                                                       device=cuda))
    assert r._buf.device.type == "cuda"
    out = [x for x in r.feed(buf[len(buf) // 2:]) + r.flush()
           if hasattr(x, "packet")]
    assert len(out) == 1 and np.array_equal(out[0].packet.payload, payload)


# ── slice 7: the multi-device layer on eight shards of the card ─────────────


def _card_mesh(cuda, shape=(2, 4)):
    return P.parallel.make_mesh(8, shape=shape, devices=[cuda] * 8)


def test_sharded_fir_and_demap_on_the_card_match_one_device(cuda):
    """sharding.py: the time-sharded FIR (both filter routes) and the
    sharded OFDM demap under CPE against the one-device paths on the
    card."""
    from orion_sdr_tpu_torch.dsp.fir import fir_apply, kaiser_lowpass_taps
    gen = torch.Generator(device=cuda).manual_seed(1)
    mesh = _card_mesh(cuda)
    x = torch.randn((2, 1 << 16), dtype=torch.complex64, device=cuda,
                    generator=gen)
    for ntaps in (63, 1031):
        taps = kaiser_lowpass_taps(ntaps, 0.2, 60.0)
        got = P.parallel.fir_overlap_save_sharded(x, taps, mesh.flat())
        assert got.device.type == "cuda"
        assert torch.allclose(got, fir_apply(x, taps)[0], atol=1e-5)
    plan = P.CarrierPlan(128, 32).with_contiguous_data(edge_guard=8)
    cfg = P.OfdmConfig(plan, fs=1e6).with_phase_tracking("cpe")
    iq = torch.randn((2, 16 * 160), dtype=torch.complex64, device=cuda,
                     generator=gen)
    got = P.parallel.ofdm_soft_demap_sharded(cfg, "qpsk", iq, 16, mesh)
    ref = P.soft_demap(cfg, "qpsk", iq, 16)
    assert torch.allclose(got, ref, atol=1e-3, rtol=1e-3)


def test_sharded_viterbi_on_the_card_is_the_chunked_decode(cuda):
    """streaming.py: one chunked Viterbi launch a shard, the output equal
    to the one-device chunked decode bit for bit."""
    rng = np.random.default_rng(3)
    info = rng.integers(0, 2, 30_000).astype(np.uint8)
    coded = conv.conv_encode_punctured(torch.as_tensor(info, device=cuda),
                                       "3/4", "dvb_k7")
    llr = ((1.0 - 2.0 * coded.to(torch.float32)) * 3.0
           + torch.as_tensor(rng.standard_normal(coded.shape[0]).astype(
               np.float32), device=cuda))
    viterbi.viterbi_chunks_kernel.launches = 0
    got = P.parallel.viterbi_decode_sharded(llr, len(info), _card_mesh(cuda),
                                            "3/4", "dvb_k7")
    assert viterbi.viterbi_chunks_kernel.launches == 8
    ref = conv.viterbi_decode_soft_chunked(llr, len(info), "3/4", "dvb_k7")
    assert torch.equal(got, ref)
    assert float((got.cpu() != torch.as_tensor(info)).float().mean()) < 1e-3


def test_sharded_link_metrics_on_the_card(cuda):
    """distributed.py: ber_sharded's counts and power_spectrum_sharded
    over eight shards of the card against the same sums on one device."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    mesh = _card_mesh(cuda).flat("ch")
    bits = torch.randint(0, 2, (8, 4096), generator=gen, device=cuda,
                         dtype=torch.uint8)
    hat = bits.clone()
    hat[3, :17] ^= 1
    assert P.parallel.ber_sharded(bits, hat, mesh) == (17 / 32768, 17,
                                                        32768)
    x = torch.randn((8, 4096), dtype=torch.complex64, device=cuda,
                    generator=gen)
    ref = (torch.fft.fft(x.reshape(8, 8, 512), dim=-1).abs() ** 2).mean(
        dim=(0, 1))
    got = P.parallel.power_spectrum_sharded(x, mesh, nfft=512)
    assert torch.allclose(got, ref, rtol=2e-4)
