"""Torch port: the DVB-T frame receiver (``DvbTFrameDemod.decode_batch``,
on the CPU) held to the benchmark's plain DVB-T link
(``orbench/reference/dvbt.py``), and the plain link held to itself.

For 64-QAM r2/3 GI 1/32 and QPSK r1/2 GI 1/8, two 68-symbol frames with
a small payload: the plain transmitter gives the port's frames; the port
and the plain receiver give the same payloads and TPS words; the port's
Viterbi rows equal the plain chunked Viterbi run on the lanes the port
handed its kernel; the port's LLRs lie within the benchmark cell's
``llr_gap`` of the plain receiver's. The plain RS(204, 188) decoder
equals the port's host and plain decoders on words with 0 to t + 4 byte
errors, and the plain chunked Viterbi is the maximum-likelihood decode of
a one-chunk row (all input sequences and start states tried)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch.fec import conv
from orion_sdr_tpu_torch.fec.bch_device import rs_decode_batch_reference
from orion_sdr_tpu_torch.fec.galois import ReedSolomon
from orion_sdr_tpu_torch.frame import chain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from orbench.checks import gap  # noqa: E402
from orbench.checks.cofdm_frames import match_rows  # noqa: E402
from orbench.reference import dvbt  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"
LINKS = {"qam64_23_gi32": ("qam64", "2/3", "1/32"),
         "qpsk_12_gi8": ("qpsk", "1/2", "1/8")}
PAYLOAD = 3 * dvbt.TS_PAYLOAD
SNR_DB = 20.0
LIMIT = json.load(open(os.path.join(
    ROOT, "orbench", "cells", "dvbt_2k_64qam23.rx_32mux.json")))[
        "limits"]["llr_gap"]


def _frames(rng, n=2):
    return [(i % 4, int(c), rng.integers(0, 256, PAYLOAD).astype(np.uint8))
            for i, c in enumerate(rng.choice(256, n, replace=False))]


@pytest.fixture(scope="module", params=sorted(LINKS))
def run(request):
    """One batch through the port (its Viterbi lanes and rows recorded)
    and through the plain receiver."""
    const, rate, guard = LINKS[request.param]
    link = dvbt.Link(const, rate, guard)
    rng = np.random.default_rng(0xD7B7)
    frames = _frames(rng)
    clean = dvbt.transmit(link, frames, CPU)
    power = (clean.abs() ** 2).mean(-1)
    noise = torch.randn(clean.shape, dtype=torch.complex64,
                        generator=torch.Generator().manual_seed(26))
    iq = clean + noise * torch.sqrt(
        power * 10 ** (-SNR_DB / 10) * dvbt.N_FFT / 1705)[:, None].to(
            torch.complex64)
    seen = {"chunks": [], "rows": []}
    real_chunks, real_vit = conv.chunk_llrs, chain.viterbi_decode_soft_chunked

    def chunks(*a, **k):
        seen["chunks"].append(real_chunks(*a, **k))
        return seen["chunks"][-1]

    def vit(*a, **k):
        seen["rows"].append(real_vit(*a, **k))
        return seen["rows"][-1]
    conv.chunk_llrs, chain.viterbi_decode_soft_chunked = chunks, vit
    try:
        params = P.DvbTFrameParams(P.DvbTLinkParams(guard, const, rate))
        out = P.DvbTFrameDemod(params, device=CPU).decode_batch(
            iq, link.n_symbols, PAYLOAD)
    finally:
        conv.chunk_llrs, chain.viterbi_decode_soft_chunked = \
            real_chunks, real_vit
    return dict(link=link, frames=frames, clean=clean, out=out, seen=seen,
                ref=dvbt.receive(link, iq, PAYLOAD))


def test_the_plain_transmitter_gives_the_ports_frames(run):
    link = run["link"]
    for (fn, cid, payload), x in zip(run["frames"], run["clean"]):
        params = P.DvbTFrameParams(P.DvbTLinkParams(
            link.guard, link.constellation, link.code_rate), fn, cid)
        port = P.DvbTFrameMod(params, device=CPU).modulate(payload)
        assert port.n_symbols == link.n_symbols
        assert np.abs(port.iq - x.numpy()).max() < 1e-5 * np.abs(port.iq).max()


def test_payloads_and_tps_words_equal(run):
    link, out, ref = run["link"], run["out"], run["ref"]
    assert len(out) == len(ref.frames) == len(run["frames"])
    for f, r, (fn, cid, payload) in zip(out, ref.frames, run["frames"]):
        want = ("ok", fn, link.constellation, link.code_rate, link.guard,
                cid, payload.tobytes())
        assert r == want
        assert (f.tps.frame_number, f.tps.constellation, f.tps.code_rate_hp,
                f.tps.guard, f.tps.cell_id) == want[1:6]
        assert f.payload.tobytes() == want[-1]


def test_viterbi_rows_equal_on_the_same_llrs(run):
    link = run["link"]
    ((c0, c1, pm0, nchunk),), (rows,) = run["seen"]["chunks"], \
        run["seen"]["rows"]
    assert nchunk > 1 and c0.shape[1] == link.chunk_steps \
        + 2 * link.chunk_overlap
    B, info = rows.shape
    plain = dvbt.decoded_rows(dvbt.viterbi_chunks(c0, c1, pm0, link), B,
                              info, link)
    assert torch.equal(plain, rows)
    assert torch.equal(run["ref"].rows, rows)


def test_start_metrics_handed_to_the_viterbi_equal_the_references(run):
    ((_, _, pm0, nchunk),) = run["seen"]["chunks"]
    ref = run["ref"]
    assert nchunk == ref.nchunk
    assert torch.equal(pm0, ref.pm0)


def test_llrs_lie_within_the_cells_llr_gap(run):
    ((c0, c1, _, _),) = run["seen"]["chunks"]
    ref = run["ref"]
    p = torch.cat([c0, c1], 1)
    q = torch.cat([ref.c0, ref.c1], 1)
    m = match_rows(p, q)
    assert bool((m >= 0).all())
    assert gap(p[m], q) < LIMIT / 10


def _rs_words(rng, n_words, n_err):
    rs = ReedSolomon(204, 16)
    msg = rng.integers(0, 256, (n_words, 188)).astype(np.uint8)
    words = rs.encode(msg)
    assert np.array_equal(dvbt.rs_encode(msg), words)
    bad = words.copy()
    for w in range(n_words):
        pos = rng.choice(204, n_err, replace=False)
        bad[w, pos] ^= rng.integers(1, 256, n_err).astype(np.uint8)
    return rs, msg, words, bad


@pytest.mark.parametrize("n_err", [0, 1, 5, 8, 9, 10, 12])
def test_rs_outputs_equal_the_ports(n_err):
    rng = np.random.default_rng(n_err)
    rs, msg, words, bad = _rs_words(rng, 24, n_err)
    got = dvbt.rs_decode(bad)
    host_msg, host_ok = rs.decode_batch(bad)
    plain_msg, plain_ok = rs_decode_batch_reference(204, 16,
                                                    torch.as_tensor(bad))
    assert np.array_equal(got.msg, host_msg)
    assert np.array_equal(got.ok, np.asarray(host_ok, bool))
    assert np.array_equal(got.msg, plain_msg.numpy())
    assert np.array_equal(got.ok, plain_ok.numpy().astype(bool))
    assert np.array_equal(got.in_error, np.full(24, n_err > 0))
    if n_err <= 8:
        assert got.ok.all() and np.array_equal(got.msg, msg)
        assert (got.errors == n_err).all()
        flips = np.unpackbits(words ^ bad, axis=1).sum(1)
        assert np.array_equal(got.bit_errors, flips)
    else:
        # beyond t: a word fails (its systematic part kept) or lands on
        # another codeword within t of it, as the port's decoders do
        assert all((got.msg[w] != msg[w]).any()
                   for w in np.flatnonzero(got.ok))
        assert np.array_equal(got.msg[~got.ok], bad[~got.ok, :188])


def _ml_bits(link, llr, n_steps):
    """The input sequence, of all 2^n_steps from each of the 2^(K−1)
    start states, whose mother coded bits correlate best with the
    (2·n_steps,) LLRs."""
    m = link.K - 1
    seqs = (np.arange(1 << (n_steps + m))[:, None]
            >> np.arange(n_steps + m)[None, :]) & 1
    reg = np.zeros((len(seqs), n_steps), np.int64)
    hist = np.zeros(len(seqs), np.int64)      # the newest input on top
    for t in range(n_steps + m):
        hist = (hist >> 1) | (seqs[:, t] << m)
        if t >= m:
            reg[:, t - m] = hist
    par = np.vectorize(lambda v: bin(v).count("1") & 1)
    x, y = par(reg & link.g1), par(reg & link.g2)
    score = ((1 - 2 * x) * llr[0::2] + (1 - 2 * y) * llr[1::2]).sum(1)
    return seqs[int(np.argmax(score)), m:]


@pytest.mark.parametrize("seed", range(4))
def test_the_chunked_viterbi_is_ml_on_a_one_chunk_row(seed):
    """One chunk: the zero margins before and after the row leave its start
    and end states free (the first chunk's pin sits before its margin), so
    the decode is the best path from any state to any state."""
    link = dvbt.Link("qpsk", "1/2", "1/32")
    info = 6
    n_steps = info + link.K - 1
    llr = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (1, 2 * n_steps)).astype(np.float32))
    c0, c1, pm0, nchunk = dvbt.chunk_rows(llr, info, link)
    assert nchunk == 1
    rows = dvbt.decoded_rows(dvbt.viterbi_chunks(c0, c1, pm0, link), 1,
                             info, link)
    ml = _ml_bits(link, llr[0].numpy().astype(np.float64), n_steps)
    assert rows[0].tolist() == ml[:info].tolist()


def test_the_dispersal_prbs_and_tps_word_follow_the_standard():
    # §4.3.1: the first PRBS byte is 0x03; the TPS word is a BCH codeword
    assert dvbt._dispersal_plane()[0, 1] == 0x03
    assert dvbt._dispersal_plane()[0, 0] == 0xFF
    bits = dvbt.tps_bits(1, dvbt.Link("qam64", "2/3", "1/32"), 0xA5)
    assert dvbt._tps_remainder(bits[1:]) == 0
    cells = np.cumprod(np.where(np.arange(68) == 0, 1.0,
                                1.0 - 2.0 * bits))[:, None] * np.ones(17)
    cells[5, 3] *= -1            # one cell wrong: the sum still decides
    assert dvbt.tps_decode(cells) == (1, "qam64", "2/3", "1/32", 0xA5)
