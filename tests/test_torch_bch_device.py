"""Torch port: the outer code on the device (fec/bch_device.py, and the
chain's dispatch to it) against the JAX package's device coders and the
port's native host coders. Exact everywhere: messages and ok flags on every
row, failed rows (their systematic prefix) included. The CUDA kernel itself
is held to these plain versions in tests/test_torch_gpu.py."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from orion_sdr_tpu.fec import bch_device as JB

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch.fec import ReedSolomon
from orion_sdr_tpu_torch.fec import bch_device as PB
from orion_sdr_tpu_torch.frame import chain
from orion_sdr_tpu_torch.ops import outer_fec

# The plain torch versions run thousands of tiny ops; with one test worker
# per core, a torch thread pool as wide as the machine in every worker
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

B = 48          # one batch shape for every JAX decode: each shape compiles


def _bch_words(t, seed):
    """B shortened BCH codewords (120 info bits), row i carrying i % (t+4)
    bit errors: 0..t decodable, t+1..t+3 mostly not."""
    code = P.shortened_bch_for(t)
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, (B, code.k)).astype(np.uint8)
    words = code.encode(msgs)
    for i in range(B):
        ne = i % (t + 4)
        if ne:
            words[i, rng.choice(code.n, ne, replace=False)] ^= 1
    return code, msgs, words


def _rs_words(n, p, seed):
    rs = ReedSolomon(n, p)
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 256, (B, rs.k)).astype(np.uint8)
    words = rs.encode(msgs)
    for i in range(B):
        ne = i % (p // 2 + 4)
        if ne:
            words[i, rng.choice(n, ne, replace=False)] ^= rng.integers(
                1, 256, ne).astype(np.uint8)
    return rs, msgs, words


@pytest.mark.parametrize("t", [1, 4, 8])
def test_bch_plain_decoder_matches_jax_and_host(t):
    code, msgs, words = _bch_words(t, 10 + t)
    out, ok = PB.bch_decode_batch_reference(code.n, code.k, t,
                                            torch.as_tensor(words))
    jout, jok = JB.bch_decode_batch_device(code.n, code.k, t, words)
    hout, hok = code.decode_batch(words)
    assert out.dtype == torch.uint8 and ok.dtype == torch.int32
    for ref_out, ref_ok in ((np.asarray(jout), np.asarray(jok)),
                            (hout, hok)):
        assert np.array_equal(out.numpy(), ref_out)
        assert np.array_equal(ok.numpy().astype(bool), ref_ok.astype(bool))
    # every row with at most t errors decodes to its message; rows beyond
    # t that fail hold their systematic prefix
    okb = ok.numpy().astype(bool)
    within = np.arange(B) % (t + 4) <= t
    assert okb[within].all()
    assert np.array_equal(out.numpy()[within], msgs[within])
    assert (~okb).any()
    assert np.array_equal(out.numpy()[~okb], words[~okb, :code.k])


@pytest.mark.parametrize("n,p", [(204, 16), (60, 8), (100, 2)])
def test_rs_plain_decoder_matches_jax_and_host(n, p):
    rs, msgs, words = _rs_words(n, p, n + p)
    out, ok = PB.rs_decode_batch_reference(n, p, torch.as_tensor(words))
    jout, jok = JB.rs_decode_batch_device(n, p, words)
    hout, hok = rs.decode_batch(words)
    for ref_out, ref_ok in ((np.asarray(jout), np.asarray(jok)),
                            (hout, hok)):
        assert np.array_equal(out.numpy(), ref_out)
        assert np.array_equal(ok.numpy().astype(bool), ref_ok.astype(bool))
    okb = ok.numpy().astype(bool)
    within = np.arange(B) % (p // 2 + 4) <= p // 2
    assert okb[within].all()
    assert np.array_equal(out.numpy()[within], msgs[within])
    assert np.array_equal(out.numpy()[~okb], words[~okb, :rs.k])


def test_plain_decoders_take_an_empty_batch_and_clean_rows():
    code = P.shortened_bch_for(8)
    out, ok = PB.bch_decode_batch_reference(
        code.n, code.k, 8, torch.zeros((0, code.n), dtype=torch.uint8))
    assert out.shape == (0, code.k) and ok.shape == (0,)
    words = torch.as_tensor(code.encode(np.ones((3, code.k), np.uint8)))
    out, ok = PB.bch_decode_batch_reference(code.n, code.k, 8, words)
    assert (ok == 1).all() and (out == 1).all()
    with pytest.raises(ValueError):
        PB.bch_decode_batch_reference(code.n, code.k, 9, words)
    with pytest.raises(ValueError):
        PB.rs_decode_batch_reference(204, 18, torch.zeros((1, 204),
                                                          dtype=torch.uint8))


@pytest.mark.parametrize("t", [1, 4, 8])
def test_bch_device_encoder_matches_jax_and_host(t):
    code = P.shortened_bch_for(t)
    msgs = np.random.default_rng(t).integers(0, 2, (B, code.k)).astype(
        np.uint8)
    ours = PB.bch_encode_batch_device(code.n, code.k, t,
                                      torch.as_tensor(msgs)).numpy()
    assert np.array_equal(ours, code.encode(msgs))
    assert np.array_equal(ours, np.asarray(JB.bch_encode_batch_device(
        code.n, code.k, t, msgs)))


@pytest.mark.parametrize("n,p", [(204, 16), (60, 8)])
def test_rs_device_encoder_matches_jax_and_host(n, p):
    rs = ReedSolomon(n, p)
    msgs = np.random.default_rng(n).integers(0, 256, (B, rs.k)).astype(
        np.uint8)
    ours = PB.rs_encode_batch_device(n, p, torch.as_tensor(msgs)).numpy()
    assert np.array_equal(ours, rs.encode(msgs))
    assert np.array_equal(ours, np.asarray(JB.rs_encode_batch_device(
        n, p, msgs)))


def test_wrappers_run_the_plain_version_on_the_cpu_and_check_arguments():
    code, _, words = _bch_words(8, 3)
    before = outer_fec.bch_decode_kernel.launches
    got = outer_fec.bch_decode_kernel(code.n, code.k, 8,
                                      torch.as_tensor(words))
    want = PB.bch_decode_batch_reference(code.n, code.k, 8,
                                         torch.as_tensor(words))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert outer_fec.bch_decode_kernel.launches == before   # no launch
    with pytest.raises(TypeError):
        outer_fec.bch_decode_kernel(code.n, code.k, 8,
                                    torch.as_tensor(words).int())
    with pytest.raises(ValueError):
        outer_fec.bch_decode_kernel(code.n, code.k, 8,
                                    torch.as_tensor(words)[:, :-1])
    with pytest.raises(ValueError):
        outer_fec.rs_decode_kernel(204, 15, torch.zeros((1, 204),
                                                        dtype=torch.uint8))


def test_outer_device_ok_gate():
    cuda = torch.device("cuda")
    n = chain._DEVICE_OUTER_MIN_BLOCKS
    assert chain._outer_device_ok(8, n, cuda)
    assert not chain._outer_device_ok(9, n, cuda)
    assert not chain._outer_device_ok(16, 10 ** 6, cuda)
    assert not chain._outer_device_ok(8, n - 1, cuda)
    assert not chain._outer_device_ok(8, n, torch.device("cpu"))
    assert not chain._outer_device_ok(8, n, None)


def _force_device_path(monkeypatch):
    """Sends every outer code of t <= 8 through the device coders, which run
    their plain versions on the CPU; returns the list their calls append
    to."""
    calls = []
    monkeypatch.setattr(chain, "_outer_device_ok",
                        lambda t, n, device: t <= PB.MAX_DEVICE_T)
    for name in ("bch_decode_batch_device", "rs_decode_batch_device",
                 "bch_encode_batch_device", "rs_encode_batch_device"):
        real = getattr(chain, name)

        def spy(*a, _real=real, _name=name):
            calls.append(_name)
            return _real(*a)
        monkeypatch.setattr(chain, name, spy)
    return calls


CHAINS = {
    # the COFDM frame link's payload code without its inner code, so that
    # the flipped bits reach the BCH decoder
    "bch8": lambda: (P.OuterFec.bch(8), P.InnerFec.none(),
                     P.InterleaverKind.none(), P.ScramblerKind.none(),
                     P.SCRAMBLER_BEFORE_OUTER, 400, 6),
    # the DVB-T payload chain's outer part: RS(204,188), Forney I=12, the
    # energy-dispersal scrambler
    "dvb_rs": lambda: (P.OuterFec.reed_solomon(204, 16), P.InnerFec.none(),
                       P.InterleaverKind.convolutional(12, 17),
                       P.ScramblerKind.dvb_t_energy_dispersal(),
                       P.SCRAMBLER_BEFORE_OUTER, 500, 40),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_decode_chain_batch_same_on_either_outer_path(name, monkeypatch):
    outer, inner, outer_il, scr, pos, n_bytes, flips = CHAINS[name]()
    none = P.InterleaverKind.none()
    rng = np.random.default_rng(7)
    rows, datas = [], []
    for f in range(6):
        data = rng.integers(0, 256, n_bytes).astype(np.uint8)
        datas.append(data)
        bits = P.encode_chain(data, "crc32", outer, inner, outer_il, none,
                              scr, pos, f, device="cpu").numpy()
        # frames 0-2 clean to a few flips, 3-5 far more than t a codeword
        n_flip = [0, 3, flips // 2, flips * 20, flips * 40, flips * 80][f]
        bits[rng.choice(len(bits), n_flip, replace=False)] ^= 1
        rows.append(np.where(bits == 0, 4.0, -4.0).astype(np.float32))
    llrs = torch.as_tensor(np.stack(rows))
    plan = P.block_plan(n_bytes, "crc32", outer, inner, outer_il, none)
    args = (plan, "crc32", outer, inner, outer_il, none, scr, pos,
            list(range(6)))
    host = P.decode_chain_batch(llrs, *args)
    calls = _force_device_path(monkeypatch)
    dev = P.decode_chain_batch(llrs, *args)
    assert calls and set(calls) <= {"bch_decode_batch_device",
                                    "rs_decode_batch_device"}
    assert np.array_equal(host[1], dev[1])
    assert host[1][:3].all() and not host[1][3:].all()
    for a, b, data in zip(host[0], dev[0], datas):
        assert np.array_equal(a, b)
    for f in range(3):
        assert np.array_equal(dev[0][f][:n_bytes], datas[f])


def test_cofdm_frames_same_on_either_outer_path(monkeypatch):
    """OfdmFrameMod → OfdmFrameDemod.decode_batch on the default ladder
    (LDPC + BCH t=8): encode and decode through the device coders give the
    frames the host coders give."""
    cfg = P.OfdmConfig(P.CarrierPlan(256, 64).with_contiguous_data(
        edge_guard=16), fs=1e6)
    pre = P.OfdmPreamble(repeat_len=128, num_repeats=4).with_training_symbol(
        256, 64)
    table = P.McsTable.default_ladder()
    rng = np.random.default_rng(11)
    frames = [(P.FrameMetadata(i, 1), rng.integers(0, 256, 300).astype(
        np.uint8)) for i in range(3)]

    def run():
        mod = P.OfdmFrameMod(cfg, table, pre, device="cpu")
        iqs = [mod.modulate_frame(P.FramePacket(m, d), 5 + i)[
            pre.total_len():] for i, (m, d) in enumerate(frames)]
        out = P.OfdmFrameDemod(cfg, table, device="cpu").decode_batch(
            np.stack(iqs))
        return iqs, out

    host_iq, host_out = run()
    calls = _force_device_path(monkeypatch)
    dev_iq, dev_out = run()
    assert "bch_encode_batch_device" in calls
    assert "bch_decode_batch_device" in calls
    for a, b in zip(host_iq, dev_iq):
        assert np.array_equal(a, b)
    for (meta, data), a, b in zip(frames, host_out, dev_out):
        assert a.metadata == b.metadata == meta
        assert np.array_equal(a.payload, data)
        assert np.array_equal(b.payload, data)


def _rs_garbage_words(seed, rows=4096):
    """RS(204,188) codewords with 9..13 byte errors each (beyond t = 8)."""
    rs = ReedSolomon(204, 16)
    rng = np.random.default_rng(seed)
    words = rs.encode(rng.integers(0, 256, (rows, rs.k)).astype(np.uint8))
    for i in range(rows):
        ne = int(rng.integers(9, 14))
        words[i, rng.choice(204, ne, replace=False)] ^= rng.integers(
            1, 256, ne).astype(np.uint8)
    return words


def _bad_dv_rows(words):
    """Rows where σ has a root in the window at which σ' vanishes (the
    decoders' bad_dv), from the plain decoder's own stages."""
    n, p = 204, 16
    t, cap = p // 2, p // 2 + 2
    _, M, plane, _ = PB._rs_tables(n, p)
    mul, inv = PB._gf_ops(torch.device("cpu"))
    r = torch.as_tensor(words).long()
    bits = ((r[:, :, None] >> torch.arange(8)) & 1).reshape(len(r), n * 8)
    sb = PB._mod2_product(bits, torch.as_tensor(M, dtype=torch.float32))
    s = (sb.reshape(len(r), p, 8).long() << torch.arange(8)).sum(-1)
    sigma, _ = PB._berlekamp_massey(s, 0, p, 0, len(r), cap, mul, inv,
                                    r.device)
    deriv = torch.zeros_like(sigma)
    deriv[:, 0:cap - 1:2] = sigma[:, 1:cap:2]
    plane = torch.as_tensor(plane).long()

    def ev(c):
        return PB._xor_mid(mul(c[:, :, None], plane[None, :cap]))
    return ((ev(sigma) == 0) & (ev(deriv) == 0)).any(-1).numpy()


def test_rs_rows_where_the_derivative_vanishes_match_jax_and_host():
    words = _rs_garbage_words(0)
    bad = np.flatnonzero(_bad_dv_rows(words))
    assert len(bad) >= 8          # 12 of seed 0's 4096 rows
    rows = words[np.concatenate([bad[:8], np.arange(B - 8)])]
    out, ok = PB.rs_decode_batch_reference(204, 16, torch.as_tensor(rows))
    jout, jok = JB.rs_decode_batch_device(204, 16, rows)
    hout, hok = ReedSolomon(204, 16).decode_batch(rows)
    assert not ok[:8].any()
    for ref_out, ref_ok in ((np.asarray(jout), np.asarray(jok)),
                            (hout, hok)):
        assert np.array_equal(out.numpy(), ref_out)
        assert np.array_equal(ok.numpy().astype(bool), ref_ok.astype(bool))
