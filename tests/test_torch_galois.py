"""Torch port: the host Reed-Solomon and BCH codes beyond the native
decoders' fixed buffers (more than 64 RS parity bytes, BCH t > 16) encode
and decode as the JAX package does, which takes its numpy coders there
(orion_sdr_tpu/fec/galois.py). Each row of a batch carries its own number of
errors, up to t and beyond: the port's decoded rows, ok flags and the
systematic prefix of a failed row equal the JAX package's, bit for bit.

The JAX codewords are made one row at a time (its numpy encoder): the JAX
package's native encoder, which it takes for batches of four rows or more,
holds 64 parity bytes a row and writes past its buffer beyond that."""

import importlib

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from orion_sdr_tpu_torch.fec import galois as PG

JG = importlib.import_module("orion_sdr_tpu.fec.galois")

torch.set_num_threads(1)


def _rs_rows(n, p, errors, seed):
    """Messages, the JAX codewords (one row at a time) and the received
    words with ``errors[i]`` random byte errors in row i."""
    rng = np.random.default_rng(seed)
    code = JG.ReedSolomon(n, p)
    msg = rng.integers(0, 256, (len(errors), n - p)).astype(np.uint8)
    cw = np.stack([np.asarray(code.encode(m)) for m in msg])
    rx = cw.copy()
    for i, ne in enumerate(errors):
        pos = rng.choice(n, ne, replace=False)
        rx[i, pos] ^= rng.integers(1, 256, ne).astype(np.uint8)
    return msg, cw, rx


@pytest.mark.parametrize("n,p", [(255, 80), (255, 128), (200, 70)])
def test_rs_beyond_64_parity_bytes_matches_jax(n, p):
    t = p // 2
    errors = [0, 1, t // 2, t, t + 1, p]
    msg, cw, rx = _rs_rows(n, p, errors, n + p)
    port = PG.ReedSolomon(n, p)
    assert np.array_equal(port.encode(msg), cw)                # a batch
    assert np.array_equal(port.encode(msg[0]), cw[0])          # one row
    got, ok = port.decode_batch(rx)
    want, want_ok = JG.ReedSolomon(n, p).decode_batch(rx)
    assert np.array_equal(ok, want_ok) and np.array_equal(got, want)
    assert ok[:4].all() and np.array_equal(got[:4], msg[:4])   # <= t
    assert not ok[4:].any()                                    # beyond t
    assert np.array_equal(got[4:], rx[4:, :n - p])             # the prefix
    # (..., n) words as the JAX decode takes them
    assert np.array_equal(port.decode(rx[:4].reshape(2, 2, n)),
                          msg[:4].reshape(2, 2, n - p))
    with pytest.raises(PG.RsError):
        port.decode(rx[4])


def test_rs_up_to_64_parity_bytes_stays_native():
    msg, cw, rx = _rs_rows(204, 64, [0, 32, 33, 5], 7)
    port = PG.ReedSolomon(204, 64)
    assert np.array_equal(port.encode(msg), cw)
    got, ok = port.decode_batch(rx)
    want, want_ok = JG.ReedSolomon(204, 64).decode_batch(rx)
    assert np.array_equal(ok, want_ok) and np.array_equal(got, want)


@pytest.mark.parametrize("t", [16, 17, 20])
def test_bch_beyond_t16_matches_jax(t):
    rng = np.random.default_rng(t)
    jcode, port = JG.Bch(t=t), PG.Bch(t=t)
    assert port.k == jcode.k
    errors = [0, 1, t, t + 1, 2 * t + 3]
    msg = rng.integers(0, 2, (len(errors), jcode.k)).astype(np.uint8)
    cw = np.asarray(jcode.encode(msg))
    assert np.array_equal(port.encode(msg), cw)
    rx = cw.copy()
    for i, ne in enumerate(errors):
        rx[i, rng.choice(jcode.n, ne, replace=False)] ^= 1
    got, ok = port.decode_batch(rx)
    want, want_ok = jcode.decode_batch(rx)
    assert np.array_equal(ok, want_ok) and np.array_equal(got, want)
    assert ok[:3].all() and np.array_equal(got[:3], msg[:3])
    assert np.array_equal(got[~ok], rx[~ok, :jcode.k])
    assert not np.asarray(port._syndromes(cw[0])).any()
