"""Torch port, FT8/FT4 sync against the JAX package: the waterfall (one
complex64 product; log-power to 1e-3 absolute on noisy input, rows past the
buffer exactly 0.0), the Costas score grid (1e-3 relative to its largest
score), the candidates (time and bin equal wherever the score gap to the
next candidate exceeds that tolerance; on an all-zero window, where every
score ties, the JAX tie order: lowest flat index first), the normalised
LLRs (1e-3 absolute) of ``ft8/ft4_sync``, ``ft8/ft4_sync_batch`` and the
multi-frame ``ft_sync_multi``."""

import importlib

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from orion_sdr_tpu.codec.ft8 import ft4_encode, ft8_encode
from orion_sdr_tpu.modulate import ft8 as JM
from orion_sdr_tpu.sync import costas as JC, waterfall as JW

from orion_sdr_tpu_torch.sync import costas as TC, waterfall as TW

JS = importlib.import_module("orion_sdr_tpu.sync.ft8_sync")
TS = importlib.import_module("orion_sdr_tpu_torch.sync.ft8_sync")

torch.set_num_threads(1)
CPU = "cpu"
FS = 12000.0
WF_ATOL, GRID_RTOL, LLR_ATOL = 1e-3, 1e-3, 1e-3


def _capture(ft8, sigma, seed, base=1012.5, n=None):
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 256, 10).astype(np.uint8)
    p[9] &= 0xF8
    iq = np.asarray(JM.ft8_mod(ft8_encode(p), FS, base) if ft8
                    else JM.ft4_mod(ft4_encode(p), FS, base))
    n = len(iq) if n is None else n
    out = np.zeros(n, np.complex64)
    out[:min(n, len(iq))] = iq[:n]
    return (out + sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(
        n))).astype(np.complex64)


@pytest.mark.parametrize("args", [(6.25, 1920, 79, 40, 0),
                                  (6.25, 1920, 82, 40, 1000),
                                  (20.833334, 576, 105, 12, 0)])
def test_waterfall_matches(args):
    spacing, sps, syms, tones, off = args
    iq = _capture(sps == 1920, 2.0, 1)
    ours = TW.compute_waterfall(torch.as_tensor(iq), FS, 950.0, spacing,
                                sps, syms, tones, off)
    ref = np.asarray(JW.compute_waterfall(iq, FS, 950.0, spacing, sps, syms,
                                          tones, off))
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=WF_ATOL)
    missing = off + np.arange(syms) * sps >= len(iq)
    assert (ours.numpy()[missing] == 0.0).all()
    assert np.array_equal(TW._tone_matrix(FS, 950.0, spacing, sps, tones),
                          JW._tone_matrix(FS, 950.0, spacing, sps, tones))


@pytest.mark.parametrize("t_range", [(0, 0), (0, 4), (-3, 2)])
def test_score_grid_and_candidates_match(t_range):
    iq = _capture(True, 1.0, 2, n=151_680 + 6 * 1920)
    wf = np.array(JW.compute_waterfall(iq, FS, 950.0, 6.25, 1920, 85, 40))
    pos = [s for s, _ in JM.FT8_SYNC_POS]
    ref = np.asarray(JC.candidate_score_grid(wf, JM.FT8_COSTAS, pos, 8,
                                             *t_range))
    ours = TC.candidate_score_grid(torch.as_tensor(wf), JM.FT8_COSTAS, pos,
                                   8, *t_range).numpy()
    tol = GRID_RTOL * np.abs(ref).max()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol)
    ca = JC.find_candidates(wf, JM.FT8_COSTAS, pos, 8, *t_range, 6)
    cb = TC.find_candidates(torch.as_tensor(wf), JM.FT8_COSTAS, pos, 8,
                            *t_range, 6)
    assert len(ca) == len(cb) == 6
    scores = np.sort(ref.reshape(-1))[::-1]
    for i, (a, b) in enumerate(zip(ca, cb)):
        assert abs(a.score - b.score) <= tol
        if scores[i] - scores[i + 1] > 2 * tol and (
                i == 0 or scores[i - 1] - scores[i] > 2 * tol):
            assert (a.time_sym, a.freq_bin) == (b.time_sym, b.freq_bin)
    c = ca[0]
    assert TC.costas_score(torch.as_tensor(wf), JM.FT8_COSTAS, pos,
                           c.time_sym, c.freq_bin) == \
        JC.costas_score(wf, JM.FT8_COSTAS, pos, c.time_sym, c.freq_bin)
    assert TC.costas_kernel(JM.FT4_COSTAS, [1, 34, 67, 100]) == \
        JC.costas_kernel(JM.FT4_COSTAS, [1, 34, 67, 100])


def test_all_zero_window_follows_the_jax_tie_order():
    z = np.zeros((2, 151_680), np.complex64)
    for ft8, sync in ((True, "ft8_sync"), (False, "ft4_sync")):
        n = 151_680 if ft8 else 60_480
        a = getattr(JS, sync)(z[0, :n], FS, 200.0, 3000.0, 0, 0, 6)
        b = getattr(TS, sync)(z[0, :n], FS, 200.0, 3000.0, 0, 0, 6,
                              device=CPU)
        assert [(c.time_sym, c.freq_bin, c.score) for c in a] == \
            [(c.time_sym, c.freq_bin, c.score) for c in b] == \
            [(0, i, 0.0) for i in range(6)]
    batch = TS.ft8_sync_batch(z, FS, 200.0, 3000.0, 4, device=CPU)
    assert [[c.freq_bin for c in w] for w in batch] == [[0, 1, 2, 3]] * 2
    flat = torch.zeros(451)
    flat[[5, 400]] = 1.0
    vals, idx = TC.top_k_stable(flat, 4)
    assert idx.tolist() == [5, 400, 0, 1]


def _same(a, b):
    assert [(c.time_sym, c.freq_bin) for c in a] == \
        [(c.time_sym, c.freq_bin) for c in b]
    for x, y in zip(a, b):
        assert abs(x.score - y.score) <= GRID_RTOL * abs(x.score) + 1e-6
        assert y.llr.dtype == torch.float32 and y.llr.shape == (174,)
        np.testing.assert_allclose(y.llr.numpy(), x.llr, rtol=0,
                                   atol=LLR_ATOL)


@pytest.mark.parametrize("ft8", [True, False])
def test_sync_llrs_match(ft8):
    iq = _capture(ft8, 1.5, 3)
    sync = "ft8_sync" if ft8 else "ft4_sync"
    for t_min, t_max in ((0, 0), (0, 2), (-2, 1)):
        _same(getattr(JS, sync)(iq, FS, 950.0, 1150.0, t_min, t_max, 4),
              getattr(TS, sync)(iq, FS, 950.0, 1150.0, t_min, t_max, 4,
                                device=CPU))


@pytest.mark.parametrize("ft8", [True, False])
def test_sync_batch_and_multi_match(ft8):
    w = np.stack([_capture(ft8, 1.5, s) for s in (4, 5, 6)])
    name = "ft8_sync_batch" if ft8 else "ft4_sync_batch"
    a = getattr(JS, name)(w, FS, 950.0, 1150.0, 3)
    b = getattr(TS, name)(w, FS, 950.0, 1150.0, 3, device=CPU)
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        _same(x, y)
    mode = "ft8" if ft8 else "ft4"
    _same(JS.ft_sync_multi(w, FS, 950.0, 1150.0, 3, mode),
          TS.ft_sync_multi(w, FS, 950.0, 1150.0, 3, mode, device=CPU))
