"""Torch port: the radix-4 Viterbi kernel's table of four-step branch sums
(ops/viterbi.py::radix4_sum_table), built on the host. A candidate formed as
pm[pred] + table[index] must equal the candidate that the plain version
``_acs_traceback4`` adds, bit for bit, on float LLRs; the table holds at most
256 entries a phase, and its addresses give conflict-free shared-memory
loads."""

import numpy as np
import pytest
import torch

from orion_sdr_tpu_torch.fec.conv import _tables
from orion_sdr_tpu_torch.ops import viterbi

# one torch thread per test worker (see tests/test_torch_viterbi.py)
torch.set_num_threads(1)

CODES = ("k5", "dvb_k7")


def _table_sums(s, d, spec):
    """Plain model of the kernel's table build: per lane the four steps'
    s = l0 + l1 and d = l0 − l1, (L, 4) each → (L, 256) table, address e
    holding ((v0 + v1) + (v2 + v3)) for the pattern spec[e]. The kernel adds
    the same pair sums in the same order."""
    p = torch.as_tensor(spec.astype(np.int64), device=s.device)
    v = [torch.where(((p >> (2 * i)) & 1).bool(), d[:, i, None], s[:, i, None])
         * torch.where(((p >> (2 * i + 1)) & 1).bool(), -1.0, 1.0)
         for i in range(4)]
    return (v[0] + v[1]) + (v[2] + v[3])


def _plain_candidates(l0, l1, pm, code, g):
    """Phase g's (L, S, 16) candidates, written as _acs_traceback4 writes
    them."""
    _, S, *_ = _tables(code)
    pred, diff, neg = viterbi._radix4_tables(code)
    pred_t = torch.as_tensor(pred, dtype=torch.int64)
    diff_t = torch.as_tensor(diff)
    flip = torch.as_tensor(np.where(neg, -1.0, 1.0), dtype=torch.float32)
    s_all = (l0 + l1).t().contiguous()
    d_all = (l0 - l1).t().contiguous()
    v = [torch.where(diff_t[i], d_all[4 * g + i, :, None, None],
                     s_all[4 * g + i, :, None, None]) * flip[i]
         for i in range(4)]
    return pm[:, pred_t] + ((v[0] + v[1]) + (v[2] + v[3]))


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e4])
@pytest.mark.parametrize("code", CODES)
def test_table_candidates_equal_the_plain_candidates(code, scale):
    rng = np.random.default_rng(int(scale * 1000) + len(code))
    _, S, *_ = _tables(code)
    L, T = 5, 32
    l0, l1 = (torch.as_tensor(rng.standard_normal((L, T)) * scale,
                              dtype=torch.float32) for _ in range(2))
    pm = torch.as_tensor(rng.standard_normal((L, S)) * 10 * scale,
                         dtype=torch.float32)
    pred, _, _ = viterbi._radix4_tables(code)
    index, spec = viterbi.radix4_sum_table(code)
    idx_t = torch.as_tensor(index.astype(np.int64))
    for g in range(T // 4):
        s = l0[:, 4 * g:4 * g + 4] + l1[:, 4 * g:4 * g + 4]
        d = l0[:, 4 * g:4 * g + 4] - l1[:, 4 * g:4 * g + 4]
        table = _table_sums(s, d, spec)
        assert table.shape == (L, 256)
        got = pm[:, torch.as_tensor(pred)] + table[:, idx_t]
        want = _plain_candidates(l0, l1, pm, code, g)
        # bit for bit: compare the float32 words, signs of zero included
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("code", CODES)
def test_table_has_at_most_256_entries_and_every_candidate_an_address(code):
    _, S, *_ = _tables(code)
    index, spec = viterbi.radix4_sum_table(code)
    assert index.shape == (S, 16) and index.dtype == np.uint8
    assert spec.shape == (256,) and spec.dtype == np.uint8
    # spec is a permutation of the 256 patterns: one sum per address, and
    # each candidate's address holds the sum of its own pattern
    assert sorted(spec.tolist()) == list(range(256))
    assert np.array_equal(spec[index], viterbi._r4_patterns(code))


@pytest.mark.parametrize("code", CODES)
def test_table_loads_are_free_of_bank_conflicts(code):
    index, _ = viterbi.radix4_sum_table(code)
    assert viterbi._r4_bank_conflicts(index.astype(np.int64)) == 1
    # the plain pattern bytes as addresses would put two in one bank
    assert viterbi._r4_bank_conflicts(viterbi._r4_patterns(code)) == 2


def test_table_sums_keep_the_negation_identity_on_signed_zeros():
    # s = d = ±0 in every step: each entry is a signed zero, and its sign is
    # the one the plain version's multiply-by-±1 and adds give
    _, spec = viterbi.radix4_sum_table("dvb_k7")
    for z in (0.0, -0.0):
        s = torch.full((1, 4), z)
        table = _table_sums(s, s.clone(), spec)
        p = torch.as_tensor(spec.astype(np.int64))
        v = [s[0, i] * torch.where(((p >> (2 * i + 1)) & 1).bool(), -1.0, 1.0)
             for i in range(4)]
        want = (v[0] + v[1]) + (v[2] + v[3])
        assert torch.equal(table[0].view(torch.int32), want.view(torch.int32))


def test_table_search_gives_up_with_an_error(monkeypatch):
    # the identity map conflicts (above): with no random map left to try,
    # the search raises instead of looping on
    monkeypatch.setattr(viterbi, "_R4_MAP_TRIES", 0)
    with pytest.raises(ValueError, match="no conflict-free table map"):
        viterbi.radix4_sum_table.__wrapped__("dvb_k7")
