"""A whole run of the harness on the CPU at a tiny size (the look for a
card skipped, the port's plain paths): correct on sound runs, and not
correct with the timed path broken underneath, once for each fault the
cells can have: an answer altered where it is produced, and half of the
batch left out (its results taken from the other half). A program that
runs a layer in other calls and order still reads correct."""

import numpy as np
import pytest
import torch

from orion_sdr_tpu_torch.codec import ft8_stream
from orion_sdr_tpu_torch.frame import chain

from orbench import harness
from tiny import copy_with_tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return copy_with_tiny(str(tmp_path_factory.mktemp("bench")))


def altered_cofdm(hooks, entry):
    def make(real):
        def w(*a, **k):
            msg, ok = real(*a, **k)
            msg = np.array(msg)
            msg[0, 40] ^= 1
            return msg, ok
        return w
    hooks.wrap(chain, "outer_decode_batch", make)


def altered_ft8(hooks, entry):
    def make(real):
        def w(*a, **k):
            bits, ok = real(*a, **k)
            bits = bits.clone()
            bits[:, 70] ^= 1
            return bits, ok
        return w
    hooks.wrap(ft8_stream, "_decode_rows", make)


def half_left_out(hooks, entry):
    def make(real):
        def w(iq):
            h = iq.shape[0] // 2
            out = real(iq[:h])
            return out + out[:iq.shape[0] - h]
        return w
    hooks.wrap(entry, "call", make)


def regrouped_cofdm(hooks, entry):
    """BP and the BCH each run as two calls a batch, the later rows first:
    the layers' outputs are the same rows in other calls and order."""
    def halves(real, join):
        def w(first, rows, *a, **k):
            h = rows.shape[0] // 2
            if h == 0:
                return real(first, rows, *a, **k)
            late = real(first, rows[h:], *a, **k)
            early = real(first, rows[:h], *a, **k)
            return tuple(join([x, y]) for x, y in zip(early, late))
        return w
    hooks.wrap(chain, "ldpc_decode", lambda real: halves(real, torch.cat))
    hooks.wrap(chain, "outer_decode_batch",
               lambda real: halves(real, np.concatenate))


CELLS = ["cofdm_ldpc_bch.tiny", "ft8_batch_rx.tiny"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(root, cell, trace):
    r = harness.run_cell(cell, 2 ** 31 + 17, 0.3, trace, root=root,
                         device="cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    names = {m["name"] for m in harness.load_cell(cell, root)[
        "per_layer" if trace else "end_to_end"]}
    assert set(r["metrics"]) <= names
    assert list(r)[-1] == "checks"
    if not trace:
        assert set(r["metrics"]) == names


@pytest.mark.parametrize("cell,fault", [
    ("cofdm_ldpc_bch.tiny", altered_cofdm),
    ("ft8_batch_rx.tiny", altered_ft8),
    ("cofdm_ldpc_bch.tiny", half_left_out),
    ("ft8_batch_rx.tiny", half_left_out)])
def test_a_broken_path_is_not_correct(root, cell, fault):
    r = harness.run_cell(cell, 2 ** 31 + 18, 0.3, False, root=root,
                         device="cpu", faults=[fault])
    assert not r["correct"]
    assert r["failed"] > 0


def test_a_regrouped_program_is_still_correct(root):
    r = harness.run_cell("cofdm_ldpc_bch.tiny", 2 ** 31 + 19, 0.3, False,
                         root=root, device="cpu", faults=[regrouped_cofdm])
    assert r["correct"] and r["failed"] == 0


def test_the_same_seed_gives_the_same_inputs(root):
    c = harness.load_cell("ft8_batch_rx.tiny", root)
    gen = harness.part("traffic", c["generator"])
    a = gen.make(c["config_file"], c["params"], 2 ** 40 + 3, "cpu")
    b = gen.make(c["config_file"], c["params"], 2 ** 40 + 3, "cpu")
    assert all(torch.equal(x.iq, y.iq) and x.truth == y.truth
               for x, y in zip(a, b))
