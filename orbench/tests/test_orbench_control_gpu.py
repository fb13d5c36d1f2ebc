"""On the card: the control (the plain reference in the precision below
the configuration's, put in the program's place) fails a cell's limits
while the program passes them, on three seeds, at a size a test run
holds; and a run with the timed path broken is not correct. Run with
``python3 -m pytest -m gpu orbench/tests``; without a card every case
skips. The readings at each cell's own size come from
``python3 -m orbench.control``."""

import pytest

from orbench import control, harness
from test_orbench_run import altered_cofdm, altered_ft8, half_left_out
from tiny import copy_with_tiny

pytestmark = pytest.mark.gpu
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return copy_with_tiny(str(tmp_path_factory.mktemp("bench")), scale=4)


@pytest.mark.parametrize("cell", ["cofdm_ldpc_bch.tiny", "ft8_batch_rx.tiny"])
def test_the_control_fails_and_the_program_passes(card, root, cell):
    limits = harness.load_cell(cell, root)["limits"]
    for seed in SEEDS:
        r = control.readings(cell, seed, card, root=root)
        assert all(r["program"][k] <= v for k, v in limits.items()), r
        assert any(r["control"][k] > v for k, v in limits.items()), r


@pytest.mark.parametrize("cell,fault", [
    ("cofdm_ldpc_bch.tiny", altered_cofdm),
    ("ft8_batch_rx.tiny", altered_ft8),
    ("cofdm_ldpc_bch.tiny", half_left_out),
    ("ft8_batch_rx.tiny", half_left_out)])
def test_a_broken_path_is_not_correct_on_the_card(card, root, cell, fault):
    r = harness.run_cell(cell, SEEDS[0], 0.5, False, root=root, device=card,
                         faults=[fault])
    assert not r["correct"]
