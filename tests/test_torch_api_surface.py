"""Torch port: the flat namespace. The port's top level carries the 114
names tests/test_api_surface.py requires of the JAX package and every
public name ``orion_sdr_tpu/__init__.py`` binds, ``parallel`` with the 19
names of ``orion_sdr_tpu/parallel/__init__.py`` among them (the test
keeps the name it had before the multi-device layer was ported); the NB
helpers agree with the JAX package's; the twelve frame and DVB-T entry points default ``device`` to
"cuda" and the three COFDM frame classes accept ``cache=``; ``trace``
writes a profiler trace and ``measure`` times a call. The source files
are read with ``ast`` (no JAX import is needed for the name checks)."""

import ast
import inspect
import os

import numpy as np
import pytest
import torch

import orion_sdr_tpu_torch as P

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _surface_list():
    """The ``surface`` list literal of
    tests/test_api_surface.py::test_flat_namespace_covers_reference_surface."""
    with open(os.path.join(ROOT, "tests", "test_api_surface.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "surface"
                for t in node.targets):
            return [e.value for e in node.value.elts]
    raise AssertionError("no surface list in tests/test_api_surface.py")


def _jax_public_names():
    """Every public name ``orion_sdr_tpu/__init__.py`` binds at top level."""
    with open(os.path.join(ROOT, "orion_sdr_tpu", "__init__.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def test_reference_surface_names():
    surface = _surface_list()
    assert len(surface) == 114
    assert [s for s in surface if not hasattr(P, s)] == []


def _jax_parallel_names():
    """The names ``orion_sdr_tpu/parallel/__init__.py`` imports."""
    with open(os.path.join(ROOT, "orion_sdr_tpu", "parallel",
                           "__init__.py")) as f:
        tree = ast.parse(f.read())
    return [a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names]


def test_every_public_name_of_the_jax_package_but_parallel():
    names = _jax_public_names()
    assert "parallel" in names and len(names) > 300
    assert sorted(n for n in names if not hasattr(P, n)) == []
    par = _jax_parallel_names()
    assert len(par) == 19
    assert [n for n in par if not hasattr(P.parallel, n)] == []


def test_nb_helpers_consistent():
    fs = P.nb_bandwidth_fs(1_000_000.0)
    assert abs(P.nb_bandwidth_occupied_hz(fs) - 1_000_000.0) < 1e-3
    assert P.dvb_t_cp_len("1/4") == 512
    assert P.dvb_t_max_rx_window_backoff() == 85
    assert P.dvb_t_tx_lowpass_group_delay(89) == 44
    assert P.dvb_t_tx_lowpass_fits_guard(89, 256, 20, 85)
    assert not P.dvb_t_tx_lowpass_fits_guard(89, 64, 40, 32)
    assert P.dvb_t_tx_lowpass_suggested_taps(60.0) > 0
    assert P.tx_lowpass_for_2k(89, 60.0).num_taps == 89
    assert P.dvb_t_config("1/4", 7.61e6).carrier_plan.n_fft == 2048


REPAIRED = [
    ("frame.modulator", "OfdmFrameMod"),
    ("frame.demodulator", "OfdmFrameDemod"),
    ("frame.demodulator", "OfdmFrameStreamDemod"),
    ("modulate.dvb_t_frame", "DvbTFrameMod"),
    ("modulate.dvb_t_frame", "DvbTHierFrameMod"),
    ("modulate.dvb_t_super_frame", "DvbTSuperFrameMod"),
    ("demodulate.dvb_t_frame", "DvbTFrameDemod"),
    ("demodulate.dvb_t_frame", "dvb_t_blind_decode"),
    ("demodulate.dvb_t_frame", "DvbTHierFrameDemod"),
    ("demodulate.dvb_t_stream", "DvbTFrameStreamDemod"),
    ("demodulate.dvb_t_stream", "DvbTHierFrameStreamDemod"),
    ("demodulate.dvb_t_super_frame", "DvbTSuperFrameDemod"),
]


@pytest.mark.parametrize("module,name", REPAIRED,
                         ids=[n for _, n in REPAIRED])
def test_entry_point_runs_on_the_card_by_default(module, name):
    import importlib
    obj = getattr(importlib.import_module(f"orion_sdr_tpu_torch.{module}"),
                  name)
    assert getattr(P, name) is obj
    p = inspect.signature(obj).parameters["device"]
    assert p.default == "cuda" and p.kind is p.KEYWORD_ONLY


def test_frame_classes_accept_cache():
    plan = P.CarrierPlan(64, 16).with_contiguous_data()
    cfg = P.OfdmConfig(plan, fs=48e3)
    pre = P.OfdmPreamble(repeat_len=32, num_repeats=2)
    table = P.McsTable.default_ladder()
    cache = P.CodecCache()
    for make in (lambda: P.OfdmFrameMod(cfg, table, pre, cache=cache,
                                        device="cpu"),
                 lambda: P.OfdmFrameMod(cfg, table, pre, cache, device="cpu"),
                 lambda: P.OfdmFrameDemod(cfg, table, cache=cache,
                                          device="cpu"),
                 lambda: P.OfdmFrameStreamDemod(cfg, table, pre,
                                                cache=cache, device="cpu")):
        assert make().device == torch.device("cpu")


def test_ofdm_config_with_methods_and_validate():
    """tests/test_api_surface.py's with_* and validate() checks on the
    port's ``OfdmConfig``."""
    plan = P.CarrierPlan(256, 64).with_contiguous_data(edge_guard=24)
    cfg = P.OfdmConfig(plan, fs=1e6)
    c = cfg.with_outer_fec(P.OuterFec.bch(8)).with_inner_fec(
        P.InnerFec.ldpc("N512R12"))
    c.validate()
    assert cfg.with_symbol_window_beta_guard(
        9.0).carrier_plan.window_roll_off == 32
    assert cfg.with_symbol_window_beta_tu(
        0.05).carrier_plan.window_roll_off == round(0.05 * 256)
    cfg.with_tx_lowpass_null_band(45, 60.0).validate()
    with pytest.raises(ValueError):
        cfg.with_equalizer_method("bogus").validate()
    with pytest.raises(ValueError):
        cfg.with_scrambler(P.ScramblerKind.additive(0b1001, 15,
                                                    per_frame=True)
                           ).with_header_format("no_header").validate()
    with pytest.raises(ValueError):
        cfg.with_inner_interleaver(P.InterleaverKind.block(0, 8)).validate()
    with pytest.raises(ValueError):
        cfg.with_outer_interleaver(
            P.InterleaverKind.convolutional(12, 0)).validate()
    for n, p in ((0, 16), (300, 16), (204, 0), (10, 12), (204, 15)):
        with pytest.raises(ValueError):
            cfg.with_outer_fec(P.OuterFec.reed_solomon(n, p)).validate()


def test_trace_writes_a_profiler_trace(tmp_path):
    with P.trace(str(tmp_path)) as t:
        y, _ = P.dsp.osc.rotate(torch.ones(1024, dtype=torch.complex64),
                                100.0, 8000.0)
        float(y[0].real)
    assert t.path and os.path.dirname(t.path) == str(tmp_path)
    assert os.path.getsize(t.path) > 0


def test_measure_times_the_call():
    calls = []
    msps, dt = P.measure(lambda: calls.append(np.ones(8)), 4_000_000,
                         repeats=3)
    assert len(calls) == 3 and dt > 0 and msps == 12.0 / dt
