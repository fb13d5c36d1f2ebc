"""Torch port: the receive paths' spans and counters (``obs``), on the CPU.

Nothing is recorded, and no ``record_function`` is opened, without a
profiler session; under one, the spans nest with their parents, self time
is duration less children, counters add up, each span has a same-named
profiler event on the same clock, and the COFDM batch decode and the FT8
window decode each leave one root with the stages and counts their shapes
give."""

import importlib
import pkgutil
import statistics
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch import obs
from orion_sdr_tpu_torch.fec.ldpc import ldpc_graph
from orion_sdr_tpu_torch.frame import demodulator
from orion_sdr_tpu_torch.frame.chain import block_plan, shortened_bch_for
from orion_sdr_tpu_torch.frame.modulator import header_block_plan

torch.set_num_threads(1)
CPU = "cpu"
FS = 12000.0
# (sequence, MCS, payload bytes, scrambler seed) of the COFDM batch; one
# more frame has its header trashed
SPECS = [(3, 1, 64, 101), (4, 1, 64, 202), (5, 3, 120, 303), (6, 0, 64, 9),
         (7, 1, 120, 44)]


def _link():
    cfg = P.OfdmConfig(P.CarrierPlan(256, 64).with_contiguous_data(
        edge_guard=16), fs=1e6)
    pre = P.OfdmPreamble(repeat_len=128, num_repeats=4).with_training_symbol(
        256, 64)
    return cfg, P.McsTable.default_ladder(), pre


@pytest.fixture(scope="module")
def cofdm():
    """(demod, batch): SPECS' frames and one with a trashed header, AWGN
    at 0.02 × the frame's power."""
    cfg, table, pre = _link()
    mod = P.OfdmFrameMod(cfg, table, pre, device=CPU)
    rng = np.random.default_rng(0x0B5)
    bodies = [mod.modulate_frame(P.FramePacket(
        P.FrameMetadata(seq, mcs), rng.integers(0, 256, n).astype(np.uint8)),
        seed)[pre.total_len():] for seq, mcs, n, seed in SPECS]
    bad = bodies[0].copy()
    bad[:2000] = (rng.standard_normal(2000)
                  + 1j * rng.standard_normal(2000)).astype(np.complex64)
    rows = bodies + [bad]
    batch = np.zeros((len(rows), max(len(b) for b in rows)), np.complex64)
    for i, b in enumerate(rows):
        sig = float(np.mean(np.abs(b) ** 2))
        batch[i, :len(b)] = b
        batch[i] += (rng.standard_normal(batch.shape[1]) + 1j
                     * rng.standard_normal(batch.shape[1])).astype(
                         np.complex64) * np.sqrt(sig * 0.02 / 2)
    demod = P.OfdmFrameDemod(cfg, table, device=CPU)
    return demod, torch.as_tensor(batch)


@pytest.fixture(scope="module")
def ft8():
    """Two FT8 windows, each one standard message at -10 dB."""
    rng = np.random.default_rng(0xF78)
    wins = []
    for i, call in enumerate(("KA1ABC", "W9XYZ")):
        tones = P.ft8_encode(P.pack77(P.Ft8Standard("CQ", call, "FN42")),
                             device=CPU)
        iq = np.asarray(P.ft8_mod(tones, FS, 1000.0 + 50.0 * i, device=CPU))
        sigma = np.sqrt(10 ** (10 / 10) * FS / 2500.0 / 2)
        wins.append(iq + sigma * (rng.standard_normal(len(iq)) + 1j
                                  * rng.standard_normal(len(iq))))
    return torch.as_tensor(np.stack(wins).astype(np.complex64))


def _decode_cofdm(data):
    demod, batch = data
    return demod.decode_batch(batch)


def _decode_ft8(data):
    return P.ft8_decode_windows(data, FS, 950.0, 1150.0, device=CPU)


PATHS = {
    "cofdm": ("orion.frame.decode_batch", _decode_cofdm,
              {"orion.frame.soft_demap", "orion.chain.deinterleave",
               "orion.chain.inner", "orion.chain.outer", "orion.chain.crc",
               "orion.frame.header_parse", "orion.frame.group",
               "orion.frame.packets"}),
    "ft8": ("orion.ft8.decode_windows", _decode_ft8,
            {"orion.ft8.sync", "orion.ft8.bp_crc", "orion.ft8.select",
             "orion.ft8.results"}),
}


def _profiled(fn, n=1):
    mark = obs.recorded()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            fn()
    return obs.since(mark), prof


@pytest.mark.parametrize("path", sorted(PATHS))
def test_nothing_is_recorded_without_a_profiler(request, monkeypatch, path):
    _, fn, _ = PATHS[path]
    data = request.getfixturevalue(path)
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    mark = obs.recorded()
    fn(data)
    assert obs.recorded() == mark
    assert not obs.recording()
    assert [n for n in opened if n.startswith("orion.")] == []
    # the same call under the profiler opens them
    got, _ = _profiled(lambda: fn(data))
    assert len(got) == 1
    assert {n for n in opened if n.startswith("orion.")} >= \
        PATHS[path][2] | {PATHS[path][0]}


def test_spans_nest_with_self_time_and_counters():
    def work():
        with obs.root("orion.test.root"):
            obs.count("items", 2)
            with obs.span("orion.test.a"):
                with obs.span("orion.test.b"):
                    time.sleep(0.002)
                obs.count("items", 3)
                time.sleep(0.001)
            with obs.span("orion.test.a"):
                obs.to_host(torch.zeros(5, dtype=torch.int32))
            # host input put on a device counts; a CPU tensor stays put
            meta = torch.empty(4, dtype=torch.complex64, device="meta")
            obs.count_h2d(np.zeros(4, np.complex64), meta)
            obs.count_h2d(meta, meta)
            obs.count_h2d(torch.zeros(4), torch.zeros(4))
            time.sleep(0.001)
    got, _ = _profiled(work)
    (r,) = got
    assert r.name == "orion.test.root" and not obs.recording()
    assert set(r.children) == {"orion.test.a"}
    assert r.children["orion.test.a"][1] == 2
    assert set(r.spans) == {"orion.test.a", "orion.test.b", "orion.d2h"}
    a, b, d = (r.spans[n] for n in ("orion.test.a", "orion.test.b",
                                    "orion.d2h"))
    assert a[1] == 2 and b[1] == 1 and d[1] == 1
    assert a[0] == r.children["orion.test.a"][0] >= b[0] + d[0]
    assert b[0] >= 2e6
    assert r.self_ns == r.duration_ns - a[0] >= 1e6   # less the children
    assert r.counters == {"items": 5, "d2h.reads": 1, "d2h.bytes": 20,
                          "h2d.bytes": 32}
    assert r.ms("orion.test.b") == b[0] / 1e6 and r.ms("none") == 0


def test_roots_of_one_profiled_run_share_a_session():
    def one():
        with obs.root("orion.test.root"):
            pass
    first, _ = _profiled(one, 3)
    one()                                      # unprofiled: a new session
    second, _ = _profiled(one, 2)
    assert len({r.session for r in first}) == 1
    assert len({r.session for r in second}) == 1
    assert second[0].session == first[0].session + 1
    assert obs.roots()[-2:] == second


def test_spans_sit_on_the_profiler_clock(ft8):
    got, prof = _profiled(lambda: _decode_ft8(ft8), 3)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        if e.name.startswith("orion."):
            events.setdefault(e.name, []).append(e)
    roots = events["orion.ft8.decode_windows"]
    assert len(roots) == len(got) == 3
    # the roots' edges, and every other span's summed time a call
    gaps = [abs(e.time_range.start - (r.start_ns - t0) / 1e3)
            for e, r in zip(roots, got)] + \
        [abs(e.time_range.end - (r.end_ns - t0) / 1e3)
         for e, r in zip(roots, got)]
    for name in set(events) - {"orion.ft8.decode_windows"}:
        ev = sum(e.time_range.end - e.time_range.start for e in events[name])
        sp = sum(r.spans[name][0] for r in got) / 1e3
        gaps.append(abs(ev - sp) / len(events[name]))
        assert len(events[name]) == sum(r.spans[name][1] for r in got)
    assert statistics.median(gaps) < 50.0, gaps


def test_cofdm_batch_gives_one_root_a_group_an_mcs_and_length(cofdm):
    out = None

    def call():
        nonlocal out
        out = _decode_cofdm(cofdm)
    (r,), _ = _profiled(call)
    assert [isinstance(p, P.FramePacket) for p in out] == \
        [True] * len(SPECS) + [False]
    assert set(r.children) == PATHS["cofdm"][2]
    groups = {(m, n) for _, m, n, _ in SPECS}
    assert r.children["orion.frame.group"][1] == len(groups)
    assert r.spans["orion.frame.soft_demap"][1] == 1 + len(groups)
    assert r.spans["orion.chain.crc"][1] == 1 + len(groups)
    cfg, table, _ = _link()
    g = ldpc_graph("N512R12")
    hplan = header_block_plan(cfg)
    rows = (len(SPECS) + 1) * (hplan.inner_coded_bits // g.n)
    words = 0
    for m, n in groups:
        mcs = table.get(m)
        plan = block_plan(n, cfg.payload_crc, mcs.outer_fec, mcs.inner_fec,
                          cfg.outer_interleaver, cfg.inner_interleaver)
        k = sum(1 for _, mm, nn, _ in SPECS if (mm, nn) == (m, n))
        rows += k * (plan.inner_coded_bits // g.n)
        words += k * (plan.outer_coded_bits // shortened_bch_for(
            mcs.outer_fec.t).n)
        assert r.counters[f"group.mcs{m}.len{n}"] == k
    c = r.counters
    assert c["frames"] == len(SPECS) + 1
    assert c["frames.header_fail"] == 1 and c["frames.crc_fail"] == 0
    assert c["bp.rows"] == rows and c["bch.words"] == words
    assert c["bch.words_failed"] == 0
    # header: the LDPC ok and the frames' bits; each group: the LDPC ok
    # and the outer code's input (the host BCH coder on the CPU)
    assert c["d2h.reads"] == 2 + 2 * len(groups)
    assert r.launches == {} and "h2d.bytes" not in c


def test_cofdm_batch_counts_the_frames_and_bytes_each_crc_stage_checked(
        monkeypatch, cofdm):
    calls = []
    real = demodulator.decode_chain_batch

    def chain_batch(llrs, plan, *a, **k):
        calls.append((llrs.shape[0], plan.framed_bytes))
        return real(llrs, plan, *a, **k)
    monkeypatch.setattr(demodulator, "decode_chain_batch", chain_batch)
    (r,), _ = _profiled(lambda: _decode_cofdm(cofdm))
    # the header's call holds every frame, the groups' the frames it passed
    assert calls[0][0] == len(SPECS) + 1
    assert sum(rows for rows, _ in calls[1:]) == len(SPECS)
    assert r.counters["crc.rows"] == sum(rows for rows, _ in calls)
    assert r.counters["crc.bytes"] == sum(rows * n for rows, n in calls)


def test_ft8_windows_give_one_root_with_four_stages(ft8):
    out = None

    def call():
        nonlocal out
        out = _decode_ft8(ft8)
    (r,), _ = _profiled(call)
    assert [o.message.call_de for o in out] == ["KA1ABC", "W9XYZ"]
    assert set(r.children) == PATHS["ft8"][2]
    assert all(v[1] == 1 for v in r.children.values())
    assert r.counters["windows"] == 2 and r.counters["windows.decoded"] == 2
    assert r.counters["d2h.reads"] == 2
    assert r.counters["bp.rows"] == 2 * 4


def test_trace_holds_the_roots_of_its_block(tmp_path, ft8):
    _decode_ft8(ft8)
    with P.trace(str(tmp_path)) as t:
        _decode_ft8(ft8)
        _decode_ft8(ft8)
    assert [r.name for r in t.spans] == ["orion.ft8.decode_windows"] * 2
    assert t.spans == obs.roots()[-2:]


def test_every_kernel_launch_counter_is_read():
    """Each ``.launches*`` attribute of an ``ops`` wrapper is in
    ``obs.LAUNCH_COUNTERS``, so a root's launches see every kernel."""
    import orion_sdr_tpu_torch.ops as ops
    found = {}
    for mi in pkgutil.iter_modules(ops.__path__):
        m = importlib.import_module(f"orion_sdr_tpu_torch.ops.{mi.name}")
        names = tuple(sorted(
            f"{n}.{a}" for n, f in vars(m).items()
            if callable(f) and getattr(f, "__module__", None) == m.__name__
            for a in vars(f) if a.startswith("launches")))
        if names:
            found[mi.name] = names
    assert found == {k: tuple(sorted(v))
                     for k, v in obs.LAUNCH_COUNTERS.items()}
