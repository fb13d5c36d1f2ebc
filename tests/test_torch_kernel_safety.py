"""The memory-safety and determinism harness (``tests/torch_kernel_safety.py``)
on the CPU, where no kernel runs:

- its case table reaches every launching C entry of every ``CudaLib`` in
  ``orion_sdr_tpu_torch/ops/*.py``, and every branch each entry selects as
  its source reads (template instantiations, dispatch cases, the load and
  decision paths), each in at least one of chip_smoke [55]'s smallest
  cases; and the shapes and alignments each kernel's risks call for;
- its band, halo, input and determinism checks pass every kernel's plain
  version and catch deliberately faulty stand-ins (a write one element
  past or before an output, a read one element before or past an input, a
  write into an input, an element never written, a result that changes
  from launch to launch); its watch finds the step and window where a kept
  tensor's bytes changed;
- each kernel's plain version, at one ragged shape, equals the JAX function
  it replaces on the same seeded numpy inputs (exact where the port rounds
  as the JAX package does, else within the tolerance stated at each test).
"""

import importlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_kernel_safety as S
from orion_sdr_tpu import gnss as JG
from orion_sdr_tpu.codec import psk31 as JC
from orion_sdr_tpu.demodulate import digital as JD
from orion_sdr_tpu.demodulate import psk31 as JP
from orion_sdr_tpu.dsp import agc as JA
from orion_sdr_tpu.fec import bch_device as JB
from orion_sdr_tpu.fec import conv as jconv
from orion_sdr_tpu.fec.ldpc import _graph_key, bp_decode as jax_bp_decode, \
    ldpc_graph as jax_ldpc_graph
from orion_sdr_tpu.ops.ldpc_bp import bp_decode_pallas

from orion_sdr_tpu_torch.buildlib import CudaLib
from orion_sdr_tpu_torch.dsp import agc as PA
from orion_sdr_tpu_torch.fec import bch_device as PB
from orion_sdr_tpu_torch.ops import gnss_track, ldpc_bp, outer_fec, \
    psk31_pll, psk31_viterbi, viterbi

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = os.path.join(ROOT, "orion_sdr_tpu_torch", "ops")


@pytest.fixture(scope="module")
def setups():
    # the main-path shapes add no branch and are too large for the CPU
    return {c: S.setup(c, CPU) for c in S.CASES if not c.main}


# ── the table against the sources ────────────────────────────────────────────

def _libs():
    libs = []
    for name in sorted(os.listdir(OPS)):
        if name.endswith(".py") and name != "__init__.py":
            mod = importlib.import_module(f"orion_sdr_tpu_torch.ops.{name[:-3]}")
            libs += [v for v in vars(mod).values() if isinstance(v, CudaLib)]
    return libs


def _entry(src: str, fn: str):
    """(parameters, body) of the C entry ``fn``."""
    m = re.search(r'extern\s+"C"\s+int\s+' + fn + r'\s*\(([^)]*)\)\s*\{',
                  src)
    assert m, fn
    nxt = src.find('extern "C"', m.end())
    return m.group(1), src[m.end():nxt if nxt >= 0 else len(src)]


def launching_entries():
    """(library, entry) of every C entry that takes a stream: the ones that
    launch a kernel (the others answer launch-plan queries)."""
    out = []
    for lib in _libs():
        with open(lib.src) as f:
            src = f.read()
        for fn in lib.argtypes:
            params, _ = _entry(src, fn)
            if params.replace(" ", "").endswith("void*stream"):
                out.append((lib, fn))
    return out


def source_branches(lib, fn: str) -> set:
    """The branches entry ``fn`` selects, read from its source."""
    with open(lib.src) as f:
        src = f.read()
    _, body = _entry(src, fn)
    if fn == "ldpc_bp_decode":
        codes = {int(v) for v in re.findall(
            r"constexpr int k(?:SumProduct|MinSum|SumProductEdge) = (\d+)",
            src)}
        exact = {int(d) for d in re.findall(
            r"case (\d+): return ldpc_bp_kernel<RULE, \1, true>", src)}
        generic = {int(d) for d in re.findall(
            r"ldpc_bp_kernel<RULE, (\d+), false>", src)}
        assert "const int bulk =" in body
        return ({("rule", c) for c in codes}
                | {("width", d, True) for d in exact}
                | {("width", d, False) for d in generic}
                | {("load", "bulk"), ("load", "word")})
    if fn == "viterbi_acs_traceback":
        radices = {int(v) for v in re.search(
            r"radix != (\d) && radix != (\d)", src).groups()}
        assert "pm0 != nullptr" in body and "dec_scratch != nullptr" in body
        return ({("radix", r) for r in radices}
                | {("mode", "chunked"), ("mode", "terminated"),
                   ("decisions", "shared"), ("decisions", "global")})
    if fn in ("outer_bch_decode", "outer_rs_decode"):
        macro = "ORION_BCH_CASE" if fn == "outer_bch_decode" else \
            "ORION_RS_CASE"
        ts = {int(v) for v in re.findall(macro + r"\((\d)\)", body)}
        lanes = {int(v) for v in re.findall(r"<TT, (\d+)>", body)}
        key = "t" if fn == "outer_bch_decode" else "half"
        return {(key, t, g) for t in ts for g in lanes}
    if fn in ("psk31_pll", "psk31_viterbi", "onepole_two_rate"):
        pat = (r"onepole_two_rate_kernel<(true|false)>"
               if fn == "onepole_two_rate" else r"launch<(true|false)>")
        key = {"psk31_pll": "qpsk", "psk31_viterbi": "coherent",
               "onepole_two_rate": "ge"}[fn]
        return {(key, v == "true") for v in re.findall(pat, body)}
    if fn == "dd_pll":
        return {("template", int(n), s == "true", z == "true")
                for n, s, z in re.findall(
                    r"launch<(\d+), (true|false), (true|false)>", body)}
    if fn == "gnss_track":
        assert "win_cap = 0" in body
        return ({("threads", int(t)) for t in re.findall(r"case (\d+):",
                                                          body)}
                | {("window", True), ("window", False)})
    if fn == "gardner":
        assert "gardner_kernel<<<" in body
        return {("gardner",)}
    assert fn in ("dd_pll_sincos_mismatches", "psk31_viterbi_lengths"), fn
    return {("helper",)}


def test_every_launching_entry_is_in_the_table(setups):
    entries = {fn for _, fn in launching_entries()}
    assert len(entries) == 12
    assert entries == {s.entry for s in setups.values()}


@pytest.mark.parametrize("lib,fn", launching_entries(),
                         ids=[fn for _, fn in launching_entries()])
def test_the_table_reaches_every_branch_of_each_entry(setups, lib, fn):
    want = source_branches(lib, fn)
    cases = [(c, s) for c, s in setups.items() if s.entry == fn]
    got = set().union(*(s.branches for _, s in cases))
    assert got == want
    smoke = set().union(*(s.branches for c, s in cases if c.smoke))
    assert smoke == want          # chip_smoke [55] reaches each branch


def _values(kernel, key):
    return {c.params[key] for c in S.CASES
            if c.kernel == kernel and not c.main}


def test_the_table_has_each_kernels_risky_shapes():
    assert {c.kernel for c in S.CASES if c.main} == set(S.SETUPS) - {
        "sincos", "lengths"}
    bp = [c.params for c in S.CASES if c.kernel == "bp"]
    assert {1, 37}.issubset({p["B"] for p in bp})
    assert {p["skew"] % 16 for p in bp} == {0, 4}
    for resident, B, grids in ((660, 37, [37, 3, 1]), (660, 700, [660, 3, 1]),
                               (660, 1, [1])):
        assert S.bp_grids(B, resident) == grids
    vit = [c.params for c in S.CASES if c.kernel == "viterbi"]
    for radix in (2, 4):
        mine = [p for p in vit if p["radix"] == radix]
        assert {p["mode"] for p in mine} == {"chunked", "terminated"}
        assert {1, 33}.issubset({p["L"] for p in mine})
    assert any(p["T"] % 2 for p in vit if p["radix"] == 2)
    for kind, key in (("bch", "t"), ("rs", "n_parity")):
        cases = [c.params for c in S.CASES if c.kernel == kind]
        for v in _values(kind, key):
            assert {1, 37}.issubset({p["B"] for p in cases if p[key] == v})
        shapes, lanes = S._outer_shapes(kind, 37, CPU)
        assert shapes[0] == {} and lanes == {16, 32}
        assert {s["lanes"] for s in shapes[1:]} == {16, 32}
    for kind, key in (("pll", "qpsk"), ("h", "coherent"), ("onepole", "ge")):
        assert _values(kind, key) == {False, True}
    assert _values("pll", "rows") == _values("h", "rows") == {1, 31, 33}
    assert _values("pll", "n") == {1, 31, 33}
    assert _values("h", "n") == {1, 33}
    assert _values("onepole", "rows") == {1, 33}
    assert _values("onepole", "n") == {1, 63, 65}
    assert _values("dd", "order") == {"bpsk", "qpsk", "qam16", "qam64",
                                      "qam256"}
    ga = [c.params for c in S.CASES if c.kernel == "gardner"]
    assert {511, 512, 513, 2049}.issubset({p["n"] for p in ga})
    assert any(p["skew"] % 16 == 8 for p in ga)
    assert any(p["loop_bw"] >= 0.95 * p["sps"] for p in ga)   # steps back
    assert any(p["mu0"] < 0 for p in ga)
    tk = [c.params for c in S.CASES if c.kernel == "track"]
    assert {p["threads"] for p in tk} == {128, 256, 512}
    assert any(p["S"] == 1 for p in tk) and any(p["E"] == 1 for p in tk)
    assert any(p["at_end"] for p in tk)


SMOKE = [c for c in S.CASES if c.smoke]


@pytest.mark.parametrize("case", SMOKE, ids=[c.label for c in SMOKE])
def test_each_case_launches_through_its_wrappers_own_launch(monkeypatch,
                                                            case):
    """Each case's launch, with the C entry's call recorded in place of
    the card's: the case's entry, with as many arguments as its
    declaration, every input and output of the case passed by pointer, and
    each launch-shape override passed on."""
    calls = []
    for lib in _libs():
        monkeypatch.setattr(lib, "launch", lambda fn, dev, *a, lib=lib:
                            calls.append((lib, fn, a)))
    monkeypatch.setattr(ldpc_bp, "_resident", lambda t, code, dev: {
        "threads": 96, "blocks_per_sm": 2, "smem": 4096, "sms": 132})
    monkeypatch.setattr(outer_fec, "launch_plan", lambda kind, B, dev:
                        outer_fec.plan_for(kind, B, 132))
    s = S.setup(case, CPU)
    ins = {k: t for k, (t, _, _) in s.ins.items()}
    outs = {k: torch.empty(shape, dtype=dtype)
            for k, (shape, dtype, _, _) in s.outs.items()}
    for shape in s.shapes:
        calls.clear()
        s.launch(ins, outs, shape)
        assert len(calls) == 1
        lib, fn, args = calls[0]
        assert fn == s.entry
        assert len(args) + 1 == len(lib.argtypes[fn])     # + the stream
        for t in list(ins.values()) + list(outs.values()):
            assert t.data_ptr() in args
        for v in shape.values():
            assert v in args


# ── the checks on plain versions and faulty stand-ins ────────────────────────

def _smallest():
    """The smoke case of each entry and kernels-line name with the fewest
    elements, the global-scratch Viterbi cases left to the card (their
    plain loop runs 25 600 steps)."""
    best = {}
    for c in S.CASES:
        p = c.params
        if not c.smoke or (c.kernel == "viterbi"
                           and p["T"] > viterbi.MAX_SMEM_STEPS):
            continue
        s = S.setup(c, CPU)
        size = sum(t.numel() for t, _, _ in s.ins.values())
        key = (s.entry, s.name)
        if key not in best or size < best[key][0]:
            best[key] = (size, c)
    return [c for _, c in best.values()]


SMALLEST = _smallest()


@pytest.mark.parametrize("case", SMALLEST, ids=[c.label for c in SMALLEST])
def test_every_plain_version_passes_every_check(case):
    r = S.run_case(case, CPU, launch=S.plain_launch(case, CPU), reps=2,
                   busy=False)
    assert r["ok"], r
    assert r["launches"] >= 3 + 2


ONEPOLE = S.case("onepole", ge=False, rows=33, n=65, skew=4)


def _faulty(kind):
    """A stand-in for the two-rate one-pole kernel that writes the plain
    version's outputs and makes one fault of ``kind``."""
    s = S.setup(ONEPOLE, CPU)
    calls = [0]

    def launch(i, o, shape):
        x, env = i["x"], o["env"]
        want = S.plain_rows(s, i)
        env.copy_(want["env"])
        keep = -1 if kind == "leaves an element" else None
        o["last"][:keep].copy_(want["last"][:keep])
        flat, xf = env.reshape(-1), x.reshape(-1)
        if kind == "writes past":
            torch.as_strided(flat, (flat.numel() + 1,), (1,))[-1] = 0.0
        elif kind == "writes before":
            torch.as_strided(flat, (1,), (1,),
                             flat.storage_offset() - 1)[0] = 0.0
        elif kind == "reads before":
            env[0, 0] += torch.as_strided(xf, (1,), (1,),
                                          xf.storage_offset() - 1)[0]
        elif kind == "reads past":
            env[-1, -1] += torch.as_strided(xf, (xf.numel() + 1,),
                                            (1,))[-1]
        elif kind == "writes its input":
            x[0, 0] += 1.0
        elif kind == "changes between launches":
            env[0, 0] += calls[0]
        calls[0] += 1
    return launch


@pytest.mark.parametrize("kind,check", [
    ("writes past", "bands"), ("writes before", "bands"),
    ("reads before", "halos"), ("reads past", "halos"),
    ("writes its input", "inputs"), ("leaves an element", "plain"),
    ("changes between launches", "alone")])
def test_the_checks_catch_a_faulty_stand_in(kind, check):
    r = S.run_case(ONEPOLE, CPU, launch=_faulty(kind), reps=2, busy=False)
    assert not r["ok"] and r["failed"]
    got = r["determinism"][check] if check == "alone" else r[check]
    assert got is False, r


def test_fingerprints_and_the_watch():
    x = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    assert S.fingerprint(x) == S.fingerprint(x.clone())
    y = x.clone()
    y.view(torch.int32)[1, 4] ^= 1
    assert S.fingerprint(y) != S.fingerprint(x)
    assert not S.same_bytes(x, y) and S.same_bytes(x, x.clone())
    w = S.Watch()
    live = torch.zeros((2, 600), dtype=torch.complex64)
    w.keep("iq", live)
    w.check("first")
    live[1, 300] = 1e-30
    live[1, 301] = 2.0
    w.check("second")
    w.check("third")
    assert not w.finish()
    assert w.parted["step"] == "second" and w.parted["side"] == "host"
    assert (w.parted["row"], w.parted["index"]) == (1, 300)
    assert w.parted["window"] == [256, 512]
    assert w.parted["changed"] == w.parted["changed_in_window"] == 2
    assert w.parted["bits"] == ["0xda24260", "0x0"]      # 1e-30's bits
    quiet = S.Watch()
    quiet.keep("x", torch.ones(5))
    quiet.check("only")
    assert quiet.finish() and quiet.parted is None
    pair = S.Watch()
    a = torch.ones(3)
    pair.keep("a", a)
    b = a.clone()
    b.view(torch.int32)[2] ^= 1 << 11               # one mantissa bit
    pair.keep("b", b)
    pair.match("copies", "b", "a")
    assert not pair.finish()
    assert pair.parted["side"] == "copy" and pair.parted["index"] == 2
    assert pair.parted["bits"] == ["0x800"]


# ── each plain version against the JAX function it replaces ──────────────────

def test_bp_plain_version_matches_jax():
    """Rules 0 and 1 (kernel 1) against the JAX f32 ``bp_decode`` on a
    ragged batch of 5 (4 decodable rows, 1 garbage): equal bits and
    unsatisfied counts on the decodable rows, garbage converging in
    neither. Rule 2 (kernel 2) against ``_bp_kernel_factory`` in interpret
    mode on converged rows only (it rounds its contractions to bf16)."""
    g = S.bp_graph("N512R12")
    llr = S.bp_llrs(g, 5, np.random.default_rng(21))
    dec, junk = [0, 1, 3, 4], [2]
    for rule in ("min_sum", "scaled_min_sum", "sum_product"):
        jb, ju = jax_bp_decode(jax_ldpc_graph("N512R12"), llr, 20, rule)
        pb, pu = ldpc_bp.bp_decode_reference(g, torch.as_tensor(llr), 20,
                                             rule)
        assert np.array_equal(pu.numpy()[dec], np.asarray(ju)[dec])
        assert np.array_equal(pb.numpy()[dec], np.asarray(jb)[dec])
        assert (pu.numpy()[dec] == 0).all()
        assert (pu.numpy()[junk] > 0).all()
        assert (np.asarray(ju)[junk] > 0).all()
    rows = llr[dec]
    best, mu = bp_decode_pallas(_graph_key(jax_ldpc_graph("N512R12")), rows,
                                20, rule="sum_product_edge", interpret=True)
    pb, pu = ldpc_bp.bp_decode_reference(g, torch.as_tensor(rows), 20,
                                         "sum_product_edge",
                                         store="codeword")
    done = np.asarray(mu) == 0
    assert done.sum() >= 3 and (pu.numpy() == 0).all()
    assert np.array_equal(pb.numpy()[done],
                          np.asarray(best)[done].astype(np.uint8))


@pytest.mark.parametrize("radix", [2, 4])
def test_viterbi_plain_versions_match_jax(radix):
    """Terminated k5 rate 1/2 on Gaussian LLRs (no ties), 3 rows: 77 info
    bits (an odd trellis) for radix 2, 80 (84 steps) for radix 4, each
    equal to the JAX ``viterbi_decode_soft``."""
    info = 77 if radix == 2 else 80
    rng = np.random.default_rng(radix)
    bits = rng.integers(0, 2, (3, info)).astype(np.uint8)
    coded = np.asarray(jconv.conv_encode_punctured(bits, "1/2", "k5"))
    llr = ((1.0 - 2.0 * coded) * 2.0 + 1.5 * rng.standard_normal(
        coded.shape)).astype(np.float32)
    ref = np.asarray(jconv.viterbi_decode_soft(llr, info, "1/2", "k5"))
    got = viterbi.viterbi_terminated_reference(torch.as_tensor(llr), info,
                                               "1/2", "k5", radix)
    assert np.array_equal(got.numpy(), ref)


def test_outer_plain_versions_match_jax():
    """BCH t = 3 and RS(60, 54) on a batch of 5 with 0..t + 3 errors a
    row: messages and flags equal to the JAX device decoders."""
    code = S.shortened_bch_for(3)
    rng = np.random.default_rng(5)
    words = code.encode(rng.integers(0, 2, (5, code.k)).astype(np.uint8))
    for i in range(5):
        words[i, rng.choice(code.n, i + 1, replace=False)] ^= 1
    out, ok = PB.bch_decode_batch_reference(code.n, code.k, 3,
                                            torch.as_tensor(words))
    jout, jok = JB.bch_decode_batch_device(code.n, code.k, 3, words)
    assert np.array_equal(out.numpy(), np.asarray(jout))
    assert np.array_equal(ok.numpy().astype(bool), np.asarray(jok)
                          .astype(bool))
    rs = S.ReedSolomon(60, 6)
    words = rs.encode(rng.integers(0, 256, (5, rs.k)).astype(np.uint8))
    for i in range(5):
        words[i, rng.choice(60, i, replace=False)] ^= rng.integers(
            1, 256, i).astype(np.uint8)
    out, ok = PB.rs_decode_batch_reference(60, 6, torch.as_tensor(words))
    jout, jok = JB.rs_decode_batch_device(60, 6, words)
    assert np.array_equal(out.numpy(), np.asarray(jout))
    assert np.array_equal(ok.numpy().astype(bool), np.asarray(jok)
                          .astype(bool))


@pytest.mark.parametrize("qpsk", [False, True])
def test_pll_plain_version_matches_jax(qpsk):
    """3 rows of 45 symbols with their own carries, against ``_pll_scan``
    under one jit: decisions exact, the rest within 1e-4 of the peak (XLA
    contracts products and sums into fused multiply-adds; the port rounds
    them apart)."""
    dots, prev, acc = S.pll_inputs(3, 45, qpsk, np.random.default_rng(45))
    ref, (rp, ra) = jax.jit(lambda d, p, a: JP._pll_scan(
        d, 256, 1.0, qpsk, p, a))(dots, prev, acc)
    c_fb, scale = S.pll_constants(256, 1.0)
    got, gp, ga = psk31_pll.psk31_pll_reference(
        torch.as_tensor(dots), torch.as_tensor(prev), torch.as_tensor(acc),
        c_fb, scale, np.float32(S.PLL_GAIN), qpsk)
    ref = np.asarray(ref)
    peak = max(np.abs(ref).max(), 1.0)
    assert np.abs(got.numpy() - ref).max() <= 1e-4 * peak
    assert np.abs(gp.numpy() - np.asarray(rp)).max() <= 1e-4
    assert np.abs(ga.numpy() - np.asarray(ra)).max() <= 1e-4
    lead = (lambda a: a[..., 0]) if qpsk else (lambda a: a)
    assert np.array_equal(lead(got.numpy()) >= 0, lead(ref) >= 0)


def test_onepole_plain_version_matches_jax():
    """agc_rms with attack != release on 3 complex rows of 70 samples: the
    port's CPU path (the two-rate one-pole's plain version) against the
    JAX scan under one jit, within 1e-5 of the peak (the JAX CPU build
    contracts a·env + b·x into one fused multiply-add)."""
    rng = np.random.default_rng(70)
    x = (rng.standard_normal((3, 70)) + 1j * rng.standard_normal((3, 70))
         ).astype(np.complex64) * 3.0
    p = JA.design_agc(8000.0, 5.0, 50.0, 0.3)
    ref, renv = jax.jit(lambda v: JA.agc_rms(v, p))(x)
    got, genv = PA.agc_rms(torch.as_tensor(x), p, device="cpu")
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert np.abs(genv.numpy() - np.asarray(renv)).max() <= 1e-5 * np.abs(
        np.asarray(renv)).max()


def test_dd_pll_plain_version_matches_jax():
    """16-QAM, 3 rows of 45 symbols with a phase ramp, each row against
    ``_dd_pll_kernel`` under one jit: within 1e-5 (XLA's cos, sin and
    fused multiply-adds against the port's separate roundings)."""
    z = S.dd_symbols("qam16", 3, 45, np.random.default_rng(16))
    got = S.dd_pll.dd_pll_reference(torch.as_tensor(z), "qam16",
                                    S.DD_LOOP_BW).numpy()
    f = jax.jit(lambda re, im: JD._dd_pll_kernel(re, im, "qam16",
                                                 S.DD_LOOP_BW))
    for r in range(3):
        ref = np.asarray(f(z[r].real.copy(), z[r].imag.copy()))
        assert np.abs(got[r] - ref).max() <= 1e-5


def test_gardner_plain_version_matches_jax():
    """Two shaped QPSK rows of 513 samples at 4 samples a symbol (the
    ring's chunk plus one), 131 symbols, each against the JAX
    ``symbol_sync_gardner``: symbols within 1e-5, positions within 1e-3."""
    z, zt = S.gardner_model().shaped_rows(2, 513, 4, 13)
    out, pos = S.gardner.gardner_reference(zt, 4.0, 131, 0.02, 1.0)
    for r in range(2):
        js, jpos = JD.symbol_sync_gardner(z[r], 4.0, 131, mu0=1.0)
        assert np.abs(out[r].numpy() - np.asarray(js)).max() <= 1e-5
        assert abs(float(pos[r]) - float(jpos)) <= 1e-3


def test_track_plain_version_matches_jax():
    """Two satellites over 5 epochs of a capture whose starts sit in its
    last epoch (the slices clamp at its end), at the plain version's
    default width, against ``_track_scan`` under one jit(vmap): prompts
    within 1e-4 of the peak, frequencies within 1e-2, bases equal,
    fractions within 1e-4."""
    z, codes, starts, f0 = S.track_inputs(2, 5, True,
                                          np.random.default_rng(5))
    f = jax.jit(jax.vmap(lambda c, s, d: JG._track_scan.__wrapped__(
        jnp.asarray(z), c, s, d, S.TRACK_FS, 5, *S.TRACK_GAINS)))
    ref = [np.asarray(a) for a in f(codes, starts, f0)]
    got = [a.numpy() for a in gnss_track.track_reference(
        torch.as_tensor(z), torch.as_tensor(codes), torch.as_tensor(starts),
        torch.as_tensor(f0), S.TRACK_FS, 5, *S.TRACK_GAINS)]
    assert np.abs(got[0] - ref[0]).max() <= 1e-4 * np.abs(ref[0]).max()
    assert np.abs(got[1] - ref[1]).max() <= 1e-2
    assert np.array_equal(got[2], ref[2])
    assert np.abs(got[3] - ref[3]).max() <= 1e-4


@pytest.mark.parametrize("coherent", [False, True])
def test_qpsk31_viterbi_plain_version_matches_jax(coherent):
    """3 rows of 45 symbols at noise 0.3: bits equal to the JAX decoder of
    each row."""
    pairs = S.qpsk31_pairs(3, 45, coherent, np.random.default_rng(31))
    got = psk31_viterbi.psk31_viterbi_reference(torch.as_tensor(pairs),
                                                coherent).numpy()
    jfn = JC.viterbi_decode_coherent if coherent else JC.viterbi_decode
    ref = np.stack([np.asarray(jfn(jnp.asarray(p))) for p in pairs])
    assert np.array_equal(got, ref)
