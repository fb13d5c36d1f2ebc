"""The JAX package's own tier-1 test files, run on the port.

``load(name)`` reads ``tests/<name>`` as text, rewrites its imports of
``orion_sdr_tpu`` (``import orion_sdr_tpu as sdr``, ``from orion_sdr_tpu.x
import ...``, ``from orion_sdr_tpu import ...``) to ``orion_sdr_tpu_torch``,
its imports of another JAX test file (``from tests.test_frame import
...``) to that file's loaded copy and of ``tests.helpers`` to ``helpers``
(the same file, reached from tests/ on the path), and executes the result
into a fresh module; nothing else in the test bodies changes. ``export(ns, names)`` puts
each loaded file's tests and test classes into a test module's namespace
under the file's prefix (``test_fec_matrix.py::test_rs`` becomes
``test_fec_matrix__test_rs``, a class ``TestX`` becomes
``Test_fec_matrix__TestX``), with their own ``parametrize`` and ``slow``
marks, and its fixtures under their own names; it leaves out what
``EXCLUDED`` lists.

Placement. The port's entry points send host data to the card. On the CPU
(tier 1) ``cpu_placement()`` sends it to the CPU for the duration of one
test: every function of the port with a ``"cuda"`` default gets ``"cpu"``,
and every module's binding of the two host-data resolvers
(``dsp/device.py::on_device``, ``frame/chain.py::_outer_device``) becomes one
that resolves host data to the CPU; all are restored on exit, so the port's
defaults stay what they are for every other test. On the card
(``card=True``) nothing of the port is patched: host data goes to the card
as a user's would, and ``card_arrays()`` lets numpy read a CUDA tensor as it
reads a JAX device array (``np.asarray`` copies it to the host); the lines
that import ``jax`` are dropped (the card machine has no JAX) and every case
that names ``jax`` or ``jnp`` is left out, by reason (a) of ``EXCLUDED``.

This module imports pytest, torch and the port only: never ``jax`` or
``orion_sdr_tpu``.
"""

from __future__ import annotations

import ast
import functools
import importlib
import inspect
import pkgutil
import re
import sys
import types
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path

import pytest
import torch

import orion_sdr_tpu_torch as T

HERE = Path(__file__).resolve().parent

# the tier-1 contract modules, tests/test_torch_contracts_<area>.py, and the
# files each loads (grouped so that xdist's --dist loadfile spreads them)
AREAS = {
    "fec": ("test_fec.py", "test_fec_matrix.py", "test_ops.py"),
    "frame": ("test_frame.py", "test_frame_matrix.py", "test_ofdm.py",
              "test_ofdm_matrix.py", "test_otfs.py", "test_dvb_t.py",
              "test_dvb_t_hier.py", "test_tps_ts_matrix.py"),
    "dsp": ("test_dsp.py", "test_dsp_matrix.py", "test_multicarrier.py",
            "test_multicarrier_matrix.py", "test_resample.py",
            "test_sync_matrix.py", "test_util_matrix.py",
            "test_parallel.py"),
    "analog": ("test_digital.py", "test_analog_matrix.py",
               "test_analog_roundtrip.py", "test_fm_broadcast.py",
               "test_blocks.py", "test_channel.py", "test_gnss.py",
               "test_gnss_nav.py"),
    "narrow": ("test_ft8.py", "test_psk31.py", "test_wspr.py",
               "test_morse_decode.py", "test_css.py", "test_adsb.py",
               "test_ais.py", "test_ax25.py", "test_pocsag.py",
               "test_sstv.py", "test_message_matrix.py"),
    "streams": ("test_robustness.py", "test_property_fuzz.py",
                "test_checkpoint.py", "test_classify.py"),
}

# The JAX package's tier-1 test files the port is held to: every
# tests/test_*.py of the JAX package but test_perf_sweeps.py (tier 3, held
# by tests/torch_sweeps.py), test_bench_harness.py (the JAX bench's own
# harness) and test_api_surface.py (held by tests/test_torch_api_surface.py,
# which walks both packages).
FILES = tuple(sorted(f for names in AREAS.values() for f in names))
NOT_LOADED = ("test_perf_sweeps.py", "test_bench_harness.py",
              "test_api_surface.py")

_PKG_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)orion_sdr_tpu(?=[\s.])",
                         re.M)
_TEST_IMPORT = re.compile(r"^(\s*from\s+)tests\.(test_\w+)(?=\s+import\b)",
                          re.M)
_HELPERS_IMPORT = re.compile(r"^(\s*from\s+)tests\.helpers(?=\s+import\b)",
                             re.M)
_JAX_IMPORT = re.compile(r"^(\s*)(?:import|from)\s+jax(?:lib)?\b.*$", re.M)


# ── the table of what does not run ──────────────────────────────────────────


@dataclass(frozen=True)
class Out:
    """Why a JAX case does not run on the port, and the port test that holds
    its contract instead. ``reason``: (a) it imports jax/jnp or builds a JAX
    mesh; (b) it reaches a private or TPU-only name the port deliberately
    lacks; (c) it applies a numpy-only method to, or compares element-wise
    with a numpy array, a returned array (the port returns tensors; its twin
    in the same contract module makes the assertion on ``np.asarray(...)``);
    (d) it is ``slow`` in the JAX file. ``card``: left out on the card only
    (it names jax or jnp, and the card machine has no JAX)."""
    reason: str
    why: str
    held_by: str
    card: bool = False


_TWIN = "its twin (tests/torch_contract_twins.py)"
_NP = ("the port returns a tensor where the JAX package returns an array: ")
_JNP = ("it builds its input with jnp.asarray; the card machine has no JAX "
        "(in tier 1 it runs whole)")

EXCLUDED: dict[str, Out] = {
    # (a) JAX itself
    "test_parallel.py": Out(
        "a", "every case builds a JAX mesh of the virtual CPU devices "
        "(jax.sharding.Mesh, jax.devices(), the mesh8 fixture) or a "
        "jax.distributed cluster",
        "tests/test_torch_parallel.py (the port's Mesh of host shards "
        "against the JAX functions on the same inputs) and chip_smoke [51]"),
    "test_digital.py::test_symbol_sync_gardner_tracks_offset": Out(
        "a", _JNP, _TWIN, card=True),
    "test_dsp.py::test_atan2_approx_accuracy": Out(
        "a", _JNP + "; the jaxlib case of test_dsp.py", _TWIN, card=True),
    "test_dvb_t.py::test_integer_cfo_on_frame_spectrum": Out(
        "a", _JNP, _TWIN, card=True),
    "test_fec_matrix.py::test_block_interleaver_inverse_f32": Out(
        "a", _JNP, _TWIN, card=True),
    "test_fec_matrix.py::test_block_interleaver_inverse_u8": Out(
        "a", _JNP, _TWIN, card=True),
    "test_fec_matrix.py::test_ldpc_code_rule_error_injected": Out(
        "a", _JNP, _TWIN, card=True),
    "test_fec_matrix.py::test_ldpc_uncorrectable_flagged": Out(
        "a", _JNP, _TWIN, card=True),
    "test_multicarrier_matrix.py::test_cyclic_prefix_is_tail_copy": Out(
        "a", _JNP, _TWIN, card=True),
    "test_multicarrier_matrix.py::test_fft_unity_roundtrip": Out(
        "a", _JNP, _TWIN, card=True),
    "test_multicarrier_matrix.py::test_figure9a_map_llr_roundtrip": Out(
        "a", _JNP, _TWIN, card=True),
    "test_multicarrier_matrix.py::test_grid_map_extract_roundtrip_with_pilots":
        Out("a", _JNP, _TWIN, card=True),
    "test_multicarrier_matrix.py::test_qpsk_figure9a_exact_points": Out(
        "a", _JNP, _TWIN, card=True),
    "test_multicarrier_matrix.py::test_taper_rx_transparent_within_budget":
        Out("a", _JNP, _TWIN, card=True),
    "test_sync_matrix.py::test_sc_metric_plateau_has_peak_at_start": Out(
        "a", _JNP, _TWIN, card=True),
    # (b) names the port deliberately lacks
    "test_fec_matrix.py::test_outer_encode_device_path_matches_host": Out(
        "b", "it replaces frame/chain.py::_outer_device_ok with the JAX "
        "gate's signature (t, n_blocks); the port's gate also takes the "
        "device the call asks for (t, n_blocks, device)",
        "tests/test_torch_bch_device.py::"
        "test_decode_chain_batch_same_on_either_outer_path and "
        "::test_bch_device_encoder_matches_jax_and_host / "
        "::test_rs_device_encoder_matches_jax_and_host"),
    "test_fec_matrix.py::test_outer_device_gate_logic": Out(
        "b", "_outer_device_ok(t, n_blocks) and the ORION_SDR_TPU_DEVICE_OUTER "
        "escape hatch are the JAX package's TPU gate, not ported (ROADMAP "
        "ground rules)",
        "tests/test_torch_bch_device.py::test_outer_device_ok_gate"),
    "test_ops.py::test_bp_tables_structure": Out(
        "b", "ops/ldpc_bp.py::_bp_tables is the Pallas kernel's TPU table "
        "layout; the port's kernel has its own compact tables",
        "tests/test_torch_ldpc_schedule.py"),
    "test_ops.py::test_ms_tables_structure": Out(
        "b", "ops/ldpc_bp.py::_ms_tables is the Pallas kernel's TPU table "
        "layout; the port's kernel has its own compact tables",
        "tests/test_torch_ldpc_schedule.py"),
    "test_digital.py::TestConstellation::test_qam16_gray_adjacency": Out(
        "b", "constellation._axis_table is the JAX mapper's Gray table; the "
        "port's map_bits Gray-decodes each axis by prefix XOR and keeps no "
        "table", _TWIN + ": the Gray adjacency of the port's own levels"),
    # (c) numpy methods on what the port returns
    "test_digital.py::test_fde_equalize_deep_isi": Out(
        "c", _NP + ".astype on fde_equalize's output", _TWIN),
    "test_digital.py::test_burst_modem_qam_orders": Out(
        "c", _NP + "np.mean(got != bits) on burst_demod's bits "
        "(tensor != ndarray is one Python bool)", _TWIN),
    "test_property_fuzz.py::test_random_chain_scheme_roundtrip": Out(
        "c", _NP + ".astype on encode_chain's bits", _TWIN),
    "test_dsp.py::test_band_compose_grid_exact_and_mixback": Out(
        "c", _NP + "dtype == np.complex64 on band_compose's output", _TWIN),
    "test_dsp.py::test_pfb_channelizer_tone_mapping_and_leakage": Out(
        "c", _NP + "np.mean(..., axis=-1) on pfb_channelize's output",
        _TWIN),
    "test_ofdm.py::TestEqualizer::test_estimate_denoise_shrinks_noise": Out(
        "c", _NP + "np.mean on channel_estimate_denoise's output", _TWIN),
    "test_channel.py::test_phase_noise_identity_power_and_walk_variance":
        Out("c", _NP + "np.mean on phase_noise_apply's output", _TWIN),
    "test_channel.py::test_multipath_normalized_unit_power": Out(
        "c", _NP + "np.mean on multipath_apply's output", _TWIN),
    "test_channel.py::test_watterson_power_and_empty": Out(
        "c", _NP + "dtype == np.complex64 and .size on watterson_apply's "
        "output", _TWIN),
    "test_channel.py::test_ft8_through_watterson_moderate": Out(
        "c", _NP + "np.mean on watterson_apply's output", _TWIN),
    "test_css.py::test_css_crc_guards_corruption": Out(
        "c", _NP + ".copy() on css_mod's output", _TWIN),
    "test_ax25.py::test_afsk_end_to_end_two_frames_awgn": Out(
        "c", _NP + "np.mean on ax25_beacon's audio", _TWIN),
    "test_ax25.py::test_rtty_end_to_end_awgn": Out(
        "c", _NP + "np.mean on rtty_mod's audio", _TWIN),
    "test_sstv.py::test_sstv_under_noise": Out(
        "c", _NP + "np.mean on sstv_mod's audio", _TWIN),
    "test_resample.py::test_batched_and_empty": Out(
        "c", _NP + ".size on Resampler.feed's output", _TWIN),
    # (d) tier 3 in the JAX file
    "test_gnss_nav.py::test_two_satellite_capture_to_ephemeris_roundtrip":
        Out("d", "opt-in in the JAX file (skipif without ORION_SDR_TPU_PERF: "
            "~3 min on the CPU), its tier 3 as slow is",
            "tests/test_torch_gnss_nav.py (the nav codec against the JAX "
            "package) and chip_smoke [41] (the two-satellite capture to "
            "ephemeris on the card)"),
}

REASONS = ("a", "b", "c", "d")


def _excluded(key: str, card: bool) -> Out | None:
    """The entry that leaves ``key`` (``file::test``, ``file::Class::test``,
    with or without ``[params]``) out, if any: the case, its test, its class
    or its file."""
    parts = key.split("::")
    keys = [key, key.split("[")[0]] + ["::".join(parts[:i])
                                       for i in range(len(parts) - 1, 0, -1)]
    for k in keys:
        out = EXCLUDED.get(k)
        if out is not None and (card or not out.card):
            return out
    return None


# ── loading ─────────────────────────────────────────────────────────────────

_LOADED: dict[tuple[str, bool], types.ModuleType] = {}


def module_name(name: str, card: bool) -> str:
    return f"torch_contracts_{'card' if card else 'cpu'}_{Path(name).stem}"


def rewrite(source: str, card: bool = False) -> str:
    """The JAX test file's text with its package imports sent to the port
    (and, for the card, its jax imports dropped): only import lines change,
    each within its own line, so line numbers stay the JAX file's."""
    source = _PKG_IMPORT.sub(r"\1orion_sdr_tpu_torch", source)
    source = _TEST_IMPORT.sub(
        lambda m: m.group(1) + module_name(m.group(2) + ".py", card), source)
    source = _HELPERS_IMPORT.sub(r"\1helpers", source)
    if card:
        source = _JAX_IMPORT.sub(r"\1pass", source)
    return source


def _compile(source: str, path: Path):
    tree = ast.parse(source, str(path))
    try:        # pytest's assertion messages, as for a collected file
        from _pytest.assertion.rewrite import rewrite_asserts
        rewrite_asserts(tree, source.encode(), str(path))
    except ImportError:
        pass
    return compile(tree, str(path), "exec", dont_inherit=True)


def load(name: str, card: bool = False) -> types.ModuleType:
    """``tests/<name>`` on the port, executed once a process and mode."""
    key = (name, card)
    if key in _LOADED:
        return _LOADED[key]
    path = HERE / name
    source = path.read_text()
    for dep in _TEST_IMPORT.findall(source):
        load(dep[1] + ".py", card)
    mod = types.ModuleType(module_name(name, card))
    mod.__file__ = str(path)
    sys.modules[mod.__name__] = mod
    try:
        exec(_compile(rewrite(source, card), path), mod.__dict__)
    except BaseException:
        del sys.modules[mod.__name__]
        raise
    _LOADED[key] = mod
    return mod


def _names_jax(source: str) -> set[str]:
    """The top-level test functions and classes of a JAX test file that name
    ``jax`` or ``jnp``, directly or through the file's own helpers."""
    tree = ast.parse(source)
    defs = {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}

    def names(node):
        return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)} | {
            a.name.split(".")[0] for n in ast.walk(node)
            if isinstance(n, (ast.Import, ast.ImportFrom))
            for a in n.names} | {
            n.module.split(".")[0] for n in ast.walk(node)
            if isinstance(n, ast.ImportFrom) and n.module}
    used = {k: names(v) for k, v in defs.items()}
    direct = {k for k, u in used.items() if u & {"jax", "jnp", "jaxlib"}}
    while True:
        more = {k for k, u in used.items() if k not in direct and u & direct}
        if not more:
            return direct
        direct |= more


def cases_naming_jax(name: str) -> list[str]:
    """``file::test`` of every test or test class that names jax/jnp."""
    src = (HERE / name).read_text()
    return sorted(f"{name}::{k}" for k in _names_jax(src)
                  if k.startswith(("test", "Test")))


def exported(name: str, attr: str) -> str:
    short = Path(name).stem[len("test_"):]
    return (f"test_{short}__{attr}" if attr.startswith("test")
            else f"Test_{short}__{attr}")


def _is_fixture(obj) -> bool:
    return any(hasattr(obj, a) for a in ("_fixture_function_marker",
                                          "_pytestfixturefunction"))


def export(ns: dict, names, card: bool = False) -> None:
    """Each file's tests and test classes into ``ns`` under the file's
    prefix, and its fixtures under their own names, less what ``EXCLUDED``
    leaves out whole; ``ns["ORIGIN"]`` maps each exported test back to its
    ``file::test``."""
    origin = ns.setdefault("ORIGIN", {})
    for name in names:
        if _excluded(name, card):
            continue
        mod = load(name, card)
        for attr, obj in vars(mod).items():
            if _is_fixture(obj):
                assert ns.get(attr, obj) is obj, attr
                ns[attr] = obj
                continue
            if not (attr.startswith("test") and inspect.isfunction(obj)
                    or attr.startswith("Test") and inspect.isclass(obj)):
                continue
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            if _excluded(f"{name}::{attr}", card):
                continue
            key = exported(name, attr)
            assert key not in ns, key
            ns[key] = obj
            origin[key] = f"{name}::{attr}"


def jax_id(item, origin: dict) -> str:
    """A collected case's id in its JAX file: ``file::test[params]`` or
    ``file::Class::test[params]``."""
    cls = item.cls.__name__ if item.cls is not None else None
    head = origin[item.parent.name if cls else item.originalname]
    case = f"{head}::{item.originalname}" if cls else head
    spec = getattr(item, "callspec", None)
    return f"{case}[{spec.id}]" if spec is not None else case


def skip_if_excluded(item, origin: dict, card: bool) -> None:
    """Skip a case ``EXCLUDED`` lists that ``export`` cannot leave out: a
    parametrised case listed by its params, or a method of an exported
    test class."""
    out = _excluded(jax_id(item, origin), card)
    if out is not None:
        pytest.skip(f"({out.reason}) {out.why}; held by {out.held_by}")


# ── placement ───────────────────────────────────────────────────────────────


def _port_modules() -> list[types.ModuleType]:
    mods = [T]
    for info in pkgutil.walk_packages(T.__path__, T.__name__ + "."):
        mods.append(importlib.import_module(info.name))
    return mods


def _functions(mods):
    """Every function the port defines at module or class level, and what
    each wraps."""
    seen, out = set(), []

    def visit(f):
        while f is not None:
            if isinstance(f, (staticmethod, classmethod)):
                f = f.__func__
            if isinstance(f, property):
                for g in (f.fget, f.fset):
                    visit(g)
                return
            if not isinstance(f, types.FunctionType) or id(f) in seen:
                return
            seen.add(id(f))
            out.append(f)
            f = getattr(f, "__wrapped__", None)

    for m in mods:
        for obj in list(vars(m).values()):
            if (getattr(obj, "__module__", None) or "").startswith(
                    T.__name__):
                if inspect.isclass(obj):
                    for v in list(vars(obj).values()):
                        visit(v)
                else:
                    visit(obj)
    return out


def _card(v) -> bool:
    return (isinstance(v, str) and v == "cuda"
            or isinstance(v, torch.device) and v.type == "cuda")


def _host_to_cpu(real):
    """A host-data resolver like ``real`` that sends host data to the CPU
    where ``real`` sends it to the card."""
    def resolve(x, device=None, *args, **kw):
        if device is None and not isinstance(x, torch.Tensor):
            device = "cpu"
        return real(x, device, *args, **kw)
    return resolve


@functools.cache
def _sites():
    """(object, attribute, port value, CPU value) of every default and
    resolver binding that sends host data to the card."""
    mods = _port_modules()
    sites = []
    for f in _functions(mods):
        if f.__defaults__ and any(map(_card, f.__defaults__)):
            sites.append((f, "__defaults__", f.__defaults__, tuple(
                "cpu" if _card(v) else v for v in f.__defaults__)))
        kw = f.__kwdefaults__
        if kw and any(map(_card, kw.values())):
            sites.append((f, "__kwdefaults__", kw, {
                k: "cpu" if _card(v) else v for k, v in kw.items()}))
    resolvers = [importlib.import_module(T.__name__ + ".dsp.device").on_device,
                 importlib.import_module(T.__name__ + ".frame.chain")
                 ._outer_device]
    resolvers = [(real, _host_to_cpu(real)) for real in resolvers]
    for m in mods:
        for k, v in list(vars(m).items()):
            for real, cpu in resolvers:
                if v is real:
                    sites.append((m, k, real, cpu))
    return sites


@contextmanager
def cpu_placement():
    """Host data and every ``"cuda"`` default of the port go to the CPU
    inside the block; all are restored on exit."""
    sites = _sites()
    for obj, attr, _, cpu in sites:
        setattr(obj, attr, cpu)
    try:
        yield
    finally:
        for obj, attr, port, _ in sites:
            setattr(obj, attr, port)


def _tensor_array(self, dtype=None, copy=None):
    a = self.detach().cpu().numpy()
    return a.astype(dtype, copy=False) if dtype is not None else a


@contextmanager
def card_arrays():
    """numpy reads a CUDA tensor as it reads a JAX device array: ``np.asarray``
    copies it to the host. Restored on exit."""
    real = torch.Tensor.__array__
    torch.Tensor.__array__ = _tensor_array
    try:
        yield
    finally:
        torch.Tensor.__array__ = real


# ── twins of the reason-(c) cases ───────────────────────────────────────────

# ``file::test`` → the port-side twin: the JAX test's assertions on
# ``np.asarray(...)`` of what the port returns (tests/torch_contract_twins.py)
TWINS: dict = {}

_MODE = {"card": False}


def twin(key: str):
    """Register a twin of the reason-(c) case ``key``."""
    def put(fn):
        assert key not in TWINS, key
        TWINS[key] = fn
        return fn
    return put


def loaded(name: str) -> types.ModuleType:
    """``tests/<name>`` as the running test's mode loaded it (a twin reads
    the JAX file's own helpers here)."""
    return load(name, _MODE["card"])


def _export_twins(ns: dict, names) -> None:
    import torch_contract_twins  # noqa: F401  (fills TWINS)
    origin = ns["ORIGIN"]
    for key, fn in TWINS.items():
        name, attr = key.split("::", 1)
        if name in names:
            ex = exported(name, attr.replace("::", "__")) + "__twin"
            assert ex not in ns, ex
            ns[ex] = fn
            origin[ex] = key + " (twin)"


# ── the test modules ────────────────────────────────────────────────────────


def tier1_module(ns: dict, area: str) -> None:
    """A tier-1 contract module: the files of ``AREAS[area]`` loaded (under
    :func:`cpu_placement`) and their tests and the twins of their reason-(c)
    cases exported into ``ns``, with an autouse fixture that skips a case
    ``EXCLUDED`` lists by its params and runs every other case under
    :func:`cpu_placement`."""
    names = AREAS[area]
    with cpu_placement():
        export(ns, names)
    _export_twins(ns, names)
    origin = ns["ORIGIN"]

    @pytest.fixture(autouse=True)
    def _contract_on_the_cpu(request):
        skip_if_excluded(request.node, origin, False)
        _MODE["card"] = False
        with cpu_placement():
            yield
    ns["_contract_on_the_cpu"] = _contract_on_the_cpu


def card_module(ns: dict) -> None:
    """The card file: every file's tests and every twin exported into ``ns``
    with the port's own defaults (host data goes to the card), and an
    autouse fixture that skips every case without a card, skips a case
    ``EXCLUDED`` lists by its params, and runs every other case under
    :func:`card_arrays`."""
    export(ns, FILES, card=True)
    _export_twins(ns, FILES)
    origin = ns["ORIGIN"]

    @pytest.fixture(autouse=True)
    def _contract_on_the_card(request):
        if not torch.cuda.is_available():
            pytest.skip("the JAX contracts on the card need a CUDA card")
        skip_if_excluded(request.node, origin, True)
        _MODE["card"] = True
        with card_arrays():
            yield
    ns["_contract_on_the_card"] = _contract_on_the_card
