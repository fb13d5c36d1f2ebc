"""Shared helpers of tests/test_torch_examples_*.py: run a JAX example in
its own process (each sets its own CPU platform, and example 04 its eight
virtual devices), run the port's counterpart under examples/torch/ in this
process with ``main("cpu")``, and hold the port's printed result lines to
the JAX ones.

Two lines agree when their text between numbers is equal and each number
agrees: a number printed without a decimal point (a count, an index, a
frequency on a search grid, a digit of a callsign or a PI code) exactly; a
number printed with one to within one unit of its last printed place.
Tests of the same functions hold the underlying values within 1e-5 of
their scale, so two printed values part only where one of them sits on a
rounding boundary."""

import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NUM = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def jax_lines(name: str) -> list:
    """stdout lines of ``python examples/<name>.py`` (it must exit 0)."""
    proc = subprocess.run([sys.executable, os.path.join("examples",
                                                        f"{name}.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.splitlines()


def port_run(name: str):
    """(main("cpu")'s result, its stdout lines) of examples/torch/<name>.py,
    on one torch thread."""
    path = os.path.join(ROOT, "examples", "torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    torch.set_num_threads(1)
    with contextlib.redirect_stdout(out):
        result = mod.main("cpu")
    return result, out.getvalue().splitlines()


def _unit(tok: str) -> float:
    """One unit of the last printed place of a number with a point."""
    mant, _, exp = tok.lower().partition("e")
    decimals = len(mant.split(".")[1])
    return 10.0 ** (-decimals) * (10.0 ** int(exp) if exp else 1.0)


def lines_agree(want: str, got: str) -> bool:
    if _NUM.split(want) != _NUM.split(got):
        return False
    wn, gn = _NUM.findall(want), _NUM.findall(got)
    if len(wn) != len(gn):
        return False
    for w, g in zip(wn, gn):
        if "." not in w:
            if w != g:
                return False
        elif abs(float(w) - float(g)) > _unit(w) * 1.0001:
            return False
    return True


def assert_same_lines(want: list, got: list) -> None:
    assert len(want) == len(got), (want, got)
    bad = [(w, g) for w, g in zip(want, got) if not lines_agree(w, g)]
    assert not bad, bad
