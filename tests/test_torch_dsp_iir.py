"""Torch port, linear recurrences and IIR sections (dsp/recurrence.py,
dsp/iir.py) against the JAX package on the CPU, with the same numpy inputs.

Tolerance: 1e-5 of the output's largest magnitude (relative to it), for
every route. The port's Hillis–Steele scan groups the sums otherwise than
XLA's associative-scan tree, and its matmuls sum in another order than
XLA's, so outputs agree within float32 rounding (measured: at most 4e-7 of
the peak at these sizes), not bit for bit. Design functions (plain float64
numpy in both packages) are equal. Carries: a capture split across two
calls equals one call, in the port, within the same tolerance, and a
carry from the JAX package continues in the port (convert.py)."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import importlib

from orion_sdr_tpu_torch import convert
from orion_sdr_tpu_torch.dsp import iir as PI
from orion_sdr_tpu_torch.dsp import recurrence as PR

JR = importlib.import_module("orion_sdr_tpu.dsp.recurrence")
JI = importlib.import_module("orion_sdr_tpu.dsp.iir")

torch.set_num_threads(1)
RTOL = 1e-5
FS = 48000.0


def jrun(fn, *args, **kw):
    """``fn(*args, **kw)`` of the JAX package under one jit: arguments
    whose leaves are all arrays are traced, the rest are static (eager
    JAX compiles each op of a scan anew, 20x slower on the CPU)."""
    def traced(a):
        leaves = jax.tree.leaves(a)
        return bool(leaves) and all(isinstance(v, (np.ndarray, jax.Array))
                                    for v in leaves)
    idx = [i for i, a in enumerate(args) if traced(a)]

    def f(*arrs):
        full = list(args)
        for i, a in zip(idx, arrs):
            full[i] = a
        return fn(*full, **kw)
    return jax.jit(f)(*[args[i] for i in idx])


def close(ref, got, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ref - got).max())
    assert err <= rtol * scale, f"max |diff| {err:.3e} > {rtol} x {scale:.3e}"


def rows(shape, seed, cplx=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return x


def t(x):
    return torch.as_tensor(x)


# ── recurrence ───────────────────────────────────────────────────────────────

def test_affine_scan_equals_a_loop():
    rng = np.random.default_rng(1)
    a = rng.uniform(-1, 1, (3, 37)).astype(np.float64)
    b = rng.standard_normal((3, 37))
    A, B = PR.affine_scan(t(a), t(b))
    y, p = np.zeros(3), np.ones(3)
    for i in range(37):
        y = a[:, i] * y + b[:, i]
        p = p * a[:, i]
        np.testing.assert_allclose(B[:, i].numpy(), y, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(A[:, i].numpy(), p, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("a,n,y0", [(0.9, 1000, 0.5), (0.999, 1000, None),
                                    (0.5, 100, 1.0), (1.0, 300, None)])
def test_first_order_constant(a, n, y0):
    b = rows((3, n), 2)
    ry, rl = jrun(JR.first_order, a, b, y0)
    py, pl = PR.first_order(a, t(b), y0)
    close(ry, py)
    close(rl, pl)


def test_first_order_complex_constant():
    b = rows((2, 700), 3, cplx=True)
    ry, rl = jrun(JR.first_order, 0.95 + 0.1j, b, 0.3 - 0.2j)
    py, pl = PR.first_order(0.95 + 0.1j, t(b), 0.3 - 0.2j)
    close(ry, py)
    close(rl, pl)


@pytest.mark.parametrize("n", [1000, 16384])
def test_first_order_array(n):
    rng = np.random.default_rng(4)
    a = rng.uniform(0.5, 0.99, (2, n)).astype(np.float32)
    b = rows((2, n), 5)
    ry, rl = jrun(JR.first_order, a, b, 1.0)
    py, pl = PR.first_order(t(a), t(b), 1.0)
    close(ry, py)
    close(rl, pl)


def test_first_order_empty():
    py, pl = PR.first_order(0.9, torch.zeros(2, 0), torch.tensor([1.0, 2.0]))
    assert py.shape == (2, 0) and pl.tolist() == [1.0, 2.0]


def test_affine2():
    A = np.array([[0.5, -0.2], [0.1, 0.9]], np.float32)
    B = np.array([1.0, 0.5], np.float32)
    x = rows((3, 300), 6)
    s0 = rows((3, 2), 7)
    rs, rl = jrun(JR.affine2, A, B, x, s0)
    ps, pl = PR.affine2(A, B, t(x), t(s0))
    close(rs, ps)
    close(rl, pl)


# ── iir ──────────────────────────────────────────────────────────────────────

def test_designs_equal():
    for fs, fc in ((48000.0, 3000.0), (480e3, 5e3), (8000.0, 100.0)):
        assert PI.design_butter_lp(fs, fc) == JI.design_butter_lp(fs, fc)
    for cut in (0.05, 2.0, 100.0):
        assert PI.dc_pole(FS, cut) == JI.dc_pole(FS, cut)


@pytest.mark.parametrize("n,cplx", [(1000, False), (200, False),
                                    (1000, True)])
def test_lp_cascade(n, cplx):
    """The real-Toeplitz chunk route (real, ≥ 256 samples) and the complex
    one-pole route (short or complex input)."""
    c = JI.design_butter_lp(FS, 3000.0)
    x = rows((2, n), 8, cplx)
    ry, (r0, r1) = jrun(JI.lp_cascade, x, c)
    py, (p0, p1) = PI.lp_cascade(t(x), c)
    close(ry, py)
    close(r0.x_tail, p0.x_tail, 0.0)      # the input's last two samples
    for r, p in ((r0, p0), (r1, p1)):
        close(r.sp, p.sp)
    close(r1.x_tail, p1.x_tail)


def test_full_f32_turns_tf32_off_inside_and_restores_the_callers_flags():
    """The guard of the port's float32 products: TF32 off for cuBLAS and
    cuDNN inside, the caller's settings back after, an exception included;
    the products it guards leave the caller's settings as they were."""
    from orion_sdr_tpu_torch.dsp.device import full_f32
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        with pytest.raises(KeyError):
            with full_f32():
                assert [f.allow_tf32 for f in flags] == [False, False]
                raise KeyError
        assert [f.allow_tf32 for f in flags] == [True, True]
        c = JI.design_butter_lp(FS, 3000.0)
        PI.lp_cascade(t(rows((2, 1000), 8)), c)
        assert [f.allow_tf32 for f in flags] == [True, True]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def test_dc_blocker_and_lp_dc_cascade():
    c = JI.design_butter_lp(FS, 3000.0)
    r = JI.dc_pole(FS, 2.0)
    x = rows((2, 1000), 9) + 0.7
    ry, rs = jrun(JI.dc_blocker, x, r)
    py, ps = PI.dc_blocker(t(x), r)
    close(ry, py)
    close(rs, ps)
    ry, rs = jrun(JI.lp_dc_cascade, x, c, r, map_fn=jnp.abs)
    py, ps = PI.lp_dc_cascade(t(x), c, r, map_fn=torch.abs)
    close(ry, py)
    close(rs.dc, ps.dc)


@pytest.mark.parametrize("cut", [300, 700, 1])
def test_lp_dc_cascade_carries_split_across_two_calls(cut):
    """Two calls with the carried state equal one call (the port against
    itself and against the JAX package)."""
    c = PI.design_butter_lp(FS, 3000.0)
    r = PI.dc_pole(FS, 2.0)
    x = rows((2, 1000), 10)
    one, _ = PI.lp_dc_cascade(t(x), c, r)
    a, st = PI.lp_dc_cascade(t(x[:, :cut]), c, r)
    b, _ = PI.lp_dc_cascade(t(x[:, cut:]), c, r, state=st)
    close(one, torch.cat([a, b], dim=-1))
    ref, _ = jrun(JI.lp_dc_cascade, x, c, r)
    close(ref, one)


def test_lp_dc_state_from_the_jax_package_continues_in_the_port():
    c = JI.design_butter_lp(FS, 3000.0)
    r = JI.dc_pole(FS, 2.0)
    x = rows((2, 1000), 11)
    ref, _ = jrun(JI.lp_dc_cascade, x, c, r)
    a, st = jrun(JI.lp_dc_cascade, x[:, :600], c, r)
    st = jax.tree.map(np.asarray, st)
    b, _ = PI.lp_dc_cascade(t(x[:, 600:]), c, r,
                            state=convert.lp_dc_state_from_fields(st, "cpu"))
    close(ref, np.concatenate([np.asarray(a), b.numpy()], axis=-1))


def test_biquad_state_fields_round_trip():
    c = JI.design_butter_lp(FS, 1000.0)
    x = rows((3, 500), 12)
    _, st = jrun(JI.biquad, x, c)
    ps = convert.biquad_state_from_fields(jax.tree.map(np.asarray, st),
                                          "cpu")
    close(st.sp, ps.sp, 0.0)
    close(st.x_tail, ps.x_tail, 0.0)
    y, _ = PI.biquad(t(x), c, ps)
    ry, _ = jrun(JI.biquad, x, c, st)
    close(ry, y)
