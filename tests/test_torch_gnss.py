"""Torch port, GPS L1 C/A (gnss.py, ops/gnss_track.py) against the JAX
package on the CPU, with the same numpy inputs.

Tolerances: exact for the C/A codes of PRNs 1–32, the sampled codes, the
synthesized captures (the same float64 numpy), the acquisition detections
(PRN, Doppler, code phase), the tracking loop's epoch bases, the nav bits
and the frame sync. The acquisition grid within 1e-5 of its largest cell
(torch.fft against XLA's FFT, the non-coherent sum in another order;
measured 2e-7). The tracking loops' plain version against the JAX scan
over 60 epochs: prompts within 1e-4 of the largest prompt, frequencies
within 0.01 Hz, fractions within 1e-4 samples (XLA sums the 2048-sample
correlations in its own order and fuses some products and sums; the
feedback carries those float32 differences, measured 2e-6 of the prompt,
2.4e-4 Hz and 1.5e-6 samples)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_sdr_tpu import gnss as JG

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch import gnss as PG
from orion_sdr_tpu_torch.ops import gnss_track as GT

torch.set_num_threads(1)
CPU = "cpu"
FS = 2.048e6
SPMS = 2048


def test_ca_codes_exact():
    for prn in range(1, 33):
        assert np.array_equal(PG.gps_ca_code(prn), JG.gps_ca_code(prn))
        assert np.array_equal(PG._ca_pm_sampled(prn, FS),
                              JG._ca_pm_sampled(prn, FS))
    assert np.array_equal(P.GPS_NAV_PREAMBLE, JG.GPS_NAV_PREAMBLE)
    for bad in (0, 33):
        with pytest.raises(ValueError):
            PG.gps_ca_code(bad)


def test_ca_mod_exact():
    nav = np.random.default_rng(0).integers(0, 2, 4).astype(np.uint8)
    a = PG.gps_ca_mod(5, FS, 90, 1840.0, 300.4, nav_bits=nav,
                      amplitude=0.7, carrier_phase=0.4)
    b = JG.gps_ca_mod(5, FS, 90, 1840.0, 300.4, nav_bits=nav,
                      amplitude=0.7, carrier_phase=0.4)
    assert np.array_equal(a, b)


def _multi_sv_capture(n_ms, noise=1.0, seed=0):
    """tests/test_gnss.py:51-80's three-satellite capture."""
    rng = np.random.default_rng(seed)
    svs = [(7, 1200.0, 101.7, 1.0), (13, -2600.0, 512.2, 0.7),
           (28, 350.0, 900.9, 0.55)]
    n = SPMS * n_ms
    z = (noise / np.sqrt(2) * (rng.standard_normal(n)
                               + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    for prn, dopp, chips, amp in svs:
        z += JG.gps_ca_mod(prn, FS, n_ms, dopp, chips, amplitude=amp,
                           carrier_phase=rng.uniform(0, 2 * np.pi))
    return z, svs


def test_acquire_grid_matches():
    z, _ = _multi_sv_capture(6, seed=1)
    codes = np.stack([JG._ca_pm_sampled(p, FS) for p in (7, 13, 20)])
    dopp = np.arange(-3000.0, 3001.0, 500.0).astype(np.float32)
    ref = np.asarray(JG._acquire_grid(z, codes, dopp, FS, 4))
    got = PG._acquire_grid(torch.as_tensor(z), torch.as_tensor(codes),
                           torch.as_tensor(dopp), FS, 4).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * ref.max()


def test_acquire_detections_exact():
    """Every satellite of the JAX test's capture, at its Doppler and code
    phase, with the same detections (and scores within 1e-4) in both
    packages; absent PRNs and noise alone stay silent."""
    z, svs = _multi_sv_capture(8)
    got = P.gps_acquire(z, FS, device=CPU)
    ref = JG.gps_acquire(z, FS)
    assert [(h.prn, h.doppler_hz, h.code_phase_samples) for h in got] == \
        [(h.prn, h.doppler_hz, h.code_phase_samples) for h in ref]
    for g, r in zip(got, ref):
        assert abs(g.score - r.score) <= 1e-4 * r.score
    assert {h.prn for h in got} == {prn for prn, *_ in svs}
    for prn, dopp, chips, _ in svs:
        h = next(h for h in got if h.prn == prn)
        assert abs(h.doppler_hz - dopp) <= 250.0
        err = (h.code_phase_samples - chips * FS / PG.GPS_CA_RATE
               + SPMS / 2) % SPMS - SPMS / 2
        assert abs(err) <= 1.5
    assert P.gps_acquire(z, FS, prns=[3, 19, 31], device=CPU) == []
    with pytest.raises(ValueError):
        P.gps_acquire(np.zeros((2, 4096), np.complex64), FS, device=CPU)
    with pytest.raises(ValueError):
        P.gps_acquire(np.zeros(64, np.complex64), FS, device=CPU)


def _track_inputs(seed=3):
    """PRN 5 at 300.4 chips (615 samples) and 1840 Hz, PRN 6 with its
    epoch at sample 0 and 2500 Hz, 70 ms."""
    rng = np.random.default_rng(seed)
    nav = rng.integers(0, 2, 6).astype(np.uint8)
    z = JG.gps_ca_mod(5, FS, 70, 1840.0, 300.4, nav_bits=nav) \
        + JG.gps_ca_mod(6, FS, 70, 2500.0, 0.0, amplitude=0.8)
    z = (z + 0.3 * (rng.standard_normal(len(z))
                    + 1j * rng.standard_normal(len(z)))).astype(np.complex64)
    codes = np.stack([JG._ca_pm_sampled(p, FS) for p in (5, 6)])
    return z, codes


@pytest.mark.parametrize("starts,f0,n_ep", [
    ((615, 2), (1900.0, 2300.0), 60),
    # at the capture's edges: PRN 6's early slice starts at −1 in its first
    # epoch (lax.dynamic_slice wraps it by n and clamps it to n − spms),
    # and the last epochs run past the end, where the slices clamp at
    # n − spms
    ((615, 0), (1840.0, 2500.0), 73),
])
def test_track_scan_plain_version_matches_jax(starts, f0, n_ep):
    """Two locked satellites (the JAX bench's vmap of _track_scan written
    out as one batched call)."""
    z, codes = _track_inputs()
    st = np.asarray(starts, np.int32)
    fr = np.asarray(f0, np.float32)
    f = jax.jit(jax.vmap(lambda c, s, d: JG._track_scan.__wrapped__(
        jnp.asarray(z), c, s, d, FS, n_ep, 7.2, 0.9, 0.12)))
    ref = [np.asarray(a) for a in f(codes, st, fr)]
    got = [a.numpy() for a in PG._track_scan(torch.as_tensor(z), codes, st,
                                             fr, FS, n_ep, 7.2, 0.9, 0.12)]
    assert np.abs(got[0] - ref[0]).max() <= 1e-4 * np.abs(ref[0]).max()
    assert np.abs(got[1] - ref[1]).max() <= 1e-2
    assert np.array_equal(got[2], ref[2])
    assert np.abs(got[3] - ref[3]).max() <= 1e-4


def _kernel_order_sum(row: np.ndarray, T: int) -> np.float32:
    """The tracking kernel's sum written as its threads run it, in float32:
    thread t adds samples t, t + T, ... in turn; each warp of 32 adds its
    partial sums by shuffles, lane l taking l + s for s = 16 .. 1; warp 0
    adds the T/32 warp sums the same way, w taking w + s for s = T/64 .. 1."""
    f = np.float32
    part = [f(0.0)] * T
    for t in range(T):
        for k in range(t, len(row), T):
            part[t] = f(part[t] + row[k])

    def tree(vals):
        s = len(vals) // 2
        while s:
            vals = [f(vals[i] + vals[i + s]) for i in range(s)]
            s //= 2
        return vals[0]
    return tree([tree(part[w:w + 32]) for w in range(0, T, 32)])


def _check_sum_order(T):
    x = np.random.default_rng(4).standard_normal((3, 2047)).astype(
        np.float32)
    got = GT._sum_fixed(torch.as_tensor(x)).numpy()
    want = np.array([_kernel_order_sum(r, T) for r in x])
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.allclose(got, x.astype(np.float64).sum(-1), atol=1e-4)


def test_track_reference_sums_in_the_kernel_order():
    """The plain version's fixed-order sum is the kernel's thread, warp and
    cross-warp order bit for bit (an explicit loop model), and a sum:
    within float32 rounding of the float64 sum."""
    _check_sum_order(GT.THREADS)


@pytest.mark.parametrize("threads", [128, 256, 512])
def test_track_reference_sum_order_at_each_width(threads, monkeypatch):
    """The widths chip_smoke [41] sweeps: the plain version follows
    ``THREADS``."""
    monkeypatch.setattr(GT, "THREADS", threads)
    _check_sum_order(threads)


def _bases(starts, steps):
    """(S, E) output bases from (S,) starts and (S, E) base steps."""
    return (torch.as_tensor(starts)[:, None]
            + torch.cumsum(torch.as_tensor(steps), 1)).to(torch.int32)


def test_window_misses_model():
    """The kernel's prefetched window (M = 8 samples of code shift either
    side, d = 1): shifts within M read the window; a shift beyond it, the
    early slice wrapped at start 0 and slices clamped past the capture's
    end read device memory."""
    n, spms, d = 20 * SPMS + 3, SPMS, 1
    within = np.full((1, 10), spms)
    within[0, 3:7] = spms + np.array([8, -8, 7, -7])
    assert GT.window_misses(torch.tensor([615]), _bases([615], within), n,
                            spms, d).tolist() == [0]
    # the window's 16-byte alignment may widen it by a sample either side,
    # so a shift of M + 2 is the least that always leaves it
    beyond = within.copy()
    beyond[0, 4] = spms - 10               # epoch 5 shifts 10 samples back
    beyond[0, 8] = spms + 10               # epoch 9 shifts 10 forward
    assert GT.window_misses(torch.tensor([615]), _bases([615], beyond), n,
                            spms, d).tolist() == [2]
    # epoch 0 at base 0: the early slice starts at −1, wraps by n and
    # clamps to n − spms
    assert GT.window_misses(torch.tensor([0]), _bases([0], within), n, spms,
                            d).tolist() == [1]
    # 25 epochs from 615 in a 20-epoch capture: from the epoch whose late
    # slice passes the end, every slice clamps to n − spms
    steps = np.full((1, 25), spms)
    last_in = (n - spms - 615 - d) // spms      # the last epoch inside
    assert GT.window_misses(torch.tensor([615]), _bases([615], steps), n,
                            spms, d).tolist() == [25 - last_in - 1]


def test_gnss_track_input_contract():
    codes = torch.ones((1, SPMS))
    with pytest.raises(TypeError):
        GT.gnss_track(torch.zeros(4096), codes, torch.zeros(1),
                      torch.zeros(1), FS, 3, 1.0, 1.0, 1.0)
    with pytest.raises(ValueError):
        GT.gnss_track(torch.zeros(100, dtype=torch.complex64), codes,
                      torch.zeros(1), torch.zeros(1), FS, 3, 1.0, 1.0, 1.0)
    p, f, b, r = GT.gnss_track(torch.zeros(4096, dtype=torch.complex64),
                               codes[:0], torch.zeros(0), torch.zeros(0), FS,
                               3, 1.0, 1.0, 1.0)
    assert tuple(p.shape) == (0, 3)
    p, f, b, r = GT.gnss_track(torch.zeros(4096, dtype=torch.complex64),
                               codes, torch.zeros(1), torch.zeros(1), FS, 0,
                               1.0, 1.0, 1.0)
    assert tuple(b.shape) == (1, 0)


def test_track_recovers_nav_bits_like_jax():
    """tests/test_gnss.py's tracking case (40 nav bits, 150 Hz off the
    acquired bin): the same nav bits, bit offset and epoch positions in
    both packages, and the bits are the ones sent."""
    rng = np.random.default_rng(3)
    nav = rng.integers(0, 2, 40).astype(np.uint8)
    z = JG.gps_ca_mod(5, FS, len(nav) * 20 + 30, 1840.0, 300.4, nav_bits=nav)
    z = (z + 0.7 / np.sqrt(2) * (rng.standard_normal(len(z))
                                 + 1j * rng.standard_normal(len(z)))
         ).astype(np.complex64)
    acq = P.gps_acquire(z, FS, prns=[5], device=CPU)
    assert acq and acq[0].prn == 5
    args = (z, FS, 5, acq[0].doppler_hz + 150.0, acq[0].code_phase_samples)
    tr = P.gps_track(*args, device=CPU)
    ref = JG.gps_track(*args)
    assert np.array_equal(tr.nav_bits, ref.nav_bits)
    assert tr.bit_offset_ms == ref.bit_offset_ms
    assert np.abs(tr.code_phase - ref.code_phase).max() <= 1e-3
    assert abs(tr.lock - ref.lock) <= 1e-3 * ref.lock and tr.lock > 2.0
    core = tr.nav_bits[1:-1]
    s = "".join(map(str, nav.tolist()))
    assert ("".join(map(str, core.tolist())) in s
            or "".join(map(str, (1 - core).tolist())) in s)
    with pytest.raises(ValueError):
        P.gps_track(np.zeros(100, np.complex64), FS, 1, 0.0, 0, device=CPU)


def test_nav_frame_sync_exact():
    rng = np.random.default_rng(6)
    for _ in range(20):
        b = rng.integers(0, 2, 700).astype(np.uint8)
        assert P.gps_nav_frame_sync(b) == JG.gps_nav_frame_sync(b)
    bits = np.concatenate([np.array([1, 1, 0], np.uint8),
                           P.GPS_NAV_PREAMBLE,
                           np.array([0, 1] * 12, np.uint8)])
    assert P.gps_nav_frame_sync(bits) == 3
    assert P.gps_nav_frame_sync(1 - bits) == 3
    assert P.gps_nav_frame_sync(np.zeros(40, np.uint8)) is None
