"""Torch port: the Gardner kernel's data flow, modelled on the CPU.

``csrc/gardner.cu`` runs each row's recurrence on one lane that reads its
samples from a ring of ``DEPTH`` chunks of ``CHUNK`` samples in shared
memory, which a loader warp fills ahead of it, and reads device memory
directly (a window miss) when a step's reads leave the chunks it holds.
:func:`ring_model` replays that schedule in numpy, step by step, beside
``ops/gardner.py::gardner_reference``: the chain's hold [lo, hi) on the
ring, the rule that frees every chunk below a step's lowest read and takes
chunks up to its highest while the ring has room, the loader's rule that
loads chunk c only after chunk c - DEPTH was freed, the ring's slot of a
sample (its index masked by CHUNK·DEPTH − 1) and the direct path.

Asserted on seeded rows (sps 2-16, loop_bw 0.001 to 1.5·sps, where the
position steps back, mu0 from −2·sps to 2·sps, odd and even n, n_out past
the row's end), with the kernel's ring and with a small one (16 samples
× 2); on noise rows whose position steps back, and in a ring too small
for a step, which force misses:
  - every sample a step reads comes from a slot that holds it (a chunk the
    chain took and has not freed) or from the direct path;
  - the loader never overwrites a chunk the chain still holds;
  - the model's symbols and final position equal the plain version bit
    for bit (the same float32 operations in the same order);
  - chip_smoke [38]'s parameters (64 × 2^17, sps 8, loop_bw 0.02, mu0 3)
    and the main path's (symbol_sync_gardner on 4096 symbols) give no
    miss.

The card tests (tests/test_torch_gpu.py) hold the kernel's counted misses
to this model's. Nothing here imports JAX."""

import os
import re

import numpy as np
import pytest
import torch

from orion_sdr_tpu_torch.ops import gardner as G

torch.set_num_threads(1)

f32 = np.float32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clip_index(p, last):
    """floor(p) as the kernel's saturating int32, clipped to [0, last]."""
    i = int(np.floor(np.float64(p)))
    return 0 if i < 0 else (last if i > last else i)


def _lerp(a, b, p, i):
    t = f32(p - f32(i))
    w = f32(f32(1.0) - t)
    return (f32(f32(a.real * w) + f32(b.real * t)),
            f32(f32(a.imag * w) + f32(b.imag * t)))


def _clip(v, lo, hi):
    return lo if v < lo else (hi if v > hi else v)


def ring_model(z, sps, n_out, loop_bw, mu0, chunk=G.CHUNK, depth=G.DEPTH):
    """One row ``z`` (n,) complex64, unit RMS, through the kernel's
    schedule. Returns (symbols (n_out,) complex64, final position float32,
    window misses)."""
    pos0, rate0, kp, ki, lo, hi = (f32(v) for v in G.loop_constants(
        sps, loop_bw, mu0))
    n = len(z)
    last = n - 2
    log_c = chunk.bit_length() - 1
    assert 1 << log_c == chunk and depth & (depth - 1) == 0
    mask = chunk * depth - 1
    n_chunks = -(-n // chunk)
    ring = np.full(chunk * depth, np.nan, np.complex64)
    slot_of = [None] * depth         # which chunk each slot holds
    h = [0, 0]                       # the chain's hold [lo, hi)

    def take():
        c = h[1]
        assert c < n_chunks
        # the loader loads chunk c once chunk c - depth is freed
        assert c - depth < h[0], "the loader would overwrite a held chunk"
        s = c % depth
        m = min(chunk, n - c * chunk)
        ring[s * chunk:s * chunk + m] = z[c * chunk:c * chunk + m]
        slot_of[s] = c
        h[1] += 1

    def advance(low_c, top_c):
        while h[0] < low_c:
            if h[0] == h[1]:
                take()
            h[0] += 1
        while h[1] <= top_c and h[1] < h[0] + depth and h[1] < n_chunks:
            take()

    out = np.empty(n_out, np.complex64)
    pos, rate, pr, pi = pos0, rate0, f32(0.0), f32(0.0)
    misses = 0
    for k in range(n_out):
        pm = f32(pos - f32(rate * f32(0.5)))
        iy, im = _clip_index(pos, last), _clip_index(pm, last)
        low, top = min(iy, im), max(iy, im) + 1
        steady = (low >> log_c) == h[0] and (top >> log_c) < h[1]
        if not steady:
            advance(low >> log_c, top >> log_c)
            misses += int(low < h[0] * chunk or top >= h[1] * chunk)
        r_lo, r_hi = h[0] * chunk, h[1] * chunk
        vals = []
        for i in (iy, iy + 1, im, im + 1):
            if r_lo <= i < r_hi:
                assert slot_of[(i & mask) // chunk] == i >> log_c
                v = ring[i & mask]
                assert v == z[i]
            else:
                assert not steady
                v = z[i]
            vals.append(v)
        yr, yi = _lerp(vals[0], vals[1], pos, iy)
        mr, mi = _lerp(vals[2], vals[3], pm, im)
        dr, di = f32(yr - pr), f32(yi - pi)
        e = _clip(f32(-f32(f32(dr * mr) + f32(di * mi))), f32(-1.0),
                  f32(1.0))
        rate = _clip(f32(rate + f32(ki * e)), lo, hi)
        pos = f32(f32(pos + rate) + f32(kp * e))
        out[k] = np.complex64(complex(yr, yi))
        pr, pi = yr, yi
    return out, pos, misses


def shaped_rows(rows, n, sps, seed):
    """QPSK at ``sps`` through a raised-cosine-ish pulse, normalised as the
    wrapper normalises: (rows, n) complex64 numpy and the same as a CPU
    tensor."""
    rng = np.random.default_rng(seed)
    sym = (rng.choice([-1.0, 1.0], (rows, n // sps + 8))
           + 1j * rng.choice([-1.0, 1.0], (rows, n // sps + 8)))
    up = np.zeros((rows, sym.shape[1] * sps), np.complex128)
    up[:, ::sps] = sym
    k = np.arange(-3 * sps, 3 * sps + 1) / sps
    pulse = np.sinc(k) * np.cos(np.pi * 0.35 * k) / np.maximum(
        1 - (0.7 * k) ** 2, 1e-3)
    x = np.stack([np.convolve(r, pulse, "same") for r in up])[:, :n]
    x = x + 0.05 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    zn = G.normalise(torch.as_tensor(x.astype(np.complex64))).contiguous()
    return zn.numpy(), zn


CASES = [
    # n, sps, loop_bw, mu0, n_out
    (2600, 2, 0.001, 0.0, 2600 // 2 - 4),
    (3001, 4, 0.02, -8.0, 3001 // 4 + 40),
    (4096, 8, 0.3, 16.0, 4096 // 8 - 4),
    (3333, 16, 0.02, 5.0, 3333 // 16 + 30),
    (2501, 8, 12.0, 0.0, 330),
    (2000, 16, 24.0, -32.0, 140),
    (1500, 3, 0.02, 6.0, 1500 // 3 + 20),
]


@pytest.mark.parametrize("case", CASES, ids=[
    f"n{c[0]}-sps{c[1]}-bw{c[2]}-mu{c[3]}-out{c[4]}" for c in CASES])
@pytest.mark.parametrize("ring", ["kernel", "small"])
def test_ring_model_reads_every_sample_from_its_slot_or_directly(case,
                                                                 ring):
    n, sps, loop_bw, mu0, n_out = case
    chunk, depth = (G.CHUNK, G.DEPTH) if ring == "kernel" else (16, 2)
    z, zt = shaped_rows(2, n, sps, seed=n + sps)
    ref, rpos = G.gardner_reference(zt, float(sps), n_out, loop_bw, mu0)
    for r in range(2):
        out, pos, misses = ring_model(z[r], float(sps), n_out, loop_bw,
                                      mu0, chunk, depth)
        assert np.array_equal(out, ref[r].numpy())
        assert pos.tobytes() == rpos[r].numpy().tobytes()
        if loop_bw < 0.95 * sps and mu0 >= 0 and ring == "kernel":
            # a forward-only window inside the row: never a miss
            assert misses == 0


def noise_rows(rows, n, seed):
    """Unit-RMS complex Gaussian rows: with no symbol to lock to, the
    error swings over [−1, 1] and a loop_bw past 0.95·sps steps the
    position back. (rows, n) complex64 numpy and the same as a tensor."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, n))
         + 1j * rng.standard_normal((rows, n))).astype(np.complex64)
    zn = G.normalise(torch.as_tensor(x)).contiguous()
    return zn.numpy(), zn


def test_ring_model_misses_where_the_position_steps_back():
    """sps 4, loop_bw 8 (2·sps) on noise: the position steps back across
    chunk boundaries the chain has left; those steps read directly, and
    the symbols stay exact."""
    z, zt = noise_rows(3, 6000, 1)
    ref, rpos = G.gardner_reference(zt, 4.0, 1500, 8.0, 0.0)
    total = 0
    for r in range(3):
        out, pos, misses = ring_model(z[r], 4.0, 1500, 8.0, 0.0)
        assert np.array_equal(out, ref[r].numpy())
        assert pos.tobytes() == rpos[r].numpy().tobytes()
        total += misses
    assert total > 0


def test_ring_model_misses_when_the_ring_cannot_hold_a_step():
    """A 4-sample chunk in a ring of 2 cannot hold a step of sps 16: every
    step after the first reads directly, and the symbols stay exact."""
    z, zt = shaped_rows(1, 600, 16, seed=5)
    ref, rpos = G.gardner_reference(zt, 16.0, 30, 0.02, 0.0)
    out, pos, misses = ring_model(z[0], 16.0, 30, 0.02, 0.0, 4, 2)
    assert np.array_equal(out, ref[0].numpy())
    assert misses >= 29


@pytest.mark.parametrize("n,n_out", [(1 << 17, (1 << 17) // 8 - 4),
                                     (4096 * 8, 4096 - 10)],
                         ids=["chip_smoke_38", "symbol_sync_gardner"])
def test_ring_model_gives_no_miss_at_the_smoke_parameters(n, n_out):
    """[38]: 64 rows × 2^17 samples at sps 8, loop_bw 0.02, mu0 3, 16 380
    symbols; the main path: 4096 symbols of 8 samples, 4086 out. One row
    each, to the plain version bit for bit, with no window miss."""
    z, zt = shaped_rows(1, n, 8, seed=38)
    out, pos, misses = ring_model(z[0], 8.0, n_out, 0.02, 3.0)
    assert misses == 0
    ref, rpos = G.gardner_reference(zt, 8.0, n_out, 0.02, 3.0)
    assert np.array_equal(out, ref[0].numpy())
    assert pos.tobytes() == rpos[0].numpy().tobytes()


def test_model_constants_are_the_kernels():
    with open(os.path.join(ROOT, "orion_sdr_tpu_torch", "csrc",
                           "gardner.cu")) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]+);", src)
                   .group(1).split("//")[0].strip().replace(
                       "1 << kLogChunk", str(1 << int(re.search(
                           r"constexpr int kLogChunk = (\d+);", src)
                           .group(1)))))
    assert (const("kChunk"), const("kDepth"), const("kOutChunk"),
            const("kOutDepth")) == (G.CHUNK, G.DEPTH, G.OUT_CHUNK,
                                    G.OUT_DEPTH)
