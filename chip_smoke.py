#!/usr/bin/env python3
"""Smoke run of the torch port's main path on one CUDA card.

Usage, from the root of a checkout:  python3 chip_smoke.py

1. Environment: requires a CUDA card (exits 1 otherwise; there is no CPU
   path) and prints its name and power limit.
2. Builds both kernels in parallel with nvcc, one process per source (the
   LDPC belief-propagation kernel csrc/ldpc_bp.cu and the Viterbi kernel
   csrc/viterbi.cu), and prints the BP kernel's build time and ptxas
   register/shared-memory report.
3. Kernel vs plain torch version for N512R12, N576R23 and N512R34 under each
   decode rule: 3072 decodable codewords (±4 LLRs, BP_FLIPS flips) plus 256
   random-normal rows. Tolerance: exact — bits and unsatisfied-check counts
   equal on every row, and no garbage row converges in either. Times both on
   N512R12 at B=3072 with CUDA events after warm-up.
4. Main path, batch: 128 frames of 1500 bytes, MCS cycling 0–3, modulated on
   the card, AWGN at 0.02 × signal power, decoded by
   OfdmFrameDemod(device="cuda").decode_batch under sum-product and then
   scaled min-sum, three timed runs each after a warm-up run. Every payload
   and header field must come back and the BP kernel's launch count must
   rise. Prints frames/s and Msps of the median run (host clock around work
   that ends in torch.cuda.synchronize()).
5. Main path, stream: 4 frames (BPSK/QPSK: at noise 0.01, about 17 dB SNR,
   the single-symbol channel estimate does not carry QAM-16/64) at random
   gaps, 37 Hz CFO, fed to OfdmFrameStreamDemod in 20 000-sample chunks;
   all 4 payloads in order.
6. Viterbi build: the Viterbi kernel's build time and ptxas report.
7. Viterbi kernel vs plain torch version, exact equality of bits on every
   lane: chunked dvb_k7 at the DVB-T decode operating point (3168 lanes =
   32 frames x 99 chunks, 1216 steps) on integer-valued and on normal float
   LLRs, with random initial-metric rows and chunk-0-pinned rows; terminated
   k5 and dvb_k7 at 128 codewords x 4096 info bits, rates 1/2 and 3/4.
   Times kernel and plain version with CUDA events after warm-up.
8. DVB-T batch (main path): 32 full frames of QPSK r1/2 GI 1/8 (9537-byte
   payloads, 68 symbols) modulated on the card by DvbTFrameMod, AWGN at
   6 dB SNR, decoded by DvbTFrameDemod(device="cuda").decode_batch; then 8
   full frames of 16-QAM r3/4 at 15 dB. Every payload and TPS word must
   come back and the Viterbi launch count must rise. Three timed runs after
   a warm-up on the full batch; frames/s and Msps of the median (host clock
   around work that ends in torch.cuda.synchronize()), and modulate
   frames/s.
9. DVB-T single frame at an unknown offset: 777 leading zeros, 4 dB, payload
   seed 7, noise seed 8, through decode; payload and every TPS field.
10. COFDM conv link batch: 64 frames of 300 bytes on a conv K=7 r1/2 +
   RS(204,188) MCS with a block inner interleaver, through
   OfdmFrameDemod.decode_batch: the terminated mode of the Viterbi kernel
   on the COFDM path; all 64 payloads and a rising launch count.
11. Prints the kernels' JSON line, the card's name and power limit, then the
   result line {"ok": true, "device": {...}} last. Any failure exits
   non-zero before it.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 20261016
N_FRAMES = 128
PAYLOAD_BYTES = 1500
BP_BATCH = 3072
BP_GARBAGE = 256
# flipped ±4 LLRs per decodable codeword: the JAX bench's 6 on the rate-1/2
# code, fewer on the higher rates (their weight-3 columns leave small
# distances, so more flips would often land on another codeword)
BP_FLIPS = {"N512R12": 6, "N576R23": 4, "N512R34": 3}
# the Viterbi operating point: 32 DVB-T frames x 99 chunks of 1216 steps
VIT_LANES, VIT_SPAN = 32 * 99, 1216
DVB_FRAMES, DVB_QAM_FRAMES = 32, 8
COFDM_CONV_FRAMES = 64


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def print_ptxas(built):
    for line in built.log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print("   ", line.strip())


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_vs_plain(ldpc_bp, dev, rng):
    """Phase 3: returns (max |kernel − plain| over all rows, {rule: (kernel
    ms, plain ms)} on N512R12)."""
    from orion_sdr_tpu_torch.fec.ldpc import LDPC_CODES, ldpc_encode, ldpc_graph
    max_err = 0.0
    times = {}
    for name in sorted(LDPC_CODES):
        g = ldpc_graph(name)
        msg = torch.as_tensor(rng.integers(0, 2, (BP_BATCH, g.k)),
                              dtype=torch.uint8, device=dev)
        cw = ldpc_encode(name, msg)
        llr = (1.0 - 2.0 * cw.to(torch.float32)) * 4.0
        flips = torch.as_tensor(np.stack([rng.choice(g.n, BP_FLIPS[name],
                                                     replace=False)
                                          for _ in range(BP_BATCH)]),
                                device=dev)
        llr.scatter_(1, flips, -llr.gather(1, flips))
        junk = torch.as_tensor(rng.standard_normal((BP_GARBAGE, g.n)),
                               dtype=torch.float32, device=dev)
        both = torch.cat([llr, junk]).contiguous()
        for rule in ldpc_bp.RULES:
            kb, ku = ldpc_bp.bp_decode_kernel(g, both, 50, rule)
            rb, ru = ldpc_bp.bp_decode_reference(g, both, 50, rule)
            torch.cuda.synchronize()
            err = max(float((kb.int() - rb.int()).abs().max()),
                      float((ku - ru).abs().max()))
            max_err = max(max_err, err)
            dec = ku[:BP_BATCH] == 0
            right = dec & (kb[:BP_BATCH] == msg).all(dim=1)
            print(f"  {name:8s} {rule:15s} max|kernel-plain|={err:g} "
                  f"converged {int(dec.sum())}/{BP_BATCH}, sent message "
                  f"{int(right.sum())}, another codeword "
                  f"{int(dec.sum() - right.sum())}; garbage min unsat "
                  f"kernel {int(ku[BP_BATCH:].min())} plain "
                  f"{int(ru[BP_BATCH:].min())}")
            if err != 0.0:
                fail(f"{name}/{rule}: kernel and plain version differ")
            if float(right.float().mean()) < 0.95:
                fail(f"{name}/{rule}: decodable rows did not decode")
            if int(ku[BP_BATCH:].min()) <= 0 or int(ru[BP_BATCH:].min()) <= 0:
                fail(f"{name}/{rule}: a garbage row converged")
            if name == "N512R12":
                x = llr.contiguous()
                k_ms = cuda_ms(lambda: ldpc_bp.bp_decode_kernel(g, x, 50, rule))
                p_ms = cuda_ms(lambda: ldpc_bp.bp_decode_reference(g, x, 50,
                                                                   rule),
                               reps=3, warmup=1)
                times[rule] = (k_ms, p_ms)
                print(f"  N512R12 {rule} B={BP_BATCH}: kernel {k_ms:.4f} ms "
                      f"({BP_BATCH / k_ms * 1e3:.4g} cw/s), plain "
                      f"{p_ms:.4f} ms ({BP_BATCH / p_ms * 1e3:.4g} cw/s)")
    return max_err, times


def link(P):
    plan = P.CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    cfg = P.OfdmConfig(plan, fs=1e6)
    pre = P.OfdmPreamble(repeat_len=128, num_repeats=4).with_training_symbol(
        plan.n_fft, plan.cp_len)
    return cfg, pre, P.McsTable.default_ladder()


def batch_path(P, ldpc_bp, dev, rng):
    """Phase 4: returns the BP launch count of the main-path run."""
    cfg, pre, table = link(P)
    mod = P.OfdmFrameMod(cfg, table, pre, device=dev)
    frames = [(P.FrameMetadata(sequence_num=1000 + i, mcs_index=i % 4,
                               flags=i % 256),
               rng.integers(0, 256, PAYLOAD_BYTES).astype(np.uint8),
               int(rng.integers(0, 2**32)))
              for i in range(N_FRAMES)]
    mod.modulate_frame(P.FramePacket(*frames[0][:2]), frames[0][2])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iqs = [mod.modulate_frame(P.FramePacket(meta, data), seed)
           for meta, data, seed in frames]
    torch.cuda.synchronize()
    t_mod = time.perf_counter() - t0
    n_mod = sum(len(x) for x in iqs)
    print(f"  modulate: {N_FRAMES} frames, {n_mod} samples in {t_mod:.4f} s "
          f"= {N_FRAMES / t_mod:.4g} frames/s, {n_mod / t_mod / 1e6:.4g} Msps")
    bodies = [x[pre.total_len():] for x in iqs]
    batch = np.zeros((N_FRAMES, max(len(b) for b in bodies)), np.complex64)
    for i, b in enumerate(bodies):
        sig = float(np.mean(np.abs(b) ** 2))
        noise = (rng.standard_normal(batch.shape[1])
                 + 1j * rng.standard_normal(batch.shape[1])) \
            * np.sqrt(sig * 0.02 / 2)
        batch[i, :len(b)] = b
        batch[i] += noise.astype(np.complex64)
    n_rx = sum(len(b) for b in bodies)
    iq_dev = torch.as_tensor(batch, device=dev)
    launches = 0
    for rule in ("sum_product", "scaled_min_sum"):
        demod = P.OfdmFrameDemod(cfg.with_ldpc_decode_rule(rule), table,
                                 device=dev)
        demod.decode_batch(iq_dev)       # warm-up: cuFFT plans, tables, build
        torch.cuda.synchronize()
        ldpc_bp.bp_decode_kernel.launches = 0
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = demod.decode_batch(iq_dev)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            good = sum(isinstance(got, P.FramePacket)
                       and np.array_equal(got.payload, data)
                       and got.metadata == meta
                       for got, (meta, data, _) in zip(out, frames))
            if good != N_FRAMES:
                fail(f"decode_batch {rule}: {N_FRAMES - good} frames lost")
        n = ldpc_bp.bp_decode_kernel.launches
        if n <= 0:
            fail("the main path launched no BP kernel")
        if rule == "sum_product":
            launches = n
        dt = sorted(secs)[1]
        print(f"  decode_batch {rule}: {N_FRAMES}/{N_FRAMES} frames recovered "
              f"in each of 3 runs, {n} BP launches; runs "
              f"{', '.join(f'{x:.4f}' for x in secs)} s; median "
              f"{N_FRAMES / dt:.4g} frames/s, {n_rx / dt / 1e6:.4g} Msps "
              f"({n_rx} post-preamble samples per run)")
    return launches


def stream_capture(P, dev, rng):
    """4 frames at random gaps, 37 Hz CFO, noise 0.01 → (buffer, payloads)."""
    from orion_sdr_tpu_torch.dsp.osc import rotate
    cfg, pre, table = link(P)
    mod = P.OfdmFrameMod(cfg, table, pre, device=dev)
    payloads, parts = [], []
    for i in range(4):
        data = rng.integers(0, 256, 400).astype(np.uint8)
        payloads.append(data)
        parts.append(np.zeros(int(rng.integers(500, 5000)), np.complex64))
        parts.append(mod.modulate_frame(
            P.FramePacket(P.FrameMetadata(i, i % 2), data), 77 + i))
    parts.append(np.zeros(3000, np.complex64))
    buf = np.concatenate(parts)
    z, _ = rotate(torch.as_tensor(buf, device=dev), 37.0, cfg.fs)
    noise = rng.standard_normal(len(buf)) + 1j * rng.standard_normal(len(buf))
    return (z.cpu().numpy() + 0.01 * noise.astype(np.complex64)), payloads


def stream_path(P, ldpc_bp, dev, rng):
    """Phase 5."""
    cfg, pre, table = link(P)
    buf, payloads = stream_capture(P, dev, rng)
    rx = P.OfdmFrameStreamDemod(cfg, table, pre, device=dev)
    before = ldpc_bp.bp_decode_kernel.launches
    res = []
    t0 = time.perf_counter()
    for i in range(0, len(buf), 20000):
        res += rx.feed(buf[i:i + 20000])
    res += rx.flush()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = [r.packet.payload for r in res if isinstance(r, P.RxFrame)]
    ok = len(got) == 4 and all(np.array_equal(a, b)
                               for a, b in zip(got, payloads))
    print(f"  stream: {len(got)}/4 frames in order={ok}, "
          f"{ldpc_bp.bp_decode_kernel.launches - before} BP launches, "
          f"{len(buf)} samples in {dt:.4f} s")
    if not ok:
        fail("the stream demod lost or reordered frames")


def viterbi_vs_plain(viterbi, dev, rng):
    """Phase 7: returns (max |kernel − plain| over every bit, kernel ms,
    plain ms) at the chunked operating point on float LLRs."""
    from orion_sdr_tpu_torch.fec.conv import punctured_coded_len
    max_err = 0.0

    def check(name, got, want):
        nonlocal max_err
        torch.cuda.synchronize()
        err = float((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        print(f"  {name}: {got.shape[0]} lanes x {got.shape[1]} bits, "
              f"max|kernel-plain|={err:g}")
        if err != 0.0:
            fail(f"Viterbi {name}: kernel and plain version differ")

    L, T = VIT_LANES, VIT_SPAN
    pm0 = torch.as_tensor(rng.integers(-30, 1, (L, 64)), dtype=torch.float32,
                          device=dev)
    pm0[::99] = -1e30                       # chunk-0 rows pinned at state 0
    pm0[::99, 0] = 0.0
    ints = [torch.as_tensor(rng.integers(-8, 9, (L, T)), dtype=torch.float32,
                            device=dev) for _ in range(2)]
    floats = [torch.as_tensor(rng.standard_normal((L, T)), dtype=torch.float32,
                              device=dev) for _ in range(2)]
    for kind, (c0, c1) in (("integer", ints), ("float", floats)):
        check(f"chunked dvb_k7 {kind} LLRs",
              viterbi.viterbi_chunks_kernel(c0, c1, pm0, "dvb_k7"),
              viterbi.viterbi_chunks_reference(c0, c1, pm0, "dvb_k7"))
    c0, c1 = floats
    k_ms = cuda_ms(lambda: viterbi.viterbi_chunks_kernel(c0, c1, pm0,
                                                         "dvb_k7"))
    p_ms = cuda_ms(lambda: viterbi.viterbi_chunks_reference(c0, c1, pm0,
                                                            "dvb_k7"),
                   reps=2, warmup=1)
    print(f"  chunked dvb_k7 L={L} T={T}: kernel {k_ms:.4f} ms "
          f"({L * 1024 / k_ms * 1e3:.4g} info bits/s), plain {p_ms:.4f} ms")
    for code in ("k5", "dvb_k7"):
        for rate in ("1/2", "3/4"):
            n = 4096
            llr = torch.as_tensor(
                rng.standard_normal((128, punctured_coded_len(n, rate, code)))
                * 2.0, dtype=torch.float32, device=dev)
            check(f"terminated {code} {rate}",
                  viterbi.viterbi_decode_soft_kernel(llr, n, rate, code),
                  viterbi.viterbi_terminated_reference(llr, n, rate, code))
            tk = cuda_ms(lambda: viterbi.viterbi_decode_soft_kernel(
                llr, n, rate, code))
            tp = cuda_ms(lambda: viterbi.viterbi_terminated_reference(
                llr, n, rate, code), reps=1, warmup=0)
            print(f"  terminated {code} {rate} 128 x {n}: kernel {tk:.4f} ms, "
                  f"plain {tp:.4f} ms")
    return max_err, k_ms, p_ms


def dvb_t_full_payload(P, params):
    """Largest whole-packet payload whose coded stream fits a 68-symbol
    frame."""
    from orion_sdr_tpu_torch.modulate.dvb_t_frame import _coded_bits_for_packets
    from orion_sdr_tpu_torch.constellation import BITS_PER_SYMBOL
    capacity = 68 * 1512 * BITS_PER_SYMBOL[params.link.constellation]
    n_pkt = 1
    while _coded_bits_for_packets(n_pkt + 1, params) <= capacity:
        n_pkt += 1
    return n_pkt * 187


def dvb_t_run(P, viterbi, dev, rng, link, n_frames, snr_db):
    """Modulate n_frames full frames on the card, add AWGN, decode them with
    decode_batch three times after a warm-up; returns the Viterbi launch
    count of the timed runs."""
    base = P.DvbTFrameParams(P.DvbTLinkParams(*link))
    n_bytes = dvb_t_full_payload(P, base)
    frames = [(P.DvbTFrameParams(base.link, i % 4, (17 * i) & 0xFF),
               rng.integers(0, 256, n_bytes).astype(np.uint8))
              for i in range(n_frames)]
    P.DvbTFrameMod(frames[0][0], device=dev).modulate(frames[0][1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mods = [P.DvbTFrameMod(params, device=dev).modulate(data)
            for params, data in frames]
    torch.cuda.synchronize()
    t_mod = time.perf_counter() - t0
    n_sym = mods[0].n_symbols
    n_samp = sum(len(m.iq) for m in mods)
    print(f"  {link}: {n_frames} frames x {n_bytes} B, {n_sym} symbols; "
          f"modulate {t_mod:.4f} s = {n_frames / t_mod:.4g} frames/s, "
          f"{n_samp / t_mod / 1e6:.4g} Msps")
    batch = np.stack([m.iq for m in mods])
    sig = float(np.mean(np.abs(batch) ** 2))
    batch = batch + ((rng.standard_normal(batch.shape)
                      + 1j * rng.standard_normal(batch.shape))
                     * np.sqrt(sig / 10 ** (snr_db / 10) / 2)
                     ).astype(np.complex64)
    iq_dev = torch.as_tensor(batch, device=dev)
    demod = P.DvbTFrameDemod(base, device=dev)
    demod.decode_batch(iq_dev, n_sym, n_bytes)       # warm-up
    torch.cuda.synchronize()
    viterbi.viterbi_chunks_kernel.launches = 0
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = demod.decode_batch(iq_dev, n_sym, n_bytes)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        good = sum(np.array_equal(o.payload, data)
                   and o.tps == params.tps_word()
                   for o, (params, data) in zip(out, frames))
        if good != n_frames:
            fail(f"DVB-T decode_batch {link}: {n_frames - good} frames lost")
    n = viterbi.viterbi_chunks_kernel.launches
    if n <= 0:
        fail("the DVB-T path launched no Viterbi kernel")
    dt = sorted(secs)[1]
    print(f"  decode_batch: {n_frames}/{n_frames} payloads and TPS words in "
          f"each of 3 runs, {n} Viterbi launches; runs "
          f"{', '.join(f'{x:.4f}' for x in secs)} s; median "
          f"{n_frames / dt:.4g} frames/s, {batch.size / dt / 1e6:.4g} Msps")
    return n


def dvb_t_batch(P, viterbi, dev, rng):
    """Phase 8: returns the Viterbi launch count of the QPSK main-path run."""
    launches = dvb_t_run(P, viterbi, dev, rng, ("1/8", "qpsk", "1/2"),
                         DVB_FRAMES, 6.0)
    dvb_t_run(P, viterbi, dev, rng, ("1/8", "qam16", "3/4"), DVB_QAM_FRAMES,
              15.0)
    return launches


def dvb_t_unknown_offset(P, dev):
    """Phase 9: the JAX package's unknown-offset capstone setup."""
    params = P.DvbTFrameParams(P.DvbTLinkParams("1/32", "qpsk", "1/2"), 1,
                               0x5A)
    payload = np.random.default_rng(7).integers(0, 256, 500).astype(np.uint8)
    frame = P.DvbTFrameMod(params, device=dev).modulate(payload)
    rng = np.random.default_rng(8)
    buf = np.concatenate([np.zeros(777, np.complex64), frame.iq,
                          np.zeros(2000, np.complex64)])
    sig_p = float(np.mean(np.abs(frame.iq) ** 2))
    buf += ((rng.standard_normal(len(buf)) + 1j * rng.standard_normal(len(buf)))
            .astype(np.complex64) * np.sqrt(sig_p / 10 ** 0.4 / 2))
    rx = P.DvbTFrameDemod(params, device=dev).decode(buf, frame.n_symbols,
                                                     len(payload))
    ok = np.array_equal(rx.payload, payload) and rx.tps == params.tps_word()
    print(f"  payload and TPS {rx.tps} recovered: {ok}")
    if not ok:
        fail("the DVB-T frame at an unknown offset did not decode")


def cofdm_conv_batch(P, viterbi, dev, rng):
    """Phase 10: the conv+RS COFDM link through decode_batch."""
    cfg, pre, _ = link(P)
    cfg = cfg.with_inner_interleaver(P.InterleaverKind.block(32, 48))
    table = P.McsTable([P.Mcs("qpsk", P.InnerFec.convolutional("1/2", "dvb_k7"),
                              P.OuterFec.reed_solomon(204, 16))])
    mod = P.OfdmFrameMod(cfg, table, pre, device=dev)
    frames = [(P.FrameMetadata(sequence_num=i, mcs_index=0),
               rng.integers(0, 256, 300).astype(np.uint8), 1000 + i)
              for i in range(COFDM_CONV_FRAMES)]
    bodies = [mod.modulate_frame(P.FramePacket(meta, data), seed)
              [pre.total_len():] for meta, data, seed in frames]
    batch = np.stack(bodies)
    sig = float(np.mean(np.abs(batch) ** 2))
    batch = batch + ((rng.standard_normal(batch.shape)
                      + 1j * rng.standard_normal(batch.shape))
                     * np.sqrt(sig * 0.02 / 2)).astype(np.complex64)
    viterbi.viterbi_decode_soft_kernel.launches = 0
    t0 = time.perf_counter()
    out = P.OfdmFrameDemod(cfg, table, device=dev).decode_batch(
        torch.as_tensor(batch, device=dev))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = viterbi.viterbi_decode_soft_kernel.launches
    good = sum(isinstance(got, P.FramePacket)
               and np.array_equal(got.payload, data) and got.metadata == meta
               for got, (meta, data, _) in zip(out, frames))
    print(f"  {good}/{COFDM_CONV_FRAMES} frames recovered in {dt:.4f} s "
          f"(first run), {n} terminated Viterbi launches")
    if good != COFDM_CONV_FRAMES:
        fail(f"COFDM conv link: {COFDM_CONV_FRAMES - good} frames lost")
    if n <= 0:
        fail("the COFDM conv link launched no Viterbi kernel")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    import orion_sdr_tpu_torch as P
    from orion_sdr_tpu_torch.ops import ldpc_bp

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"[1] device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    smi_line = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
                else f"nvidia-smi gave nothing: {smi.stderr.strip()}")
    print(smi_line)

    from orion_sdr_tpu_torch.ops import viterbi
    with ThreadPoolExecutor(2) as pool:       # one nvcc per source, together
        builds = [pool.submit(ldpc_bp.build), pool.submit(viterbi.build)]
        built, vit_built = [b.result() for b in builds]
    print(f"[2] built {built.path} in {built.seconds:.2f} s")
    print_ptxas(built)

    rng = np.random.default_rng(SEED)
    print(f"[3] BP kernel vs plain version (exact), B={BP_BATCH}+{BP_GARBAGE}")
    max_err, times = kernel_vs_plain(ldpc_bp, dev, rng)

    print(f"[4] batch path: {N_FRAMES} frames x {PAYLOAD_BYTES} B")
    launches = batch_path(P, ldpc_bp, dev, rng)

    print("[5] stream path: 4 frames, 37 Hz CFO, 20000-sample chunks")
    stream_path(P, ldpc_bp, dev, rng)

    print(f"[6] built {vit_built.path} in {vit_built.seconds:.2f} s")
    print_ptxas(vit_built)

    print(f"[7] Viterbi kernel vs plain version (exact): chunked dvb_k7 "
          f"L={VIT_LANES} x {VIT_SPAN}, terminated 128 x 4096")
    vit_err, vit_ms, vit_plain_ms = viterbi_vs_plain(viterbi, dev, rng)

    print(f"[8] DVB-T batch: {DVB_FRAMES} QPSK r1/2 GI 1/8 frames at 6 dB, "
          f"{DVB_QAM_FRAMES} 16-QAM r3/4 frames at 15 dB")
    vit_launches = dvb_t_batch(P, viterbi, dev, rng)

    print("[9] DVB-T single frame at an unknown offset, 4 dB")
    dvb_t_unknown_offset(P, dev)

    print(f"[10] COFDM conv+RS link: {COFDM_CONV_FRAMES} frames x 300 B")
    cofdm_conv_batch(P, viterbi, dev, rng)

    k_ms, p_ms = times["sum_product"]
    print(json.dumps({"kernels": [{
        "name": "ldpc_bp_decode", "route": "cuda",
        "source": "orion_sdr_tpu_torch/csrc/ldpc_bp.cu",
        "replaces": "orion_sdr_tpu/ops/ldpc_bp.py:256",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms}, {
        "name": "viterbi_acs_traceback", "route": "cuda",
        "source": "orion_sdr_tpu_torch/csrc/viterbi.cu",
        "replaces": "orion_sdr_tpu/ops/viterbi.py:200",
        "launches": vit_launches, "max_abs_err": vit_err,
        "ms": vit_ms, "plain_ms": vit_plain_ms}]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
