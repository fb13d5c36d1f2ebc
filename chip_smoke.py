#!/usr/bin/env python3
"""Smoke run of the torch port's main path on one CUDA card.

Usage, from the root of a checkout:  python3 chip_smoke.py

1. Environment: requires a CUDA card (exits 1 otherwise; there is no CPU
   path) and prints its name and power limit.
2. Builds the eight kernels in parallel with nvcc, one process per source
   (the LDPC belief-propagation kernel csrc/ldpc_bp.cu, the Viterbi kernel
   csrc/viterbi.cu, the BCH/RS outer-code kernel csrc/outer_fec.cu, the
   PSK31 PLL csrc/psk31_pll.cu, the two-rate one-pole
   csrc/onepole_two_rate.cu, the burst modem's DD-PLL csrc/dd_pll.cu and
   Gardner loop csrc/gardner.cu, and the GPS tracking loops
   csrc/gnss_track.cu), and
   prints the BP kernel's build time and ptxas
   register/shared-memory report, then the BP launch for each code and rule
   at B=3072 (ops.ldpc_bp.launch_plan: threads a block, resident blocks an
   SM by cudaOccupancyMaxActiveBlocksPerMultiprocessor, shared memory, the
   persistent grid, codewords a block).
3. Kernel vs plain torch version for N512R12, N576R23 and N512R34 under each
   decode rule: 3072 decodable codewords (±4 LLRs, BP_FLIPS flips) plus 256
   random-normal rows. Tolerance: exact — bits and unsatisfied-check counts
   equal on every row, and no garbage row converges in either. Times both on
   N512R12 at B=3072 with CUDA events after warm-up, and the kernel there at
   max_iter 0, 1 and 2 (the fixed cost of a launch and what an iteration
   adds). After [4], holds the kernel to its plain version (exact, as
   above) on the five BP batches [4]'s decode_batch hands the wrapper,
   recorded as the path makes them: the 128-row header launch and the four
   2 336-row payload launches, one an MCS (BPSK and QPSK rows arrive as
   codewords, 16-QAM rows take up to one iteration, 64-QAM rows several);
   prints each batch's rows still unsatisfied after 0, 1, 2, ...
   iterations and times sum_product there, with its bound and the host's
   time a call.
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
6. Viterbi build: the Viterbi kernel's build time and ptxas report (each
   kernel's registers, stack frame and spills), and for both radices at
   3168 x 1216 the launch the wrapper makes (ops.viterbi.launch_plan: lanes
   a block, resident blocks an SM by cudaOccupancyMaxActiveBlocksPer-
   Multiprocessor, resident lanes an SM, waves).
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
   frames/s. Each run of phases 8-10 and 13-16 counts both radices'
   Viterbi launches from 0 (warm-ups included, comparisons with the plain
   versions not); a default path that launches radix 4 fails the run.
9. DVB-T single frame at an unknown offset: 777 leading zeros, 4 dB, payload
   seed 7, noise seed 8, through decode; payload and every TPS field.
10. COFDM conv link batch: 64 frames of 300 bytes on a conv K=7 r1/2 +
   RS(204,188) MCS with a block inner interleaver, through
   OfdmFrameDemod.decode_batch: the terminated mode of the Viterbi kernel
   on the COFDM path; all 64 payloads and a rising launch count.
11. Radix-4 Viterbi kernel vs its plain version, exact on every lane:
   chunked dvb_k7 at the phase-7 operating point on integer and normal
   float LLRs, terminated k5 128 x 4096 info bits (4100 steps) at r1/2 and
   r3/4; on integer LLRs also equal to the radix-2 kernel. Times radix 4
   beside radix 2 with CUDA events.
12. BP rule sum_product_edge vs its plain version on N512R12, N576R23 and
   N512R34 at B = 3072 + 256 garbage rows (bits and unsat equal on every
   row); on rows where both converge, the same message as the sum_product
   kernel. Times it on N512R12 (also at max_iter 0, 1 and 2), then drives it
   once through the entry point that reaches it,
   ops.bp_decode_pallas(rule="sum_product_edge"), on the 3072 decodable
   rows, counting the launches; then holds it to its plain version (exact)
   and times it at [4]'s five recorded batches.
13. Hierarchical link (the JAX bench's dvb_t_hier_receive_throughput link:
   16-QAM alpha=2, GI 1/8, HP r1/2, LP r3/4): 8 full frames modulated on
   the card by DvbTHierFrameMod, each behind 913 zero samples (the setup of
   tests/test_dvb_t_hier.py:119), decoded one by one by
   DvbTHierFrameDemod(device="cuda").decode with FORCE_RADIX4 off, then
   on. Every HP and LP payload and TPS word must come back in both, and
   each radix's launch count must rise; frames/s of the median of three
   timed runs of each. Then one frame's HP and LP chunk batches (99 and 150
   lanes x 1216 steps), recorded as the path hands them to the chunked
   decode, go through each radix's kernel and its plain version (exact on
   every lane), and each radix is timed there with CUDA events and by the
   host's time a call.
14. Super-frame: four full QPSK r1/2 GI 1/8 frames (cell id 0xBEEF) at
   12 dB through DvbTSuperFrameDemod.decode and .decode_batch: every
   payload byte and the 16-bit cell id.
15. Stream: 6 full QPSK r1/2 frames at random gaps of 0-2000 samples,
   10 dB, fed to DvbTFrameStreamDemod in 50 000-sample chunks, then 2
   hierarchical frames through DvbTHierFrameStreamDemod; all payloads, in
   order. (The receiver searches the GI metric over the buffer's first
   symbol period, as the JAX one does: a gap longer than a symbol can be
   trimmed into the next frame and cost it, in both packages alike.)
16. Blind decode: one QPSK r2/3 GI 1/8 frame at an offset and one
   hierarchical 16-QAM GI 1/16 frame through dvb_t_blind_decode: guard,
   TPS and payloads.
17. Outer-code kernel vs its plain version vs the native host decoder,
   exact (messages and ok flags equal on every row): the ptxas report
   (registers, stack, spills) of both kernels at t = 8 and each lane
   width; every BCH and RS launch that [4]-[16] made, each on its own
   input (every later path's launches are held the same way after [50],
   [51]'s in [51]); BCH t=8 (184,120) at 12 928 codewords ([4]'s count)
   and RS(204,188) at 1 632 ([8]'s), rows with 0..t+3 errors (failed rows
   keep their systematic prefix); small batches at BCH t=1 and t=4 and
   RS(255,239) and RS(60,56); then every batch of blocks [4]'s and [8]'s
   warm-up runs handed the outer decoder, recorded as the path formed them.
18. Outer-code times (CUDA events) at the two main batches, at the
   recorded path blocks and, for RS, at one DVB-T frame's 51 codewords and
   83 ([13]'s largest decode), each beside its bound and its launch plan
   (ops.outer_fec.launch_plan: lanes a codeword, codewords a block, grid);
   the plain version at the main batches; the sweep of lanes a codeword
   (16, 32) and blocks an SM (4, 8, 16) at each of those shapes, each run
   held to the plain version; and the chain's own outer decode
   (frame.chain.outer_decode_batch, host clock, the copies the chain makes
   included) on the native host path and on the card path, swept over the
   block count on the error-laden rows and on the path's rows: the
   crossover the chain's block threshold (_DEVICE_OUTER_MIN_BLOCKS) is set
   from.
19. COFDM batch with a TX lowpass (with_tx_lowpass_null_band(65, 60.0)),
   32 frames, MCS 0-3, through decode_batch.
20. DVB-T with tx_lowpass_for_2k(89, 60.0) (the setup of the JAX package's
   tests/test_dvb_t.py spectral-shaping case: taper 40, RX back-off 64), 4
   full QPSK frames at 15 dB through decode_batch; then the two filter
   paths of dsp/fir.py timed on the card over tap counts (the crossover
   _FFT_MIN_TAPS is set from).
21. COFDM with pilot_interp + cpe (pilots every 8 carriers) through a
   5-sample echo and a phase drift, MCS 0-2.
22. COFDM with DFT precoding, MCS 0-3.
23. COFDM with a QAM-256 MCS at 35 dB.
24. COFDM link on the preset dvb_t_config("1/8", 1e6) with
   dvb_t_mcs_table (conv + RS(204,188) + Forney), MCS 0-2.
   Phases 19-24 recover every payload and header on the card. Every run
   of a decode path counts the outer kernel's launches from 0 and notes
   each outer decode's block count: a decode at or above the threshold on
   the card must launch the kernel, one below must not.
25. FT8/FT4 batched receive (slice 3's main path, the JAX bench's
   ft8_batched_receive_throughput link): ft8_decode_windows(device="cuda")
   on 64 windows of 180 000 samples (15 s at 12 kHz), 56 of them with one
   frame at sample 0, each its own standard message on a carrier drawn
   from 300-2900 Hz on the 6.25 Hz grid, 8 noise only, AWGN at -12 dB in
   2500 Hz (tests/test_ft8.py's batched-window SNR); search band 200-3000
   Hz, max_cand 4 (458 bins, 451 candidate frequencies a window). Every
   message and carrier must come back and every noise window None, in a
   warm-up, three timed runs (windows/s and Msps of the median, host clock
   around work that ends in torch.cuda.synchronize()) and a run with
   ft8_ap_prior("CQ") (the AP rows in the same BP batch); one run under
   torch.profiler gives the card's busy share, and each layer (waterfall
   GEMM, Costas grid + top-k, LLR gather, BP, batched CRC) is timed with
   CUDA events, the host's unpack77 on the host clock. Then the same for
   FT4: ft4_decode_windows on 64 windows of 90 000 samples (7.5 s) at -8
   dB, carriers on FT4's 20.83 Hz grid.
26. The BP kernel on ft8_174_91 (n 174, k 91, m 83, check degree 7, the
   kernel's exact width 7): its launch plan and ptxas registers at width
   7; held to bp_decode_reference exactly (bits and unsat on every row) on
   the four BP batches [25] handed the wrapper, recorded as the path made
   them, and on 4096 decodable rows (±4, 6 flips) + 256 garbage rows; timed
   there with its bound. Rows are 696 bytes, so each is staged by 4-byte
   cp.async.
27. FT8/FT4 TX and the other decoders (tests/test_ft8.py's setups):
   ft8_mod_batch of 64 messages on the card through ft8_demod (exact
   tones); Ft8StreamDecoder.new_ft8 / new_ft4 at -15 / -11 dB, five seeds
   each; ft8_decode_multi_frame on four -21 dB repeats;
   ft8_decode_multi_signal on a co-channel pair with max_passes 1 (the
   strong call) and 3 (both); ft4_decode_multi_signal on two signals.
   Every message must come back; each run counts the BP launches from 0.
28. FM chain (slice 4; the JAX bench's fm_demod_chain_throughput,
   bench.py:160-188): 64 rows of 2^20 random-normal IQ (numpy seed 0, as
   the bench) at 480 kHz through the bench's body on the card (the
   delay-conjugate product, atan2_approx, lp_cascade with the LR4 at 5
   kHz, k = 1/75 kHz); Msps of the median of 7 timed runs after a warm-up
   (host clock around work that ends in torch.cuda.synchronize()); rows 0
   and 63 against the port's CPU output (1e-5 of the peak); then fm_mod ->
   fm_demod (audio bandwidth 5 kHz) of a 1 kHz tone at 75 kHz deviation on
   all 64 rows (random start phases): the tone SNR of every row's last
   three quarters above 20 dB (tests/test_analog_roundtrip.py:20-26).
29. PSK31 roundtrip (psk31_roundtrip_throughput, bench.py:194-233): 16 x
   2048 random bits (seed 1) through the batched DBPSK crossfade and
   bpsk31_demod on the card; every bit back, one PLL launch; Msps of the
   median of 7 timed runs. The PLL kernel against its plain version on the
   roundtrip's matched-filter dots, BPSK and QPSK: decisions exact, soft
   values, symbols and phases within 1e-5 of the peak (the kernel's cosf,
   sinf and rsqrtf against torch's own on the card); both timed (CUDA
   events), with the bound.
30. PSK31 receivers (tests/test_psk31.py's setups) on the card, each run's
   PLL launches counted from 0: psk31_decode_band on three BPSK31 texts off
   the waterfall grid and on a QPSK31 text; Psk31Stream at -5 dB (BPSK31)
   and -6 dB (QPSK31), five seeds each; every text back. The batch
   viterbi_decode (a torch loop, no kernel yet) on 16 x 2048 noisy symbols,
   timed, exact against the CPU on two rows and every bit back.
31. The two-rate one-pole kernel against its plain version, exact, at 64 x
   8192 on agc_rms's real and complex powers (x^2 > env) and cw_mod's keys
   (target >= env), both timed; then agc_rms on 64 x 2^20 complex IQ
   (tail RMS within 25 % of the target) and cw_mod on 64 x 2^20 keys
   (the envelope at 1 at the end of a mark) with the launches counted from
   0 (two); every step of those two launches is held to the plain
   version at once (each step recomputed from the launch's own previous
   envelope in the plain version's float32 operations, exact at every
   step, so exact over the whole run by induction), and the kernel is
   timed at 64 x 2^20.
32. PFB (slice 5a; the JAX bench's pfb_channelizer_throughput, bench.py:
   749-761): pfb_channelize at C = 64, n = 2^20 on the card; four unit
   tones at channel centers (3, 17, -20, -31) must land in their rows more
   than 60 dB over every other row; rows 3 and 40 of a random-normal
   capture (numpy seed 11, as the bench) within 1e-5 of the rows' peak of
   a float64 host bank; Msps of the median of 7 runs beside the bytes
   bound.
33. Band receivers on the card (slice 5a's main path): the COFDM band
   (tests/test_frame.py:487's three links at 8 MS/s in chunks of 37 003,
   every payload back) with its BP launches counted from 0 and each held
   to the plain version (exact: bits and unsat on every row); the DVB-T
   band (tests/test_dvb_t.py:377's two muxes, every payload and cell id
   back) with its radix-2 Viterbi launches counted from 0, each chunk
   batch recorded as the path hands it over and held to the plain version
   (exact), a radix-4 launch failing the run; the AM blind scan (three
   stations, each audio peak within 5 Hz), SSB on three USB channels and
   one LSB (tone SNR > 20 dB) and the FM band (2.6 M samples at 2.4 MHz,
   three stereo + RDS stations found blind: PS names, centers within 5
   kHz, pilot 0.09 ± 10 %, tones 0.8 ± 10 %, separation > 25 dB), the JAX
   tests' bounds (tests/test_fm_broadcast.py:160, :214, :247); the
   channelizer's output on the FM band under one push and 100 003-sample
   chunks, equal.
34. FM stereo + RDS (fm_stereo_rds_throughput, bench.py:800-813):
   _stereo_device at 1 x 2^17 (the bench) and 64 x 2^17 random-normal
   samples at 240 kHz, Msps beside the bytes bound and the card's busy
   share under torch.profiler; RDS PS/RT at 15 dB through fm_stereo_mod
   and fm_stereo_demod on the card (tests/test_fm_broadcast.py:114); the
   clean L/R separation (> 40 dB, levels within 5 %).
35. CSS (css_dechirp_throughput, bench.py:763-779): _dechirp_fft at SF 9 x
   128 symbols, Msps; css_mod -> css_demod for SF 7-12 at an unknown
   offset (777 samples) and 10 dB: every payload and CRC. (Without noise
   the offset search is a tie decided by rounding, in the JAX package
   too: every sub-symbol offset dechirps the repeated preamble to a pure
   tone over a median of rounding residue.)
36. WSPR (wspr_energy_grid_throughput, bench.py:781-799): _energy_grid at
   166 x 8192 samples, 9 dt x 7 df, Msps; wspr_decode_band on
   tests/test_wspr.py:114's three beacons: all three messages.
37. The DD-PLL kernel (slice 5b; specialised on the constellation, one
   sincosf, rows staged through shared memory): first
   the premise of its one range reduction, sincosf against cosf and sinf
   on all 2^32 float32 inputs (ops.dd_pll.sincos_mismatches, none may
   differ); then the kernel against its plain version, exact, on every
   order (BPSK to 256-QAM) at the JAX bench's 4 x 2048 symbols and at 64 x
   2048 (constellation symbols behind a phase ramp, so the unwrapped phase
   reaches ~27 rad); kernel and plain times at 4 and 64 rows of 16-QAM
   with the bytes bound and the kernel's time a symbol.
38. The Gardner kernel against its plain version, exact (symbols and final
   positions), at 64 rows x 2^17 samples of RRC-shaped QPSK at sps 8
   through the matched filter; the loop locks (|y| spread < 0.25); timed
   with the bytes bound. After [42], symbol_sync_gardner on 4096 QPSK
   symbols with its launches counted from 0, its launch recorded and held
   to the plain version on its own inputs, exact.
39. The burst modem (burst_modem_throughput, bench.py:851-874): the bench's
   body (RRC matched filter, energy timing, the batched DD-PLL) at 4 and
   64 x 16384 random-normal samples, Msps beside the bytes bound and the
   card's busy share under torch.profiler;
   burst_mod -> burst_demod for BPSK to 256-QAM under
   tests/test_digital.py:142-169's impairments (37-sample delay, 0.21 %
   CFO, 1.1 rad, ~34 dB), every bit back; digital_mod -> digital_demod
   through a 12 kHz carrier, every order. DD-PLL launches counted from 0
   for each run; every launch of the body's runs and of burst_demod
   recorded and held to the plain version on its own inputs (its rows,
   length and loop_bw), exact.
40. GNSS acquisition (gnss_acquisition_throughput, bench.py:833-849):
   _acquire_grid at 32 PRNs x 41 Dopplers x 2048 samples, 4 blocks, M
   cells/s beside its bound and the busy share; gps_acquire on tests/test_gnss.py:51-80's
   three satellites: each at its Doppler (250 Hz) and code phase (1.5
   samples).
41. The tracking kernel (a prefetched window for E, P and L, two barriers
   an epoch) against its plain version, exact
   (prompts, frequencies, bases, fractions), at the bench's 8 satellites x
   2000 epochs (bench.py:906-940) at each width of TRACK_WIDTHS (128, 256,
   512 threads a satellite, the plain version at the same width): each
   width's time and us an epoch, the chosen width (ops.gnss_track.THREADS)
   beside the fastest, and the window misses (epochs that read device
   memory) a satellite, equal to ops.gnss_track.window_misses' count from
   the run's bases; gnss_tracking_throughput from the kernel's marginal
   time of 2000 over 100 epochs; then tests/test_gnss_nav.py:139-183's
   two-satellite ~18.7 s capture through gps_decode_ephemeris on the card,
   every ephemeris field within that test's tolerances, each of the path's
   tracking launches recorded and its first 2000 epochs held to the plain
   version (run from the same start for 2000 epochs), exact; each launch
   timed again alone (ms, us an epoch) with its window misses against the
   model's.
42. The 2-FSK family (fsk2_engine_throughput, bench.py:815-831):
   fsk2_decision at 4 and 64 x 2^18 samples at 48 kHz, Msps beside the
   bytes bound and the busy share; an AX.25 beacon, Afsk1200Stream under two chunkings, RTTY
   from audio and from IQ FSK, POCSAG pages and AIS reports, each back.
43. Capture I/O and the channel simulator (slice 6a): a 2^22-sample capture
   through the WAV (within 16-bit quantisation) and .npz (exact) formats;
   the seven impairments (CFO, phase noise, I/Q imbalance, multipath,
   fading taps + fading, Watterson) at 64 x 2^20 on the card, rows 0 and
   63 against the CPU path on the same numpy draws (1e-5 of the peak),
   each one's Msps beside its bytes bound and busy share; then [4]'s 128
   frames at MCS 0 behind an echo inside the CP and a 0.5 Hz residual CFO
   into decode_batch, [8]'s 32 QPSK r1/2 frames behind
   tests/test_channel.py:226's -6 dB echo at 10 dB, and 64 FT8 windows
   each through its own Watterson "moderate" channel
   (tests/test_channel.py:203): every payload and message back, and every
   BP and radix-2 Viterbi launch recorded and held to its plain version on
   its own inputs, exact.
44. Morse: a 14 s 48 kHz CW band of 16 stations (MorseEncoder with 10 %
   jitter at 12-35 wpm, tones 600 Hz apart from 1 kHz, levels over 20 dB,
   AWGN) keyed by cw_mod on the card, each two-rate one-pole launch held to
   the plain version at every step; morse_decode_band(max_carriers=16):
   every text and each wpm within 15 %; the envelope filter's route (FFT
   overlap-save above 1 025 taps) and Msps beside the bytes bound and
   the busy share.
45. Band monitor: band_decode on a 2.4 Msps capture of 2^22 samples (AM,
   FM, POCSAG and SSB stations): every label, the AM and FM tones and the
   SSB tone spacing within 10 Hz, every page; Msps beside the bytes bound
   and the busy share; then the narrow modes at the JAX tests' widths (CW
   at 250 kHz, RTTY at 256 kHz, PSK31 beside AM and POCSAG at 500 kHz):
   labels and texts. Every PSK31 PLL launch and the CW capture's two-rate
   one-pole launch held to the plain version.
46. ADS-B: 100 DF17 frames from 20 aircraft at 2 Msps (2^21 samples,
   amplitudes 0.3-1.0, AWGN 0.05) through adsb_decode_capture
   (max_candidates 1024): every message with its fields, each callsign,
   each aircraft's position within 5e-3 degrees; Msps, bound, busy share.
47. SSTV: tests/test_sstv.py's 320 x 256 picture through sstv_mod and
   sstv_demod at 11 025 Hz and 48 kHz: VIS 44 and PSNR at least 35 dB at
   both; Msps of sstv_demod, bound, busy share.
   Every capture of [43]-[47] follows a numpy recipe (the s6_* functions);
   tools/slice6a_jax_fullwidth.py decodes the same captures with the JAX
   package on the CPU.
48. The generic OFDM receive and OTFS (slice 6b) on the 2K grid of
   dvb_t_config("1/4", 7.61e6) (n_fft 2048, cp 512), QPSK and 16-QAM, 64
   rows x 68 symbols behind a known training symbol: ofdm_mod with the
   plan's pilots passed as pilot_bins/pilot_values, multipath_apply (taps
   0, 5, 17), then ofdm_demod with the training-symbol estimate
   (channel_estimate_training, ZF), mmse_equalize, and pilot_interp on
   dvb_t_scattered_config's plan; otfs_mod/otfs_demod at n_doppler 16 (64
   symbols, 4 OTFS frames a row) with LMMSE through the same echo and
   through watterson_apply (a per-symbol estimate from a probe of known
   symbols through the same draws). Every bit back on the noiseless echo;
   on copies at 20 dB rows 0 and 63 against the CPU path (hard bits
   equal, soft symbols within 1e-4 of the peak, build_ofdm_rx_frame's EVM
   within 0.1 dB); Msps of each receive beside its bytes bound and busy
   share. The path launches none of our kernels (checked).
49. The Block classes (slice 6b): 60 s of BPSK31 and QPSK31 text at 8 kHz
   through Bpsk31Mod/Bpsk31Demod/Bpsk31Decider and Qpsk31Demod.flush in
   4 096-sample process() calls (the text back, one PLL launch a call,
   each held to the plain version); 10 s of Morse through CwKeyedMod at
   48 kHz in 1 s calls (each kernel B launch held at every step);
   Ft8Codec.decode_soft on 256 noisy codewords, one call and one BP launch
   each (every payload back, each launch held); the analog and digital
   blocks on 2^20 samples in 2^16-sample calls against one call on the
   whole (Msps); OfdmMod/OfdmDemod on [48]'s grid under both equalizers
   (every bit back).
50. Checkpoint/resume (slice 6b): [5]'s four COFDM frames in
   OfdmFrameStreamDemod, three full 2K QPSK r1/2 frames in
   DvbTFrameStreamDemod, two hierarchical frames, a QPSK31 Psk31Stream,
   an FT8 frame in Ft8StreamDecoder and [33]'s three links in
   OfdmFrameBandStreamDemod, each cut mid-frame, saved with
   save_checkpoint, loaded into a fresh receiver on the card and fed the
   rest: the outputs equal the uninterrupted run's; the file size, save
   and load times; every BP, radix-2 and PLL launch held to the plain
   version. Then the QPSK31 stream checkpointed on the card and finished
   on the CPU, with the same text.
51. The multi-device layer (slice 7) on one Mesh of 8 shards of the card,
   shape (2, 4) (ch x t): fir_overlap_save_sharded (8 time shards) and
   fm_demod_sharded at [28]'s 64 x 2^20 at 480 kHz, 129 taps (1e-5; FM
   1e-4 from column 1); ofdm_soft_demap_sharded at [48]'s 64 x 68 symbols
   of the 2K grid behind its echo at 20 dB under ZF with the held training
   estimate, pilot_interp, DFT precoding and CPE (1e-4, CPE 1e-3, absolute
   and relative); dvb_t_receive_sharded on 64 aligned QPSK r1/2 frames at
   10 dB (LLRs 1e-3, TPS cells 1e-4); psk31_demod_sharded on [49]'s 60 s of
   BPSK31 and QPSK31 (1e-5, one PLL launch a call) and the sharded stream
   decode's texts; each against the port's one-device path on the card,
   on the same inputs (tests/test_parallel.py's tolerances). Then the
   capstones: dvb_t_decode_time_sharded on a 16-QAM r3/4 GI 1/32 capture
   at 18 dB and a noiseless one of tests/test_parallel.py's QPSK r1/2 GI
   1/8 link, each the largest whole-packet payload that fits 1088 and 272
   symbols (1088 and 271 symbols), payload and TPS equal to
   DvbTFrameDemod.decode (one Viterbi launch a shard, RS on the card),
   and the first one's Viterbi and Forney stages alone, each equal to its
   one-device version bit for bit; ofdm_frame_decode_time_sharded
   on [4]'s link, one 1500-byte frame at each of MCS 0-3 (30 dB), and on
   a pilot_interp + CPE link behind an echo, payload and metadata equal to
   OfdmFrameStreamDemod; ber_sharded (exact counts) and
   power_spectrum_sharded (2e-4) on 64 x 2^20; two processes under gloo
   (tools/torch_distributed_smoke.py, the local work on the card)
   all-reducing ber_sharded; dryrun_multichip(8, ["cuda:0"] * 8) and
   entry(). For each path, the time at 8 shards and at 1 shard of the
   card for the same work (host clock, median of 5 after a warm-up, busy
   share under torch.profiler) and the bytes each collective moved between
   shards (parallel.mesh.traffic): shards on one card measure overhead, not
   scaling; and format_scaling_table over 1/2/4/8 channel shards of the
   card for the FIR. Every BP, radix-2 Viterbi, PSK31 PLL and BCH/RS
   launch of the phase is recorded and held to its plain version on its
   own inputs, exact.
52. Prints the kernels' JSON line (each kernel's main-path launches, error
   against its plain version, kernel and plain times, its bound on this
   card from this run's inputs, no library call; for the Viterbi kernels
   also the launches by phase, "13 FORCE_RADIX4" being [13]'s forced run,
   their sum over the default paths, the resident lanes an SM and waves at
   3168 x 1216 and the times at phase 13's chunk batches; for the BP rules
   the launches by phase ([4] by rule, [5], [12], [25], [27] by run and
   [33]), the registers, the launch plan, the times at max_iter 0/1/2 and at
   [4]'s and [25]'s batches with their bounds, the time at [26]'s 4096
   rows, the registers at width 7 and [25]'s receive readings; for the
   outer-code decoders, which no Pallas kernel
   computes, the launches by phase, the chain's two paths at the main
   batch, the sweeps and crossovers and the threshold; for the PSK31 PLL
   and the two-rate one-pole, which replace lax.scan recurrences, the
   launches by phase, the dependent steps a row and [28]-[30]'s rates;
   the two-rate one-pole's ms, plain_ms and bound_ms are at 64 x 8192,
   where the plain loop runs, and its 64 x 2^20 time and bound are under
   ms_full and bound_ms_full; for the DD-PLL, Gardner and tracking
   kernels of slice 5b the same, with their launches by phase: [39]'s
   runs, symbol_sync_gardner, [41]'s ephemeris path (the DD-PLL adds its
   time a symbol and [37]'s sincosf count; the tracking kernel its time
   an epoch, its threads a satellite, [41]'s sweep, its window misses at
   8 x 2000 and on the ephemeris launches, and those launches' times);
   [43]-[45] add to
   the BP, radix-2, PSK31 PLL and two-rate one-pole launches by phase), a
   "slice5" object with [32]-[36]'s rates, bounds and readings, a
   "slice5b" object with [39]-[42]'s, a "slice6a" object with
   [43]-[47]'s, a "slice6b" object with [48]-[50]'s ([49] and [50] add
   to the BP, radix-2, PSK31 PLL and two-rate one-pole launches by phase)
   and a "slice7" object with [51]'s readings ([51] adds to the BP,
   radix-2, PSK31 PLL and outer-code launches by phase);
   the card's name and power limit, then the
   result line
   {"ok": true, "device": {...}} last. Any failure exits non-zero before
   it.

Bounds: the larger of the bytes the function must move (each input read
once, each output written once) over 3.35 TB/s and its float32 operations
(outside the tensor cores) over 67 TFLOP/s, the H100 SXM's published peaks.
BP work is counted per edge and per row-iteration actually run on these
inputs (a row runs iteration i+1 only while it has unsatisfied checks after
i: counted by running the kernel with max_iter = 0, 1, 2, ...); the
operation counts are the least each algorithm needs, a transcendental
counting as one. Viterbi branch sums that every state of a lane shares are
counted once a lane (viterbi_ops). The outer decode's GF table steps are
counted per row and per row that is not a codeword (outer_bound), at the
same rate outside the tensor cores. The PSK31 PLL, the two-rate one-pole,
the DD-PLL and the Gardner loop are bound by bytes (each input read once,
each output written once), the tracking loops by operations (30 float32
operations a sample and satellite an epoch: track_bound); all are chains of
dependent
steps by design, and the line states the chain's length beside the
bound.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 20261016
N_FRAMES = 128
PAYLOAD_BYTES = 1500
BP_BATCH = 3072
BP_GARBAGE = 256
# one MCS group of [4]'s payload launches: 32 frames x 73 N512R12 blocks of
# a 1500-byte payload (block_plan(1500, ...).coded_bits = 73 x 512)
PAYLOAD_ROWS = 32 * 73
# [4]'s frames cycle MCS 0-3 and decode_batch groups them in the order of
# their first frames, so its payload launches come in this order
PAYLOAD_MCS = ("bpsk", "qpsk", "qam16", "qam64")
# flipped ±4 LLRs per decodable codeword: the JAX bench's 6 on the rate-1/2
# code, fewer on the higher rates (their weight-3 columns leave small
# distances, so more flips would often land on another codeword)
BP_FLIPS = {"N512R12": 6, "N576R23": 4, "N512R34": 3}
# the Viterbi operating point: 32 DVB-T frames x 99 chunks of 1216 steps
VIT_LANES, VIT_SPAN = 32 * 99, 1216
DVB_FRAMES, DVB_QAM_FRAMES = 32, 8
COFDM_CONV_FRAMES = 64
HIER_FRAMES = 8
STREAM_FRAMES, STREAM_CHUNK = 6, 50_000
# the outer code's main batches: [4]'s BCH codewords (128 frames x 101
# blocks) and [8]'s RS codewords (32 frames x 51), and the block counts of
# the sweep that locates the crossover between the chain's host and card
# outer paths
BCH_ROWS, RS_ROWS = N_FRAMES * 101, DVB_FRAMES * 51
# [18] also times RS at one DVB-T frame's codewords and at [13]'s largest
# decode, and sweeps the outer kernel's lanes a codeword and blocks an SM
OUTER_FRAME_ROWS = (51, 83)
OUTER_SWEEP_LANES, OUTER_SWEEP_BPS = (16, 32), (4, 8, 16)
SWEEP_BLOCKS = (1, 4, 16, 32, 64, 128, 256, 512, 1024, 1632, 3232, 12928)
# the new link phases (19-24)
LINK_FRAMES, DVB_LP_FRAMES = 32, 4
PILOT_CARRIERS = [(k, 1.0 + 0j) for k in range(-104, 105, 8) if k]
FIR_TAPS = (17, 33, 65, 89, 129, 193, 257, 513, 1025, 2049)
# the one run of a decode path that is not a default path: [13] with
# ops.viterbi.FORCE_RADIX4 on
FORCED = "13 FORCE_RADIX4"
# float32 operations per edge and row-iteration of BP, the least each rule
# needs (check update, bit sum, new message, syndrome); Viterbi's count is
# viterbi_ops
BP_OPS = {"sum_product": 33, "sum_product_edge": 42}
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12
# ~10 ms of the card's clock: longer than the host takes to queue any timed
# run of kernel launches below
SLEEP_CYCLES = 20_000_000
# FT8/FT4 (phases 25-27): the JAX bench's ft8_batched_receive_throughput
# windows (15 s FT8 / 7.5 s FT4 at 12 kHz), the full search band, and the
# SNR of tests/test_ft8.py's batched-window tests (in 2500 Hz)
FT_FS, FT_BASE, FT_MAX, FT_MAX_CAND = 12000.0, 200.0, 3000.0, 4
FT_WINDOWS, FT_SIGNALS = 64, 56
FT_WIN = {"ft8": 180_000, "ft4": 90_000}
FT_SNR = {"ft8": -12.0, "ft4": -8.0}
FT_BP_ROWS, FT_BP_FLIPS = 4096, 6
# slice 4 (phases 28-31): the JAX bench's FM chain (bench.py:160-188: 64
# channels of 2^20 samples at 480 kHz, LR4 at 5 kHz, k = 1/75 kHz) and PSK31
# roundtrip (bench.py:194-233: 16 channels of 2048 bits at 8 kHz), and the
# two-rate one-pole at the FM width
FM_ROWS, FM_LOG2_N, FM_FS, FM_LP_HZ, FM_RUNS = 64, 20, 480e3, 5e3, 7
FM_K = float(np.float32(1.0 / 75e3))
FM_TONE_HZ, FM_DEV_HZ, FM_AUDIO_BW_HZ = 1000.0, 75e3, 5000.0
PSK_FS, PSK_ROWS, PSK_BITS, PSK_RUNS = 8000.0, 16, 2048, 7
ONEPOLE_FS, ONEPOLE_ROWS, ONEPOLE_CMP, ONEPOLE_LOG2_N = 8000.0, 64, 8192, 20
# slice 5a (phases 32-36): the JAX bench's family shapes (bench.py:742-815):
# the PFB at C = 64, n = 2^20 (P = 12 taps a phase), the FM stereo program
# at 2^17 samples of 240 kHz (and a 64-channel batch), the CSS dechirp at SF
# 9 x 128 symbols; each rate the median of S5_RUNS runs
PFB_C, PFB_LOG2_N, PFB_TAPS = 64, 20, 12
PFB_TONE_CH = (3, 17, -20, -31)
STEREO_FS, STEREO_LOG2_N, STEREO_ROWS = 240e3, 17, 64
CSS_SF, CSS_SYMS = 9, 128
S5_RUNS = 7
# slice 5b (phases 37-42): the JAX bench's family shapes (bench.py:815-940)
# and wider batches: the burst modem at 4 and 64 rows of 2048 16-QAM symbols
# at sps 8, the Gardner loop at 64 x 2^17 samples, acquisition at 32 PRNs x
# 41 Dopplers x 2048 samples (2.048 MHz), tracking at 8 satellites x 2000
# epochs (100 for the marginal), the 2-FSK decision at 4 and 64 x 2^18
BURST_SPS, BURST_SYMS, BURST_ROWS, BURST_ORDER = 8, 2048, (4, 64), "qam16"
GARDNER_ROWS, GARDNER_LOG2_N = 64, 17
GNSS_FS, GNSS_SPMS = 2.048e6, 2048
TRACK_SATS, TRACK_EPOCHS, TRACK_SHORT = 8, 2000, 100
TRACK_WIDTHS = (128, 256, 512)     # kernel E's threads a satellite, swept
FSK_LOG2_N, FSK_ROWS = 18, (4, 64)
# slice 6a (phases 43-47): the capture-to-text receivers. [43] a 2^22-sample
# capture through the file formats, the seven impairments at 64 x 2^20
# (fs 1 MHz), three links through the channel: [4]'s 128 COFDM frames at
# MCS 0 behind an echo inside the CP and a 0.5 Hz residual CFO (decode_batch
# takes aligned, CFO-corrected bodies: 1 Hz at 1 rad already costs every
# frame in both packages), [8]'s 32 QPSK
# r1/2 DVB-T frames behind tests/test_channel.py:226's -6 dB echo at 10 dB,
# 64 FT8 windows through Watterson "moderate"; [44] a 14 s 48 kHz CW band of
# 16 stations; [45] a 2.4 Msps band of AM, FM, POCSAG and SSB stations and
# the narrow modes at the JAX tests' widths; [46] 100 DF17 frames from 20
# aircraft at 2 Msps; [47] a Martin M1 picture at 11 025 Hz and 48 kHz.
# The recipes (s6_* below) are numpy only: the JAX package decodes the same
# captures on the CPU (PERF.md, PR 11)
S6_SEED = 611
CH_FS, CH_ROWS, CH_LOG2_N, IO_LOG2_N = 1e6, 64, 20, 22
CH_ECHO = ([0, 4], [1.0, 0.35 * np.exp(0.7j)])      # inside [4]'s 64-sample CP
CH_CFO_HZ, CH_PHASE0 = 0.5, 0.3
DVB_ECHO = ([0, 32], [1.0, 10 ** (-6 / 20) * np.exp(1.3j)])
DVB_ECHO_SNR_DB = 10.0
FT_FADED, FT_CARRIER = 64, 1000.0
MORSE_FS, MORSE_N, MORSE_SIGS, MORSE_NOISE = 48_000.0, 672_000, 16, 0.05
BAND_FS, BAND_LOG2_N, BAND_NOISE = 2.4e6, 22, 0.004
ADSB_FS, ADSB_LOG2_N, ADSB_PLANES, ADSB_NOISE = 2e6, 21, 20, 0.05
SSTV_RATES = (11025.0, 48000.0)
# slice 6b (phases 48-50): [48] the generic OFDM receive and OTFS on the 2K
# grid of dvb_t_config("1/4", 7.61e6) (n_fft 2048, cp 512), QPSK and 16-QAM,
# 64 rows x 68 symbols (OTFS 64 symbols: 4 frames at n_doppler 16) behind a
# known training symbol, through three echo taps inside the guard and
# within the scattered pilots' safe backoff (85 samples), and through
# Watterson (183 samples apart, inside the guard); [49] the Block classes
# at session lengths (60 s of PSK31 at 8 kHz, 10 s of CW at 48 kHz, 256
# FT8 codewords, 2^20 samples of the analog and digital blocks); [50] six
# streams checkpointed mid-frame and resumed in a fresh receiver
S6B_SEED, S6B_RUNS = 612, 5
OFDM_BW, OFDM_ROWS, OFDM_SYMS = 7.61e6, 64, 68
OTFS_DOPPLER, OTFS_SYMS = 16, 64
OFDM_ECHO = ([0, 5, 17], [1.0, 0.3 * np.exp(0.7j), 0.15 * np.exp(-1.9j)])
OFDM_SNR_DB = 20.0
WATTERSON = (20e-6, 10.0)         # path delay s, Doppler spread Hz
BLOCK_PSK_S, BLOCK_PSK_CHUNK, BLOCK_PSK_BUSY_CALLS = 60.0, 4096, 16
BLOCK_CW_S, BLOCK_CW_FS, BLOCK_CW_CHUNK = 10.0, 48_000.0, 48_000
BLOCK_FT8_ROWS, BLOCK_FT8_SIGMA = 256, 0.55
BLOCK_LOG2_N, BLOCK_LOG2_CHUNK = 20, 16
CKPT_DVB_FRAMES = 3
# slice 7 (phase 51): the multi-device layer on one Mesh of 8 shards of the
# card, shape (2, 4) (ch x t), each sharded path against the port's
# one-device path: [28]'s FIR/FM width (129 taps), [48]'s 2K grid, 64
# aligned DVB-T frames, [49]'s 60 s of PSK31, the DVB-T capstone on the
# largest payloads that fit 1088 symbols of 16-QAM r3/4 GI 1/32 at 18 dB
# and 272 of tests/test_parallel.py's QPSK r1/2 GI 1/8 link, the COFDM
# capstone on [4]'s link at MCS 0-3 (30 dB) and on a pilot_interp + CPE
# link; the overhead of 8 shards against 1 for the same work
S7_SEED, S7_RUNS, S7_SHARDS, S7_SHAPE = 713, 5, 8, (2, 4)
S7_FIR_TAPS, S7_SCALE_ROWS, S7_COFDM_SNR_DB = 129, 8, 30.0
S7_DVB = {"16-QAM r3/4 GI 1/32 at 18 dB, a 1088-symbol payload":
          ("1/32", "qam16", "3/4", 1088, 18.0),
          "QPSK r1/2 GI 1/8 (tests/test_parallel.py's link), a 272-symbol "
          "payload": ("1/8", "qpsk", "1/2", 272, None)}


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def print_ptxas(built):
    for line in built.log.splitlines():
        if "Compiling entry function" in line:
            print("   ", line.split("'")[1] if "'" in line else line.strip())
        elif "registers" in line or "smem" in line or "spill" in line:
            print("   ", line.strip())


def zero_vit(viterbi):
    """Sets both Viterbi wrappers' launch counts to 0."""
    for fn in (viterbi.viterbi_chunks_kernel,
               viterbi.viterbi_decode_soft_kernel):
        fn.launches = 0
        fn.launches_radix4 = 0


def read_vit(viterbi):
    """(radix-2, radix-4) launches of both wrappers since zero_vit."""
    k, t = viterbi.viterbi_chunks_kernel, viterbi.viterbi_decode_soft_kernel
    return k.launches + t.launches, k.launches_radix4 + t.launches_radix4


def print_plans(viterbi):
    """The launch each radix makes at the DVB-T batch: returns {radix:
    plan}."""
    plans = {}
    for radix in (2, 4):
        p = viterbi.launch_plan(VIT_LANES, VIT_SPAN, "dvb_k7", radix)
        plans[radix] = p
        print(f"  radix {radix} at {VIT_LANES} x {VIT_SPAN}: {p['warps']} "
              f"lanes a block, {p['blocks_per_sm']} blocks an SM (occupancy "
              f"query), {p['lanes_per_sm']} resident lanes an SM, "
              f"{p['smem']} B shared memory a block, {p['sms']} SMs: "
              f"{p['waves']} wave(s)")
    return plans


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Device ms a call of ``fn``: CUDA events around ``reps`` calls queued
    behind a sleep kernel that holds the card while the host enqueues them,
    so launches shorter than the host's time a call run back to back and
    the host's gaps are not counted (a plain version whose host work
    outlasts the sleep still counts them)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float):
    """(least time in ms, what sets it) on the H100's published peaks."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bp_bound(ldpc_bp, g, llr, rule, max_iter=50):
    """Bound of one BP decode of ``llr`` under ``rule``: (ms, what sets it,
    iterations a row, rows still unsatisfied after i iterations for i = 0,
    1, ...). Counts the row-iterations these inputs run, by running the
    kernel at max_iter = 0, 1, 2, ..."""
    rows = 0
    lefts = []
    for i in range(max_iter):
        _, unsat = ldpc_bp.bp_decode_kernel(g, llr, i, rule)
        left = int((unsat > 0).sum())
        lefts.append(left)
        if left == 0:
            break
        rows += left
    t = ldpc_bp.graph_tables(g, llr.device)
    edges = int(np.asarray(g.check_mask).sum())
    B = llr.shape[0]
    n_bytes = (B * g.n * 4 + B * g.k + B * 4 + t.check_slots.numel() * 2
               + t.bit_slots.numel() * 2)
    return bound_ms(n_bytes, rows * edges * BP_OPS[rule]) + (rows / B, lefts)


def bp_iter_times(ldpc_bp, g, x, rule):
    """Kernel ms at max_iter 0, 1 and 2 on ``x``: the fixed cost of a
    launch and what an iteration adds."""
    times = {i: cuda_ms(lambda: ldpc_bp.bp_decode_kernel(g, x, i, rule),
                        reps=20) for i in (0, 1, 2)}
    print(f"  N512R12 {rule} B={x.shape[0]} at max_iter 0 / 1 / 2: "
          + " / ".join(f"{ms:.4f}" for ms in times.values()) + " ms")
    return times


def bp_path_times(ldpc_bp, batches, rule, where="[4]'s"):
    """``rule`` at a path's recorded batches ([4]'s by default), each at the
    max_iter the path gave it: the kernel against its plain version (exact:
    bits and unsat equal on every row), then kernel ms, bound and the
    host's ms a call. Returns (max |kernel − plain|, {label: (ms,
    bound)})."""
    out, max_err = {}, 0.0
    for label, (g, x, max_iter) in batches.items():
        kb, ku = ldpc_bp.bp_decode_kernel(g, x, max_iter, rule)
        rb, ru = ldpc_bp.bp_decode_reference(g, x, max_iter, rule)
        torch.cuda.synchronize()
        err = max(float((kb.int() - rb.int()).abs().max()),
                  float((ku - ru).abs().max()))
        max_err = max(max_err, err)
        if err != 0.0:
            fail(f"{rule} at {where} {label} batch: kernel and plain version "
                 f"differ")
        ms = cuda_ms(lambda: ldpc_bp.bp_decode_kernel(g, x, max_iter, rule),
                     reps=20)
        bnd = bp_bound(ldpc_bp, g, x, rule, max_iter)
        out[label] = (ms, bnd)
        grid = ldpc_bp.launch_plan(g, rule, x.shape[0])["grid"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            ldpc_bp.bp_decode_kernel(g, x, max_iter, rule)
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        print(f"  {rule} at {where} {label} batch ({x.shape[0]} rows, grid "
              f"{grid}, max_iter {max_iter}): max|kernel-plain|={err:g}, "
              f"{int((ku > 0).sum())} rows left unsatisfied; rows "
              f"unsatisfied after 0, 1, 2, ... iterations {bnd[3]}; kernel "
              f"{ms:.4f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}, {bnd[2]:.3f} "
              f"iterations a row), {bnd[0] / ms:.1%} of it; host "
              f"{host_ms:.4f} ms a call")
    return max_err, out


def print_bp_plans(ldpc_bp):
    """[2]: the BP launch (ops.ldpc_bp.launch_plan) for each code and rule
    code at B = BP_BATCH; returns N512R12's {rule: plan} there."""
    from orion_sdr_tpu_torch.fec.ldpc import LDPC_CODES, ldpc_graph
    for name in sorted(LDPC_CODES):
        g = ldpc_graph(name)
        for rule in ("sum_product", "min_sum", "sum_product_edge"):
            p = ldpc_bp.launch_plan(g, rule, BP_BATCH)
            print(f"  {name} {rule} B={BP_BATCH}: {p['threads']} threads a "
                  f"block, {p['blocks_per_sm']} blocks an SM (occupancy "
                  f"query), {p['smem']} B shared memory a block, "
                  f"{p['sms']} SMs: grid {p['grid']}, "
                  f"{p['codewords_per_block']} codewords a block")
    return {rule: ldpc_bp.launch_plan(ldpc_graph("N512R12"), rule, BP_BATCH)
            for rule in ("sum_product", "sum_product_edge")}


def ptxas_registers(built, rule_code, width):
    """Registers of ldpc_bp_kernel<rule_code, width, exact> from the
    build's -Xptxas -v report."""
    rep = ptxas_report(built, f"ldpc_bp_kernelILi{rule_code}ELi{width}ELb1E")
    return rep.get("registers") if rep else None


def r4_shared_sums(code: str) -> int:
    """Per lane and phase, the radix-4 branch sums that all states share:
    s = l0 + l1 and d = l0 − l1 of four steps, then the distinct pair sums
    v0 + v1 and v2 + v3 and four-step sums the code's candidates use, each
    up to sign (a sum and its negation cost one operation)."""
    from orion_sdr_tpu_torch.ops.viterbi import _radix4_tables
    _, diff, neg = _radix4_tables(code)
    d, n = diff.reshape(4, -1).astype(int), neg.reshape(4, -1).astype(int)
    p01 = d[0] * 4 + d[1] * 2 + (n[0] ^ n[1])
    p23 = d[2] * 4 + d[3] * 2 + (n[2] ^ n[3])
    quad = (p01 * 8 + p23) * 2 + (n[0] ^ n[2])
    return 8 + len(set(p01)) + len(set(p23)) + len(set(quad))


def viterbi_ops(L: int, T: int, code: str, radix: int) -> int:
    """The least float32 operations of a chunked decode, L lanes of T steps.
    Radix 2, per state and step: two candidates of two adds (the plain
    version's (pm + v0) + v1 order), compare, select, then the maximum and
    the subtraction. Radix 4, per state and phase: 16 candidates of one add
    over the shared four-step sums, a 15-node tree of compare + select, the
    maximum and the subtraction; per lane and phase the shared sums."""
    from orion_sdr_tpu_torch.fec.conv import CONV_CODES
    S = 1 << (CONV_CODES[code]["K"] - 1)
    if radix == 2:
        return L * T * (8 * S - 1)
    return L * (T // 4) * (48 * S - 1 + r4_shared_sums(code))


def viterbi_bound(L: int, T: int, code: str, radix: int):
    """Bound of a chunked decode: L lanes of T steps."""
    from orion_sdr_tpu_torch.fec.conv import CONV_CODES
    S = 1 << (CONV_CODES[code]["K"] - 1)
    return bound_ms(2 * L * T * 4 + L * S * 4 + L * T,
                    viterbi_ops(L, T, code, radix))


def bp_inputs(name, g, dev, rng):
    """BP_BATCH decodable codewords of code ``name`` (±4 LLRs with
    BP_FLIPS flips) → (messages, their LLRs, the LLRs with BP_GARBAGE
    random-normal rows appended)."""
    from orion_sdr_tpu_torch.fec.ldpc import ldpc_encode
    msg = torch.as_tensor(rng.integers(0, 2, (BP_BATCH, g.k)),
                          dtype=torch.uint8, device=dev)
    llr = (1.0 - 2.0 * ldpc_encode(name, msg).to(torch.float32)) * 4.0
    flips = torch.as_tensor(np.stack([rng.choice(g.n, BP_FLIPS[name],
                                                 replace=False)
                                      for _ in range(BP_BATCH)]), device=dev)
    llr.scatter_(1, flips, -llr.gather(1, flips))
    junk = torch.as_tensor(rng.standard_normal((BP_GARBAGE, g.n)),
                           dtype=torch.float32, device=dev)
    return msg, llr, torch.cat([llr, junk]).contiguous()


def vit_inputs(dev, rng):
    """The chunked operating point: (initial metrics with every 99th row
    pinned at state 0 as a stream's chunk 0, integer LLR pair, normal float
    LLR pair)."""
    L, T = VIT_LANES, VIT_SPAN
    pm0 = torch.as_tensor(rng.integers(-30, 1, (L, 64)), dtype=torch.float32,
                          device=dev)
    pm0[::99] = -1e30
    pm0[::99, 0] = 0.0
    ints = [torch.as_tensor(rng.integers(-8, 9, (L, T)), dtype=torch.float32,
                            device=dev) for _ in range(2)]
    floats = [torch.as_tensor(rng.standard_normal((L, T)), dtype=torch.float32,
                              device=dev) for _ in range(2)]
    return pm0, ints, floats


def kernel_vs_plain(ldpc_bp, dev, rng):
    """Phase 3: returns (max |kernel − plain| over all rows, {rule: (kernel
    ms, plain ms)} on N512R12, the sum_product bound there, sum_product's
    times at max_iter 0 / 1 / 2 there)."""
    from orion_sdr_tpu_torch.fec.ldpc import (DECODE_RULES, LDPC_CODES,
                                              ldpc_graph)
    max_err = 0.0
    times = {}
    for name in sorted(LDPC_CODES):
        g = ldpc_graph(name)
        msg, llr, both = bp_inputs(name, g, dev, rng)
        for rule in DECODE_RULES:
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
                if rule == "sum_product":
                    bound = bp_bound(ldpc_bp, g, x, rule)
                    after = (0, 1, 2, 3, 5, 10, 20, 49)
                    left = [bound[3][i] if i < len(bound[3]) else 0
                            for i in after]
                    print(f"  N512R12 sum_product bound {bound[0]:.5f} ms "
                          f"({bound[1]}), {bound[2]:.3f} iterations a row; "
                          f"rows unsatisfied after {after} iterations: "
                          f"{left}")
                    iters = bp_iter_times(ldpc_bp, g, x, rule)
    return max_err, times, bound, iters


def link(P):
    plan = P.CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    cfg = P.OfdmConfig(plan, fs=1e6)
    pre = P.OfdmPreamble(repeat_len=128, num_repeats=4).with_training_symbol(
        plan.n_fft, plan.cp_len)
    return cfg, pre, P.McsTable.default_ladder()


def cofdm_frames(P, dev, rng):
    """[4]'s capture: N_FRAMES frames of PAYLOAD_BYTES, MCS cycling 0-3,
    modulated on the card, AWGN at 0.02 x signal power → (cfg, table,
    frames, iq batch on the card, post-preamble samples)."""
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
    return (cfg, table, frames, torch.as_tensor(batch, device=dev),
            sum(len(b) for b in bodies))


def record_bp(run, module=None, attr="ldpc_decode"):
    """Calls ``run()`` with every LDPC decode that ``module.attr`` makes
    (the frame chain's ``ldpc_decode`` by default, or FT8's
    ``codec.ft8_ldpc.bp_decode``; its first argument a code name or a
    graph) recorded as the path hands it to the BP wrapper: returns
    [(graph, LLRs, max_iter, rule)]."""
    from orion_sdr_tpu_torch.fec.ldpc import ldpc_graph
    from orion_sdr_tpu_torch.frame import chain
    module = chain if module is None else module
    seen = []
    real = getattr(module, attr)

    def rec(code, llr, max_iter=50, rule="sum_product", alpha=0.75):
        g = ldpc_graph(code) if isinstance(code, str) else code
        seen.append((g, llr.clone(), max_iter, rule))
        return real(code, llr, max_iter, rule, alpha)
    setattr(module, attr, rec)
    try:
        run()
    finally:
        setattr(module, attr, real)
    return seen


def batch_path(P, ldpc_bp, dev, rng):
    """Phase 4: returns ({rule: BP launches of its three timed runs}, the
    BP batches of the sum-product warm-up run as the path handed them)."""
    cfg, table, frames, iq_dev, n_rx = cofdm_frames(P, dev, rng)
    launches, recorded = {}, []
    for rule in ("sum_product", "scaled_min_sum"):
        demod = P.OfdmFrameDemod(cfg.with_ldpc_decode_rule(rule), table,
                                 device=dev)
        # warm-up (cuFFT plans, tables, build), BP batches recorded once
        if rule == "sum_product":
            OUTER.record = True
            try:
                recorded = record_bp(lambda: demod.decode_batch(iq_dev))
            finally:
                OUTER.record = False
        else:
            demod.decode_batch(iq_dev)
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
        n = launches[rule] = ldpc_bp.bp_decode_kernel.launches
        if n <= 0:
            fail("the main path launched no BP kernel")
        dt = sorted(secs)[1]
        print(f"  decode_batch {rule}: {N_FRAMES}/{N_FRAMES} frames recovered "
              f"in each of 3 runs, {n} BP launches; runs "
              f"{', '.join(f'{x:.4f}' for x in secs)} s; median "
              f"{N_FRAMES / dt:.4g} frames/s, {n_rx / dt / 1e6:.4g} Msps "
              f"({n_rx} post-preamble samples per run)")
    print(f"  recorded BP batches (sum_product warm-up): "
          f"{[(g.name, tuple(x.shape), mi, r) for g, x, mi, r in recorded]}")
    return launches, recorded


def path_batches(recorded):
    """[4]'s header launch and its payload launches, one an MCS:
    {"header 128x512": (graph, LLRs, max_iter), "payload bpsk 2336x512":
    ..., ...}."""
    header, payloads = recorded[0], recorded[1:]
    rows = [r[1].shape[0] for r in payloads]
    if rows != [PAYLOAD_ROWS] * len(PAYLOAD_MCS):
        fail(f"[4]'s payload launches have {rows} rows, not "
             f"{len(PAYLOAD_MCS)} x {PAYLOAD_ROWS}")
    out = {f"header {header[1].shape[0]}x{header[0].n}": header[:3]}
    for mcs, r in zip(PAYLOAD_MCS, payloads):
        out[f"payload {mcs} {PAYLOAD_ROWS}x{r[0].n}"] = r[:3]
    return out


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
    """Phase 5: returns its BP launches."""
    cfg, pre, table = link(P)
    buf, payloads = stream_capture(P, dev, rng)
    rx = P.OfdmFrameStreamDemod(cfg, table, pre, device=dev)
    ldpc_bp.bp_decode_kernel.launches = 0
    res = []
    t0 = time.perf_counter()
    for i in range(0, len(buf), 20000):
        res += rx.feed(buf[i:i + 20000])
    res += rx.flush()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ldpc_bp.bp_decode_kernel.launches
    got = [r.packet.payload for r in res if isinstance(r, P.RxFrame)]
    ok = len(got) == 4 and all(np.array_equal(a, b)
                               for a, b in zip(got, payloads))
    print(f"  stream: {len(got)}/4 frames in order={ok}, {launches} BP "
          f"launches, {len(buf)} samples in {dt:.4f} s")
    if not ok:
        fail("the stream demod lost or reordered frames")
    if launches <= 0:
        fail("the stream path launched no BP kernel")
    return launches


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
    pm0, ints, floats = vit_inputs(dev, rng)
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
          f"({L * 1024 / k_ms * 1e3:.4g} info bits/s), plain {p_ms:.4f} ms; "
          f"bound {viterbi_bound(L, T, 'dvb_k7', 2)}")
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


def dvb_t_full_payload(P, params, n_sym: int = 68):
    """Largest whole-packet payload whose coded stream fits ``n_sym``
    symbols (a 68-symbol frame by default)."""
    from orion_sdr_tpu_torch.modulate.dvb_t_frame import _coded_bits_for_packets
    from orion_sdr_tpu_torch.constellation import BITS_PER_SYMBOL
    capacity = n_sym * 1512 * BITS_PER_SYMBOL[params.link.constellation]
    # the coded length grows with the packet count: bisect for the last fit
    lo, hi = 1, capacity // (188 * 8) + 1
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if _coded_bits_for_packets(mid, params) <= capacity:
            lo = mid
        else:
            hi = mid
    return lo * 187


def dvb_t_run(P, viterbi, dev, rng, link, n_frames, snr_db):
    """Modulate n_frames full frames on the card, add AWGN, decode them with
    decode_batch three times after a warm-up; returns the (radix-2,
    radix-4) Viterbi launches of the warm-up and the timed runs."""
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
    zero_vit(viterbi)
    OUTER.record = True                              # warm-up, recorded
    try:
        demod.decode_batch(iq_dev, n_sym, n_bytes)
    finally:
        OUTER.record = False
    torch.cuda.synchronize()
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
    n = read_vit(viterbi)
    if n[0] <= 0:
        fail("the DVB-T path launched no Viterbi kernel")
    dt = sorted(secs)[1]
    print(f"  decode_batch: {n_frames}/{n_frames} payloads and TPS words in "
          f"each of 3 runs, {n[0]} radix-2 and {n[1]} radix-4 Viterbi "
          f"launches (warm-up included); runs "
          f"{', '.join(f'{x:.4f}' for x in secs)} s; median "
          f"{n_frames / dt:.4g} frames/s, {batch.size / dt / 1e6:.4g} Msps")
    return n


def dvb_t_batch(P, viterbi, dev, rng):
    """Phase 8: returns the (radix-2, radix-4) Viterbi launches of both
    runs."""
    a = dvb_t_run(P, viterbi, dev, rng, ("1/8", "qpsk", "1/2"), DVB_FRAMES,
                  6.0)
    b = dvb_t_run(P, viterbi, dev, rng, ("1/8", "qam16", "3/4"),
                  DVB_QAM_FRAMES, 15.0)
    return a[0] + b[0], a[1] + b[1]


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
    """Phase 10: the conv+RS COFDM link through decode_batch; returns its
    (radix-2, radix-4) Viterbi launches."""
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
    zero_vit(viterbi)
    t0 = time.perf_counter()
    out = P.OfdmFrameDemod(cfg, table, device=dev).decode_batch(
        torch.as_tensor(batch, device=dev))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = read_vit(viterbi)
    good = sum(isinstance(got, P.FramePacket)
               and np.array_equal(got.payload, data) and got.metadata == meta
               for got, (meta, data, _) in zip(out, frames))
    print(f"  {good}/{COFDM_CONV_FRAMES} frames recovered in {dt:.4f} s "
          f"(first run), {n[0]} radix-2 and {n[1]} radix-4 Viterbi "
          f"launches")
    if good != COFDM_CONV_FRAMES:
        fail(f"COFDM conv link: {COFDM_CONV_FRAMES - good} frames lost")
    if viterbi.viterbi_decode_soft_kernel.launches <= 0:
        fail("the COFDM conv link launched no terminated Viterbi kernel")
    return n


def radix4_vs_plain(viterbi, dev, rng):
    """Phase 11: returns (max |kernel − plain| over every bit, radix-4 ms,
    plain ms) at the chunked operating point on float LLRs."""
    from orion_sdr_tpu_torch.fec.conv import punctured_coded_len
    max_err = 0.0

    def check(name, got, want, radix2=None):
        nonlocal max_err
        torch.cuda.synchronize()
        err = float((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        r2 = ("" if radix2 is None else
              f", differs from radix 2 on {int((got != radix2).sum())} bits")
        print(f"  {name}: {got.shape[0]} lanes x {got.shape[1]} bits, "
              f"max|kernel-plain|={err:g}{r2}")
        if err != 0.0:
            fail(f"radix-4 Viterbi {name}: kernel and plain version differ")
        if radix2 is not None and not torch.equal(got, radix2):
            fail(f"radix-4 Viterbi {name}: differs from radix 2 on integer "
                 f"LLRs")

    L, T = VIT_LANES, VIT_SPAN
    pm0, ints, floats = vit_inputs(dev, rng)
    for kind, (c0, c1) in (("integer", ints), ("float", floats)):
        r4 = viterbi.viterbi_chunks_kernel(c0, c1, pm0, "dvb_k7", radix=4)
        r2 = viterbi.viterbi_chunks_kernel(c0, c1, pm0, "dvb_k7", radix=2)
        check(f"chunked dvb_k7 {kind} LLRs", r4,
              viterbi.viterbi_chunks_reference(c0, c1, pm0, "dvb_k7", radix=4),
              r2 if kind == "integer" else None)
        if kind == "float":
            print(f"  float LLRs: radix 4 differs from radix 2 on "
                  f"{int((r4 != r2).sum())} of {r4.numel()} bits (near-ties)")
    c0, c1 = floats
    k4 = cuda_ms(lambda: viterbi.viterbi_chunks_kernel(c0, c1, pm0, "dvb_k7",
                                                       radix=4))
    k2 = cuda_ms(lambda: viterbi.viterbi_chunks_kernel(c0, c1, pm0, "dvb_k7",
                                                       radix=2))
    p4 = cuda_ms(lambda: viterbi.viterbi_chunks_reference(c0, c1, pm0,
                                                          "dvb_k7", radix=4),
                 reps=2, warmup=1)
    print(f"  chunked dvb_k7 L={L} T={T}: radix 4 {k4:.4f} ms, radix 2 "
          f"{k2:.4f} ms, radix-4 plain {p4:.4f} ms; radix-4 bound "
          f"{viterbi_bound(L, T, 'dvb_k7', 4)}")
    n = 4096
    for rate in ("1/2", "3/4"):
        llr = torch.as_tensor(
            rng.standard_normal((128, punctured_coded_len(n, rate, "k5")))
            * 2.0, dtype=torch.float32, device=dev)
        ints = torch.as_tensor(
            rng.integers(-8, 9, (128, punctured_coded_len(n, rate, "k5"))),
            dtype=torch.float32, device=dev)
        check(f"terminated k5 {rate} float",
              viterbi.viterbi_decode_soft_kernel(llr, n, rate, "k5", radix=4),
              viterbi.viterbi_terminated_reference(llr, n, rate, "k5", 4))
        check(f"terminated k5 {rate} integer",
              viterbi.viterbi_decode_soft_kernel(ints, n, rate, "k5", radix=4),
              viterbi.viterbi_terminated_reference(ints, n, rate, "k5", 4),
              viterbi.viterbi_decode_soft_kernel(ints, n, rate, "k5", radix=2))
        t4 = cuda_ms(lambda: viterbi.viterbi_decode_soft_kernel(
            llr, n, rate, "k5", radix=4))
        t2 = cuda_ms(lambda: viterbi.viterbi_decode_soft_kernel(
            llr, n, rate, "k5", radix=2))
        print(f"  terminated k5 {rate} 128 x {n}: radix 4 {t4:.4f} ms, "
              f"radix 2 {t2:.4f} ms")
    return max_err, k4, p4


def edge_vs_plain(ldpc_bp, dev, rng, batches):
    """Phase 12: returns (max |kernel − plain| over these inputs and [4]'s
    recorded batches, kernel ms, plain ms, bound, main-path launches, times
    at max_iter 0 / 1 / 2, {label: (ms, bound)} at [4]'s recorded batches)
    of the sum_product_edge rule."""
    from orion_sdr_tpu_torch.fec.ldpc import LDPC_CODES, ldpc_graph
    from orion_sdr_tpu_torch.ops import bp_decode_pallas
    rule = "sum_product_edge"
    max_err = 0.0
    for name in sorted(LDPC_CODES):
        g = ldpc_graph(name)
        msg, llr, both = bp_inputs(name, g, dev, rng)
        kb, ku = ldpc_bp.bp_decode_kernel(g, both, 50, rule)
        rb, ru = ldpc_bp.bp_decode_reference(g, both, 50, rule)
        sb, su = ldpc_bp.bp_decode_kernel(g, both, 50, "sum_product")
        torch.cuda.synchronize()
        err = max(float((kb.int() - rb.int()).abs().max()),
                  float((ku - ru).abs().max()))
        max_err = max(max_err, err)
        both_conv = (ku[:BP_BATCH] == 0) & (su[:BP_BATCH] == 0)
        other = int((kb[:BP_BATCH][both_conv]
                     != sb[:BP_BATCH][both_conv]).any(dim=1).sum())
        right = (ku[:BP_BATCH] == 0) & (kb[:BP_BATCH] == msg).all(dim=1)
        print(f"  {name:8s} max|kernel-plain|={err:g}; converged "
              f"{int((ku[:BP_BATCH] == 0).sum())}/{BP_BATCH}, sent message "
              f"{int(right.sum())}; rows where both rules converge "
              f"{int(both_conv.sum())}, message differs from sum_product on "
              f"{other}; garbage min unsat {int(ku[BP_BATCH:].min())}")
        if err != 0.0:
            fail(f"{name}/{rule}: kernel and plain version differ")
        if other:
            fail(f"{name}/{rule}: a converged row differs from sum_product")
        if float(right.float().mean()) < 0.95:
            fail(f"{name}/{rule}: decodable rows did not decode")
        if name == "N512R12":
            x = llr.contiguous()
            k_ms = cuda_ms(lambda: ldpc_bp.bp_decode_kernel(g, x, 50, rule))
            p_ms = cuda_ms(lambda: ldpc_bp.bp_decode_reference(g, x, 50, rule),
                           reps=3, warmup=1)
            s_ms = cuda_ms(lambda: ldpc_bp.bp_decode_kernel(g, x, 50,
                                                            "sum_product"))
            bound = bp_bound(ldpc_bp, g, x, rule)
            print(f"  N512R12 {rule} B={BP_BATCH}: kernel {k_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms, sum_product kernel {s_ms:.4f} ms; "
                  f"bound {bound[0]:.5f} ms ({bound[1]}), {bound[2]:.3f} "
                  f"iterations a row")
            iters = bp_iter_times(ldpc_bp, g, x, rule)
            main = (g, x, msg)
    g, x, msg = main
    ldpc_bp.bp_decode_kernel.launches_edge = 0
    bits, unsat = bp_decode_pallas(g, x, 50, rule=rule)
    torch.cuda.synchronize()
    launches = ldpc_bp.bp_decode_kernel.launches_edge
    good = int(((unsat == 0) & (bits == msg).all(dim=1)).sum())
    print(f"  ops.bp_decode_pallas(rule={rule!r}), N512R12 B={BP_BATCH}: "
          f"{good} messages back, {launches} launch(es)")
    if launches <= 0 or good < 0.95 * BP_BATCH:
        fail("bp_decode_pallas did not run the sum_product_edge kernel")
    path_err, path = bp_path_times(ldpc_bp, batches, rule)
    return max(max_err, path_err), k_ms, p_ms, bound, launches, iters, path


def full_hier_payloads(P):
    """Largest whole-packet HP and LP payloads of one 68-symbol frame of the
    phase-13 link."""
    from orion_sdr_tpu_torch.modulate.dvb_t_frame import _coded_bits_for_stream
    params = P.DvbTHierFrameParams(P.DvbTHierLinkParams("1/8", "qam16", 2,
                                                        "1/2", "3/4"))
    out = []
    for inner in (params.inner_hp(), params.inner_lp()):
        n_pkt = 1
        while _coded_bits_for_stream(n_pkt + 1, inner) <= 68 * 1512 * 2:
            n_pkt += 1
        out.append(n_pkt * 187)
    return params.link, out


def hier_link(P, viterbi, dev, rng):
    """Phase 13: returns ((radix-2, radix-4) launches of the default run,
    the same of the run with FORCE_RADIX4 on, path_chunks' result)."""
    link, (n_hp, n_lp) = full_hier_payloads(P)
    frames = []
    for i in range(HIER_FRAMES):
        params = P.DvbTHierFrameParams(link, i % 4, (29 * i) & 0xFF)
        frames.append((params,
                       rng.integers(0, 256, n_hp).astype(np.uint8),
                       rng.integers(0, 256, n_lp).astype(np.uint8)))
    t0 = time.perf_counter()
    mods = [P.DvbTHierFrameMod(p, device=dev).modulate(hp, lp)
            for p, hp, lp in frames]
    torch.cuda.synchronize()
    t_mod = time.perf_counter() - t0
    n_sym = mods[0].n_symbols
    caps = [torch.as_tensor(np.concatenate([np.zeros(913, np.complex64),
                                            m.iq]), device=dev)
            for m in mods]
    n_samp = sum(int(c.shape[0]) for c in caps)
    print(f"  {HIER_FRAMES} frames, HP {n_hp} B + LP {n_lp} B, {n_sym} "
          f"symbols; modulate {HIER_FRAMES / t_mod:.4g} frames/s")
    demod = P.DvbTHierFrameDemod(frames[0][0], device=dev)
    counts = {}
    for forced in (False, True):
        viterbi.FORCE_RADIX4 = forced
        try:
            zero_vit(viterbi)
            demod.decode(caps[0], n_sym, n_hp, n_lp)      # warm-up
            torch.cuda.synchronize()
            secs = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = [demod.decode(c, n_sym, n_hp, n_lp) for c in caps]
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                good = sum(np.array_equal(o.hp_payload, hp)
                           and o.lp_payload is not None
                           and np.array_equal(o.lp_payload, lp)
                           and o.tps == p.tps_word()
                           for o, (p, hp, lp) in zip(out, frames))
                if good != HIER_FRAMES:
                    fail(f"hierarchical decode (radix 4 forced: {forced}): "
                         f"{HIER_FRAMES - good} frames lost")
            n2, n4 = read_vit(viterbi)
        finally:
            viterbi.FORCE_RADIX4 = False
        if (n4 if forced else n2) <= 0 or (n2 if forced else n4) != 0:
            fail(f"hierarchical decode (radix 4 forced: {forced}) ran "
                 f"{n2} radix-2 and {n4} radix-4 launches")
        counts[forced] = n2, n4
        dt = sorted(secs)[1]
        print(f"  FORCE_RADIX4={forced}: {HIER_FRAMES}/{HIER_FRAMES} HP+LP "
              f"payloads and TPS words in each of 3 runs, {n2} radix-2 and "
              f"{n4} radix-4 launches (warm-up included); runs "
              f"{', '.join(f'{x:.4f}' for x in secs)} s; median "
              f"{HIER_FRAMES / dt:.4g} frames/s, {n_samp / dt / 1e6:.4g} Msps")
    # both kernels against their plain versions on the chunk tensors this
    # path gives them: one frame's HP and LP decodes, recorded as chunked
    return (counts[False], counts[True],
            path_chunks(viterbi, demod, caps[0], n_sym, n_hp, n_lp))


def path_chunks(viterbi, demod, cap, n_sym, n_hp, n_lp):
    """Decodes ``cap`` once with conv.chunk_llrs recorded, then holds both
    radices against their plain versions (exact) on each recorded chunk
    batch and times each radix there with CUDA events, and the host's time
    a call (wrapper and launch, host clock over 20 calls that do not wait
    for the card). Returns ({radix: largest |kernel − plain| bit}, {(plane,
    radix): ms}, {plane: lanes})."""
    from orion_sdr_tpu_torch.fec import conv
    seen = []
    real = conv.chunk_llrs
    conv.chunk_llrs = lambda *a: seen.append(real(*a)) or seen[-1]
    try:
        demod.decode(cap, n_sym, n_hp, n_lp)
    finally:
        conv.chunk_llrs = real
    if len(seen) != 2:
        fail(f"hierarchical decode made {len(seen)} chunked decodes, not 2")
    errs, times, lanes = {2: 0.0, 4: 0.0}, {}, {}
    for plane, (c0, c1, pm0, _) in zip(("HP", "LP"), seen):
        lanes[plane] = c0.shape[0]
        for radix in (2, 4):
            got = viterbi.viterbi_chunks_kernel(c0, c1, pm0, "dvb_k7",
                                                radix=radix)
            want = viterbi.viterbi_chunks_reference(c0, c1, pm0, "dvb_k7",
                                                    radix=radix)
            torch.cuda.synchronize()
            err = float((got.int() - want.int()).abs().max())
            errs[radix] = max(errs[radix], err)
            def run():
                return viterbi.viterbi_chunks_kernel(c0, c1, pm0, "dvb_k7",
                                                     radix=radix)
            times[plane, radix] = cuda_ms(run, reps=20)
            t0 = time.perf_counter()
            for _ in range(20):
                run()
            host_ms = (time.perf_counter() - t0) / 20 * 1e3
            torch.cuda.synchronize()
            print(f"  {plane} chunks of one frame: {c0.shape[0]} lanes x "
                  f"{c0.shape[1]} steps, radix {radix} max|kernel-plain|="
                  f"{err:g}, kernel {times[plane, radix]:.4f} ms, host "
                  f"{host_ms:.4f} ms a call")
            if err != 0.0:
                fail(f"radix-{radix} Viterbi on the {plane} chunks: kernel "
                     f"and plain version differ")
    return errs, times, lanes


def add_noise(iq, snr_db, rng):
    sig = float(np.mean(np.abs(iq) ** 2))
    return iq + ((rng.standard_normal(iq.shape)
                  + 1j * rng.standard_normal(iq.shape))
                 * np.sqrt(sig / 10 ** (snr_db / 10) / 2)).astype(np.complex64)


def super_frame(P, dev, rng):
    """Phase 14."""
    sp = P.DvbTSuperFrameParams(P.DvbTLinkParams("1/8", "qpsk", "1/2"),
                                cell_id=0xBEEF)
    n_bytes = 4 * dvb_t_full_payload(P, sp.frame(0))
    payload = rng.integers(0, 256, n_bytes).astype(np.uint8)
    sf = P.DvbTSuperFrameMod(sp, device=dev).modulate(payload)
    cap = torch.as_tensor(add_noise(sf.iq, 12.0, rng), device=dev)
    demod = P.DvbTSuperFrameDemod(sp, device=dev)
    for how in ("decode", "decode_batch"):
        t0 = time.perf_counter()
        rx = getattr(demod, how)(cap, sf.symbols_per_frame,
                                 sf.frame_payload_lens)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ok = np.array_equal(rx.payload, payload) and rx.cell_id == 0xBEEF
        print(f"  {how}: {len(payload)} payload bytes and cell id "
              f"{rx.cell_id:#06x} back: {ok} ({dt:.4f} s, first run)")
        if not ok:
            fail(f"super-frame {how} lost its payload or cell id")


def streams(P, dev, rng):
    """Phase 15."""
    params = P.DvbTFrameParams(P.DvbTLinkParams("1/8", "qpsk", "1/2"), 0, 5)
    n_bytes = dvb_t_full_payload(P, params)
    mod = P.DvbTFrameMod(params, device=dev)
    payloads, parts = [], []
    for _ in range(STREAM_FRAMES):
        payloads.append(rng.integers(0, 256, n_bytes).astype(np.uint8))
        # gaps shorter than one symbol period (2304 samples): see phase 15
        parts.append(np.zeros(int(rng.integers(0, 2000)), np.complex64))
        parts.append(mod.modulate(payloads[-1]).iq)
    parts.append(np.zeros(5000, np.complex64))
    buf = add_noise(np.concatenate(parts), 10.0, rng)
    rx = P.DvbTFrameStreamDemod(params, 68, n_bytes, device=dev)
    t0 = time.perf_counter()
    res = []
    for i in range(0, len(buf), STREAM_CHUNK):
        res += rx.feed(buf[i:i + STREAM_CHUNK])
    res += rx.flush()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = [r.payload for r in res if isinstance(r, P.DvbTRxFrame)]
    ok = len(got) == STREAM_FRAMES and all(
        np.array_equal(a, b) for a, b in zip(got, payloads))
    print(f"  DvbTFrameStreamDemod: {len(got)}/{STREAM_FRAMES} frames in "
          f"order={ok}, {len(res) - len(got)} errors on the way; {len(buf)} "
          f"samples in {dt:.4f} s")
    if not ok:
        fail("the DVB-T stream demod lost or reordered frames")
    link, (n_hp, n_lp) = full_hier_payloads(P)
    hparams = P.DvbTHierFrameParams(link)
    hmod = P.DvbTHierFrameMod(hparams, device=dev)
    sent = [(rng.integers(0, 256, n_hp).astype(np.uint8),
             rng.integers(0, 256, n_lp).astype(np.uint8)) for _ in range(2)]
    hbuf = np.concatenate([np.zeros(500, np.complex64)]
                          + [hmod.modulate(hp, lp).iq for hp, lp in sent]
                          + [np.zeros(300, np.complex64)])
    hrx = P.DvbTHierFrameStreamDemod(hparams, 68, n_hp, n_lp, device=dev)
    res = []
    for i in range(0, len(hbuf), STREAM_CHUNK):
        res += hrx.feed(hbuf[i:i + STREAM_CHUNK])
    res += hrx.flush()
    got = [r for r in res if isinstance(r, P.DvbTHierRxFrame)]
    ok = len(got) == 2 and all(
        np.array_equal(r.hp_payload, hp) and r.lp_payload is not None
        and np.array_equal(r.lp_payload, lp) for r, (hp, lp) in zip(got, sent))
    print(f"  DvbTHierFrameStreamDemod: {len(got)}/2 frames in order={ok}")
    if not ok:
        fail("the hierarchical stream demod lost or reordered frames")


def blind(P, dev, rng):
    """Phase 16."""
    payload = rng.integers(0, 256, 500).astype(np.uint8)
    params = P.DvbTFrameParams(P.DvbTLinkParams("1/8", "qpsk", "2/3"), 1, 7)
    frame = P.DvbTFrameMod(params, device=dev).modulate(payload)
    out = P.dvb_t_blind_decode(np.concatenate([np.zeros(1234, np.complex64),
                                               frame.iq]), device=dev)
    ok = (out.guard == "1/8" and out.tps == params.tps_word()
          and np.array_equal(out.payload[:500], payload)
          and out.lp_payload is None)
    print(f"  plain frame: guard {out.guard}, {out.tps}, payload back: {ok}")
    if not ok:
        fail("blind decode of a plain frame")
    hparams = P.DvbTHierFrameParams(P.DvbTHierLinkParams("1/16", "qam16", 2,
                                                         "1/2", "3/4"))
    hp = rng.integers(0, 256, 300).astype(np.uint8)
    lp = rng.integers(0, 256, 900).astype(np.uint8)
    frame = P.DvbTHierFrameMod(hparams, device=dev).modulate(hp, lp)
    out = P.dvb_t_blind_decode(frame.iq, device=dev)
    ok = (out.guard == "1/16" and out.tps == hparams.tps_word()
          and np.array_equal(out.payload[:300], hp)
          and out.lp_payload is not None
          and np.array_equal(out.lp_payload[:900], lp))
    print(f"  hierarchical frame: guard {out.guard}, {out.tps}, HP and LP "
          f"back: {ok}")
    if not ok:
        fail("blind decode of a hierarchical frame")


# ── the BCH/RS outer code ────────────────────────────────────────────────────

OUTER = None          # OuterSpy, installed by main() before any decode path


class OuterSpy:
    """Wraps frame.chain.outer_decode_batch: per run of a decode path it
    notes each outer decode's kind, block count and whether that count makes
    it due on the card (chain._outer_device_ok, the function the chain asks),
    and while ``record`` is set it keeps the blocks each decode gets, formed
    as the device path forms them. Shape arithmetic only when not recording,
    so timed runs pay no extra copy."""

    def __init__(self, chain, outer_fec, bch_device):
        self.chain, self.outer_fec, self.bd = chain, outer_fec, bch_device
        self.calls, self.recorded, self.record = [], [], False
        self.held, self.hold = [], True
        self.real = real = chain.outer_decode_batch

        def spy(outer, coded_bits, device=None):
            self._see(outer, coded_bits, device)
            return real(outer, coded_bits, device)
        chain.outer_decode_batch = spy
        for name in ("bch_decode_kernel", "rs_decode_kernel"):
            self._keep_launches(name)

    def _keep_launches(self, name):
        """Replaces the kernel wrapper ``outer_fec.<name>`` in its module
        (the chain's coders read it there at each call) by a pass-through
        that, while ``hold`` is set, keeps each card launch's (kind,
        arguments, input, output) in ``held``, for holding to the plain
        version and the native host decoder. The wrapper counts its
        launches through that name, so the counts live on the pass-through
        from here on."""
        real = getattr(self.outer_fec, name)
        kind = name.split("_")[0]

        def keep(*args):
            out = real(*args)
            x = args[-1]
            if self.hold and x.is_cuda and x.shape[0]:
                self.held.append((kind, args[:-1], x, out))
            return out
        keep.launches = real.launches
        setattr(self.outer_fec, name, keep)

    def take_held(self):
        held, self.held = self.held, []
        return held

    def _see(self, outer, bits, device):
        if outer.kind == "none":
            return
        dev = self.chain._outer_device(bits, device)
        nb, nbits = bits.shape
        if outer.kind == "bch":
            code = self.chain.shortened_bch_for(outer.t)
            n_blk, t = nb * (nbits // code.n), outer.t
            args = (code.n, code.k, code.t)
        else:
            n_blk = nb * ((-(-nbits // 8)) // outer.n)
            t, args = outer.n_parity // 2, (outer.n, outer.n_parity)
        self.calls.append((outer.kind, n_blk,
                           self.chain._outer_device_ok(t, n_blk, dev)))
        if self.record and n_blk:
            self.recorded.append((outer.kind, args,
                                  self._blocks(outer.kind, args, bits, dev)))

    def _blocks(self, kind, args, bits, dev):
        x = torch.as_tensor(bits, device=dev).to(torch.uint8)
        n = args[0]
        if kind == "bch":
            return x[:, : (x.shape[1] // n) * n].reshape(-1, n).contiguous()
        n_full = (-(-x.shape[1] // 8)) // n
        need = n_full * n * 8
        x = torch.nn.functional.pad(x[:, :need], (0, max(need - x.shape[1],
                                                          0)))
        return self.bd.bytes_from_bits(x).reshape(-1, n).contiguous()

    def zero(self):
        self.calls = []
        self.outer_fec.bch_decode_kernel.launches = 0
        self.outer_fec.rs_decode_kernel.launches = 0

    def read(self, phase: str) -> dict:
        """{bch, rs: kernel launches, due: decodes at or over the
        threshold, decodes, max_blocks} since zero(); fails the run when the
        launches differ from the decodes that were due."""
        bch = self.outer_fec.bch_decode_kernel.launches
        rs = self.outer_fec.rs_decode_kernel.launches
        due = sum(c[2] for c in self.calls)
        out = {"bch": bch, "rs": rs, "due": due, "decodes": len(self.calls),
               "max_blocks": max((c[1] for c in self.calls), default=0)}
        if bch + rs != due:
            fail(f"[{phase}] {due} outer decodes reached the block threshold "
                 f"({self.chain._DEVICE_OUTER_MIN_BLOCKS}) but the outer "
                 f"kernel launched {bch + rs} times")
        return out


def outer_words(kind, code, B, errors, rng):
    """B codewords of ``code`` with ``errors(i)`` bit (BCH) or byte (RS)
    errors in row i → (numpy words, messages)."""
    if kind == "bch":
        msgs = rng.integers(0, 2, (B, code.k)).astype(np.uint8)
    else:
        msgs = rng.integers(0, 256, (B, code.k)).astype(np.uint8)
    words = code.encode(msgs)
    for i in range(B):
        ne = errors(i)
        if ne:
            pos = rng.choice(code.n, ne, replace=False)
            words[i, pos] ^= (1 if kind == "bch" else rng.integers(
                1, 256, ne).astype(np.uint8))
    return words, msgs


def outer_args(kind, code):
    return (code.n, code.k, code.t) if kind == "bch" else (code.n,
                                                          code.n_parity)


def outer_run(outer_fec, kind, args, x):
    fn = outer_fec.bch_decode_kernel if kind == "bch" else \
        outer_fec.rs_decode_kernel
    return fn(*args, x)


def outer_plain(bd, kind, args, x):
    fn = bd.bch_decode_batch_reference if kind == "bch" else \
        bd.rs_decode_batch_reference
    return fn(*args, x)


def outer_host_code(P, kind, args):
    from orion_sdr_tpu_torch.fec.galois import Bch, ReedSolomon
    return Bch(args[2], args[0]) if kind == "bch" else ReedSolomon(*args)


def outer_compare(P, bd, kind, args, x, kb, kok):
    """A kernel result (kb, kok) on the (B, n) uint8 CUDA tensor ``x``
    against the plain version and the native host decoder: (max |kernel −
    plain| over messages and flags, equal to the host decoder)."""
    rb, rok = outer_plain(bd, kind, args, x)
    torch.cuda.synchronize()
    err = max(float((kb.int() - rb.int()).abs().max()) if kb.numel() else 0.0,
              float((kok - rok).abs().max()) if kok.numel() else 0.0)
    hb, hok = outer_host_code(P, kind, args).decode_batch(x.cpu().numpy())
    host_same = (np.array_equal(kb.cpu().numpy(), hb) and np.array_equal(
        kok.cpu().numpy().astype(bool), hok.astype(bool)))
    return err, host_same


def outer_held(P, bd, held, label):
    """Every path launch ``OuterSpy`` kept (``held``) against the plain
    version and the native host decoder on its own input, exact: → (max
    |kernel − plain|, {kind: launches held})."""
    err, n = 0.0, {"bch": 0, "rs": 0}
    for kind, args, x, (kb, kok) in held:
        e, host_same = outer_compare(P, bd, kind, args, x, kb, kok)
        if e != 0.0 or not host_same:
            fail(f"{label}: a {kind} launch of {x.shape[0]} codewords "
                 f"differs from its plain version or the host decoder")
        err = max(err, e)
        n[kind] += 1
    print(f"  {label}: every outer-kernel launch of the paths (BCH "
          f"{n['bch']}, RS {n['rs']}) equal to its plain version and to the "
          f"native host decoder on its own input")
    return err, n


def outer_exact(P, outer_fec, bd, label, kind, args, x):
    """Kernel vs plain version vs native host decoder on the (B, n) uint8
    CUDA tensor ``x``: messages and ok flags equal on every row. Returns
    (max |kernel − plain| over messages and flags, rows ok)."""
    kb, kok = outer_run(outer_fec, kind, args, x)
    err, host_same = outer_compare(P, bd, kind, args, x, kb, kok)
    n_ok = int(kok.sum())
    print(f"  {label}: {x.shape[0]} x {x.shape[1]}, max|kernel-plain|={err:g}, "
          f"equal to the host decoder: {host_same}; {n_ok} rows ok, "
          f"{x.shape[0] - n_ok} failed (systematic prefix)")
    if err != 0.0 or not host_same:
        fail(f"outer code {label}: kernel, plain version and host decoder "
             f"differ")
    return err, n_ok


def outer_bound(bd, kind, args, x):
    """Bound of one outer decode of ``x``: (ms, what sets it, rows with a
    nonzero syndrome). Bytes: each codeword byte read once, each message
    byte and flag written once, the 768-byte GF tables. Operations (GF
    table steps, counted at the H100's 67 TFLOP/s f32 rate outside the
    tensor cores, its only published scalar peak): the syndromes of every row (BCH one
    64-bit word a position, RS 2t terms a byte), and for the rows that are
    not codewords 2t·cap·2 Berlekamp–Massey products, n·cap Chien terms and
    for RS cap·(2t + cap) Forney terms. Codeword rows are found by
    re-encoding each row's prefix."""
    B, n = x.shape
    if kind == "bch":
        _, k, t = args
        enc = bd.bch_encode_batch_device(n, k, t, x[:, :k])
        syn = n
    else:
        k, t = n - args[1], args[1] // 2
        enc = bd.rs_encode_batch_device(n, args[1], x[:, :k])
        syn = n * 2 * t
    bad = int((enc != x).any(dim=1).sum())
    cap = t + 2
    per_bad = 2 * t * cap * 2 + n * cap + (cap * (2 * t + cap)
                                           if kind == "rs" else 0)
    return bound_ms(B * n + B * k + 4 * B + 768, B * syn + bad * per_bad) + (
        bad,)


def outer_path_ms(chain, outer, coded, reps: int):
    """Host-clock ms of the chain's own outer decode of ``coded`` (the form
    the chain hands it: a CUDA bit tensor for BCH, numpy bits after the
    Forney deinterleave for RS), the copies included, with the block
    threshold forced to send it to the native host decoder and to the card,
    the two runs alternating so that drift of the host's clock rate falls on
    both: (host median, card median) of ``reps`` runs each after a
    warm-up."""
    saved = chain._DEVICE_OUTER_MIN_BLOCKS
    times = {False: [], True: []}
    try:
        for rep in range(reps + 1):
            for card in (False, True):
                chain._DEVICE_OUTER_MIN_BLOCKS = 0 if card else 1 << 62
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                OUTER.real(outer, coded)
                torch.cuda.synchronize()
                if rep:
                    times[card].append((time.perf_counter() - t0) * 1e3)
    finally:
        chain._DEVICE_OUTER_MIN_BLOCKS = saved
    return float(np.median(times[False])), float(np.median(times[True]))


def outer_sweep(chain, bd, kind, outer, x):
    """The chain's outer decode on each path at SWEEP_BLOCKS rows of ``x``
    (as many as it has): ([(blocks, host ms, card ms)], the smallest swept
    count from which the card path is faster at every larger count, or
    None)."""
    coded = x if kind == "bch" else bd.bits_from_bytes(x).cpu().numpy()
    sweep = []
    for nb in SWEEP_BLOCKS + (x.shape[0],):
        if nb > x.shape[0] or (sweep and nb <= sweep[-1][0]):
            continue
        sweep.append((nb,) + outer_path_ms(chain, outer, coded[:nb], 15))
    cross = None
    for nb, h, d in reversed(sweep):
        if d >= h:
            break
        cross = nb
    return sweep, cross


def outer_phase_exact(P, outer_fec, bd, dev, rng):
    """Phase 17: returns (max error, {kind: (code, args, CUDA words)} of the
    two main batches)."""
    from orion_sdr_tpu_torch.frame import chain
    err = 0.0
    main = {}
    cases = [("bch", chain.shortened_bch_for(8), BCH_ROWS, 12),
             ("rs", chain.rs_for(204, 16), RS_ROWS, 12),
             ("bch", chain.shortened_bch_for(1), 200, 5),
             ("bch", chain.shortened_bch_for(4), 200, 8),
             ("rs", chain.rs_for(255, 16), 200, 12),
             ("rs", chain.rs_for(60, 4), 200, 6)]
    for kind, code, B, spread in cases:
        words, _ = outer_words(kind, code, B, lambda i: i % spread, rng)
        x = torch.as_tensor(words, device=dev)
        args = outer_args(kind, code)
        label = (f"{kind.upper()}({code.n},{code.k}) t={args[2] if kind == 'bch' else args[1] // 2}, "
                 f"0..{spread - 1} errors a row")
        e, _ = outer_exact(P, outer_fec, bd, label, kind, args, x)
        err = max(err, e)
        if B in (BCH_ROWS, RS_ROWS) and kind not in main:
            main[kind] = (code, args, x)
    for i, (kind, args, x) in enumerate(OUTER.recorded):
        e, _ = outer_exact(P, outer_fec, bd, f"recorded {kind} batch {i} of "
                           f"[4]/[8]", kind, args, x)
        err = max(err, e)
    return err, main


def outer_shapes(kind, x):
    """{name: (B, n) CUDA words} the kernel is timed at: the bench batch
    ``x``, the path's recorded blocks and, for RS, one DVB-T frame's 51
    codewords and 83 (the size of [13]'s largest decode), both cut from the
    path's blocks."""
    shapes = {"bench": x}
    rec = [r[2] for r in OUTER.recorded if r[0] == kind]
    if rec:
        xr = torch.cat(rec)
        shapes["path"] = xr
        if kind == "rs":
            for b in OUTER_FRAME_ROWS:
                shapes[f"path_{b}"] = xr[:b].contiguous()
    return shapes


def ptxas_report(built, tag):
    """{registers, stack, spill_stores, spill_loads} of the kernel whose
    mangled name holds ``tag``, from the build's -Xptxas -v report."""
    lines = built.log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and tag in line:
            rep = {}
            for nxt in lines[i + 1:i + 5]:
                if "bytes stack frame" in nxt:
                    w = nxt.split()
                    rep.update(stack=int(w[0]), spill_stores=int(w[4]),
                               spill_loads=int(w[8]))
                elif "Used " in nxt and " registers" in nxt:
                    rep["registers"] = int(
                        nxt.split("Used ")[1].split(" registers")[0])
            return rep
    return None


def outer_ptxas(built):
    """{kind: {lanes: ptxas report}} of the t = 8 kernels."""
    out = {}
    for kind in ("bch", "rs"):
        out[kind] = {G: ptxas_report(built, f"{kind}_decode_kernelILi8ELi{G}E")
                     for G in OUTER_SWEEP_LANES}
        print(f"  {kind}_decode_kernel<8, G> (ptxas): " + "; ".join(
            f"G={G}: {r}" for G, r in out[kind].items()))
    return out


def outer_sweep_plans(P, outer_fec, bd, kind, args, shapes):
    """The kernel at every lanes × BLOCKS_PER_SM of the sweep on each shape,
    each run held to the plain version (exact): → {"GxBPS": {shape: ms}}."""
    want = {name: outer_plain(bd, kind, args, xs)
            for name, xs in shapes.items()}
    sweep = {}
    lanes, bps = dict(outer_fec.LANES), outer_fec.BLOCKS_PER_SM
    try:
        for G in OUTER_SWEEP_LANES:
            for b in OUTER_SWEEP_BPS:
                outer_fec.LANES[kind], outer_fec.BLOCKS_PER_SM = G, b
                row = sweep[f"{G}x{b}"] = {}
                for name, xs in shapes.items():
                    got = outer_run(outer_fec, kind, args, xs)
                    if not (torch.equal(got[0], want[name][0])
                            and torch.equal(got[1], want[name][1])):
                        fail(f"[18] {kind} at {G} lanes, {b} blocks an SM, "
                             f"{name}: the kernel differs from its plain "
                             f"version")
                    row[name] = cuda_ms(
                        lambda: outer_run(outer_fec, kind, args, xs), reps=20)
    finally:
        outer_fec.LANES.update(lanes)
        outer_fec.BLOCKS_PER_SM = bps
    names = list(shapes)
    print(f"  {kind.upper()} sweep, kernel ms at lanes x blocks an SM "
          f"({', '.join(f'{n} {shapes[n].shape[0]}' for n in names)}; "
          f"default {lanes[kind]}x{bps}, each run exact): " + "; ".join(
              f"{k}: " + " / ".join(f"{v[n]:.4f}" for n in names)
              for k, v in sweep.items()))
    return sweep


def outer_phase_times(P, outer_fec, bd, main, dev):
    """Phase 18: kernel times at the bench batch, the path's blocks and
    (RS) one frame's and [13]'s counts, each with its bound and launch
    plan; the plain version's time at the bench batch; the lanes and
    blocks-an-SM sweep; the chain's two outer paths swept over the block
    count. Returns {kind: dict of numbers}."""
    from orion_sdr_tpu_torch.frame import chain
    out = {}
    for kind, (code, args, x) in main.items():
        outer = (P.OuterFec.bch(args[2]) if kind == "bch"
                 else P.OuterFec.reed_solomon(*args))
        shapes = outer_shapes(kind, x)
        at = {}
        for name, xs in shapes.items():
            ms = cuda_ms(lambda: outer_run(outer_fec, kind, args, xs),
                         reps=20)
            bnd = outer_bound(bd, kind, args, xs)
            plan = outer_fec.launch_plan(kind, xs.shape[0], dev)
            at[name] = {"rows": xs.shape[0], "not_codewords": bnd[2],
                        "ms": ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                        "plan": plan}
            print(f"  {kind.upper()}({code.n},{code.k}) kernel at {name} "
                  f"({xs.shape[0]} codewords, {bnd[2]} not codewords): "
                  f"{ms:.4f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}), "
                  f"{bnd[0] / ms:.1%} of it; plan {plan['lanes']} lanes a "
                  f"codeword, {plan['groups_per_block']} codewords a block, "
                  f"grid {plan['grid']} on {plan['sms']} SMs")
        p_ms = cuda_ms(lambda: outer_plain(bd, kind, args, x), reps=3,
                       warmup=1)
        lane_sweep = outer_sweep_plans(P, outer_fec, bd, kind, args, shapes)
        # the chain's inputs: a CUDA bit tensor for BCH (no outer
        # interleaver), numpy bits after the Forney deinterleave for RS;
        # swept on these error-laden rows and on the path's own blocks
        sweeps = {"errors": outer_sweep(chain, bd, kind, outer, x)}
        if "path" in shapes:
            sweeps["path"] = outer_sweep(chain, bd, kind, outer,
                                         shapes["path"])
        host_ms, dev_ms = sweeps["errors"][0][-1][1:]
        print(f"  {kind.upper()} at {x.shape[0]} codewords: plain "
              f"{p_ms:.4f} ms; chain's outer decode, host clock: native "
              f"host path {host_ms:.4f} ms, card path {dev_ms:.4f} ms")
        for name, (sweep, cross) in sweeps.items():
            print(f"  {kind.upper()} sweep on the {name} rows, the chain's "
                  f"outer decode ms (blocks: host path / card path): "
                  + "; ".join(f"{nb}: {h:.4f} / {d:.4f}"
                              for nb, h, d in sweep))
            print(f"  {kind.upper()} crossover on the {name} rows: the card "
                  f"path is faster from {cross} blocks on (threshold in "
                  f"frame/chain.py: {chain._DEVICE_OUTER_MIN_BLOCKS})")
        bench = at["bench"]
        out[kind] = {"ms": bench["ms"], "plain_ms": p_ms,
                     "bound": (bench["bound_ms"], bench["bound_by"],
                               bench["not_codewords"]),
                     "host_ms": host_ms, "card_path_ms": dev_ms,
                     "ms_at_path": at["path"]["ms"] if "path" in at else None,
                     "sweeps": sweeps, "rows": x.shape[0], "at": at,
                     "lane_sweep": lane_sweep, "plan": bench["plan"]}
    return out


def cofdm_link(P, dev, rng, label, cfg, pre, table, n_frames, mcs_of,
               n_bytes, noise, channel=None):
    """Modulates n_frames frames on the card, passes each body through
    ``channel`` and AWGN at ``noise`` × its power, decodes the batch with
    OfdmFrameDemod.decode_batch on the card; every payload and header must
    come back. Returns the first run's seconds."""
    mod = P.OfdmFrameMod(cfg, table, pre, device=dev)
    frames = [(P.FrameMetadata(7000 + i, mcs_of(i), i % 256),
               rng.integers(0, 256, n_bytes).astype(np.uint8))
              for i in range(n_frames)]
    bodies = [mod.modulate_frame(P.FramePacket(m, d), 900 + i)
              [pre.total_len():] for i, (m, d) in enumerate(frames)]
    batch = np.zeros((n_frames, max(len(b) for b in bodies)), np.complex64)
    for i, b in enumerate(bodies):
        if channel is not None:
            b = channel(b, i)
        sig = float(np.mean(np.abs(b) ** 2))
        batch[i, :len(b)] = b
        batch[i] += ((rng.standard_normal(batch.shape[1])
                      + 1j * rng.standard_normal(batch.shape[1]))
                     * np.sqrt(sig * noise / 2)).astype(np.complex64)
    t0 = time.perf_counter()
    out = P.OfdmFrameDemod(cfg, table, device=dev).decode_batch(
        torch.as_tensor(batch, device=dev))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    good = sum(isinstance(o, P.FramePacket) and np.array_equal(o.payload, d)
               and o.metadata == m for o, (m, d) in zip(out, frames))
    print(f"  {label}: {good}/{n_frames} frames of {n_bytes} B back "
          f"({dt:.4f} s, first run)")
    if good != n_frames:
        fail(f"{label}: {n_frames - good} frames lost")
    return dt


def fir_sweep(dev, rng):
    """The TX lowpass's two filter paths (dsp/fir.py: conv1d, FFT
    overlap-save) on the card at FIR_TAPS, over one DVB-T frame's stream
    (68 symbols of 2304 samples, real and imaginary rows), CUDA events:
    prints each path's ms and the tap count from which the FFT path is
    faster at every larger count (the crossover _FFT_MIN_TAPS is set
    from)."""
    from orion_sdr_tpu_torch.dsp import fir
    x = torch.as_tensor(rng.standard_normal((2, 68 * 2304)),
                        dtype=torch.float32, device=dev)
    rows = []
    for T in FIR_TAPS:
        taps = fir.kaiser_lowpass_taps(T, 0.43, 60.0)
        xp = torch.nn.functional.pad(x, (T - 1, T // 2))
        rows.append((T, cuda_ms(lambda: fir._conv_direct(xp, taps)),
                     cuda_ms(lambda: fir._fft_overlap_save(xp, taps))))
    cross = None
    for T, c, f in reversed(rows):
        if f >= c:
            break
        cross = T
    print(f"  FIR paths on a DVB-T frame's stream (2 x {68 * 2304}), ms "
          f"(taps: conv1d / FFT overlap-save): " + "; ".join(
              f"{T}: {c:.4f} / {f:.4f}" for T, c, f in rows)
          + f"; FFT faster from {cross} taps on (dsp/fir.py _FFT_MIN_TAPS = "
          f"{fir._FFT_MIN_TAPS})")


def new_links(P, dev, rng):
    """Phases 19-24, each a default path counted from 0: returns {phase:
    outer-kernel counts}."""
    from orion_sdr_tpu_torch.modulate.dvb_t_frame import tx_lowpass_for_2k
    from orion_sdr_tpu_torch.waveform import dvb_t as PD
    runs = {}
    cfg, pre, table = link(P)

    def run(phase, title, fn):
        print(f"[{phase}] {title}")
        OUTER.zero()
        fn()
        runs[phase] = OUTER.read(phase)

    run("19", f"COFDM batch with a TX lowpass (with_tx_lowpass_null_band(65, "
        f"60.0)): {LINK_FRAMES} frames, MCS 0-3",
        lambda: cofdm_link(P, dev, rng, "lowpass",
                           cfg.with_tx_lowpass_null_band(65, 60.0), pre,
                           table, LINK_FRAMES, lambda i: i % 4,
                           PAYLOAD_BYTES, 0.02))

    def dvb_t_lowpass():
        params = P.DvbTFrameParams(P.DvbTLinkParams("1/8", "qpsk", "1/2"))
        n_bytes = dvb_t_full_payload(P, params)
        mask = tx_lowpass_for_2k(89, 60.0)
        frames = [(P.DvbTFrameParams(params.link, i % 4, i),
                   rng.integers(0, 256, n_bytes).astype(np.uint8))
                  for i in range(DVB_LP_FRAMES)]
        iq = np.stack([add_noise(P.DvbTFrameMod(p, device=dev)
                                 .with_symbol_window(40).with_tx_lowpass(mask)
                                 .modulate(d).iq, 15.0, rng)
                       for p, d in frames])
        demod = P.DvbTFrameDemod(params, device=dev).with_rx_window_backoff(64)
        out = demod.decode_batch(torch.as_tensor(iq, device=dev), 68, n_bytes)
        good = sum(np.array_equal(o.payload, d) and o.tps == p.tps_word()
                   for o, (p, d) in zip(out, frames))
        print(f"  {good}/{DVB_LP_FRAMES} full QPSK r1/2 frames (taper 40, "
              f"89-tap mask, RX back-off 64, 15 dB): payload and TPS back")
        if good != DVB_LP_FRAMES:
            fail("DVB-T frames with the TX lowpass did not decode")

    run("20", "DVB-T with tx_lowpass_for_2k(89, 60.0)", dvb_t_lowpass)
    fir_sweep(dev, rng)

    plan = P.CarrierPlan(256, 64).with_pilot_carriers(PILOT_CARRIERS)
    pcfg = P.OfdmConfig(plan.with_contiguous_data(edge_guard=16), fs=1e6) \
        .with_equalizer_method("pilot_interp").with_phase_tracking("cpe")

    def echo_drift(x, i):
        y = x + 0.4 * np.concatenate([np.zeros(5, np.complex64), x[:-5]])
        return (y * np.exp(1j * 1e-4 * (i % 4 + 1) * np.arange(len(y)))
                ).astype(np.complex64)

    run("21", f"COFDM with pilot_interp + cpe through a 5-sample echo and a "
        f"phase drift: {LINK_FRAMES} frames, MCS 0-2",
        lambda: cofdm_link(P, dev, rng, "pilot_interp + cpe", pcfg, pre,
                           table, LINK_FRAMES, lambda i: i % 3,
                           PAYLOAD_BYTES, 0.005, echo_drift))
    run("22", f"COFDM with DFT precoding: {LINK_FRAMES} frames, MCS 0-3",
        lambda: cofdm_link(P, dev, rng, "DFT-s-OFDM",
                           cfg.with_transform_precoding(True), pre, table,
                           LINK_FRAMES, lambda i: i % 4, PAYLOAD_BYTES,
                           0.02))
    t256 = P.McsTable([P.Mcs("qam256", P.InnerFec.ldpc("N512R12"),
                             P.OuterFec.bch(8))])
    run("23", f"COFDM QAM-256 MCS (LDPC N512R12 + BCH t=8) at 35 dB: "
        f"{LINK_FRAMES} frames",
        lambda: cofdm_link(P, dev, rng, "qam256", cfg, pre, t256,
                           LINK_FRAMES, lambda i: 0, PAYLOAD_BYTES, 3e-4))
    dpre = P.OfdmPreamble(repeat_len=1024, num_repeats=2) \
        .with_training_symbol(2048, 256)
    run("24", f"COFDM link on dvb_t_config('1/8', 1e6) with dvb_t_mcs_table "
        f"(conv + RS(204,188) + Forney): {LINK_FRAMES} frames",
        lambda: cofdm_link(P, dev, rng, "dvb_t_config",
                           PD.dvb_t_config("1/8", 1e6), dpre,
                           PD.dvb_t_mcs_table(), LINK_FRAMES,
                           lambda i: i % 3, PAYLOAD_BYTES, 0.02))
    return runs


# ── FT8/FT4 (slice 3) ────────────────────────────────────────────────────────


def ft_noise_power(snr_db: float) -> float:
    """Noise power a sample at ``snr_db`` in 2500 Hz for a unit-power signal
    at 12 kHz (tests/test_ft8.py::snr_to_noise_power)."""
    return FT_FS / (2500.0 * 10.0 ** (snr_db / 10.0))


def ft_awgn(rng, n: int, power: float) -> np.ndarray:
    """tests/test_ft8.py::_awgn."""
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * np.sqrt(power / 2)).astype(np.complex64)


def ft_messages(P, n: int):
    """``n`` distinct standard messages: calls W<d><L><L><L>, half to CQ
    (what ft8_ap_prior("CQ") pins), the rest to a call, over grids and
    reports."""
    L = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    extras = ("FN42", "JN58", "IO91", "EN50", "-12", "R+03", "RR73", "73")
    return [P.Ft8Standard("CQ" if i % 2 == 0 else f"K{(i + 3) % 10}XYZ",
                          f"W{i % 10}{L[i // 10 % 26]}{L[i * 7 % 26]}"
                          f"{L[i * 11 % 26]}", extras[i % len(extras)])
            for i in range(n)]


def ft_windows(P, mode: str, dev, rng):
    """[25]'s capture: FT_WINDOWS windows of FT_WIN[mode] samples on the card;
    FT_SIGNALS of them (at places drawn from ``rng``) hold one frame at
    sample 0 with its own message on a carrier drawn from 300-2900 Hz on the
    mode's tone grid, the rest noise only; AWGN at FT_SNR[mode] in 2500 Hz
    over every window. → (windows, expected message or None each, carrier
    each)."""
    from orion_sdr_tpu_torch.modulate import ft8 as M
    ft8 = mode == "ft8"
    spacing = M.FT8_TONE_SPACING_HZ if ft8 else M.FT4_TONE_SPACING_HZ
    encode, mod = (P.ft8_encode, P.ft8_mod) if ft8 else (P.ft4_encode,
                                                         P.ft4_mod)
    ht = P.CallsignHashTable()
    msgs = ft_messages(P, FT_SIGNALS)
    j = rng.integers(int(np.ceil(100.0 / spacing)),
                     int((2900.0 - FT_BASE) / spacing) + 1, FT_SIGNALS)
    where = np.sort(rng.choice(FT_WINDOWS, FT_SIGNALS, replace=False))
    x = torch.zeros((FT_WINDOWS, FT_WIN[mode]), dtype=torch.complex64,
                    device=dev)
    expect, carriers = [None] * FT_WINDOWS, [None] * FT_WINDOWS
    for w, msg, jj in zip(where, msgs, j):
        carrier = FT_BASE + int(jj) * spacing
        frame = mod(encode(P.pack77(msg, ht), device=dev), FT_FS, carrier,
                    device=dev)
        x[w, :frame.shape[0]] = frame
        expect[w], carriers[w] = msg, carrier
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    x += torch.randn(x.shape, dtype=torch.complex64, device=dev,
                     generator=gen) * float(np.sqrt(ft_noise_power(
                         FT_SNR[mode])))
    return x, expect, carriers


def ft_check(out, expect, carriers, label):
    bad = [w for w, (o, e, c) in enumerate(zip(out, expect, carriers))
           if (o is None) != (e is None)
           or (o is not None and (o.message != e
                                  or abs(o.carrier_hz - c) > 1e-6))]
    if bad:
        fail(f"{label}: windows {bad[:8]} did not come back as sent "
             f"({len(bad)} of {len(out)})")


def busy_share(fn):
    """One run of ``fn`` under torch.profiler: (host ms around the run,
    ending in torch.cuda.synchronize(); the card's busy ms, the union of
    its kernel and copy intervals, or None where the profiler recorded no
    device activity; [(kernel name, ms)] by device time, largest first)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end, by_name = 0.0, -np.inf, {}
    for (s, e) in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return wall, (busy / 1e3 if spans else None), top


def ft_layers(P, ldpc_bp, mode, x, batch):
    """The receive's layers at [25]'s batch, each on the card with CUDA
    events (the host's unpack77 on the host clock): {layer: ms}."""
    from orion_sdr_tpu_torch.codec.ft8_crc import ft8_check_crc_batch
    from orion_sdr_tpu_torch.dsp.device import sanitize_iq
    from orion_sdr_tpu_torch.message import unpack77
    from orion_sdr_tpu_torch.sync import ft8_sync as S
    from orion_sdr_tpu_torch.sync.costas import (candidate_score_grid,
                                                 top_k_stable)
    from orion_sdr_tpu_torch.sync.waterfall import compute_waterfall
    m = S._MODE[mode]
    costas, sync_pos, data_pos, gray = S._mode_tables(mode)
    nb = S._num_bins(FT_BASE, FT_MAX + m["spacing"], m)
    k = FT_MAX_CAND
    out = {"sanitize_iq": cuda_ms(lambda: sanitize_iq(x), reps=5)}
    out["waterfall GEMM"] = cuda_ms(lambda: compute_waterfall(
        x, FT_FS, FT_BASE, m["spacing"], m["sps"], m["total_syms"], nb),
        reps=5)
    wf = compute_waterfall(x, FT_FS, FT_BASE, m["spacing"], m["sps"],
                           m["total_syms"], nb)

    def grid():
        sc = candidate_score_grid(wf, costas, sync_pos, m["n_tones"], 0, 0)
        return top_k_stable(sc.reshape(sc.shape[0], -1), k)
    out["Costas grid + top-k"] = cuda_ms(grid, reps=5)
    _, idx = grid()
    f_count = nb - m["n_tones"] + 1
    win = torch.arange(x.shape[0], device=x.device).repeat_interleave(k)
    flat = idx.reshape(-1)
    out["LLR gather + normalise"] = cuda_ms(lambda: S._extract_llrs(
        wf, win, flat // f_count, flat % f_count, data_pos, gray,
        m["bits_per_sym"]), reps=5)
    g, llr, max_iter = batch
    bits, _ = ldpc_bp.bp_decode_kernel(g, llr, max_iter)
    out["BP kernel"] = cuda_ms(lambda: ldpc_bp.bp_decode_kernel(
        g, llr, max_iter), reps=10)
    out["batched CRC-14"] = cuda_ms(lambda: ft8_check_crc_batch(bits),
                                    reps=10)
    payloads = [P.pack77(msg, P.CallsignHashTable())
                for msg in ft_messages(P, FT_SIGNALS)]
    t0 = time.perf_counter()
    for p in payloads:
        unpack77(p, P.CallsignHashTable())
    out[f"host unpack77 x{FT_SIGNALS}"] = (time.perf_counter() - t0) * 1e3
    return out


def ft_receive(P, ldpc_bp, dev, rng, mode):
    """[25] for one mode: returns ({run: BP launches}, {label: (graph,
    LLRs, max_iter)} of the BP batches the path handed the wrapper (the
    plain run's and the AP run's), {"ms": median ms, ...})."""
    from orion_sdr_tpu_torch.codec import ft8_ldpc
    ft8 = mode == "ft8"
    x, expect, carriers = ft_windows(P, mode, dev, rng)
    decode = P.ft8_decode_windows if ft8 else P.ft4_decode_windows
    ap = P.ft8_ap_prior("CQ", ft4=not ft8)

    def run(prior=None):
        return decode(x, FT_FS, FT_BASE, FT_MAX, FT_MAX_CAND, ap=prior,
                      device=dev)
    t0 = time.perf_counter()
    out = []
    recorded = record_bp(lambda: out.append(run()), ft8_ldpc, "bp_decode")
    torch.cuda.synchronize()
    print(f"  {mode}: {FT_WINDOWS} windows x {FT_WIN[mode]} samples, "
          f"{FT_SIGNALS} frames at {FT_SNR[mode]} dB in 2500 Hz, band "
          f"{FT_BASE:g}-{FT_MAX:g} Hz, max_cand {FT_MAX_CAND}; warm-up "
          f"{time.perf_counter() - t0:.3f} s")
    ft_check(out[0], expect, carriers, f"[25] {mode} warm-up")
    launches = {}
    ldpc_bp.bp_decode_kernel.launches = 0
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        ft_check(got, expect, carriers, f"[25] {mode}")
    launches[f"25 {mode}"] = ldpc_bp.bp_decode_kernel.launches
    dt = sorted(secs)[1]
    n_samp = FT_WINDOWS * FT_WIN[mode]
    print(f"  {mode} decode_windows: {FT_SIGNALS}/{FT_SIGNALS} messages and "
          f"carriers back, {FT_WINDOWS - FT_SIGNALS} noise windows None, in "
          f"each of 3 runs ({launches[f'25 {mode}']} BP launches); runs "
          f"{', '.join(f'{v:.4f}' for v in secs)} s; median "
          f"{FT_WINDOWS / dt:.4g} windows/s, {n_samp / dt / 1e6:.4g} Msps")
    ldpc_bp.bp_decode_kernel.launches = 0
    got = []
    recorded += record_bp(lambda: got.append(run(ap)), ft8_ldpc, "bp_decode")
    torch.cuda.synchronize()
    launches[f"25 {mode} ap"] = ldpc_bp.bp_decode_kernel.launches
    ft_check(got[0], expect, carriers, f"[25] {mode} with ap")
    print(f"  {mode} with ft8_ap_prior('CQ'{', ft4=True' if not ft8 else ''}"
          f"): every message back, noise windows None "
          f"({launches[f'25 {mode} ap']} BP launch of "
          f"{recorded[-1][1].shape[0]} rows)")
    if min(launches.values()) <= 0:
        fail(f"[25] {mode}: the receive launched no BP kernel")
    wall, busy, top = busy_share(run)
    print(f"  {mode} one run under torch.profiler: {wall:.3f} ms host; card "
          + (f"busy {busy:.3f} ms ({busy / wall:.1%})" if busy is not None
             else "busy not measured (no device events)")
          + "; by device time: " + ", ".join(f"{n[:48]} {v:.3f}"
                                              for n, v in top[:6]))
    if len(recorded) != 2:
        fail(f"[25] {mode}: {len(recorded)} BP batches, not one a run")
    batches = {f"{mode}{' ap' if i else ''} {x_.shape[0]}x{g.n}": (g, x_, mi)
               for i, (g, x_, mi, _) in enumerate(recorded)}
    layers = ft_layers(P, ldpc_bp, mode, x, recorded[0][:3])
    print(f"  {mode} layers (ms): " + ", ".join(f"{k} {v:.4f}"
                                                for k, v in layers.items()))
    return launches, batches, {"ms": dt * 1e3,
                               "windows_per_s": FT_WINDOWS / dt,
                               "msps": n_samp / dt / 1e6, "busy_ms": busy,
                               "profiled_ms": wall, "layers_ms": layers}


def ft_bp_inputs(g, dev, rng, rows: int, flips: int):
    """``rows`` decodable FT8 codewords (±4 LLRs, ``flips`` flipped) →
    (messages, LLRs, LLRs with BP_GARBAGE random-normal rows appended)."""
    from orion_sdr_tpu_torch.codec.ft8_ldpc import ldpc_encode
    msg = torch.as_tensor(rng.integers(0, 2, (rows, g.k)), dtype=torch.uint8,
                          device=dev)
    llr = (1.0 - 2.0 * ldpc_encode(msg).to(torch.float32)) * 4.0
    pick = torch.as_tensor(np.stack([rng.choice(g.n, flips, replace=False)
                                     for _ in range(rows)]), device=dev)
    llr.scatter_(1, pick, -llr.gather(1, pick))
    junk = torch.as_tensor(rng.standard_normal((BP_GARBAGE, g.n)),
                           dtype=torch.float32, device=dev)
    return msg, llr.contiguous(), torch.cat([llr, junk]).contiguous()


def ft_bp_phase(ldpc_bp, built, dev, rng, recorded):
    """[26]: the BP kernel on ft8_174_91 at its exact width 7, held to its
    plain version (exact) on [25]'s batches and on FT_BP_ROWS + garbage
    rows, and timed. Returns (max |kernel − plain|, kernel ms, plain ms,
    bound, {label: (ms, bound)} at [25]'s batches, registers)."""
    from orion_sdr_tpu_torch.codec.ft8_ldpc import ft8_ldpc_graph
    g = ft8_ldpc_graph()
    regs = {r: ptxas_registers(built, code, g.max_deg)
            for r, code in ldpc_bp._RULE_CODE.items()}
    for B in (FT_BP_ROWS, FT_WINDOWS * FT_MAX_CAND):
        p = ldpc_bp.launch_plan(g, "sum_product", B)
        print(f"  {g.name} (n {g.n}, k {g.k}, m {g.m}, D {g.max_deg}) "
              f"sum_product B={B}: {p['threads']} threads a block, "
              f"{p['blocks_per_sm']} blocks an SM (occupancy query), "
              f"{p['smem']} B shared memory a block, {p['sms']} SMs: grid "
              f"{p['grid']}, {p['codewords_per_block']} codewords a block")
    print(f"  registers at width {g.max_deg} (ptxas): {regs}")
    if regs["sum_product"] is None:
        fail(f"no exact width-{g.max_deg} instantiation in the build report")
    err, at25 = bp_path_times(ldpc_bp, recorded, "sum_product", "[25]'s")
    msg, llr, both = ft_bp_inputs(g, dev, rng, FT_BP_ROWS, FT_BP_FLIPS)
    kb, ku = ldpc_bp.bp_decode_kernel(g, both, 20)
    rb, ru = ldpc_bp.bp_decode_reference(g, both, 20)
    torch.cuda.synchronize()
    e = max(float((kb.int() - rb.int()).abs().max()),
            float((ku - ru).abs().max()))
    right = (ku[:FT_BP_ROWS] == 0) & (kb[:FT_BP_ROWS] == msg).all(dim=1)
    print(f"  {FT_BP_ROWS} rows (±4, {FT_BP_FLIPS} flips) + {BP_GARBAGE} "
          f"garbage, max_iter 20: max|kernel-plain|={e:g}; sent message "
          f"{int(right.sum())}/{FT_BP_ROWS}; garbage min unsat kernel "
          f"{int(ku[FT_BP_ROWS:].min())} plain {int(ru[FT_BP_ROWS:].min())}")
    if e != 0.0:
        fail("ft8_174_91: kernel and plain version differ")
    if float(right.float().mean()) < 0.95:
        fail("ft8_174_91: decodable rows did not decode")
    if int(ku[FT_BP_ROWS:].min()) <= 0 or int(ru[FT_BP_ROWS:].min()) <= 0:
        fail("ft8_174_91: a garbage row converged")
    k_ms = cuda_ms(lambda: ldpc_bp.bp_decode_kernel(g, llr, 20))
    p_ms = cuda_ms(lambda: ldpc_bp.bp_decode_reference(g, llr, 20), reps=3,
                   warmup=1)
    bnd = bp_bound(ldpc_bp, g, llr, "sum_product", 20)
    print(f"  {FT_BP_ROWS} rows: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"bound {bnd[0]:.5f} ms ({bnd[1]}, {bnd[2]:.3f} iterations a "
          f"row), {bnd[0] / k_ms:.1%} of it; rows of {g.n * 4} bytes, not a "
          f"multiple of 16, so each row is staged by 4-byte cp.async")
    return max(err, e), k_ms, p_ms, bnd, at25, regs


def ft_others(P, ldpc_bp, dev, rng):
    """[27]: FT8/FT4 TX and the other decoders, each run's BP launches
    counted from 0 (tests/test_ft8.py's setups). Returns {run: launches}."""
    runs = {}

    def count(label, fn):
        ldpc_bp.bp_decode_kernel.launches = 0
        out = fn()
        torch.cuda.synchronize()
        runs[label] = ldpc_bp.bp_decode_kernel.launches
        return out

    msgs = ft_messages(P, FT_WINDOWS)
    tones = np.stack([P.ft8_encode(P.pack77(m), device=dev) for m in msgs])
    iq = P.ft8_mod_batch(tones, FT_FS, 1000.0, device=dev)
    back = P.ft8_demod(iq, FT_FS, 1000.0, device=dev)
    one = P.ft8_mod(tones[0], FT_FS, 1000.0, device=dev)
    err = float((iq[0] - one).abs().max())
    print(f"  ft8_mod_batch of {FT_WINDOWS} messages on the card, ft8_demod: "
          f"tones exact {np.array_equal(back, tones)}; batch vs ft8_mod "
          f"max |diff| {err:.2e}")
    if not np.array_equal(back, tones) or err > 2e-3:
        fail("ft8_mod_batch / ft8_demod")

    def msg_of(call_to, call_de, extra):
        return P.pack77(P.Ft8Standard(call_to, call_de, extra),
                        P.CallsignHashTable())

    cq = msg_of("CQ", "KA1ABC", "FN42")
    for ft8, snr in ((True, -15.0), (False, -11.0)):
        mode = "ft8" if ft8 else "ft4"
        sig = (P.ft8_mod(P.ft8_encode(cq, device=dev), FT_FS, 1012.5,
                         device=dev) if ft8 else
               P.ft4_mod(P.ft4_encode(cq, device=dev), FT_FS, 1012.5,
                         device=dev)).cpu().numpy()
        mk = (P.Ft8StreamDecoder.new_ft8 if ft8
              else P.Ft8StreamDecoder.new_ft4)

        def streams():
            ok = 0
            for seed in range(5):
                r = np.random.default_rng(2000 + seed)
                dec = mk(FT_FS, 950.0, 1150.0, max_cand=4, device=dev)
                res = dec.feed(sig + ft_awgn(r, len(sig),
                                             ft_noise_power(snr)))
                ok += bool(res and res[0].message.call_de == "KA1ABC"
                           and res[0].message.extra == "FN42")
            return ok
        ok = count(f"27 stream {mode}", streams)
        print(f"  Ft8StreamDecoder.new_{mode} at {snr:g} dB: {ok}/5 "
              f"({runs[f'27 stream {mode}']} BP launches)")
        if ok != 5:
            fail(f"the {mode} stream decoder lost frames at its floor")

    sig = P.ft8_mod(P.ft8_encode(cq, device=dev), FT_FS, 1012.5,
                    device=dev).cpu().numpy()
    r = np.random.default_rng(101)
    frames = np.stack([sig + ft_awgn(r, len(sig), ft_noise_power(-21.0))
                       for _ in range(4)])
    got = count("27 multi-frame", lambda: P.ft8_decode_multi_frame(
        frames, FT_FS, 950.0, 1150.0, device=dev))
    print(f"  ft8_decode_multi_frame, 4 repeats at -21 dB: "
          f"{got.message if got else None} ({runs['27 multi-frame']} BP "
          f"launch(es))")
    if got is None or got.message.call_de != "KA1ABC":
        fail("multi-frame decode")

    def ft8_sig(fields, base, amp):
        return amp * P.ft8_mod(P.ft8_encode(msg_of(*fields), device=dev),
                               FT_FS, base, device=dev).cpu().numpy()
    strong = ft8_sig(("CQ", "KA1ABC", "FN42"), 1012.5, 1.0)
    weak = ft8_sig(("KA1ABC", "W9XYZ", "EN50"), 1012.5, 0.12)
    r = np.random.default_rng(12)
    iq = (strong + weak + 0.01 * (r.standard_normal(len(strong)) + 1j
                                   * r.standard_normal(len(strong)))
          ).astype(np.complex64)
    for passes, want in ((1, {"KA1ABC"}), (3, {"KA1ABC", "W9XYZ"})):
        got = count(f"27 multi-signal {passes}", lambda:
                    P.ft8_decode_multi_signal(iq, FT_FS, 950.0, 1150.0,
                                              max_passes=passes, device=dev))
        calls = {g.message.call_de for g in got}
        print(f"  ft8_decode_multi_signal, co-channel pair, max_passes="
              f"{passes}: {sorted(calls)} "
              f"({runs[f'27 multi-signal {passes}']} BP launches)")
        if calls != want:
            fail(f"multi-signal decode with max_passes={passes}")
    a = P.ft4_mod(P.ft4_encode(msg_of("CQ", "KA1ABC", "FN42"), device=dev),
                  FT_FS, 1012.5, device=dev).cpu().numpy()
    b = P.ft4_mod(P.ft4_encode(msg_of("CQ", "W9XYZ", "EN50"), device=dev),
                  FT_FS, 1300.0, device=dev).cpu().numpy()
    got = count("27 ft4 multi-signal", lambda: P.ft4_decode_multi_signal(
        (a + 0.5 * b).astype(np.complex64), FT_FS, 950.0, 1400.0,
        device=dev))
    calls = {g.message.call_de for g in got}
    print(f"  ft4_decode_multi_signal, two signals: {sorted(calls)} "
          f"({runs['27 ft4 multi-signal']} BP launches)")
    if calls != {"KA1ABC", "W9XYZ"}:
        fail("FT4 multi-signal decode")
    if min(runs.values()) <= 0:
        fail("an FT8/FT4 decoder launched no BP kernel")
    return runs


# ── slice 4: the FM chain and PSK31 (phases 28-31) ─────────────────────────


def median_ms(fn, runs: int):
    """Host ms of ``fn`` (work ending in torch.cuda.synchronize()), each of
    ``runs`` runs after a warm-up: (median, all)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out)), out


def fm_body(P, re, im):
    """bench.py:160-188's body: delay-conjugate product, atan2_approx, LR4."""
    from orion_sdr_tpu_torch.demodulate.analog import delay_conj_product
    from orion_sdr_tpu_torch.dsp.iir import design_butter_lp, lp_cascade
    z = torch.complex(re, im)
    prod = delay_conj_product(z, torch.ones_like(z[..., 0]))
    disc = P.atan2_approx(prod.imag, prod.real) * FM_K
    audio, _ = lp_cascade(disc, design_butter_lp(FM_FS, FM_LP_HZ))
    return audio


def tone_snr_rows(x: torch.Tensor, fs: float, f0: float) -> torch.Tensor:
    """tests/helpers.py::tone_snr_db of every row, in float64 on the card:
    the projection on f0 over the projection on 0.73·f0, in dB."""
    x = x.to(torch.float64)
    t = torch.arange(x.shape[-1], dtype=torch.float64, device=x.device)

    def proj(f):
        w = -2.0 * np.pi * f / fs * t
        return ((x * torch.cos(w)).sum(-1) ** 2
                + (x * torch.sin(w)).sum(-1) ** 2) / x.shape[-1] ** 2
    return 10.0 * torch.log10(proj(f0) / (proj(0.73 * f0) + 1e-20))


def fm_phase(P, dev):
    """[28]: the JAX bench's FM chain at its width on the card, its rate,
    two rows against the port's CPU output, and the fm_mod → fm_demod
    roundtrip of a 1 kHz tone at 75 kHz deviation on every row."""
    n = 1 << FM_LOG2_N
    rng = np.random.default_rng(0)
    re = torch.as_tensor(rng.standard_normal((FM_ROWS, n)).astype(np.float32),
                         device=dev)
    im = torch.as_tensor(rng.standard_normal((FM_ROWS, n)).astype(np.float32),
                         device=dev)
    med, runs = median_ms(lambda: fm_body(P, re, im), FM_RUNS)
    msps = FM_ROWS * n / med / 1e3
    print(f"  fm_demod_chain_throughput: {msps:.1f} Msps ({FM_ROWS} x {n}, "
          f"median of {FM_RUNS} runs {med:.3f} ms; runs "
          f"{[round(r, 3) for r in runs]})")
    prof_ms, busy, top = busy_share(lambda: fm_body(P, re, im))
    print(f"  under torch.profiler: {prof_ms:.3f} ms, card busy "
          f"{busy if busy is None else round(busy, 3)} ms; largest: "
          + ", ".join(f"{k[:40]} {v:.3f}" for k, v in top[:6]))
    audio = fm_body(P, re, im)
    rows = [0, FM_ROWS - 1]
    cpu = fm_body(P, re[rows].cpu(), im[rows].cpu())
    err = float((audio[rows].cpu() - cpu).abs().max())
    peak = float(cpu.abs().max())
    print(f"  rows {rows} against the CPU: max |diff| {err:.3e} of peak "
          f"{peak:.3e} (tolerance 1e-5 of the peak)")
    if not err <= 1e-5 * peak:
        fail("[28] the FM chain on the card disagrees with the CPU")
    del re, im, audio
    t = torch.arange(n, dtype=torch.float64, device=dev) / FM_FS
    phi = torch.as_tensor(rng.uniform(0, 2 * np.pi, (FM_ROWS, 1)),
                          device=dev)
    tone = torch.sin(2 * np.pi * FM_TONE_HZ * t + phi).to(torch.float32)
    iq, _ = P.fm_mod(tone, FM_FS, FM_DEV_HZ, device=dev)
    out, _ = P.fm_demod(iq, FM_FS, FM_DEV_HZ, FM_AUDIO_BW_HZ, device=dev)
    snr = tone_snr_rows(out[:, n // 4:], FM_FS, FM_TONE_HZ).cpu().numpy()
    print(f"  fm_mod -> fm_demod, 1 kHz at 75 kHz deviation, {FM_ROWS} rows: "
          f"tone SNR {snr.min():.1f}-{snr.max():.1f} dB (bound 20 dB)")
    if not (np.isfinite(snr).all() and snr.min() > 20.0):
        fail("[28] the FM roundtrip fell below 20 dB")
    return {"msps": msps, "median_ms": med, "runs_ms": runs,
            "profiled_ms": prof_ms, "busy_ms": busy,
            "top_kernels_ms": dict(top[:6]),
            "cpu_rows_max_abs_err": err, "tone_snr_db_min": float(snr.min())}


def psk31_bound(rows: int, n: int, qpsk: bool):
    """Kernel A's bound from its inputs: dots, carries and soft values moved
    once over the card's rate; the chain is n dependent steps a row."""
    return bound_ms(rows * n * 8 + rows * 12 * 2
                    + rows * n * 4 * (2 if qpsk else 1), 0)


def psk31_phase(P, pll, dev):
    """[29]: the JAX bench's PSK31 roundtrip at its width: every bit back,
    its rate, and the PLL kernel (module ``pll``) against its plain version
    on its dots."""
    psk31_pll = pll.psk31_pll
    from orion_sdr_tpu_torch.demodulate.psk31 import (matched_filter_dots,
                                                      pll_constants, _hann)
    from orion_sdr_tpu_torch.modulate.psk31 import bpsk31_mod_bits_batch
    sps = P.modulate.psk31.psk31_sps(PSK_FS)
    bits = torch.as_tensor(np.random.default_rng(1).integers(
        0, 2, (PSK_ROWS, PSK_BITS)).astype(np.uint8), device=dev)

    def body():
        iq = bpsk31_mod_bits_batch(bits, PSK_FS)
        return P.bpsk31_demod(iq, PSK_FS, device=dev) >= 0
    psk31_pll.launches = 0
    back = body()
    torch.cuda.synchronize()
    launches = psk31_pll.launches
    if not torch.equal(back.to(torch.uint8), bits):
        fail("[29] the PSK31 roundtrip lost bits")
    if launches != 1:
        fail(f"[29] the PSK31 roundtrip launched the PLL kernel {launches} "
             f"times, not once")
    med, runs = median_ms(body, PSK_RUNS)
    msps = PSK_ROWS * PSK_BITS * sps / med / 1e3
    print(f"  psk31_roundtrip_throughput: {msps:.1f} Msps ({PSK_ROWS} x "
          f"{PSK_BITS} bits x {sps} samples, every bit back; median of "
          f"{PSK_RUNS} runs {med:.3f} ms; runs {[round(r, 3) for r in runs]})")
    prof_ms, busy, top = busy_share(body)
    print(f"  under torch.profiler: {prof_ms:.3f} ms, card busy "
          f"{busy if busy is None else round(busy, 3)} ms; largest: "
          + ", ".join(f"{k[:40]} {v:.3f}" for k, v in top[:6]))
    iq = bpsk31_mod_bits_batch(bits, PSK_FS)
    dots = matched_filter_dots(iq.reshape(PSK_ROWS, -1, sps), _hann(sps, dev))
    prev = torch.ones(PSK_ROWS, dtype=torch.complex64, device=dev)
    acc = torch.zeros(PSK_ROWS, dtype=torch.float32, device=dev)
    c_fb, scale = pll_constants(sps, 1.0)
    stats = {}
    for qpsk in (False, True):
        args = (dots, prev, acc, c_fb, scale, 0.05, qpsk)
        ks, kp, ka = psk31_pll(*args)
        rs, rp, ra = pll.psk31_pll_reference(*args)
        dec = (ks[..., 0] >= 0) if qpsk else (ks >= 0)
        rdec = (rs[..., 0] >= 0) if qpsk else (rs >= 0)
        err = max(float((ks - rs).abs().max()), float((kp - rp).abs().max()),
                  float((ka - ra).abs().max()))
        peak = float(rs.abs().max())
        mode = "qpsk" if qpsk else "bpsk"
        print(f"  PLL kernel vs plain version ({mode}, {PSK_ROWS} x "
              f"{dots.shape[-1]} dots): decisions exact "
              f"{bool(torch.equal(dec, rdec))}, max |diff| {err:.3e} of peak "
              f"{peak:.3e} (bound 1e-5 of the peak)")
        if not torch.equal(dec, rdec) or not err <= 1e-5 * max(peak, 1.0):
            fail(f"[29] the PLL kernel disagrees with its plain version "
                 f"({mode})")
        stats[mode] = {"max_abs_err": err,
                       "ms": cuda_ms(lambda: psk31_pll(*args)),
                       "plain_ms": cuda_ms(
                           lambda: pll.psk31_pll_reference(*args),
                           reps=2, warmup=1),
                       "bound": psk31_bound(PSK_ROWS, dots.shape[-1], qpsk)}
        print(f"    kernel {stats[mode]['ms']:.4f} ms, plain "
              f"{stats[mode]['plain_ms']:.2f} ms, bound "
              f"{stats[mode]['bound'][0]:.6f} ms (bytes; the chain is "
              f"{dots.shape[-1]} dependent steps a row)")
    return launches, {"msps": msps, "median_ms": med, "runs_ms": runs,
                      "profiled_ms": prof_ms, "busy_ms": busy,
                      "top_kernels_ms": dict(top[:6])}, stats


def psk31_receivers(P, pll, dev):
    """[30]: tests/test_psk31.py's receivers on the card: the three-carrier
    band decode, the QPSK band smoke, the stream decoders at their floors
    (five seeds each) and the batch Viterbi, timed. Returns {run: PLL
    launches}."""
    from orion_sdr_tpu_torch.codec import psk31 as C
    psk31_pll = pll.psk31_pll
    runs = {}
    fs, baud = PSK_FS, P.modulate.psk31.PSK31_BAUD

    def count(label, fn):
        psk31_pll.launches = 0
        out = fn()
        torch.cuda.synchronize()
        runs[label] = psk31_pll.launches
        return out

    def awgn(rng, n, power):
        return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                * np.sqrt(power / 2)).astype(np.complex64)

    def text_iq(msg, hz, qpsk=False, pre=64):
        mod = P.qpsk31_mod_text if qpsk else P.bpsk31_mod_text
        return mod(msg, fs, rf_hz=hz, preamble_bits=pre,
                   device="cpu").numpy()

    base = 900.0
    msgs = {base + 4 * baud + 12.5: "CQ DX ALPHA",
            base + 12 * baud + 12.5: "HELLO BAND",
            base + 22 * baud + 12.5: "TEST 73"}
    n = int(fs * 6)
    buf = np.zeros(n, np.complex64)
    rng = np.random.default_rng(21)
    for (hz, msg), a in zip(msgs.items(), [1.0, 0.4, 0.15]):
        iq = a * text_iq(msg, hz)
        start = int(rng.integers(0, fs // 4))
        buf[start:start + len(iq)] += iq[: n - start]
    buf += awgn(rng, n, 1e-4)
    t0 = time.perf_counter()
    got = count("30 band", lambda: P.psk31_decode_band(
        buf, fs, base, base + 30 * baud, device=dev))
    ms = (time.perf_counter() - t0) * 1e3
    print(f"  psk31_decode_band, three carriers: "
          f"{[(round(r.carrier_hz, 2), r.text) for r in got]} ({ms:.1f} ms)")
    ok = len(got) == 3 and all(
        any(abs(r.carrier_hz - hz) < 40.0 and msg in r.text for r in got)
        for hz, msg in msgs.items())
    if not ok:
        fail("[30] the three-carrier band decode lost a text")
    hz = base + 6 * baud
    qbuf = np.concatenate([text_iq("QPSK BAND", hz, True),
                           np.zeros(int(fs), np.complex64)])
    got = count("30 band qpsk", lambda: P.psk31_decode_band(
        qbuf, fs, base, base + 200.0, qpsk=True, device=dev))
    print(f"  psk31_decode_band, QPSK: {[r.text for r in got]}")
    if not (got and "QPSK BAND" in got[0].text):
        fail("[30] the QPSK band decode lost its text")
    carrier = 993.75
    for qpsk, snr in ((False, -5.0), (True, -6.0)):
        iq = text_iq("CQ TEST", carrier, qpsk)
        power = fs / (2500.0 * 10.0 ** (snr / 10.0))
        mk = P.Psk31Stream.new_qpsk if qpsk else P.Psk31Stream.new_bpsk

        def streams():
            ok = 0
            for seed in range(5):
                r = np.random.default_rng(1000 + seed)
                st = mk(fs, carrier, device=dev)
                ok += "CQ TEST" in st.feed(iq + awgn(r, len(iq), power)) \
                    + st.flush()
            return ok
        mode = "qpsk" if qpsk else "bpsk"
        ok = count(f"30 stream {mode}", streams)
        print(f"  Psk31Stream.new_{mode} at {snr:g} dB: {ok}/5 "
              f"({runs[f'30 stream {mode}']} PLL launches)")
        if ok != 5:
            fail(f"[30] the {mode} stream decoder lost a text at its floor")
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (PSK_ROWS, PSK_BITS)).astype(np.uint8)
    pairs = []
    for row in bits:
        c = C.conv_encode(row)
        d = C.DQPSK_EXP[c[0::2] * 2 + c[1::2]] + 0.3 * (
            rng.standard_normal(PSK_BITS) + 1j * rng.standard_normal(PSK_BITS))
        pairs.append(np.stack([d.real, d.imag], -1).astype(np.float32))
    pairs = torch.as_tensor(np.stack(pairs), device=dev)
    vit_ms, vit_runs = median_ms(lambda: C.viterbi_decode(pairs, device=dev),
                                 3)
    out = C.viterbi_decode(pairs, device=dev).cpu().numpy()
    cpu = C.viterbi_decode(pairs[:2].cpu(), device="cpu").numpy()
    print(f"  psk31 viterbi_decode (torch loop) on {PSK_ROWS} x {PSK_BITS} "
          f"symbols: {vit_ms:.1f} ms (median of 3); bit errors "
          f"{int((out != bits).sum())}; rows 0-1 equal to the CPU "
          f"{np.array_equal(out[:2], cpu)}")
    if not np.array_equal(out[:2], cpu) or (out != bits).any():
        fail("[30] the batch Viterbi on the card")
    if min(runs.values()) <= 0:
        fail("[30] a PSK31 receiver launched no PLL kernel")
    return runs, vit_ms


def onepole_steps_exact(one, x, env0, a_hi, a_lo, ge, env, last) -> bool:
    """Holds a two-rate one-pole run to its plain version at every step at
    once: each step recomputed from the run's own previous envelope (env0
    before the first) in the plain version's float32 operations (the two
    products rounded apart, then the sum). Exact at every step is exact
    over the whole run, by induction from env0."""
    ah, bh, al, bl = (float(v) for v in one._poles(a_hi, a_lo))
    prev = torch.cat([env0[..., None], env[..., :-1]], dim=-1)
    hi = x >= prev if ge else x > prev
    expect = torch.where(hi, ah * prev + bh * x, al * prev + bl * x)
    return torch.equal(expect, env) and torch.equal(last, env[..., -1])


def agc_parting(one, p, x, y, y_cpu, env_card):
    """Prints where agc_rms on the card and on the CPU part: the first
    (row, sample) whose outputs differ by more than 1e-5, with both paths'
    x², envelopes and gains there and one sample before (the card's
    envelope as its launch wrote it, the CPU's from the plain version)."""
    from orion_sdr_tpu_torch.dsp.agc import _gain
    bad = ((y.cpu() - y_cpu).abs() > 1e-5).nonzero()
    r, i = (int(v) for v in bad[0])
    x2_card = (x.abs() ** 2).to(torch.float32).cpu()
    x2_cpu = (x.cpu().abs() ** 2).to(torch.float32)
    env_cpu, _ = one.onepole_two_rate_reference(
        x2_cpu, torch.clamp(x2_cpu[..., 0], min=1e-12), p.attack_a,
        p.release_a, False)
    g_card = _gain(env_card, p) if env_card is not None else None
    g_cpu = _gain(env_cpu, p)
    for k in (max(i - 1, 0), i):
        print(f"  [31] agc parting: row {r}, sample {k}: x^2 card "
              f"{float(x2_card[r, k])!r} cpu {float(x2_cpu[r, k])!r}; env "
              f"card {None if env_card is None else float(env_card[r, k])!r}"
              f" cpu {float(env_cpu[r, k])!r}; gain card "
              f"{None if g_card is None else float(g_card[r, k])!r} cpu "
              f"{float(g_cpu[r, k])!r}; y card {complex(y[r, k])!r} cpu "
              f"{complex(y_cpu[r, k])!r}")


def onepole_phase(P, one, dev):
    """[31]: the two-rate one-pole kernel on the paths that launch it
    (agc_rms with attack != release, real and complex, and cw_mod) against
    its plain loop at 64 x 8192 (exact) and timed there; then the entry
    points at 64 x 2^20 with the launches counted, every step of those
    launches held to the plain version (exact), and the kernel timed at
    that width."""
    import orion_sdr_tpu_torch.dsp.agc as agc_mod
    import orion_sdr_tpu_torch.modulate.analog as analog_mod
    from orion_sdr_tpu_torch.dsp.agc import agc_rms, design_agc
    onepole = one.onepole_two_rate
    rng = np.random.default_rng(31)
    p = design_agc(ONEPOLE_FS, 5.0, 50.0, 0.3)
    a_r = float(np.exp(-1.0 / (3.0 * 1e-3 * ONEPOLE_FS)))
    x = torch.as_tensor(rng.standard_normal((ONEPOLE_ROWS, ONEPOLE_CMP))
                        .astype(np.float32), device=dev)
    z = torch.complex(x, x.flip(-1))
    key = torch.as_tensor(((np.arange(ONEPOLE_CMP) // 700 + np.arange(
        ONEPOLE_ROWS)[:, None]) % 2).astype(np.float32), device=dev)
    cases = {"agc_rms real": (x.abs() ** 2, p.attack_a, p.release_a, False),
             "agc_rms complex": (z.abs() ** 2, p.attack_a, p.release_a,
                                 False),
             "cw_mod": (key, a_r, a_r * 0.999, True)}
    err, plain_ms, k_ms = 0.0, {}, {}
    for label, (xs, a_hi, a_lo, ge) in cases.items():
        e0 = torch.clamp(xs[..., 0], min=1e-12).contiguous()
        ke, kl = onepole(xs, e0, a_hi, a_lo, ge)
        re_, rl = one.onepole_two_rate_reference(xs, e0, a_hi, a_lo, ge)
        same = torch.equal(ke, re_) and torch.equal(kl, rl)
        err = max(err, float((ke - re_).abs().max()))
        k_ms[label] = cuda_ms(lambda: onepole(xs, e0, a_hi, a_lo, ge))
        plain_ms[label] = cuda_ms(lambda: one.onepole_two_rate_reference(
            xs, e0, a_hi, a_lo, ge), reps=1, warmup=1)
        print(f"  {label}: kernel vs plain version at {ONEPOLE_ROWS} x "
              f"{ONEPOLE_CMP}: exact {same}; kernel {k_ms[label]:.4f} ms, "
              f"plain {plain_ms[label]:.1f} ms")
        if not same:
            fail(f"[31] the two-rate one-pole kernel disagrees with its "
                 f"plain version ({label})")
    n = 1 << ONEPOLE_LOG2_N
    iq = torch.complex(*(torch.randn((ONEPOLE_ROWS, n), device=dev,
                                     generator=torch.Generator(dev)
                                     .manual_seed(s)) for s in (1, 2))) * 3.0
    keys = ((torch.arange(n, device=dev)[None, :] // 4000
             + torch.arange(ONEPOLE_ROWS, device=dev)[:, None]) % 2).float()
    seen = []

    def rec(x, env0, a_hi, a_lo, ge):
        env, last = onepole(x, env0, a_hi, a_lo, ge)
        seen.append((x, env0, a_hi, a_lo, ge, env, last))
        return env, last
    for m in (agc_mod, analog_mod):
        m.onepole_two_rate = rec
    try:
        onepole.launches = 0
        y, _ = agc_rms(iq, p)
        cw, _ = P.cw_mod(keys, ONEPOLE_FS, 700.0, device=dev)
        torch.cuda.synchronize()
        launches = onepole.launches
    finally:
        for m in (agc_mod, analog_mod):
            m.onepole_two_rate = onepole
    steps_exact = [onepole_steps_exact(one, *r) for r in seen]
    agc_env = seen[0][5][:2, :ONEPOLE_CMP].cpu() if seen else None
    del seen
    tail_rms = float(y[:, n // 2:].abs().pow(2).mean().sqrt())
    mark = keys[:, 7999] > 0                    # rows keyed over 4000-7999
    on = float(cw[mark, 7999].abs().min())
    # the first CMP samples of two rows through the CPU path
    head = slice(0, ONEPOLE_CMP)
    y_cpu, _ = agc_rms(iq[:2, head].cpu(), p)
    cw_cpu, _ = P.cw_mod(keys[:2, head].cpu(), ONEPOLE_FS, 700.0,
                         device="cpu")
    err_agc = float((y[:2, head].cpu() - y_cpu).abs().max())
    err_cw = float((cw[:2, head].cpu() - cw_cpu).abs().max())
    if not err_agc <= 1e-5:
        agc_parting(one, p, iq[:2, head], y[:2, head], y_cpu, agc_env)
    in_rms = float(iq[:, n // 2:].abs().pow(2).mean().sqrt())
    print(f"  agc_rms on {ONEPOLE_ROWS} x {n} complex IQ (rms {in_rms:.3f}): "
          f"tail rms {tail_rms:.4f} (target {p.target_rms}; the fast attack "
          f"holds it below); cw_mod on {ONEPOLE_ROWS} x {n} keys: envelope "
          f"{on:.4f} at the end of a 4000-sample mark; the first "
          f"{ONEPOLE_CMP} samples of rows 0-1 against the CPU path: agc "
          f"{err_agc:.2e}, cw {err_cw:.2e} (tolerance 1e-5); two-rate "
          f"launches {launches}; every step of each launch at {ONEPOLE_ROWS}"
          f" x {n} against the plain version's step: exact {steps_exact}")
    if launches != 2 or not 0.5 < tail_rms / p.target_rms < 2.0 \
            or not on > 0.99 or not max(err_agc, err_cw) <= 1e-5:
        fail("[31] agc_rms / cw_mod on the card")
    if len(steps_exact) != 2 or not all(steps_exact):
        fail("[31] the two-rate one-pole kernel disagrees with its plain "
             "version on the main path's launches")
    x2 = (iq.abs() ** 2).contiguous()
    e0 = torch.clamp(x2[..., 0], min=1e-12).contiguous()
    ms_full = cuda_ms(lambda: onepole(x2, e0, p.attack_a, p.release_a, False),
                      reps=3, warmup=1)
    bnd_full = bound_ms(ONEPOLE_ROWS * n * 8 + ONEPOLE_ROWS * 8, 0)
    bnd = bound_ms(ONEPOLE_ROWS * ONEPOLE_CMP * 8 + ONEPOLE_ROWS * 8, 0)
    print(f"  kernel at {ONEPOLE_ROWS} x {n}: {ms_full:.3f} ms, bound "
          f"{bnd_full[0]:.4f} ms (bytes; the chain is {n} dependent steps a "
          f"row); at {ONEPOLE_ROWS} x {ONEPOLE_CMP}: bound {bnd[0]:.5f} ms")
    return {"launches": launches, "max_abs_err": err,
            "ms": k_ms["agc_rms real"], "plain_ms": plain_ms["agc_rms real"],
            "bound": bnd, "ms_full": ms_full, "bound_full": bnd_full,
            "ms_at_8192": k_ms, "plain_ms_at_8192": plain_ms,
            "steps_exact_at_full": all(steps_exact), "tail_rms": tail_rms}


# ── slice 5a (phases 32-36) ─────────────────────────────────────────────────

def s5_rate(label, fn, n_samples, n_bytes, runs=S5_RUNS):
    """Host ms of ``fn`` (median of ``runs`` after a warm-up, work ending in
    torch.cuda.synchronize()), its Msps over ``n_samples`` and its bytes
    bound; printed and returned as a dict."""
    med, all_ms = median_ms(fn, runs)
    bnd = bound_ms(n_bytes, 0)[0]
    msps = n_samples / med / 1e3
    print(f"  {label}: {msps:.1f} Msps (median of {runs} runs {med:.4f} ms; "
          f"runs {[round(r, 4) for r in all_ms]}); bytes bound {bnd:.5f} ms, "
          f"{bnd / med:.2%} of it")
    return {"msps": msps, "median_ms": med, "runs_ms": all_ms,
            "bound_ms": bnd, "bound_by": "bytes", "samples": n_samples}


def pfb_float64(x: np.ndarray, proto: np.ndarray, c: int, rows):
    """The polyphase bank in float64 on the host: the rows ``rows``."""
    h = proto.reshape(-1, c).astype(np.float64)
    p = h.shape[0]
    n_out = len(x) // c - (p - 1)
    xb = x[: (n_out + p - 1) * c].astype(np.complex128).reshape(-1, c)
    acc = sum(xb[j: j + n_out] * h[j] for j in range(p))
    return np.fft.fft(acc, axis=-1).T[rows]


def pfb_phase(P, dev):
    """[32]: pfb_channelize at the JAX bench's C = 64, n = 2^20 (bench.py:
    749-761): four tones at channel centers land in their rows > 60 dB over
    every other row; two rows of a random-normal capture against a float64
    host bank (1e-5 of the rows' peak); Msps."""
    from orion_sdr_tpu_torch.dsp.pfb import pfb_prototype
    c, n = PFB_C, 1 << PFB_LOG2_N
    k = torch.arange(n, dtype=torch.float64, device=dev)
    x = sum(torch.exp(2j * np.pi * ch / c * k) for ch in PFB_TONE_CH).to(
        torch.complex64)
    y = P.pfb_channelize(x, c, device=dev)
    power = (y[:, PFB_TAPS:].abs() ** 2).mean(dim=-1).cpu().numpy()
    rows = [ch % c for ch in PFB_TONE_CH]
    others = np.delete(power, rows)
    margin = float(10 * np.log10(power[rows].min() / max(others.max(),
                                                         1e-30)))
    print(f"  tones in channels {PFB_TONE_CH} (rows {rows}): row power "
          f"{np.round(power[rows], 4).tolist()}, the other rows at most "
          f"{others.max():.3e}: {margin:.1f} dB apart (bound 60 dB)")
    if not margin > 60.0:
        fail("[32] a PFB tone leaked into another channel")
    rng = np.random.default_rng(11)
    xn = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    xd = torch.as_tensor(xn, device=dev)
    y = P.pfb_channelize(xd, c, device=dev)
    cmp_rows = [3, 40]
    want = pfb_float64(xn, pfb_prototype(c), c, cmp_rows)
    err = float(np.abs(y[cmp_rows].cpu().numpy() - want).max())
    peak = float(np.abs(want).max())
    print(f"  rows {cmp_rows} against a float64 host bank: max |diff| "
          f"{err:.3e} of peak {peak:.3e} (tolerance 1e-5 of the peak)")
    if not err <= 1e-5 * peak:
        fail("[32] the PFB disagrees with the float64 bank")
    return {**s5_rate(f"pfb_channelizer_throughput (C={c}, n=2^{PFB_LOG2_N})",
                      lambda: P.pfb_channelize(xd, c, device=dev), n,
                      n * 8 + y.numel() * 8),
            "tone_margin_db": margin, "rows_max_abs_err": err}


def upsample(x, m: int) -> np.ndarray:
    """Exact bandlimited m× upsampling by FFT zero padding (the signal is
    zero-guarded, so the circular wrap touches only dead air)."""
    x = np.concatenate([np.zeros(256), np.asarray(x, np.complex128),
                        np.zeros(256)])
    X = np.fft.fft(x)
    n = len(x)
    Y = np.zeros(m * n, np.complex128)
    Y[: n // 2] = X[: n // 2]
    Y[-(n - n // 2):] = X[n // 2:]
    return m * np.fft.ifft(Y)


def wideband(parts, centers, starts, n_wide, fs_wide, m, rng, noise):
    """Channel-rate signals upsampled ×m, placed at their starts, mixed to
    their centers and summed, with AWGN at ``noise`` × the signal power."""
    wide = np.zeros(n_wide, np.complex128)
    k = np.arange(n_wide)
    for x, fc, start in zip(parts, centers, starts):
        u = upsample(x, m)
        wide[start:start + len(u)] += u * np.exp(
            2j * np.pi * fc * k[start:start + len(u)] / fs_wide)
    wide = wide.astype(np.complex64)
    sig = float(np.mean(np.abs(wide) ** 2))
    return wide + ((rng.standard_normal(n_wide)
                    + 1j * rng.standard_normal(n_wide))
                   * np.sqrt(sig * noise / 2)).astype(np.complex64)


def band_run(rx, wide, chunk: int):
    got = {}
    for i in range(0, len(wide), chunk):
        for c, res in rx.feed(wide[i:i + chunk]).items():
            got.setdefault(c, []).extend(res)
    for c, res in rx.flush().items():
        got.setdefault(c, []).extend(res)
    return got


def record_chunks(run):
    """Calls ``run()`` with every chunked Viterbi decode's inputs recorded
    as the path hands them to the kernel: [(c0, c1, pm0)]."""
    from orion_sdr_tpu_torch.fec import conv
    seen = []
    real = conv.chunk_llrs

    def rec(*a):
        out = real(*a)
        seen.append(tuple(t.clone() for t in out[:3]))
        return out
    conv.chunk_llrs = rec
    try:
        run()
    finally:
        conv.chunk_llrs = real
    return seen


def cofdm_band(P, ldpc_bp, dev, rng):
    """[33] COFDM: tests/test_frame.py:487's three links at 8 MS/s, fed in
    chunks of 37 003; returns (BP launches, the largest |kernel − plain|
    over the run's recorded BP launches)."""
    cfg = P.OfdmConfig(P.CarrierPlan(256, 64).with_contiguous_data(
        edge_guard=16), fs=1e6)
    pre = P.OfdmPreamble(repeat_len=128, num_repeats=4).with_training_symbol(
        256, 64)
    table = P.McsTable.default_ladder()
    payloads = [rng.integers(0, 256, 120).astype(np.uint8) for _ in range(3)]
    mod = P.OfdmFrameMod(cfg, table, pre, device=dev)
    frames = [mod.modulate_frame(P.FramePacket(P.FrameMetadata(i, 1), p), i)
              for i, p in enumerate(payloads)]
    centers = [-2.1e6, 0.3e6, 1.5e6]
    wide = wideband([f / 8.0 for f in frames], centers,
                    [3000 + 9000 * i for i in range(3)], 120_000, 8e6, 8,
                    rng, 0.001)
    rx = P.OfdmFrameBandStreamDemod(cfg, table, pre, centers, 8e6,
                                    device=dev)
    ldpc_bp.bp_decode_kernel.launches = 0
    ldpc_bp.bp_decode_kernel.launches_edge = 0
    got = {}
    t0 = time.perf_counter()
    recorded = record_bp(lambda: got.update(band_run(rx, wide, 37_003)))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ldpc_bp.bp_decode_kernel.launches
    edge = ldpc_bp.bp_decode_kernel.launches_edge
    back = [c for c, p in enumerate(payloads) if any(
        isinstance(r, P.RxFrame) and np.array_equal(r.packet.payload, p)
        for r in got.get(c, []))]
    print(f"  COFDM band: channels {back} of 3 back, {launches} BP launches "
          f"({edge} of the edge rule), {len(wide)} samples in {dt:.4f} s "
          f"(first run)")
    if len(back) != 3:
        fail("[33] the COFDM band receiver lost a payload")
    if launches <= 0 or launches != len(recorded):
        fail(f"[33] {launches} BP launches for {len(recorded)} recorded "
             f"decodes")
    err = 0.0
    for g, x, max_iter, rule in recorded:
        kb, ku = ldpc_bp.bp_decode_kernel(g, x, max_iter, rule)
        rb, ru = ldpc_bp.bp_decode_reference(g, x, max_iter, rule)
        err = max(err, float((kb.int() - rb.int()).abs().max()),
                  float((ku - ru).abs().max()))
    print(f"  its {len(recorded)} BP launches "
          f"{[(g.name, tuple(x.shape), r) for g, x, _, r in recorded]} "
          f"against the plain version: max |kernel - plain| {err:g}")
    if err != 0.0:
        fail("[33] a BP launch of the COFDM band differs from its plain "
             "version")
    return launches, edge, err


def dvb_t_band(P, viterbi, dev, rng):
    """[33] DVB-T: tests/test_dvb_t.py:377's two muxes; returns ((radix-2,
    radix-4) launches, the largest |kernel − plain| bit)."""
    from orion_sdr_tpu_torch.waveform.dvb_t import dvb_t_fs_for_bandwidth
    params = P.DvbTFrameParams(P.DvbTLinkParams("1/32", "qpsk", "1/2"), 0, 5)
    payloads = [rng.integers(0, 256, 300).astype(np.uint8) for _ in range(2)]
    mod = P.DvbTFrameMod(params, device=dev)
    frames = [mod.modulate(p) for p in payloads]
    fs = dvb_t_fs_for_bandwidth(1_000_000.0)
    centers = [-1.4e6, 1.1e6]
    n_wide = max(len(upsample(f.iq, 4)) for f in frames) + 40_000
    wide = wideband([f.iq for f in frames], centers, [8_000, 12_000], n_wide,
                    4 * fs, 4, rng, 0.002)
    rx = P.DvbTBandStreamDemod(params, frames[0].n_symbols, 300, centers, fs,
                               4 * fs, device=dev)
    zero_vit(viterbi)
    got = {}
    t0 = time.perf_counter()
    chunks = record_chunks(lambda: got.update(band_run(rx, wide, 120_000)))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    runs = read_vit(viterbi)
    ok = [c for c, p in enumerate(payloads) if any(
        isinstance(r, P.DvbTRxFrame) and np.array_equal(r.payload, p)
        and r.tps.cell_id == 5 for r in got.get(c, []))]
    print(f"  DVB-T band: muxes {ok} of 2 back with cell id 5, Viterbi "
          f"launches radix 2 / 4: {runs[0]} / {runs[1]}, {len(wide)} "
          f"samples in {dt:.4f} s (first run)")
    if len(ok) != 2:
        fail("[33] the DVB-T band receiver lost a payload or cell id")
    if runs[1]:
        fail("[33] the DVB-T band receiver launched the radix-4 kernel")
    if runs[0] <= 0 or runs[0] != len(chunks):
        fail(f"[33] {runs[0]} radix-2 launches for {len(chunks)} recorded "
             f"chunked decodes")
    err = 0.0
    for c0, c1, pm0 in chunks:
        a = viterbi.viterbi_chunks_kernel(c0, c1, pm0, "dvb_k7", radix=2)
        b = viterbi.viterbi_chunks_reference(c0, c1, pm0, "dvb_k7", radix=2)
        err = max(err, float((a.int() - b.int()).abs().max()))
    print(f"  its {len(chunks)} radix-2 launches "
          f"{[tuple(c0.shape) for c0, _, _ in chunks]} against the plain "
          f"version: max |kernel - plain| {err:g}")
    if err != 0.0:
        fail("[33] a Viterbi launch of the DVB-T band differs from its "
             "plain version")
    return runs, err


def tone_amp(x: torch.Tensor, f: float, fs: float, guard: int = 20_000):
    """tests/test_fm_broadcast.py::_tone_amp: 2·|mean(x·e^{−j2πft})| away
    from the edges."""
    seg = x[guard:-guard].to(torch.float64)
    t = torch.arange(guard, guard + seg.shape[0], dtype=torch.float64,
                     device=x.device)
    ph = -2 * np.pi * f / fs * t
    return float(2 * torch.complex(seg * torch.cos(ph),
                                   seg * torch.sin(ph)).mean().abs())


def analog_bands(P, dev, rng):
    """[33] AM blind scan, SSB on three channels (and LSB), FM band stereo
    (tests/test_fm_broadcast.py:160, :214, :247); returns the readings."""
    from orion_sdr_tpu_torch.dsp.channelizer import Channelizer
    from orion_sdr_tpu_torch.dsp.osc import rotate
    out = {}

    def noise(n, scale):
        return torch.as_tensor(((rng.standard_normal(n) + 1j
                                 * rng.standard_normal(n)) * scale).astype(
            np.complex64), device=dev)

    fs, n = 1_000_000.0, 1 << 19
    t = torch.arange(n, dtype=torch.float64, device=dev) / fs
    band = noise(n, 0.01)
    for f_a, center, gain in ((800, -300e3, 1.0), (1500, 50e3, 0.6),
                              (2200, 350e3, 0.3)):
        iq, _ = P.am_mod((0.6 * torch.sin(2 * np.pi * f_a * t)).float(), fs,
                         device=dev)
        band = band + gain * rotate(iq, center, fs)[0]
    t0 = time.perf_counter()
    stations = P.am_band_demod(band, fs, device=dev)
    dt = time.perf_counter() - t0
    got = {}
    for s in stations:
        seg = s.audio[4000:].cpu().numpy()
        spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
        f = np.fft.rfftfreq(len(seg), 1 / s.fs_audio)
        got[round(s.center_hz / 1e3)] = float(f[np.argmax(spec[5:]) + 5])
    print(f"  AM band (blind scan, 2^19 at 1 MHz): stations (kHz: audio "
          f"peak Hz) {got} in {dt:.4f} s")
    if len(stations) != 3 or any(
            abs(got.get(k, 0.0) - f) >= 5 for k, f in ((-300, 800),
                                                       (50, 1500),
                                                       (350, 2200))):
        fail("[33] the AM band receiver missed a station or its tone")
    out["am_peaks_hz"] = got

    fs, n = 480_000.0, 1 << 17
    t = torch.arange(n, dtype=torch.float64, device=dev) / fs

    def ssb(f_a, dial, usb=True):
        a = (0.5 * torch.sin(2 * np.pi * f_a * t)).float()
        iq, _ = P.ssb_mod(a, fs, 2800.0, 1500.0, 0.0, usb=usb, device=dev)
        return rotate(iq, dial, fs)[0]
    band = ssb(1200, -150e3) + ssb(800, 10e3) + ssb(500, 120e3) \
        + noise(n, 0.005)
    snrs = []
    for s, f_a in zip(P.ssb_band_demod(band, fs, [-150e3, 10e3, 120e3],
                                       device=dev), (1200, 800, 500)):
        seg = s.audio[int(0.12 * s.fs_audio):]
        snrs.append(float(tone_snr_rows(seg[None], s.fs_audio, f_a)[0]))
    lsb = P.ssb_band_demod(ssb(900, -40e3, usb=False) + noise(n, 0.005), fs,
                           [-40e3], usb=False, device=dev)[0]
    snrs.append(float(tone_snr_rows(lsb.audio[int(0.12 * lsb.fs_audio):]
                                    [None], lsb.fs_audio, 900)[0]))
    print(f"  SSB band: tone SNR of the three USB channels and the LSB one "
          f"{np.round(snrs, 1).tolist()} dB (bound 20 dB)")
    if not min(snrs) > 20.0:
        fail("[33] an SSB band channel fell below 20 dB")
    out["ssb_tone_snr_db"] = snrs

    fs_w, n = 2_400_000.0, (1 << 18) * 10
    t = torch.arange(n, dtype=torch.float64, device=dev) / fs_w
    plan = {"ALPHA FM": (1000, 2500, -800e3, 1.0),
            "BETA  FM": (600, 1800, 0.0, 1.0),
            "GAMMAFM ": (400, 3000, 650e3, 0.5)}
    band = noise(n, 0.02)
    for ps, (f_l, f_r, center, gain) in plan.items():
        bits = P.rds_encode_groups(P.rds_groups_0a(0x1234, ps_name=ps))
        iq, _ = P.fm_stereo_mod((0.8 * torch.sin(2 * np.pi * f_l * t)).float(),
                                (0.8 * torch.sin(2 * np.pi * f_r * t)).float(),
                                fs_w, rds_bits=bits, device=dev)
        band = band + gain * rotate(iq, center, fs_w)[0]
    t0 = time.perf_counter()
    stations = P.fm_band_demod(band, fs_w, decode_rds=True, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    found = {s.audio.rds.ps_name: s for s in stations}
    readings, bad = {}, set(found) != set(plan)
    for ps, (f_l, f_r, center, _) in plan.items():
        if ps not in found:
            continue
        s = found[ps]
        a = s.audio
        l_amp = tone_amp(a.left, f_l, 240_000.0)
        leak = tone_amp(a.right, f_l, 240_000.0)
        r_amp = tone_amp(a.right, f_r, 240_000.0)
        sep = 20 * np.log10(l_amp / max(leak, 1e-9))
        readings[ps] = {"center_hz": s.center_hz, "pilot": a.pilot_level,
                        "left": l_amp, "right": r_amp, "separation_db": sep}
        bad |= not (abs(s.center_hz - center) < 5e3
                    and abs(a.pilot_level - 0.09) <= 0.009
                    and abs(l_amp - 0.8) <= 0.08 and abs(r_amp - 0.8) <= 0.08
                    and sep > 25.0)
    print(f"  FM band (blind scan, {n} samples at 2.4 MHz, RDS): "
          f"{sorted(found)} in {dt:.4f} s; "
          + "; ".join(f"{ps!r} at {r['center_hz']:.0f} Hz pilot "
                      f"{r['pilot']:.4f} L {r['left']:.4f} R {r['right']:.4f} "
                      f"separation {r['separation_db']:.1f} dB"
                      for ps, r in readings.items()))
    if bad:
        fail("[33] the FM band receiver missed a station, its text or its "
             "stereo bounds")
    out["fm_band"] = readings

    centers = [s.center_hz for s in stations]
    outs = []
    for chunk in (n, 100_003):
        ch = Channelizer(fs_w, 240_000.0, centers, passband_hz=60_000.0,
                         device=dev)
        parts = [ch.push(band[i:i + chunk]) for i in range(0, n, chunk)]
        outs.append(torch.cat(parts + [ch.flush()], dim=-1))
    same = torch.equal(outs[0], outs[1])
    print(f"  channelizer on the FM band, one push against 100 003-sample "
          f"chunks: equal {same} ({tuple(outs[0].shape)})")
    if not same:
        fail("[33] the channelizer's output depends on the chunking")
    return out


def band_phase(P, ldpc_bp, viterbi, dev, rng):
    """[33]: the band receivers on the card."""
    bp, edge, bp_err = cofdm_band(P, ldpc_bp, dev, rng)
    vit, vit_err = dvb_t_band(P, viterbi, dev, rng)
    return bp, edge, bp_err, vit, vit_err, analog_bands(P, dev, rng)


def stereo_phase(P, dev):
    """[34]: _stereo_device at the bench's 1 × 2^17 at 240 kHz and at a
    64-channel batch (rates, bytes bounds, busy share); RDS PS/RT end to
    end at 15 dB (tests/test_fm_broadcast.py:114) and the clean L/R
    separation (tests/test_fm_broadcast.py:71)."""
    from orion_sdr_tpu_torch.demodulate.fm_stereo import _stereo_device
    n = 1 << STEREO_LOG2_N
    rng = np.random.default_rng(11)
    out = {}
    for rows in (1, STEREO_ROWS):
        re = torch.as_tensor(rng.standard_normal((rows, n)).astype(
            np.float32), device=dev)
        im = torch.as_tensor(rng.standard_normal((rows, n)).astype(
            np.float32), device=dev)

        def body():
            return _stereo_device(re, im, STEREO_FS, 75e3, 15e3, 0.45, True)
        # inputs re, im; outputs mono, sub, RDS baseband, pilot level
        r = s5_rate(f"fm_stereo_rds_throughput ({rows} x 2^{STEREO_LOG2_N} "
                    f"at {STEREO_FS:g} Hz)", body, rows * n,
                    rows * n * 4 * 5 + rows * 4)
        prof_ms, busy, top = busy_share(body)
        print(f"    under torch.profiler: {prof_ms:.3f} ms, card busy "
              f"{busy if busy is None else round(busy, 3)} ms"
              + (f" ({busy / prof_ms:.1%})" if busy else "") + "; largest: "
              + ", ".join(f"{k[:40]} {v:.3f}" for k, v in top[:5]))
        out[f"{rows}x{n}"] = {**r, "profiled_ms": prof_ms, "busy_ms": busy,
                              "busy_share": busy / prof_ms if busy else None,
                              "top_kernels_ms": dict(top[:5])}
    n = 1 << 19
    t = torch.arange(n, dtype=torch.float64, device=dev) / STEREO_FS
    left = (0.8 * torch.sin(2 * np.pi * 1000 * t)).float()
    right = (0.8 * torch.sin(2 * np.pi * 2500 * t)).float()
    bits = P.rds_encode_groups(
        P.rds_groups_0a(0x52A1, pty=9, tp=True, ps_name="ORIONFM ")
        + P.rds_groups_2a(0x52A1, pty=9, radiotext="TPU NATIVE SDR"))
    iq, _ = P.fm_stereo_mod(left, right, STEREO_FS, rds_bits=bits, device=dev)
    z = iq + torch.as_tensor(((rng.standard_normal(n) + 1j
                               * rng.standard_normal(n))
                              * np.sqrt(1.0 / 10 ** 1.5 / 2)).astype(
        np.complex64), device=dev)
    a = P.fm_stereo_demod(z, STEREO_FS, decode_rds=True, device=dev)
    print(f"  RDS at 15 dB through the FM chain: PI {a.rds.pi:#06x}, PS "
          f"{a.rds.ps_name!r}, RT {a.rds.radiotext!r}, {len(a.rds.groups)} "
          f"groups")
    if (a.rds.pi, a.rds.ps_name, a.rds.radiotext) != (
            0x52A1, "ORIONFM ", "TPU NATIVE SDR"):
        fail("[34] the RDS text did not come back")
    iq, _ = P.fm_stereo_mod(left[:1 << 18], right[:1 << 18], STEREO_FS,
                            device=dev)
    a = P.fm_stereo_demod(iq, STEREO_FS, device=dev)
    lL, lR = tone_amp(a.left, 1000, STEREO_FS), tone_amp(a.right, 1000,
                                                         STEREO_FS)
    rR, rL = tone_amp(a.right, 2500, STEREO_FS), tone_amp(a.left, 2500,
                                                          STEREO_FS)
    sep = (20 * np.log10(lL / max(lR, 1e-9)), 20 * np.log10(rR / max(rL,
                                                                     1e-9)))
    print(f"  clean stereo: pilot {a.pilot_level:.4f}, L {lL:.4f}, R "
          f"{rR:.4f}, separation {sep[0]:.1f} / {sep[1]:.1f} dB (bounds "
          f"0.09 ± 5 %, 0.8 ± 5 %, 40 dB)")
    if not (abs(a.pilot_level - 0.09) <= 0.0045 and abs(lL - 0.8) <= 0.04
            and abs(rR - 0.8) <= 0.04 and min(sep) > 40.0):
        fail("[34] the stereo separation or levels missed their bounds")
    out["separation_db"] = sep
    return out


def css_phase(P, dev):
    """[35]: _dechirp_fft at the bench's SF 9, 128 symbols (bench.py:763-
    779); the roundtrip at an unknown offset (777 samples) for SF 7-12 at
    10 dB: every payload back, CRC ok."""
    from orion_sdr_tpu_torch.demodulate.css import _base_tensor, _dechirp_fft
    sf, spsym = CSS_SF, 1 << CSS_SF
    n = CSS_SYMS * spsym
    rng = np.random.default_rng(11)
    z = torch.as_tensor((rng.standard_normal(n) + 1j * rng.standard_normal(n)
                         ).astype(np.complex64), device=dev)
    base = _base_tensor(sf, 125e3, 125e3, False, dev)
    r = s5_rate(f"css_dechirp_throughput (SF {sf}, {CSS_SYMS} symbols)",
                lambda: _dechirp_fft(z, base, CSS_SYMS, spsym, spsym), n,
                n * 8 + spsym * 8 + n * 4)
    msg = b"hello chirp world"
    back = {}
    for sf in range(7, 13):
        iq = P.css_mod(msg, sf=sf, device=dev).cpu().numpy()
        buf = np.concatenate([np.zeros(777, np.complex64), iq,
                              np.zeros(500, np.complex64)])
        buf = buf + ((rng.standard_normal(len(buf)) + 1j * rng.standard_normal(
            len(buf))) * np.sqrt(0.1 / 2)).astype(np.complex64)
        t0 = time.perf_counter()
        out = P.css_demod(buf, sf=sf, device=dev)
        back[sf] = (out is not None and out.crc_ok and out.payload == msg,
                    round(time.perf_counter() - t0, 4),
                    None if out is None else round(out.snr_db, 2))
    print(f"  roundtrip at offset 777, 10 dB (SF: payload and CRC ok, s, "
          f"SNR dB): {back}")
    if not all(v[0] for v in back.values()):
        fail("[35] a CSS roundtrip lost its payload")
    return {**r, "roundtrip": {str(k): v for k, v in back.items()}}


def wspr_phase(P, dev):
    """[36]: _energy_grid at the bench's 166 × 8192 samples, 9 dt × 7 df
    (bench.py:781-799); wspr_decode_band on tests/test_wspr.py:114's three
    beacons."""
    from orion_sdr_tpu_torch.demodulate.wspr import _energy_grid
    n = 166 * 8192
    rng = np.random.default_rng(11)
    z = torch.as_tensor((rng.standard_normal(n) + 1j * rng.standard_normal(n)
                         ).astype(np.complex64), device=dev)
    dts = tuple(int(d) for d in np.arange(-4, 5) * 1024)
    dfs = np.linspace(-2.0, 2.0, 7).astype(np.float32)
    r = s5_rate("wspr_energy_grid_throughput (166 x 8192, 9 dt x 7 df)",
                lambda: _energy_grid(z, dts, dfs, 12_000.0, 1500.0), n,
                n * 8 + 7 * 9 * 162 * 4 * 4)
    beacons = [("K1ABC", "FN42", 30, 1420.0, 1.0, 0),
               ("W1AW", "FN31", 37, 1500.0, 0.5, 8000),
               ("DL2XYZ", "JO62", 23, 1570.0, 0.25, 20000)]
    b = [P.wspr_mod(c, g, d, base_hz=f, device=dev) * a
         for c, g, d, f, a, _ in beacons]
    band = torch.as_tensor(((rng.standard_normal(b[0].shape[0] + 30000) + 1j
                             * rng.standard_normal(b[0].shape[0] + 30000))
                            * 0.05).astype(np.complex64), device=dev)
    for x, (*_, start) in zip(b, beacons):
        band[start:start + x.shape[0]] += x
    t0 = time.perf_counter()
    got = {m.callsign: (m.grid, m.dbm)
           for m in P.wspr_decode_band(band, device=dev)}
    dt = time.perf_counter() - t0
    want = {c: (g, d) for c, g, d, *_ in beacons}
    print(f"  wspr_decode_band, three beacons: {got} in {dt:.4f} s")
    if got != want:
        fail("[36] the WSPR band decode lost a beacon")
    return {**r, "band_decode_s": dt}


# ── slice 5b (phases 37-42) ─────────────────────────────────────────────────

def with_busy(rate: dict, fn) -> dict:
    """``rate`` with the card's busy share of one run of ``fn`` under
    torch.profiler, printed."""
    prof_ms, busy, top = busy_share(fn)
    print(f"    under torch.profiler: {prof_ms:.3f} ms, card busy "
          f"{busy if busy is None else round(busy, 3)} ms"
          + (f" ({busy / prof_ms:.1%})" if busy else "") + "; largest: "
          + ", ".join(f"{k[:40]} {v:.3f}" for k, v in top[:4]))
    return {**rate, "profiled_ms": prof_ms, "busy_ms": busy,
            "busy_share": busy / prof_ms if busy else None,
            "top_kernels_ms": dict(top[:4])}


def exact_all(got, ref) -> bool:
    """Every tensor of ``got`` equal to its counterpart in ``ref``."""
    return all(torch.equal(g, r) for g, r in zip(got, ref))


def max_diff(got, ref) -> float:
    """The largest |difference| over the pairs of tensors (in double)."""
    def diff(g, r):
        if g.is_complex():
            return g.to(torch.complex128) - r.to(torch.complex128)
        return g.double() - r.double()
    return max(float(diff(g, r).abs().max()) if g.numel() else 0.0
               for g, r in zip(got, ref))


def recorder(real):
    """(``real`` wrapped, the list it fills): each call passes through, and
    its arguments (keywords after the positional ones, in the order given)
    and output are kept. The wrapper's own launch count is untouched."""
    seen = []

    def rec(*args, **kw):
        out = real(*args, **kw)
        seen.append((args + tuple(kw.values()), out))
        return out
    return rec, seen


@contextlib.contextmanager
def recording(module, attr):
    """``module.attr``, a kernel wrapper as a path calls it, replaced by its
    ``recorder`` for the block; yields the list. ``module`` is the caller's,
    never the wrapper's own (the wrapper counts its launches through its
    module's name)."""
    real = getattr(module, attr)
    rec, seen = recorder(real)
    setattr(module, attr, rec)
    try:
        yield seen
    finally:
        setattr(module, attr, real)


def held_to_plain(seen, plain):
    """Each recorded call's output (``recording``) against ``plain`` run on
    that call's own arguments, exact: (every one equal, max |diff|). A call
    whose arguments equal an earlier one's reuses that one's plain result."""
    def same_args(a, b):
        return len(a) == len(b) and all(
            torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
            for x, y in zip(a, b))
    done, same, err = [], True, 0.0
    for args, out in seen:
        ref = next((r for a, r in done if same_args(a, args)), None)
        if ref is None:
            ref = plain(*args)
            done.append((args, ref))
        out, ref = ((out, ref) if isinstance(out, tuple)
                    else ((out,), (ref,)))
        same &= exact_all(out, ref)
        err = max(err, max_diff(out, ref))
    return same, err


def ramped_symbols(P, order, rows, n, seed, cfo=0.013):
    """Constellation symbols of ``order`` behind a random phase and a
    0.013 rad/symbol ramp (φ reaches ~27 rad at 2048 symbols), light
    noise: (rows, n) complex64 on the host."""
    rng = np.random.default_rng(seed)
    bits = torch.as_tensor(rng.integers(0, 2, (
        rows, n * P.BITS_PER_SYMBOL[order])).astype(np.uint8))
    s = P.map_bits(bits, order).numpy()
    k = np.arange(n)
    z = s * np.exp(1j * (rng.uniform(0, 6, (rows, 1)) + cfo * k)) + 0.02 * (
        rng.standard_normal((rows, n)) + 1j * rng.standard_normal((rows, n)))
    return z.astype(np.complex64)


def dd_pll_phase(P, dd, dev):
    """[37]: the premise of kernel C's one range reduction (sincosf gives
    the bits of cosf and sinf on all 2^32 float32 inputs); kernel C against
    its plain version, exact, on every order at the bench's 4 × 2048
    symbols and a 64-row batch; times at 4 and 64 × 2048 (qam16, the
    bench's order) with the bytes bound and the time a symbol."""
    err, same = 0.0, True
    t0 = time.perf_counter()
    mism = dd.sincos_mismatches(dev)
    print(f"  sincosf against cosf and sinf over all 2^32 float32 inputs: "
          f"{mism} with other bits ({time.perf_counter() - t0:.2f} s)")
    if mism:
        fail("[37] sincosf gives other bits than cosf/sinf")
    stats = {"sincos_mismatches": mism}
    for rows in BURST_ROWS:
        for order in P.constellation.ORDERS:
            z = torch.as_tensor(ramped_symbols(P, order, rows, BURST_SYMS,
                                               rows), device=dev)
            got = dd.dd_pll(z, order, 0.03)
            ref = dd.dd_pll_reference(z, order, 0.03)
            ok = torch.equal(got, ref)
            same &= ok
            err = max(err, max_diff([got], [ref]))
            print(f"  {order} {rows} x {BURST_SYMS}: exact {ok}")
            if order == BURST_ORDER:
                bnd = bound_ms(2 * rows * BURST_SYMS * 8, 0)
                k_ms = cuda_ms(lambda: dd.dd_pll(z, order, 0.03))
                p_ms = cuda_ms(lambda: dd.dd_pll_reference(z, order, 0.03),
                               reps=1, warmup=0)
                us_sym = k_ms / BURST_SYMS * 1e3
                stats[f"{rows}x{BURST_SYMS}"] = {
                    "ms": k_ms, "plain_ms": p_ms, "bound": bnd,
                    "us_per_symbol": us_sym}
                print(f"    kernel {k_ms:.4f} ms ({us_sym:.4f} us a "
                      f"symbol), plain {p_ms:.1f} ms, bound {bnd[0]:.6f} ms "
                      f"(bytes; the chain is {BURST_SYMS} dependent steps a "
                      f"row)")
    if not same:
        fail("[37] the DD-PLL kernel disagrees with its plain version")
    return err, stats


def gardner_phase(P, ga, dev):
    """[38]: kernel G against its plain version, exact, at 64 rows × 2^17
    samples (sps 8, RRC-shaped QPSK through the matched filter) and timed
    there with the bytes bound."""
    from orion_sdr_tpu_torch.dsp.fir import fir_filter_aligned
    n = 1 << GARDNER_LOG2_N
    rng = np.random.default_rng(38)
    bits = rng.integers(0, 2, (GARDNER_ROWS, 2 * (n // BURST_SPS))).astype(
        np.uint8)
    zf = fir_filter_aligned(P.burst_mod(bits, "qpsk", BURST_SPS, device=dev),
                            P.rrc_taps(BURST_SPS))
    n_out = n // BURST_SPS - 4
    got = ga.gardner(zf, float(BURST_SPS), n_out, 0.02, 3.0)
    zn = ga.normalise(zf).contiguous()
    t0 = time.perf_counter()
    ref = ga.gardner_reference(zn, float(BURST_SPS), n_out, 0.02, 3.0)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    same = exact_all(got, ref)
    err = max_diff(got, ref)
    mags = got[0][:, 200:].abs()
    spread = float((mags.std(-1) / mags.mean(-1)).max())
    k_ms = cuda_ms(lambda: ga.gardner(zf, float(BURST_SPS), n_out, 0.02,
                                      3.0), reps=5, warmup=1)
    bnd = bound_ms(GARDNER_ROWS * (n + n_out) * 8 + GARDNER_ROWS * 4, 0)
    print(f"  {GARDNER_ROWS} x 2^{GARDNER_LOG2_N} samples, {n_out} symbols "
          f"a row: exact {same}; locked |y| spread {spread:.3f} (bound "
          f"0.25); kernel {k_ms:.3f} ms, plain {p_ms:.0f} ms (host clock, "
          f"the compared run), bound {bnd[0]:.5f} ms (bytes; the chain is "
          f"{n_out} dependent steps a row)")
    if not same:
        fail("[38] the Gardner kernel disagrees with its plain version")
    if not spread < 0.25:
        fail("[38] the Gardner loop did not lock")
    return err, {"ms": k_ms, "plain_ms": p_ms, "bound": bnd,
                 "shape": f"{GARDNER_ROWS}x{n}", "n_out": n_out}


def gardner_plain(ga, z, sps, n_out, loop_bw, mu0):
    """ops.gardner.gardner's CPU route on a tensor of any device: the
    shared normalisation, then the plain loop."""
    lead, n = z.shape[:-1], z.shape[-1]
    rows = int(np.prod(lead, dtype=np.int64))
    out, pos = ga.gardner_reference(ga.normalise(z.reshape(rows, n))
                                    .contiguous(), sps, int(n_out), loop_bw,
                                    mu0)
    return out.reshape(lead + (int(n_out),)), pos.reshape(lead)


def gardner_path(P, ga, dev):
    """The Gardner loop's main path (after [42]): symbol_sync_gardner on
    4096 QPSK symbols of [38]'s kind, launches counted from 0, each launch
    recorded and held to the plain version on its own inputs, exact.
    Returns ({run: G launches}, max |diff|)."""
    import orion_sdr_tpu_torch.demodulate.digital as digital_mod
    ga.gardner.launches = 0
    bits = np.random.default_rng(7).integers(0, 2, 2 * 4096).astype(np.uint8)
    zf = P.burst_mod(bits, "qpsk", BURST_SPS, device=dev)
    with recording(digital_mod, "gardner") as seen:
        syms, _ = P.symbol_sync_gardner(zf, float(BURST_SPS),
                                        zf.shape[-1] // BURST_SPS - 10,
                                        mu0=3.0, device=dev)
        torch.cuda.synchronize()
    runs = {"38 symbol_sync_gardner": ga.gardner.launches}
    exact, err = held_to_plain(seen, lambda *a: gardner_plain(ga, *a))
    mags = syms[200:].abs()
    spread = float(mags.std() / mags.mean())
    print(f"  symbol_sync_gardner on 4096 QPSK symbols: |y| spread "
          f"{spread:.3f} (bound 0.25); {runs} launches, each held to the "
          f"plain version on its own inputs ({len(seen)} calls of "
          f"{[tuple(o[0].shape) for _, o in seen]} symbols): exact {exact}, "
          f"max |diff| {err}")
    if not spread < 0.25 or min(runs.values()) <= 0:
        fail("[38] symbol_sync_gardner did not lock or launched no kernel")
    if not exact or len(seen) != runs["38 symbol_sync_gardner"]:
        fail("[38] the Gardner launch of symbol_sync_gardner disagrees with "
             "the plain version")
    return runs, err


def burst_body(P, pll, re, im, taps):
    """bench.py:851-874's body: RRC matched filter, energy timing, the
    batched DD-PLL (``pll``, ops.dd_pll.dd_pll or its recorder)."""
    from orion_sdr_tpu_torch.dsp.fir import fir_filter_aligned
    rows, n = re.shape
    zf = fir_filter_aligned(torch.complex(re, im), taps)
    grid = zf[..., : BURST_SYMS * BURST_SPS].reshape(rows, BURST_SYMS,
                                                     BURST_SPS)
    ph = (grid.real ** 2 + grid.imag ** 2).mean(1).argmax(-1)
    syms = torch.gather(grid, 2, ph[:, None, None].expand(
        rows, BURST_SYMS, 1))[..., 0]
    y = pll(syms.contiguous(), BURST_ORDER, 0.03)
    return y.abs().sum()


def burst_phase(P, dd, dev):
    """[39]: burst_modem_throughput at 4 and 64 × 16384 samples (Msps and
    the bytes bound); burst_mod → burst_demod for every order under
    tests/test_digital.py:142-169's impairments; digital_mod →
    digital_demod through a 12 kHz carrier. Every DD-PLL launch of the body
    and of burst_demod is recorded and held to the plain version on its own
    inputs, exact. Returns ({run: D launches}, rates, max |diff|)."""
    import orion_sdr_tpu_torch.demodulate.digital as digital_mod
    from orion_sdr_tpu_torch.dsp.osc import rotate
    runs, rates, held = {}, {}, {}
    n = BURST_SYMS * BURST_SPS
    taps = P.rrc_taps(BURST_SPS, 0.35, 8)
    rng = np.random.default_rng(39)
    for rows in BURST_ROWS:
        re = torch.as_tensor(rng.standard_normal((rows, n)).astype(
            np.float32), device=dev)
        im = torch.as_tensor(rng.standard_normal((rows, n)).astype(
            np.float32), device=dev)
        dd.dd_pll.launches = 0
        pll, seen = recorder(dd.dd_pll)
        r = s5_rate(f"burst_modem_throughput ({rows} x {n}, sps "
                    f"{BURST_SPS}, {BURST_ORDER})",
                    lambda: burst_body(P, pll, re, im, taps), rows * n,
                    rows * n * 8 + rows * BURST_SYMS * 8)
        rates[f"{rows}x{n}"] = with_busy(
            r, lambda: burst_body(P, pll, re, im, taps))
        torch.cuda.synchronize()
        runs[f"39 body {rows}"] = dd.dd_pll.launches
        held[f"39 body {rows}"] = seen
    pre = P.burst_preamble(32)
    lost = {}
    dd.dd_pll.launches = 0
    # tests/test_digital.py:142-169's draws (numpy seed 0, its four orders
    # in its order), then BPSK on the next draws
    rng = np.random.default_rng(0)
    with recording(digital_mod, "dd_pll") as seen:
        for order, nb in (("qpsk", 512), ("qam16", 1024), ("qam64", 1536),
                          ("qam256", 2048), ("bpsk", 256)):
            lost[order] = burst_roundtrip(P, rotate, order, nb, pre, rng,
                                          dev)
        torch.cuda.synchronize()
    runs["39 burst_demod"] = dd.dd_pll.launches
    held["39 burst_demod"] = seen
    carrier = {}
    rng = np.random.default_rng(3)
    for order in P.constellation.ORDERS:
        bits = rng.integers(0, 2, 120 * P.BITS_PER_SYMBOL[order]).astype(
            np.uint8)
        iq, _ = P.digital_mod(bits, order, 48_000.0, 12_000.0, device=dev)
        back, _ = P.digital_demod(iq, order, 48_000.0, 12_000.0, device=dev)
        carrier[order] = int((back.cpu().numpy() != bits).sum())
    print(f"  burst_mod -> burst_demod (37-sample delay, 0.21 % CFO, 1.1 "
          f"rad, ~34 dB), bit errors by order: {lost}; digital_mod -> "
          f"digital_demod at 12 kHz: {carrier}; DD-PLL launches {runs}")
    exact, calls, err = {}, {}, 0.0
    for run, seen in held.items():
        exact[run], e = held_to_plain(seen, dd.dd_pll_reference)
        calls[run], err = len(seen), max(err, e)
    print(f"  each DD-PLL launch of these runs held to the plain version on "
          f"its own inputs (calls {calls}): exact {exact}, max |diff| {err}")
    if any(lost.values()) or any(carrier.values()):
        fail("[39] the burst modem lost bits")
    if min(runs.values()) <= 0:
        fail("[39] a burst path launched no DD-PLL kernel")
    if not all(exact.values()) or any(len(held[r]) != runs[r] for r in runs):
        fail("[39] a DD-PLL launch of the burst paths disagrees with the "
             "plain version")
    return runs, rates, err


def burst_roundtrip(P, rotate, order, nb, pre, rng, dev) -> int:
    """One burst_mod -> burst_demod draw under tests/test_digital.py:142-169's
    impairments: the bits it lost."""
    bits = rng.integers(0, 2, nb).astype(np.uint8)
    iq = P.burst_mod(bits, order, BURST_SPS, preamble_syms=pre, device=dev)
    z = torch.cat([torch.zeros(37, dtype=torch.complex64, device=dev), iq,
                   torch.zeros(50, dtype=torch.complex64, device=dev)])
    z = rotate(z, 0.0021 * BURST_SPS, float(BURST_SPS))[0] * np.exp(1j * 1.1)
    z = (z + torch.as_tensor((0.02 * (rng.standard_normal(z.shape[0])
                                      + 1j * rng.standard_normal(
                                          z.shape[0]))).astype(
        np.complex64), device=dev)).to(torch.complex64)
    got, _ = P.burst_demod(z, order, BURST_SPS, pre, device=dev)
    got = got.cpu().numpy()
    m = min(len(got), nb)
    return int((got[:m] != bits[:m]).sum()) + (nb - m)


def multi_sv_capture(P, n_ms, rng):
    """tests/test_gnss.py:51-80's three satellites in unit noise."""
    svs = [(7, 1200.0, 101.7, 1.0), (13, -2600.0, 512.2, 0.7),
           (28, 350.0, 900.9, 0.55)]
    n = GNSS_SPMS * n_ms
    z = (1.0 / np.sqrt(2) * (rng.standard_normal(n)
                             + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    for prn, dopp, chips, amp in svs:
        z += P.gps_ca_mod(prn, GNSS_FS, n_ms, dopp, chips, amplitude=amp,
                          carrier_phase=rng.uniform(0, 2 * np.pi))
    return z, svs


def acquire_phase(P, dev):
    """[40]: gnss_acquisition_throughput (_acquire_grid at 32 PRNs × 41
    Dopplers × 2048 samples, 4 blocks, 2.048 MHz; M cells/s and the
    bound); gps_acquire on tests/test_gnss.py's three-satellite capture."""
    from orion_sdr_tpu_torch.gnss import _acquire_grid, _ca_pm_sampled
    rng = np.random.default_rng(40)
    codes = torch.as_tensor(np.stack([_ca_pm_sampled(p, GNSS_FS)
                                      for p in range(1, 33)]), device=dev)
    dopp = torch.as_tensor(np.arange(-5000.0, 5001.0, 250.0, np.float32),
                           device=dev)
    n = 5 * GNSS_SPMS
    z = torch.as_tensor((rng.standard_normal(n) + 1j * rng.standard_normal(
        n)).astype(np.complex64), device=dev)
    cells = 32 * dopp.shape[0] * GNSS_SPMS
    med, runs = median_ms(lambda: _acquire_grid(z, codes, dopp, GNSS_FS, 4),
                          S5_RUNS)
    # bytes: capture and codes in, the grid out; operations: the wipes,
    # the block FFTs, the products and inverse FFTs (5·N·log2 N a complex
    # FFT), the power sums
    planes = 32 * dopp.shape[0] * 4
    ops = (dopp.shape[0] * 4 * GNSS_SPMS * (8 + 5 * 11)
           + planes * GNSS_SPMS * (6 + 5 * 11 + 3))
    bnd = bound_ms(n * 8 + codes.numel() * 4 + cells * 4, ops)
    print(f"  gnss_acquisition_throughput: {cells / med / 1e3:.1f} M cells/s "
          f"(32 x 41 x {GNSS_SPMS}, 4 blocks; median of {S5_RUNS} runs "
          f"{med:.4f} ms; runs {[round(r, 4) for r in runs]}); bound "
          f"{bnd[0]:.5f} ms ({bnd[1]}), {bnd[0] / med:.2%} of it")
    rate = with_busy({"mcells_per_s": cells / med / 1e3, "median_ms": med,
                      "runs_ms": runs, "bound_ms": bnd[0],
                      "bound_by": bnd[1], "cells": cells},
                     lambda: _acquire_grid(z, codes, dopp, GNSS_FS, 4))
    cap, svs = multi_sv_capture(P, 8, rng)
    hits = {h.prn: h for h in P.gps_acquire(cap, GNSS_FS, device=dev)}
    ok = set(hits) == {prn for prn, *_ in svs}
    for prn, dopp_hz, chips, _ in svs:
        h = hits.get(prn)
        err = None if h is None else (h.code_phase_samples - chips * GNSS_FS
                                      / 1.023e6 + GNSS_SPMS / 2) \
            % GNSS_SPMS - GNSS_SPMS / 2
        ok &= h is not None and abs(h.doppler_hz - dopp_hz) <= 250.0 \
            and abs(err) <= 1.5
    print("  gps_acquire, three satellites: "
          + str([(h.prn, h.doppler_hz, h.code_phase_samples)
                 for h in hits.values()]))
    if not ok:
        fail("[40] gps_acquire missed a satellite")
    return rate


def track_bench_inputs(P, dev, n_epochs):
    """bench.py:906-940's tracking bank: 8 satellites (PRNs 1-8) on one
    random-normal capture of n_epochs + 2 epochs, starts 8, initial
    Dopplers linspace(-3000, 3000)."""
    from orion_sdr_tpu_torch.gnss import _ca_pm_sampled
    rng = np.random.default_rng(41)
    n = (n_epochs + 2) * GNSS_SPMS
    z = torch.as_tensor((rng.standard_normal(n) + 1j * rng.standard_normal(
        n)).astype(np.complex64), device=dev)
    codes = torch.as_tensor(np.stack([_ca_pm_sampled(p, GNSS_FS)
                                      for p in range(1, TRACK_SATS + 1)]),
                            device=dev)
    starts = torch.full((TRACK_SATS,), 8, dtype=torch.int32, device=dev)
    f0 = torch.as_tensor(np.linspace(-3000, 3000, TRACK_SATS,
                                     dtype=np.float32), device=dev)
    return z, codes, starts, f0


def track_bound(n_capture, sats, epochs):
    """Kernel T's bound: the capture read once, codes and starts in, the
    four outputs out; or its float32 operations, the larger. The least a
    sample, satellite and epoch needs is 30: the wipe's phase (2), cos and
    sin (2), the code times the wiped sample (2, the early, prompt and late
    taps share a code chip) and, for each of the three correlators, one
    complex product and its two sums (3 × 8)."""
    n_bytes = n_capture * 8 + sats * GNSS_SPMS * 4 + sats * epochs * 20
    ops = sats * epochs * GNSS_SPMS * 30
    return bound_ms(n_bytes, ops)


def ephemeris_capture(P, rng):
    """tests/test_gnss_nav.py:139-183's two-satellite capture: ~18.7 s at
    2.048 MHz, three subframes behind 30 random bits a satellite."""
    eph1 = P.GpsEphemeris(
        week=221, ura=1, sv_health=0, iodc=0x1A7, t_gd=-5.12e-9,
        t_oc=302400.0, a_f2=0.0, a_f1=-3.1e-12, a_f0=4.57e-4,
        iode=0xA7, c_rs=-112.8125, delta_n=4.3e-9, m0=1.23456,
        c_uc=-6.3e-6, e=0.0123456, c_us=5.2e-6, sqrt_a=5153.712,
        t_oe=302400.0, c_ic=1.1e-7, omega0=-2.2345, c_is=-9.3e-8,
        i0=0.9617, c_rc=287.46875, omega=2.7182, omega_dot=-8.1e-9,
        idot=4.0e-10)
    eph2 = P.GpsEphemeris(
        week=222, ura=2, sv_health=0, iodc=0x055, t_gd=3.1e-9,
        t_oc=54000.0, a_f2=0.0, a_f1=1.2e-12, a_f0=-2.3e-4,
        iode=0x55, c_rs=54.03125, delta_n=5.1e-9, m0=-2.5,
        c_uc=3.1e-6, e=0.0045, c_us=-1.2e-6, sqrt_a=5153.655,
        t_oe=54000.0, c_ic=-6.5e-8, omega0=1.75, c_is=4.1e-8,
        i0=0.9722, c_rc=-198.5, omega=-0.77, omega_dot=-7.7e-9,
        idot=-2.5e-10)
    svs = [(7, 1200.0, 101.7, 1.0, eph1), (13, -2600.0, 512.2, 0.8, eph2)]
    n_ms = (30 + 900 + 6) * 20 + 15
    n = GNSS_SPMS * n_ms
    z = (0.25 / np.sqrt(2) * (rng.standard_normal(n)
                              + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    for prn, dopp, chips, amp, eph in svs:
        bits = np.concatenate([
            rng.integers(0, 2, 30).astype(np.uint8),
            P.nav_subframes_encode(eph)[:900],
            rng.integers(0, 2, 6).astype(np.uint8)])
        z = z + P.gps_ca_mod(prn, GNSS_FS, n_ms, dopp, chips, nav_bits=bits,
                             amplitude=amp,
                             carrier_phase=rng.uniform(0, 2 * np.pi))
    return z, svs


def ephemeris_ok(P, d, eph) -> bool:
    """tests/test_gnss_nav.py:175-183's checks of one decoded ephemeris."""
    return (d is not None and d.iodc == eph.iodc and d.iode == eph.iode
            and d.week == eph.week
            and abs(d.sqrt_a - eph.sqrt_a) <= 2 ** -19
            and abs(d.e - eph.e) <= 2 ** -33
            and abs(d.m0 - eph.m0) <= np.pi * 2 ** -31
            and abs(d.omega0 - eph.omega0) <= np.pi * 2 ** -31
            and d.t_oe == eph.t_oe
            and 25.9e6 < np.linalg.norm(P.eph_sat_pos(d, d.t_oe)) < 27.2e6)


def track_width(tk, width, z, codes, starts, f0, args):
    """Kernel E at ``width`` threads a satellite (tk.THREADS set for the
    kernel and the plain version alike): (outputs, window misses, plain
    outputs, plain host ms, kernel ms)."""
    saved, tk.THREADS = tk.THREADS, width
    try:
        got = tk.gnss_track(z, codes, starts, f0, *args)
        misses = tk.gnss_track.last_misses.clone()
        t0 = time.perf_counter()
        ref = tk.track_reference(z, codes, starts, f0, *args)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        k_ms = cuda_ms(lambda: tk.gnss_track(z, codes, starts, f0, *args),
                       reps=3, warmup=1)
    finally:
        tk.THREADS = saved
    return got, misses, ref, p_ms, k_ms


def track_misses_model(tk, starts, bases, n, args):
    """tk.window_misses for a launch's starts and output bases."""
    d_el = tk.loop_constants(args[0], GNSS_SPMS, *args[2:])["d_el"]
    return tk.window_misses(starts, bases, n, GNSS_SPMS, d_el)


def track_phase(P, tk, dev):
    """[41]: kernel E against its plain version, exact, at the bench's 8
    satellites × 2000 epochs at each width of TRACK_WIDTHS (times, the
    chosen width tk.THREADS, the window misses against tk.window_misses);
    gnss_tracking_throughput; then the ~18.7 s capture → ephemeris path on
    the card, each of its launches held to the plain version over its first
    2000 epochs, timed again alone, with its window misses. Returns (max
    |diff|, {run: E launches}, stats)."""
    import orion_sdr_tpu_torch.gnss as gnss_mod
    E = TRACK_EPOCHS
    z, codes, starts, f0 = track_bench_inputs(P, dev, E)
    args = (GNSS_FS, E, 7.2, 0.9, 0.12)
    sweep, same, err = {}, True, 0.0
    for width in TRACK_WIDTHS:
        got_w, miss_w, ref_w, p_w, k_w = track_width(tk, width, z, codes,
                                                     starts, f0, args)
        ok = exact_all(got_w, ref_w)
        same &= ok
        err = max(err, max_diff(got_w, ref_w))
        sweep[str(width)] = {"ms": k_w, "us_per_epoch": k_w / E * 1e3,
                             "exact": ok, "plain_ms": p_w}
        print(f"  {width} threads a satellite: kernel {k_w:.3f} ms "
              f"({k_w / E * 1e3:.3f} us an epoch), exact {ok} (plain "
              f"{p_w:.0f} ms)")
        if width == tk.THREADS:
            got, misses, p_ms, k_ms = got_w, miss_w, p_w, k_w
    fastest = min(sweep, key=lambda w: sweep[w]["ms"])
    model = track_misses_model(tk, starts, got[2], z.shape[0], args)
    print(f"  threads a satellite: {tk.THREADS} (fastest of the sweep: "
          f"{fastest}); window misses at {TRACK_SATS} x {E}: "
          f"{misses.tolist()} (the window model: {model.tolist()})")
    z1, c1, s1, f1 = track_bench_inputs(P, dev, TRACK_SHORT)
    k_short = cuda_ms(lambda: tk.gnss_track(z1, c1, s1, f1, GNSS_FS,
                                            TRACK_SHORT, 7.2, 0.9, 0.12),
                      reps=3, warmup=1)
    per_epoch = (k_ms - k_short) / (E - TRACK_SHORT)
    bnd = track_bound(z.shape[0], TRACK_SATS, E)
    msps = TRACK_SATS * GNSS_SPMS / per_epoch / 1e3
    print(f"  kernel vs plain version at {TRACK_SATS} satellites x {E} "
          f"epochs: exact {same}; kernel {k_ms:.3f} ms ({TRACK_SHORT} "
          f"epochs: {k_short:.3f} ms), plain {p_ms:.0f} ms (host clock, the "
          f"compared run); bound {bnd[0]:.5f} ms ({bnd[1]}; the chain is "
          f"{E} dependent epochs)")
    print(f"  gnss_tracking_throughput: {msps:.1f} Msps ({TRACK_SATS} x "
          f"{GNSS_SPMS} samples an epoch over {per_epoch * 1e3:.3f} us an "
          f"epoch, the marginal of {E} over {TRACK_SHORT} epochs; bound "
          f"{bnd[0] / E * 1e3:.5f} us an epoch)")
    if not same:
        fail("[41] the tracking kernel disagrees with its plain version")
    if not torch.equal(misses.cpu(), model.cpu()):
        fail("[41] the tracking kernel's window misses disagree with the "
             "window model")
    rng = np.random.default_rng(9)
    t0 = time.perf_counter()
    cap, svs = ephemeris_capture(P, rng)
    cap_s = time.perf_counter() - t0
    tk.gnss_track.launches = 0
    eph_misses = []
    real = gnss_mod.gnss_track

    def with_misses(*a, **kw):
        out = real(*a, **kw)
        eph_misses.append(tk.gnss_track.last_misses.clone())
        return out
    gnss_mod.gnss_track = with_misses
    try:
        with recording(gnss_mod, "gnss_track") as seen:
            zc = torch.as_tensor(cap, device=dev)
            t0 = time.perf_counter()
            frames = [P.gps_decode_ephemeris(zc, GNSS_FS, prn, device=dev)
                      for prn, *_ in svs]
            torch.cuda.synchronize()
            path_s = time.perf_counter() - t0
    finally:
        gnss_mod.gnss_track = real
    runs = {"41 ephemeris": tk.gnss_track.launches}
    good = [bool(ephemeris_ok(P, f.ephemeris, sv[4]))
            for f, sv in zip(frames, svs)]
    prefix, launch_ms, eph_model = [], [], []
    for (zz, cc, ss, ff, fs, _, *gains), out in seen:
        pre = tk.track_reference(zz, cc, ss, ff, fs, E, *gains)
        prefix.append(exact_all([o[:, :E] for o in out], pre))
        err = max(err, max_diff([o[:, :E] for o in out], pre))
        eph_model.append(track_misses_model(
            tk, ss, out[2], zz.shape[0], (fs, 0, *gains)).tolist())
    for args_e, out in seen:
        launch_ms.append(cuda_ms(lambda: tk.gnss_track(*args_e), reps=1,
                                 warmup=0))
    eph_epochs = [int(o[0].shape[1]) for _, o in seen]
    eph_misses = [m.tolist() for m in eph_misses]
    print(f"  capture -> ephemeris: {cap.shape[0]} samples "
          f"({cap.shape[0] / GNSS_FS:.2f} s, made in {cap_s:.1f} s), "
          f"gps_decode_ephemeris on the card for PRNs "
          f"{[sv[0] for sv in svs]}: every field within tolerance {good} "
          f"({path_s:.2f} s); {runs['41 ephemeris']} tracking launches of "
          f"{eph_epochs} epochs, the first {E} of each exact against the "
          f"plain version: {prefix}")
    print(f"  each ephemeris launch alone: "
          f"{[round(m, 3) for m in launch_ms]} ms "
          f"({[round(m / e * 1e3, 3) for m, e in zip(launch_ms, eph_epochs)]}"
          f" us an epoch); window misses {eph_misses} (the window model: "
          f"{eph_model})")
    if not all(good):
        fail("[41] an ephemeris did not come back")
    if len(prefix) != runs["41 ephemeris"] or not all(prefix):
        fail("[41] a tracking launch of the ephemeris path disagrees with "
             "the plain version")
    if eph_misses != eph_model:
        fail("[41] an ephemeris launch's window misses disagree with the "
             "window model")
    return err, runs, {"ms": k_ms, "plain_ms": p_ms, "bound": bnd,
                       "ms_short": k_short, "per_epoch_ms": per_epoch,
                       "msps": msps, "ephemeris_s": path_s,
                       "ephemeris_epochs": eph_epochs,
                       "ephemeris_launch_ms": launch_ms,
                       "threads": tk.THREADS, "sweep": sweep,
                       "window_misses": misses.tolist(),
                       "ephemeris_window_misses": eph_misses}


def fsk2_phase(P, dev):
    """[42]: fsk2_engine_throughput (fsk2_decision at 4 and 64 × 2^18,
    48 kHz; Msps and the bytes bound); an AX.25 beacon, the stream TNC
    under two chunkings, RTTY from audio and from IQ FSK, POCSAG pages and
    AIS reports, all on the card."""
    from orion_sdr_tpu_torch.demodulate.afsk import fsk2_decision
    from orion_sdr_tpu_torch.modulate.pocsag import _fsk_iq
    from orion_sdr_tpu_torch.codec.rtty import baudot_encode, rtty_frame_bits
    rates = {}
    n = 1 << FSK_LOG2_N
    rng = np.random.default_rng(42)
    for rows in FSK_ROWS:
        x = torch.as_tensor(rng.standard_normal((rows, n)).astype(
            np.float32), device=dev)
        rates[f"{rows}x{n}"] = with_busy(s5_rate(
            f"fsk2_engine_throughput ({rows} x 2^{FSK_LOG2_N} at 48 kHz)",
            lambda: fsk2_decision(x, 48_000.0, 40, device=dev), rows * n,
            rows * n * 8), lambda: fsk2_decision(x, 48_000.0, 40,
                                                 device=dev))
    fs = 48_000.0
    frames = [P.Ax25Frame(dest="APRS", src="W1AW-5", digis=("WIDE1-1",),
                          payload=b"!4237.14N/07120.83W-orion test"),
              P.Ax25Frame(dest="CQ", src="N0CALL", payload=b"hello packet")]
    ok = {"ax25": P.ax25_decode(P.ax25_beacon(frames, fs, device=dev), fs,
                                device=dev) == frames}
    parts = [P.ax25_beacon([f], fs, device="cpu").numpy() for f in frames]
    audio = np.concatenate([parts[0], np.zeros(20000, np.float32), parts[1]])
    for chunk in (7777, len(audio)):
        tnc = P.Afsk1200Stream(fs, device=dev)
        got = []
        for i in range(0, len(audio), chunk):
            got += tnc.feed(audio[i:i + chunk])
        ok[f"stream {chunk}"] = got + tnc.flush() == frames
    msg = "CQ CQ DE W1AW W1AW K 599 #73!"
    ok["rtty audio"] = P.rtty_decode(P.rtty_mod(msg, 11025.0, device=dev),
                                     11025.0, device=dev) == msg
    line = rtty_frame_bits(baudot_encode("RYRYRY DE K1ABC TEST"))
    sps = 8000.0 / 45.45
    iq = _fsk_iq(line, 8000.0, sps, 85.0, int(round(len(line) * sps)),
                 device=dev)
    ok["rtty iq"] = "DE K1ABC TEST" in P.demodulate.afsk.rtty_decode_fsk(
        iq, 8000.0, 45.45, device=dev)
    pages = [P.PocsagPage(address=0x12345, function=3, text="CALL HOME ASAP"),
             P.PocsagPage(address=0x00FA7, function=0, digits="5551234 88")]
    ok["pocsag"] = P.pocsag_decode(P.pocsag_mod(pages, 38_400.0, device=dev),
                                   38_400.0, device=dev) == pages
    ships = [P.AisPosition(mmsi=211234567, lat=53.5421, lon=9.9845,
                           sog_kt=12.3, cog_deg=87.5, heading_deg=88),
             P.AisPosition(mmsi=244000111, lat=-33.8568, lon=151.2153,
                           sog_kt=0.2, cog_deg=310.0, msg_type=3)]
    ok["ais"] = P.ais_decode(P.ais_mod(ships, device=dev), 96_000.0,
                             device=dev) == ships
    print(f"  every frame, text, page and position back: {ok}")
    if not all(ok.values()):
        fail("[42] the 2-FSK family lost a frame, text, page or position")
    return rates


# ── slice 6a (phases 43-47) ─────────────────────────────────────────────────

MORSE_CALLS = ("W1AW", "K2ABC", "N3XYZ", "VE3RX", "DL1ABC", "G4XYZ",
               "JA1NUT", "VK2DX", "F5ABC", "I2XYZ", "EA3QRP", "OH2BH",
               "PY2KQ", "ZL1AB", "UA3XY", "SM5ABC")


def s6_morse_plan():
    """[44]'s stations: [(text, wpm, tone Hz, amplitude, start sample)]:
    12-35 wpm, tones 600 Hz apart from 1 kHz, levels spread over 20 dB in
    a shuffled order, starts inside the first second."""
    rng = np.random.default_rng(S6_SEED + 44)
    levels = rng.permutation(MORSE_SIGS) * (20.0 / (MORSE_SIGS - 1))
    plan = []
    for k, call in enumerate(MORSE_CALLS):
        wpm = 12.0 + 23.0 * k / (MORSE_SIGS - 1)
        text = (f"CQ {call}" + (" TEST" if wpm >= 18 else "")
                + (" 599 K" if wpm >= 26 else ""))
        plan.append((text, wpm, 1000.0 + 600.0 * k,
                     float(10 ** (-levels[k] / 20)),
                     int(rng.integers(0, MORSE_FS))))
    return plan


def s6_adsb_plan():
    """[46]: 20 aircraft, each an identification, an even and an odd
    position, a velocity and a repeat of its identification, in a shuffled
    order on 150 us slots (a frame is 120 us) → ([(encoder, args)],
    offsets s, amplitudes, {icao: (callsign, lat, lon)})."""
    rng = np.random.default_rng(S6_SEED + 46)
    msgs, truth = [], {}
    for k in range(ADSB_PLANES):
        icao = int(rng.integers(0x100000, 0x1000000))
        cs = f"ORN{k:03d}"
        lat, lon = float(rng.uniform(-60, 60)), float(rng.uniform(-179, 179))
        alt = 25 * int(rng.integers(40, 1600))
        gs, trk = float(rng.uniform(100, 600)), float(rng.uniform(0, 360))
        truth[icao] = (cs, lat, lon)
        msgs += [("adsb_encode_identification", (icao, cs)),
                 ("adsb_encode_position", (icao, lat, lon, alt, 0)),
                 ("adsb_encode_position", (icao, lat, lon, alt, 1)),
                 ("adsb_encode_velocity", (icao, gs, trk)),
                 ("adsb_encode_identification", (icao, cs))]
    order = rng.permutation(len(msgs))
    slot = 150e-6
    n_slots = int(((1 << ADSB_LOG2_N) / ADSB_FS - 200e-6) / slot)
    offsets = np.sort(rng.choice(n_slots, len(msgs), replace=False)) \
        * slot + 50e-6
    amps = rng.uniform(0.3, 1.0, len(msgs))
    return [msgs[i] for i in order], offsets, amps, truth


def s6_adsb_check(msgs, frames, decode_frame, truth):
    """[46]'s checks on a decode's messages: (every sent message back, its
    fields as sent, each aircraft's positions resolved and each within
    5e-3 degrees) → (ok, {check: value})."""
    def key(m):
        return (m.icao, m.type_code, m.callsign, m.altitude_ft, m.cpr,
                m.ground_speed_kt, m.track_deg)
    sent = sorted(key(decode_frame(f)) for f in frames)
    got = sorted(key(m) for m in msgs)
    pos_err = max((max(abs(m.position[0] - truth[m.icao][1]),
                       abs(m.position[1] - truth[m.icao][2]))
                   for m in msgs if m.position is not None), default=np.inf)
    resolved = {m.icao for m in msgs if m.position is not None}
    calls = all(m.callsign == truth[m.icao][0] for m in msgs
                if m.callsign is not None)
    out = {"messages": len(msgs), "sent": len(frames),
           "fields_as_sent": got == sent, "callsigns": calls,
           "aircraft_resolved": len(resolved), "max_position_err_deg":
           pos_err}
    return (got == sent and calls and len(resolved) == len(truth)
            and pos_err <= 5e-3), out


BAND_STATIONS = {-800: "am", -300: "fm", 250: "fsk", 700: "ssb"}   # kHz
BAND_PAGE = "ORION BAND MONITOR"


def s6_tone(audio, fs: float, guard: int = 2000):
    """The strongest tone (Hz) of numpy ``audio`` past ``guard`` samples,
    and the spectrum it was read from (tests/test_classify.py's reading)."""
    a = np.asarray(audio)[guard:]
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    f = np.fft.rfftfreq(len(a), 1 / fs)
    return float(f[np.argmax(spec[5:]) + 5]), f, spec


def s6_band_check(entries, to_np):
    """[45]'s checks on band_decode's entries (audio through ``to_np``):
    each station found within 20 kHz of its centre with its label and no
    other segment, the AM and FM tones within 10 Hz, the SSB tones' spacing
    within 10 Hz of 1100 Hz, every page text (the pages run past the
    capture's end: the last one may come back cut) → (ok, {check:
    value})."""
    got = {}
    for e in entries:
        c = e.segment.center_hz / 1e3
        got[next((k for k in BAND_STATIONS if abs(k - c) < 20), round(c))] = e
    labels = {k: e.signal.label for k, e in got.items()}
    what = {"labels": labels}
    if labels != BAND_STATIONS:
        return False, what
    am, fm, ssb, pg = (got[k] for k in (-800, -300, 700, 250))
    what["am_hz"] = s6_tone(to_np(am.audio), am.fs_audio)[0]
    what["fm_hz"] = s6_tone(to_np(fm.audio), fm.fs_audio)[0]
    _, f, spec = s6_tone(to_np(ssb.audio), ssb.fs_audio)
    p1 = int(np.argmax(spec))
    spec[max(p1 - 5, 0):p1 + 6] = 0.0
    what["ssb_spacing_hz"] = abs(float(f[int(np.argmax(spec))] - f[p1]))
    what["pages"] = pg.text
    pages = (pg.text or "").split(" / ")
    ok = (abs(what["am_hz"] - 800) < 10 and abs(what["fm_hz"] - 1000) < 10
          and abs(what["ssb_spacing_hz"] - 1100) < 10 and len(pages) >= 3
          and set(pages[:-1]) == {BAND_PAGE} and pages[-1]
          and BAND_PAGE.startswith(pages[-1]))
    return ok, what


def s6_sstv_image():
    """tests/test_sstv.py's 320 x 256 test picture."""
    img = np.zeros((256, 320, 3), np.uint8)
    img[:, :, 0] = np.linspace(0, 255, 320)[None, :]
    img[:, :, 1] = np.linspace(0, 255, 256)[:, None]
    img[:128, :, 2] = 200
    return img


def s6_psnr(got, want) -> float:
    """tests/test_sstv.py::_psnr."""
    err = np.abs(got.astype(float) - want.astype(float))[3:-3, 6:-6]
    return float(20 * np.log10(255 / np.sqrt(np.mean(err ** 2))))


@contextlib.contextmanager
def recording_kernel(module, attr, counters=("launches",)):
    """The kernel wrapper ``module.attr`` in its own module (callers that
    import it inside a function read it there) replaced by its
    ``recorder`` for the block; yields the list. The wrapper counts its
    launches through that name, so the launches counted on the recorder
    meanwhile are added to the wrapper's ``counters`` after the block."""
    real = getattr(module, attr)
    rec, seen = recorder(real)
    for c in counters:
        setattr(rec, c, 0)
    setattr(module, attr, rec)
    try:
        yield seen
    finally:
        setattr(module, attr, real)
        for c in counters:
            setattr(real, c, getattr(real, c) + getattr(rec, c))


def host_noise(rng, shape, scale):
    """Complex AWGN of ``scale`` a component, drawn on the host (the JAX
    reference check draws the same)."""
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def s6_channel_cases(P):
    """[43]'s seven impairments, each ``fn(x, device)`` on (..., n) IQ at
    CH_FS with its own numpy draws."""
    return {
        "cfo_apply": lambda x, d: P.cfo_apply(x, 1234.5, CH_FS, 0.3,
                                              device=d),
        "phase_noise_apply": lambda x, d: P.phase_noise_apply(
            np.random.default_rng(S6_SEED + 1), x, 100.0, CH_FS, device=d),
        "iq_imbalance_apply": lambda x, d: P.iq_imbalance_apply(
            x, 1.0, 5.0, device=d),
        "multipath_apply": lambda x, d: P.multipath_apply(
            x, [0, 4, 17], [1.0, 0.35 * np.exp(0.7j), 0.1j], device=d),
        "fading_taps+fading_apply": lambda x, d: P.fading_apply(
            x, CH_FS, P.fading_taps(np.random.default_rng(S6_SEED + 3), 80,
                                    64.0, 5.0, "jakes", n_paths=2),
            64.0, [0, 9], [0.0, -3.0], device=d),
        "watterson_apply": lambda x, d: P.watterson_apply(
            np.random.default_rng(S6_SEED + 2), x, CH_FS, 1e-3, 0.5,
            device=d),
    }


def io_phase(P, dev):
    """[43] a 2^22-sample capture (written from the card) through the WAV
    and .npz formats on the host: → {format: seconds}."""
    rng = np.random.default_rng(S6_SEED + 43)
    n = 1 << IO_LOG2_N
    z = host_noise(rng, n, 0.3)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        P.write_iq_wav(f"{d}/c.wav", torch.as_tensor(z, device=dev), CH_FS)
        back, fs = P.read_iq_wav(f"{d}/c.wav")
        out["wav_s"] = time.perf_counter() - t0
        scale = np.vdot(back, z).real / np.vdot(back, back).real
        wav_err = float(np.max(np.abs(back * scale - z)))
        t0 = time.perf_counter()
        P.write_iq_npy(f"{d}/c.npz", z, CH_FS)
        z2, fs2 = P.read_iq_npy(f"{d}/c.npz")
        out["npz_s"] = time.perf_counter() - t0
    print(f"  capture I/O, {n} samples: WAV {out['wav_s']:.3f} s (16-bit "
          f"error {wav_err:.2e} after the scale fit, tolerance 2e-3), .npz "
          f"{out['npz_s']:.3f} s (exact {np.array_equal(z2, z)})")
    if not (fs == fs2 == CH_FS and back.shape == z.shape and wav_err < 2e-3
            and np.array_equal(z2, z)):
        fail("[43] a capture did not come back through its file format")
    return {**out, "samples": n, "wav_err": wav_err}


def impairment_phase(P, dev):
    """[43] the seven impairments at CH_ROWS x 2^CH_LOG2_N on the card:
    rows 0 and CH_ROWS-1 against the CPU path on the same draws (1e-5 of
    the peak), each one's rate beside its bytes bound and busy share."""
    n = 1 << CH_LOG2_N
    gen = torch.Generator(device=dev).manual_seed(S6_SEED)
    x = torch.randn((CH_ROWS, n), dtype=torch.complex64, device=dev,
                    generator=gen)
    rows = [0, CH_ROWS - 1]
    x_cpu = x[rows].cpu()
    rates, errs = {}, {}
    for name, fn in s6_channel_cases(P).items():
        y = fn(x, dev)
        ref = fn(x_cpu, "cpu")
        errs[name] = float((y[rows].cpu() - ref).abs().max()) / max(
            float(ref.abs().max()), 1e-30)
        del y
        rates[name] = with_busy(s5_rate(
            f"{name} ({CH_ROWS} x 2^{CH_LOG2_N}; rows {rows} vs the CPU "
            f"{errs[name]:.2e} of the peak)", lambda: fn(x, dev),
            CH_ROWS * n, CH_ROWS * n * 16), lambda: fn(x, dev))
        rates[name]["rel_err_vs_cpu"] = errs[name]
    if not all(e <= 1e-5 for e in errs.values()):
        fail(f"[43] an impairment on the card parts from the CPU path: "
             f"{errs}")
    return rates


def cofdm_echo(P, ldpc_bp, dev):
    """[43] [4]'s 128 x 1500 B frames at MCS 0 behind an echo inside the
    CP and a residual CFO (CH_CFO_HZ at CH_PHASE0 rad), AWGN at 0.02 x
    signal power, into decode_batch; every BP launch held to the plain
    version."""
    rng = np.random.default_rng(S6_SEED + 431)
    cfg, pre, table = link(P)
    mod = P.OfdmFrameMod(cfg, table, pre, device=dev)
    frames = [(P.FrameMetadata(sequence_num=2000 + i, mcs_index=0,
                               flags=i % 256),
               rng.integers(0, 256, PAYLOAD_BYTES).astype(np.uint8),
               int(rng.integers(0, 2**32))) for i in range(N_FRAMES)]
    bodies = [mod.modulate_frame(P.FramePacket(m, d), s)[pre.total_len():]
              for m, d, s in frames]
    batch = np.zeros((len(bodies), max(map(len, bodies))), np.complex64)
    for i, b in enumerate(bodies):
        batch[i, :len(b)] = b
    y = P.cfo_apply(P.multipath_apply(batch, *CH_ECHO, device=dev),
                    CH_CFO_HZ, 1e6, CH_PHASE0, device=dev)
    sig = y.abs().pow(2).mean(dim=1, keepdim=True).cpu().numpy()
    y = y + torch.as_tensor(host_noise(rng, y.shape, 1.0) * np.sqrt(
        sig * 0.02 / 2).astype(np.float32), device=dev)
    demod = P.OfdmFrameDemod(cfg, table, device=dev)
    ldpc_bp.bp_decode_kernel.launches = 0
    t0 = time.perf_counter()
    with recording_kernel(ldpc_bp, "bp_decode_kernel",
                          ("launches", "launches_edge")) as seen:
        out = demod.decode_batch(y)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = ldpc_bp.bp_decode_kernel.launches
    good = sum(isinstance(o, P.FramePacket) and np.array_equal(o.payload, d)
               and o.metadata == m for o, (m, d, _) in zip(out, frames))
    exact, err = held_to_plain(seen, ldpc_bp.bp_decode_reference)
    print(f"  COFDM behind the echo and {CH_CFO_HZ} Hz: {good}/{N_FRAMES} "
          f"payloads in {dt:.4f} s (first run), {n} BP launches "
          f"{[tuple(a[1].shape) for a, _ in seen]}, each against the plain "
          f"version: exact {exact} (max |diff| {err:g})")
    if good != N_FRAMES or n <= 0 or n != len(seen) or not exact:
        fail("[43] the COFDM link through the channel")
    return n, err, {"frames_back": good, "first_run_s": dt}


def dvbt_echo(P, viterbi, dev):
    """[43] [8]'s 32 QPSK r1/2 frames behind tests/test_channel.py:226's
    -6 dB echo at delay 32, DVB_ECHO_SNR_DB, into decode_batch; every
    radix-2 launch held to the plain version."""
    rng = np.random.default_rng(S6_SEED + 432)
    base = P.DvbTFrameParams(P.DvbTLinkParams("1/8", "qpsk", "1/2"))
    n_bytes = dvb_t_full_payload(P, base)
    frames = [(P.DvbTFrameParams(base.link, i % 4, (17 * i) & 0xFF),
               rng.integers(0, 256, n_bytes).astype(np.uint8))
              for i in range(DVB_FRAMES)]
    mods = [P.DvbTFrameMod(p, device=dev).modulate(d) for p, d in frames]
    batch = torch.as_tensor(np.stack([m.iq for m in mods]), device=dev)
    sig = float(batch.abs().pow(2).mean())
    y = P.multipath_apply(batch, *DVB_ECHO, device=dev)
    y = y + torch.as_tensor(host_noise(rng, tuple(y.shape), np.sqrt(
        sig / 10 ** (DVB_ECHO_SNR_DB / 10) / 2)), device=dev)
    demod = P.DvbTFrameDemod(base, device=dev)
    zero_vit(viterbi)
    t0 = time.perf_counter()
    with recording_kernel(viterbi, "viterbi_chunks_kernel",
                          ("launches", "launches_radix4")) as seen:
        out = demod.decode_batch(y, mods[0].n_symbols, n_bytes)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = read_vit(viterbi)
    good = sum(np.array_equal(o.payload, d) and o.tps == p.tps_word()
               for o, (p, d) in zip(out, frames))
    exact, err = held_to_plain(seen, lambda c0, c1, pm0, code:
                               viterbi.viterbi_chunks_reference(
                                   c0, c1, pm0, code, 2))
    print(f"  DVB-T behind the -6 dB echo at {DVB_ECHO_SNR_DB:g} dB: "
          f"{good}/{DVB_FRAMES} payloads and TPS words in {dt:.4f} s (first "
          f"run), Viterbi launches radix 2 {n[0]}, radix 4 {n[1]} "
          f"{[tuple(a[0].shape) for a, _ in seen]}, each against the plain "
          f"version: exact {exact} (max |diff| {err:g})")
    if good != DVB_FRAMES or n[0] <= 0 or n[1] or n[0] != len(seen) \
            or not exact:
        fail("[43] the DVB-T link through the channel")
    return n, err, {"frames_back": good, "first_run_s": dt}


def ft8_faded(P, ldpc_bp, dev):
    """[43] 64 FT8 windows, each frame through its own Watterson
    "moderate" channel (1 ms, 0.5 Hz) and AWGN at half the faded power
    (tests/test_channel.py:203), decoded by ft8_decode_windows; every BP
    launch held to the plain version."""
    ht = P.CallsignHashTable()
    msgs = ft_messages(P, FT_FADED)
    n = FT_WIN["ft8"]
    x = torch.zeros((FT_FADED, n), dtype=torch.complex64, device=dev)
    for w, msg in enumerate(msgs):
        frame = P.ft8_mod(P.ft8_encode(P.pack77(msg, ht), device=dev), FT_FS,
                          FT_CARRIER, device=dev)
        r = np.random.default_rng(S6_SEED + 4300 + w)
        win = torch.zeros(n, dtype=torch.complex64, device=dev)
        win[:frame.shape[0]] = frame
        y = P.watterson_apply(r, win, FT_FS, 1e-3, 0.5, device=dev)
        sig = float(y[:frame.shape[0]].abs().pow(2).mean())
        x[w] = y + torch.as_tensor(P.awgn(r, n, np.sqrt(sig * 0.5)),
                                   device=dev)
    ldpc_bp.bp_decode_kernel.launches = 0
    t0 = time.perf_counter()
    with recording_kernel(ldpc_bp, "bp_decode_kernel",
                          ("launches", "launches_edge")) as seen:
        out = P.ft8_decode_windows(x, FT_FS, FT_BASE, FT_MAX, device=dev)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_bp = ldpc_bp.bp_decode_kernel.launches
    back = [w for w, (o, m) in enumerate(zip(out, msgs))
            if o is not None and o.message == m]
    wrong = sum(o is not None and o.message != m
                for o, m in zip(out, msgs))
    exact, err = held_to_plain(seen, ldpc_bp.bp_decode_reference)
    print(f"  FT8 through Watterson moderate: {len(back)}/{FT_FADED} messages "
          f"back (tests/test_channel.py:203 asserts every frame back), "
          f"{wrong} wrong, in {dt:.4f} s (first run); {n_bp} BP "
          f"launches {[tuple(a[1].shape) for a, _ in seen]}, each against "
          f"the plain version: exact {exact}")
    if len(back) != FT_FADED or n_bp != len(seen) or not exact:
        fail("[43] the FT8 windows through Watterson")
    return n_bp, err, {"messages_back": len(back), "windows": FT_FADED,
                       "first_run_s": dt}


def channel_phase(P, ldpc_bp, viterbi, dev):
    """[43]: → (BP launches, radix launches, max |kernel - plain| BP and
    Viterbi, readings)."""
    io = io_phase(P, dev)
    rates = impairment_phase(P, dev)
    bp_a, bp_err_a, cofdm = cofdm_echo(P, ldpc_bp, dev)
    vit, vit_err, dvbt = dvbt_echo(P, viterbi, dev)
    bp_b, bp_err_b, ft8 = ft8_faded(P, ldpc_bp, dev)
    return (bp_a + bp_b, vit, max(bp_err_a, bp_err_b), vit_err,
            {"io": io, "impairments": rates, "cofdm_echo": cofdm,
             "dvb_t_echo": dvbt, "ft8_watterson": ft8})


def keyed(P, one, dev, stations, fs, n, noise, seed):
    """Stations [(text, wpm, tone, amp, start)] keyed by MorseEncoder with
    10 % jitter and cw_mod on the card, in AWGN of ``noise`` rms: → (the
    capture on the card, its kernel B launches, each held to the plain
    version at every step)."""
    from orion_sdr_tpu_torch.modulate import analog as analog_mod
    rng = np.random.default_rng(seed)
    buf = torch.as_tensor(host_noise(rng, n, noise / np.sqrt(2)), device=dev)
    one.onepole_two_rate.launches = 0
    with recording(analog_mod, "onepole_two_rate") as seen:
        for text, wpm, tone, amp, start in stations:
            env = P.MorseEncoder(fs, wpm).with_jitter(10.0).encode_text(text)
            if start + len(env) > n:
                fail(f"{text!r} at {wpm} wpm does not fit the capture")
            iq = P.cw_mod(env, fs, tone, device=dev)[0]
            buf[start:start + iq.shape[0]] += amp * iq
        torch.cuda.synchronize()
    launches = one.onepole_two_rate.launches
    exact = [onepole_steps_exact(one, *args, *out) for args, out in seen]
    if launches != len(stations) or len(seen) != launches or not all(exact):
        fail(f"cw_mod's two-rate one-pole launches: {launches} for "
             f"{len(stations)} stations, each exact at every step: {exact}")
    return buf, launches


def morse_phase(P, one, dev):
    """[44] a CW skimmer band: → (kernel B launches, readings)."""
    from orion_sdr_tpu_torch.dsp import fir
    plan = s6_morse_plan()
    buf, launches = keyed(P, one, dev, plan, MORSE_FS, MORSE_N, MORSE_NOISE,
                          S6_SEED + 440)
    nt = fir.kaiser_num_taps(100.0 / MORSE_FS, 60.0)
    route = ("FFT overlap-save" if nt >= fir._FFT_MIN_TAPS
             else "conv1d")

    def run():
        return P.morse_decode_band(buf, MORSE_FS, 500.0, 10_500.0,
                                   max_carriers=MORSE_SIGS, device=dev)
    got = run()
    by_tone = {round(r.tone_hz / 100.0): r for r in got}
    bad = []
    for text, wpm, tone, _, _ in plan:
        r = by_tone.get(round(tone / 100.0))
        if r is None or r.text != text or abs(r.wpm - wpm) / wpm >= 0.15:
            bad.append((text, wpm, r and (r.text, round(r.wpm, 2))))
    print(f"  {len(got)} of {MORSE_SIGS} stations decoded, every text and wpm "
          f"(within 15 %) back: {not bad} {bad}; {MORSE_SIGS} kernel B "
          f"launches (cw_mod), each exact at every step; the envelope "
          f"filter has {nt} taps: {route} (_FFT_MIN_TAPS "
          f"{fir._FFT_MIN_TAPS})")
    if bad or len(got) != MORSE_SIGS:
        fail("[44] the CW skimmer lost a station")
    rate = with_busy(s5_rate(
        f"morse_decode_band ({MORSE_N} samples at 48 kHz, {MORSE_SIGS} "
        f"carriers)", run, MORSE_N, MORSE_N * 8), run)
    return launches, {**rate, "fir_taps": nt, "fir_route": route,
                      "stations": MORSE_SIGS}


def placed(P, z, c, fs, n, g=1.0):
    """``z`` cut or zero-padded to n samples and mixed to ``c`` Hz by a
    phasor formed in float64 (a float32 phase ramp over millions of samples
    would carry an ulp of a radian)."""
    z = z.to(torch.complex64)[:n]
    z = torch.nn.functional.pad(z, (0, n - z.shape[0]))
    k = torch.arange(n, dtype=torch.float64, device=z.device)
    turn = torch.remainder(k * (c / fs), 1.0)
    ph = torch.polar(torch.ones_like(turn), 2 * np.pi * turn)
    return (g * (z.to(torch.complex128) * ph)).to(torch.complex64)


def band_monitor(P, dev):
    """[45] the 2.4 Msps band (AM, FM, POCSAG, SSB): → readings."""
    fs, n = BAND_FS, 1 << BAND_LOG2_N
    rng = np.random.default_rng(S6_SEED + 45)
    t = np.arange(n) / fs
    am = P.am_mod((0.6 * np.sin(2 * np.pi * 800 * t)).astype(np.float32),
                  fs, device=dev)[0]
    fm = P.fm_mod((0.5 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32),
                  fs, 5000.0, device=dev)[0]
    pg = P.pocsag_mod([P.PocsagPage(address=0x1234, function=3,
                                    text=BAND_PAGE)] * 5, fs, device=dev)
    ssb = P.ssb_mod((0.5 * np.sin(2 * np.pi * 800 * t) + 0.4 * np.sin(
        2 * np.pi * 1900 * t)).astype(np.float32), fs, 2800.0, 1500.0,
        device=dev)[0]
    wide = (placed(P, am, -800e3, fs, n) + placed(P, fm, -300e3, fs, n)
            + placed(P, pg, 250e3, fs, n, 0.7) + placed(P, ssb, 700e3, fs, n)
            + torch.as_tensor(host_noise(rng, n, BAND_NOISE), device=dev))

    def run():
        return P.band_decode(wide, fs, device=dev)
    ok, what = s6_band_check(run(), lambda a: a.cpu().numpy())
    print(f"  2.4 Msps band, {n} samples: {what}")
    if not ok:
        fail("[45] the band monitor mislabelled or lost a station")
    return {**with_busy(s5_rate(f"band_decode ({n} samples at 2.4 Msps, four "
                                f"stations)", run, n, n * 8, runs=3), run),
            **what}


def band_narrow(P, one, dev):
    """[45] the narrow modes at the JAX tests' widths: CW at 250 kHz
    (tests/test_classify.py:230), RTTY at 256 kHz (:175), PSK31 beside AM
    and POCSAG in a 500 kHz dispatch capture (:93, 2^22 samples: the
    PSK31 text takes 7.9 s):
    → (kernel B launches, {capture: [(centre kHz, label, text)]})."""
    from orion_sdr_tpu_torch.codec.rtty import baudot_encode, rtty_frame_bits
    rng = np.random.default_rng(S6_SEED + 451)
    out = {}
    fs, n = 250_000.0, 1 << 20
    cw, launches = keyed(P, one, dev, [("CQ TEST K", 30.0, 0.0, 1.0, 0)],
                         fs, n, 0.0, S6_SEED + 452)
    z = placed(P, cw, 80e3, fs, n) + torch.as_tensor(
        host_noise(rng, n, 0.01), device=dev)
    out["cw 250 kHz"] = [(round(e.segment.center_hz / 1e3), e.signal.label,
                          e.text) for e in P.band_decode(z, fs, device=dev)]
    fsr = 8000.0
    line = rtty_frame_bits(baudot_encode("CQ DE ORION SDR 599"))
    sps = fsr / 45.45
    k = np.minimum((np.arange(int(len(line) * sps)) / sps).astype(int),
                   len(line) - 1)
    iq = np.exp(1j * np.cumsum(2 * np.pi * np.where(line[k] == 1, -85.0,
                                                     85.0) / fsr)
                ).astype(np.complex64)
    wide = P.band_compose(iq[None], [60e3], 256_000.0, fsr, device=dev)
    wide = wide + torch.as_tensor(host_noise(rng, wide.shape[0], 0.003),
                                  device=dev)
    out["rtty 256 kHz"] = [(round(e.segment.center_hz / 1e3),
                            e.signal.label, e.text)
                           for e in P.band_decode(wide, 256_000.0,
                                                  device=dev)]
    fs, n = 500_000.0, 1 << 22           # the PSK31 text takes 7.9 s
    t = np.arange(n) / fs
    am = P.am_mod((0.6 * np.sin(2 * np.pi * 800 * t)).astype(np.float32),
                  fs, device=dev)[0]
    pg = P.pocsag_mod([P.PocsagPage(address=0x123, function=3,
                                    text="PAGE ME NOW")] * 60, fs, device=dev)
    psk = P.bpsk31_mod_text("ORION PSK31 DISPATCH", fs, device=dev)
    band = (placed(P, am, -150e3, fs, n) + placed(P, pg, 100e3, fs, n, 0.8)
            + placed(P, psk, 30e3, fs, n, 0.5)
            + torch.as_tensor(host_noise(rng, n, 0.004), device=dev))
    out["dispatch 500 kHz"] = [(round(e.segment.center_hz / 1e3),
                                e.signal.label, e.text)
                               for e in P.band_decode(band, fs, device=dev)]
    print(f"  narrow modes: {out}")
    d = {c: (label, text) for c, label, text in out["dispatch 500 kHz"]}
    if (out["cw 250 kHz"] != [(80, "cw", "CQ TEST K")]
            or out["rtty 256 kHz"] != [(60, "fsk", "CQ DE ORION SDR 599")]
            or {c: v[0] for c, v in d.items()}
            != {-150: "am", 100: "fsk", 30: "psk31"}
            or set((d[100][1] or "").split(" / ")) != {"PAGE ME NOW"}
            or "ORION PSK31 DISPATCH" not in (d[30][1] or "")):
        fail("[45] a narrow mode was mislabelled or lost")
    return launches, out


def band_phase6(P, one, pll, dev):
    """[45]: → (PSK31 PLL launches, kernel B launches, readings); every
    PLL launch held to the plain version."""
    from orion_sdr_tpu_torch.demodulate import psk31 as psk31_mod
    pll.psk31_pll.launches = 0
    with recording(psk31_mod, "psk31_pll") as seen:
        rate = band_monitor(P, dev)
        one_n, narrow = band_narrow(P, one, dev)
        torch.cuda.synchronize()
    n = pll.psk31_pll.launches
    exact, err = held_to_plain(seen, pll.psk31_pll_reference)
    print(f"  PSK31 PLL launches {n} {[tuple(a[0].shape) for a, _ in seen]}, "
          f"each against the plain version: exact {exact}")
    if n <= 0 or n != len(seen) or not exact:
        fail("[45] a PSK31 PLL launch differs from its plain version")
    return n, err, one_n, {**rate, "narrow": narrow}


def adsb_phase(P, dev):
    """[46] 100 DF17 frames from 20 aircraft at 2 Msps: → readings."""
    from orion_sdr_tpu_torch.codec import adsb as A
    msgs, offsets, amps, truth = s6_adsb_plan()
    frames = [getattr(A, enc)(*args) for enc, args in msgs]
    n = 1 << ADSB_LOG2_N
    rng = np.random.default_rng(S6_SEED + 460)
    iq = P.adsb_mod(frames, ADSB_FS, offsets_s=offsets, amplitudes=amps,
                    total_s=n / ADSB_FS, device=dev) + torch.as_tensor(
        host_noise(rng, n, ADSB_NOISE), device=dev)

    def run():
        return P.adsb_decode_capture(iq, ADSB_FS, max_candidates=1024,
                                     device=dev)
    ok, what = s6_adsb_check(run(), frames, A.adsb_decode_frame, truth)
    print(f"  {what}")
    if not ok:
        fail("[46] the ADS-B receiver lost or garbled a message")
    return {**with_busy(s5_rate(f"adsb_decode_capture ({n} samples at 2 "
                                f"Msps)", run, n, n * 8), run), **what}


def sstv_phase(P, dev):
    """[47] a Martin M1 picture through sstv_mod and sstv_demod at 11 025
    Hz and 48 kHz: → readings."""
    img = s6_sstv_image()
    out = {}
    for fs in SSTV_RATES:
        audio = P.sstv_mod(img, fs, device=dev)

        def run():
            return P.sstv_demod(audio, fs, device=dev)
        got = run()
        psnr = s6_psnr(got.image, img)
        print(f"  {fs:g} Hz: {audio.shape[0]} samples, VIS {got.vis}, PSNR "
              f"{psnr:.2f} dB (at least 35)")
        if got.vis != 44 or not psnr >= 35.0:
            fail(f"[47] the SSTV picture at {fs:g} Hz")
        out[f"{fs:g}"] = {**with_busy(s5_rate(
            f"sstv_demod ({audio.shape[0]} samples at {fs:g} Hz)", run,
            audio.shape[0], audio.shape[0] * 4, runs=3), run),
            "psnr_db": psnr, "vis": got.vis}
    return out


# ── [48] the generic OFDM receive and OTFS ───────────────────────────────────


def s6b_grid(P, order):
    """[48]'s two configs of ``order``: dvb_t_config("1/4", 7.61e6) (the 2K
    grid, n_fft 2048, cp 512, continual pilots) and the scattered-pilot
    dvb_t_scattered_config (its phase-0 plan)."""
    from dataclasses import replace
    return (replace(P.dvb_t_config("1/4", OFDM_BW), constellation=order),
            replace(P.dvb_t_scattered_config("1/4", OFDM_BW),
                    constellation=order))


def s6b_known(P, n_fft):
    from orion_sdr_tpu_torch.sync.ofdm_sync import \
        training_symbol_freq_pattern
    return training_symbol_freq_pattern(n_fft).astype(np.complex64)


def s6b_capture(P, cfg, rows, n_sym, dev, seed, otfs=False):
    """(bits (rows, n_sym·bps) uint8 on ``dev``, IQ (rows, (1 + n_sym)·sps):
    a known training symbol, then ``n_sym`` symbols by ofdm_mod with the
    plan's pilots passed as ``pilot_bins``/``pilot_values``, or by
    otfs_mod at n_doppler OTFS_DOPPLER)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bits = torch.randint(0, 2, (rows, n_sym * cfg.bits_per_ofdm_symbol()),
                         generator=gen, device=dev, dtype=torch.uint8)
    g = cfg.grid()
    if otfs:
        iq, _ = P.otfs_mod(cfg, bits, OTFS_DOPPLER)
    else:
        iq, _ = P.ofdm_mod(cfg, bits, pilot_bins=g.pilot_bins,
                           pilot_values=g.pilot_values)
    known = torch.as_tensor(s6b_known(P, g.n_fft), device=dev)
    train = P.multicarrier.ofdm_assemble(known[None, :], g.cp_len)
    return bits, torch.cat([train.expand(rows, -1), iq], dim=-1)


def s6b_noise(x, snr_db, seed):
    """``x`` plus complex AWGN at ``snr_db`` below its mean power (drawn on
    its device from ``seed``); → (noisy, per-sample noise power)."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    p = float(x.abs().pow(2).mean()) / 10 ** (snr_db / 10)
    n = torch.randn(x.shape, generator=gen, device=x.device,
                    dtype=torch.complex64)          # unit complex variance
    return x + n * np.float32(np.sqrt(p)), p


def s6b_receivers(P, cfg, cfg_s, nv):
    """[48]'s receive paths on a capture whose symbol 0 is the known
    training symbol: name → fn(rx) → soft symbols (rows, n_sym, n_data)."""
    g, gs = cfg.grid(), cfg_s.grid()
    n_fft, cp = g.n_fft, g.cp_len
    sps = n_fft + cp
    known = s6b_known(P, n_fft)

    def est(rx):
        f0 = P.multicarrier.symbol_fft(rx[..., :sps], n_fft, cp,
                                       n_symbols=1)[..., 0, :]
        return P.channel_estimate_training(f0, known)[..., None, :]

    def zf(rx):
        return P.ofdm_demod(cfg, rx[..., sps:], estimate=est(rx))[0]

    def mmse(rx):
        freq = P.multicarrier.symbol_fft(rx[..., sps:], n_fft, cp)
        return P.multicarrier.grid_extract(
            g, P.mmse_equalize(freq, est(rx), nv))

    def pilots(rx):
        freq = P.multicarrier.symbol_fft(rx[..., sps:], n_fft, cp)
        h = P.channel_estimate_pilots(freq, gs.pilot_bins, gs.pilot_values,
                                      n_fft)
        return P.multicarrier.grid_extract(gs, P.zf_equalize(freq, h))

    def otfs(rx, h=None):
        return P.otfs_demod(cfg, rx[..., sps:], OTFS_DOPPLER,
                            estimate=est(rx) if h is None else h,
                            noise_var=nv)[0]
    return {"ofdm_demod ZF (training symbol)": zf,
            "mmse_equalize (training symbol)": mmse,
            "pilot_interp (dvb_t_scattered_config)": pilots,
            "otfs_demod LMMSE (echo)": otfs}, otfs


def s6b_vs_cpu(P, cfg, fn, rx, soft, rows):
    """Rows ``rows`` of the card's ``soft`` against ``fn`` run on the CPU
    on the same rows of ``rx``: (max |soft diff| / peak, hard bits equal,
    |EVM card − EVM CPU| in dB of row rows[0])."""
    ref = fn(rx[rows].cpu())
    got = soft[rows].cpu()
    err = float((got - ref).abs().max()) / float(ref.abs().max())
    hard = P.ofdm_decide(cfg, got)
    same = torch.equal(hard, P.ofdm_decide(cfg, ref))
    evm = [P.build_ofdm_rx_frame(cfg, s[0], h[0]).evm_db
           for s, h in ((got, hard), (ref, P.ofdm_decide(cfg, ref)))]
    return err, same, abs(evm[0] - evm[1]), evm[0]


def ofdm_rx_phase(P, dev):
    """[48] the generic OFDM receive and OTFS on the 2K grid: → readings.
    Every receive returns every bit on the noiseless echo; on the noisy
    captures rows 0 and OFDM_ROWS-1 match the CPU path (hard bits equal,
    soft symbols within 1e-4 of the peak, EVM within 0.1 dB)."""
    rows, out, bad = [0, OFDM_ROWS - 1], {}, []
    for k, order in enumerate(("qpsk", "qam16")):
        cfg, cfg_s = s6b_grid(P, order)
        seed = S6B_SEED + 480 + 10 * k
        caps = {"ofdm": s6b_capture(P, cfg, OFDM_ROWS, OFDM_SYMS, dev, seed),
                "scattered": s6b_capture(P, cfg_s, OFDM_ROWS, OFDM_SYMS, dev,
                                         seed + 1),
                "otfs": s6b_capture(P, cfg, OFDM_ROWS, OTFS_SYMS, dev,
                                    seed + 2, otfs=True)}
        echo = {name: P.multipath_apply(iq, *OFDM_ECHO, device=dev)
                for name, (_, iq) in caps.items()}
        noisy, p = {}, {}
        for i, (name, x) in enumerate(echo.items()):
            noisy[name], p[name] = s6b_noise(x, OFDM_SNR_DB, seed + 5 + i)
        nv = cfg.carrier_plan.n_fft * p["ofdm"]   # per-bin noise variance
        recv, otfs = s6b_receivers(P, cfg, cfg_s, nv)
        which = {"ofdm_demod ZF (training symbol)": "ofdm",
                 "mmse_equalize (training symbol)": "ofdm",
                 "pilot_interp (dvb_t_scattered_config)": "scattered",
                 "otfs_demod LMMSE (echo)": "otfs"}
        for name, fn in recv.items():
            bits = caps[which[name]][0]
            cfg_n = cfg_s if which[name] == "scattered" else cfg
            clean = P.ofdm_decide(cfg_n, fn(echo[which[name]]))
            wrong = int((clean != bits).sum())
            x = noisy[which[name]]
            soft = fn(x)
            err, same, d_evm, evm = s6b_vs_cpu(P, cfg_n, fn, x, soft, rows)
            n = x.shape[-1] * OFDM_ROWS
            rate = with_busy(s5_rate(
                f"{order} {name}: {OFDM_ROWS} x {x.shape[-1]}", lambda:
                fn(x), n, n * 8 + soft.numel() * 8, runs=S6B_RUNS),
                lambda: fn(x))
            print(f"    noiseless echo: {wrong} of {bits.numel()} bits "
                  f"wrong; at {OFDM_SNR_DB:g} dB rows {rows} vs the CPU: "
                  f"soft {err:.2e} of the peak, hard equal {same}, EVM "
                  f"{evm:.2f} dB (card - CPU {d_evm:.4f} dB)")
            out[f"{order} {name}"] = {**rate, "bits_wrong_noiseless": wrong,
                                      "rel_err_vs_cpu": err, "evm_db": evm,
                                      "evm_diff_db": d_evm}
            if wrong or not same or err > 1e-4 or d_evm > 0.1:
                bad.append(f"{order} {name}")
        # Watterson: a per-symbol estimate from a probe of known training
        # symbols through the same draws (the channel is one realisation
        # for every row and depends only on the seed and the length)
        bits, iq = caps["otfs"]
        n_sym = 1 + OTFS_SYMS
        g = cfg.grid()
        known = torch.as_tensor(s6b_known(P, g.n_fft), device=dev)
        probe = P.multicarrier.ofdm_assemble(
            known.expand(n_sym, -1)[None], g.cp_len)
        ws = S6B_SEED + 490 + k

        def watt(x):
            return P.watterson_apply(np.random.default_rng(ws), x, cfg.fs,
                                     *WATTERSON, device=dev)
        h = (P.multicarrier.symbol_fft(watt(probe), g.n_fft, g.cp_len)
             / known)[..., 1:, :]
        xw = watt(iq)
        clean = int((P.ofdm_decide(cfg, otfs(xw, h)) != bits).sum())
        xn, _ = s6b_noise(xw, OFDM_SNR_DB, ws + 7)

        def fn_w(x):
            return otfs(x, h.to(x.device))
        soft = fn_w(xn)
        err, same, d_evm, evm = s6b_vs_cpu(P, cfg, fn_w, xn, soft, rows)
        noisy_wrong = int((P.ofdm_decide(cfg, soft) != bits).sum())
        n = xn.shape[-1] * OFDM_ROWS
        rate = with_busy(s5_rate(
            f"{order} otfs_demod LMMSE (Watterson {WATTERSON[0] * 1e6:g} us, "
            f"{WATTERSON[1]:g} Hz)", lambda: fn_w(xn), n,
            n * 8 + soft.numel() * 8 + h.numel() * 8, runs=S6B_RUNS),
            lambda: fn_w(xn))
        print(f"    Watterson noiseless {clean}, at {OFDM_SNR_DB:g} dB "
              f"{noisy_wrong} of {bits.numel()} bits wrong; rows {rows} vs "
              f"the CPU: soft {err:.2e} of the peak, hard equal {same}, EVM "
              f"{evm:.2f} dB (card - CPU {d_evm:.4f} dB)")
        out[f"{order} otfs_demod LMMSE (Watterson)"] = {
            **rate, "bits_wrong_noiseless": clean,
            "bits_wrong_noisy": noisy_wrong, "rel_err_vs_cpu": err,
            "evm_db": evm, "evm_diff_db": d_evm}
        if not same or err > 1e-4 or d_evm > 0.1:
            bad.append(f"{order} otfs Watterson")
        del caps, echo, noisy
    if bad:
        fail(f"[48] receive paths off: {bad}")
    return out


# ── [49] the Block classes ───────────────────────────────────────────────────


def s6b_psk_text(P, seconds: float, fs: float) -> str:
    """Text whose BPSK31 transmission (varicode, 32-bit pre/postamble)
    takes ``seconds`` at ``fs``."""
    from orion_sdr_tpu_torch.codec.varicode import encode_text
    words = ("ORION SDR BLOCK SESSION, THE QUICK BROWN FOX JUMPS OVER THE "
             "LAZY DOG 0123456789.").split()
    text, i = words[0], 1
    sps = P.modulate.psk31.psk31_sps(fs)
    while len(encode_text(text, 32, 32)) * sps < seconds * fs:
        text += " " + words[i % len(words)]
        i += 1
    return text


def s6b_rate(label, fn, n, unit, n_bytes, busy_fn=None):
    """Host ms of ``fn`` (median of S6B_RUNS runs after a warm-up, work
    ending in torch.cuda.synchronize()), ``n`` over it in ``unit`` (Msps
    for samples, calls/s or frames/s), the bytes bound and the card's busy
    share under torch.profiler (of ``busy_fn``, a shorter run of the same
    calls, where the whole run holds too many launches to profile within
    the smoke's time); printed and returned."""
    med, all_ms = median_ms(fn, S6B_RUNS)
    scale = 1e3 / (1e6 if unit == "Msps" else 1.0)
    bnd = bound_ms(n_bytes, 0)[0]
    print(f"  {label}: {n / med * scale:.4g} {unit} (median of {S6B_RUNS} "
          f"runs {med:.4f} ms; runs {[round(r, 4) for r in all_ms]}); bytes "
          f"bound {bnd:.5f} ms, {bnd / med:.2%} of it")
    return with_busy({"rate": n / med * scale, "unit": unit,
                      "median_ms": med, "runs_ms": all_ms, "bound_ms": bnd,
                      "bound_by": "bytes"}, busy_fn or fn)


def s6b_chunks(x, n):
    return [np.ascontiguousarray(x[i:i + n]) for i in range(0, len(x), n)]


def psk31_blocks(P, pll, dev):
    """[49] BPSK31 and QPSK31 sessions through the blocks in 4096-sample
    process() calls: → (PLL launches, max |kernel − plain|, readings)."""
    from orion_sdr_tpu_torch.demodulate import psk31 as psk31_mod
    fs = 8000.0
    text = s6b_psk_text(P, BLOCK_PSK_S, fs)
    out = {}
    pll.psk31_pll.launches = 0
    with recording(psk31_mod, "psk31_pll") as seen:
        for mode in ("bpsk", "qpsk"):
            mod = (P.Bpsk31Mod if mode == "bpsk" else P.Qpsk31Mod)(
                fs, 1000.0, device=dev)
            iq = mod.modulate_text(text)
            parts = s6b_chunks(iq, BLOCK_PSK_CHUNK)

            def run(mode=mode, parts=parts):
                if mode == "bpsk":
                    d = P.Bpsk31Demod(fs, 1000.0, device=dev)
                    soft = np.concatenate([d.process(c) for c in parts])
                    bits = P.Bpsk31Decider(device=dev).process(soft)
                else:
                    d = P.Qpsk31Demod(fs, 1000.0, device=dev)
                    for c in parts:
                        d.process(c)
                    bits = d.flush()
                return P.VaricodeDecoder().push_bits(bits)
            n0 = len(seen)
            got = run()
            torch.cuda.synchronize()
            calls = len(seen) - n0
            print(f"  {mode.upper()}31 {len(iq) / fs:.1f} s ({len(iq)} "
                  f"samples) in {len(parts)} process() calls: text back "
                  f"{text in got}, {calls} PLL launches")
            if text not in got or calls != len(parts):
                fail(f"[49] {mode.upper()}31 through the blocks")
            out[mode] = {"seconds_of_signal": len(iq) / fs,
                         "calls": len(parts), "run": run,
                         "busy_run": lambda run=run, parts=parts: run(
                             parts=parts[:BLOCK_PSK_BUSY_CALLS])}
    n = pll.psk31_pll.launches
    exact, err = held_to_plain(seen, pll.psk31_pll_reference)
    print(f"  PSK31 PLL launches {n}, each against the plain version: exact "
          f"{exact} (max |diff| {err:g})")
    if n != len(seen) or not exact:
        fail("[49] a PSK31 PLL launch differs from its plain version")
    for mode, o in out.items():             # timed apart from the counted run
        n_s = int(o["seconds_of_signal"] * fs)
        out[mode] = {**s6b_rate(
            f"{mode.upper()}31 session ({n_s} samples, {o['calls']} calls"
            f"{' and flush' if mode == 'qpsk' else ''}; busy share over "
            f"its first {BLOCK_PSK_BUSY_CALLS} calls)", o.pop("run"), n_s,
            "Msps", n_s * 8, busy_fn=o.pop("busy_run")), **o,
            "busy_share_calls": BLOCK_PSK_BUSY_CALLS}
    return n, err, out


def cw_block(P, one, dev):
    """[49] 10 s of Morse keyed by CwKeyedMod at 48 kHz in 1 s calls, each
    two-rate one-pole launch held to the plain version at every step:
    → (launches, readings)."""
    from orion_sdr_tpu_torch.modulate import analog as analog_mod
    n = int(BLOCK_CW_S * BLOCK_CW_FS)
    key = P.MorseEncoder(BLOCK_CW_FS, 20.0).encode_text(
        "CQ CQ DE ORION SDR BLOCKS K " * 4)[:n]
    key = np.ascontiguousarray(np.pad(key, (0, n - len(key))), np.float32)
    parts = s6b_chunks(key, BLOCK_CW_CHUNK)

    def run():
        blk = P.CwKeyedMod(BLOCK_CW_FS, 700.0, device=dev)
        return np.concatenate([blk.process(c) for c in parts])
    one.onepole_two_rate.launches = 0
    with recording(analog_mod, "onepole_two_rate") as seen:
        iq = run()
        torch.cuda.synchronize()
    launches = one.onepole_two_rate.launches
    exact = [onepole_steps_exact(one, *args, *o) for args, o in seen]
    mag = np.abs(iq)
    on = mag[(np.convolve(key, np.ones(961), "same") > 960.5)]
    off = mag[(np.convolve(key, np.ones(961), "same") < 0.5)]
    print(f"  CwKeyedMod: {n} samples in {n // BLOCK_CW_CHUNK} calls, "
          f"{launches} kernel B launches, each exact at every step "
          f"{all(exact)}; |iq| key down {on.min():.4f}-{on.max():.4f}, key up "
          f"max {off.max():.2e}")
    if (launches != n // BLOCK_CW_CHUNK or len(seen) != launches
            or not all(exact) or on.min() < 0.9 or off.max() > 0.1):
        fail("[49] CwKeyedMod")
    return launches, {**s6b_rate(f"CwKeyedMod ({n} samples, {launches} "
                                 f"calls)", run, n, "Msps", n * 12),
                      "samples": n, "calls": launches}


def ft8_codec_block(P, ldpc_bp, dev):
    """[49] Ft8Codec.decode_soft on BLOCK_FT8_ROWS noisy codewords, one
    call each: → (BP launches, max |kernel − plain|, readings)."""
    from orion_sdr_tpu_torch.codec.ft8 import _payload_to_codeword_bits
    rng = np.random.default_rng(S6B_SEED + 49)
    ht = P.CallsignHashTable()
    payloads = [bytes(np.asarray(P.pack77(m, ht), np.uint8))
                for m in ft_messages(P, BLOCK_FT8_ROWS)]
    codec = P.Ft8Codec(device=dev)
    llrs = []
    for p in payloads:
        cw = _payload_to_codeword_bits(np.frombuffer(p, np.uint8), dev)
        y = (1.0 - 2.0 * cw) + BLOCK_FT8_SIGMA * rng.standard_normal(174)
        llrs.append((2.0 * y / BLOCK_FT8_SIGMA ** 2).astype(np.float32))
    def run():
        return [codec.decode_soft(x) for x in llrs]
    ldpc_bp.bp_decode_kernel.launches = 0
    with recording_kernel(ldpc_bp, "bp_decode_kernel",
                          ("launches", "launches_edge")) as seen:
        got = run()
        torch.cuda.synchronize()
    n = ldpc_bp.bp_decode_kernel.launches
    back = sum(g == p for g, p in zip(got, payloads))
    exact, err = held_to_plain(seen, ldpc_bp.bp_decode_reference)
    print(f"  Ft8Codec.decode_soft: {back}/{BLOCK_FT8_ROWS} payloads back "
          f"(sigma {BLOCK_FT8_SIGMA}), {n} BP launches, each against the "
          f"plain version: exact {exact}")
    if back != BLOCK_FT8_ROWS or n != BLOCK_FT8_ROWS or len(seen) != n \
            or not exact:
        fail("[49] Ft8Codec.decode_soft")
    return n, err, {**s6b_rate(f"Ft8Codec.decode_soft ({BLOCK_FT8_ROWS} "
                               f"calls)", run, BLOCK_FT8_ROWS, "calls/s",
                               BLOCK_FT8_ROWS * (174 * 4 + 10)),
                    "payloads_back": back}


def stream_blocks(P, dev):
    """[49] analog and digital blocks: 2^BLOCK_LOG2_N samples in calls of
    2^BLOCK_LOG2_CHUNK samples (the digital modulators: 65 520 bits, a
    whole number of symbols of every order) against one call on the whole:
    the modulators and the digital demodulators exact, the analog
    demodulators within 1e-5 of the peak (their filter states cross the
    seams); Msps of the chunked run."""
    fs = 48_000.0
    n = 1 << BLOCK_LOG2_N
    rng = np.random.default_rng(S6B_SEED + 491)
    k = np.arange(n)
    iq = (np.exp(2j * np.pi * 1300.0 * k / fs) * (1 + 0.3 * np.sin(
        2 * np.pi * 400.0 * k / fs)) + 0.05 * (rng.standard_normal(n) + 1j
                                               * rng.standard_normal(n))
          ).astype(np.complex64)
    audio = (0.5 * np.sin(2 * np.pi * 700.0 * k / fs)).astype(np.float32)
    bits = rng.integers(0, 2, n - n % 24).astype(np.uint8)
    chunk = 1 << BLOCK_LOG2_CHUNK
    cases = {
        "FmQuadratureDemod": (lambda: P.FmQuadratureDemod(
            fs, 5000.0, 3000.0, device=dev), iq, chunk, 1e-5),
        "PmQuadratureDemod": (lambda: P.PmQuadratureDemod(
            fs, 1.0, 3000.0, device=dev), iq, chunk, 1e-5),
        "AmEnvelopeDemod": (lambda: P.AmEnvelopeDemod(
            fs, 3000.0, device=dev), iq, chunk, 1e-5),
        "AmEnvelopeDemod abs_approx": (lambda: P.AmEnvelopeDemod(
            fs, 3000.0, True, device=dev), iq, chunk, 1e-5),
        "CwEnvelopeDemod": (lambda: P.CwEnvelopeDemod(
            fs, 1300.0, 200.0, device=dev), iq, chunk, 1e-5),
        "AmDsbMod": (lambda: P.AmDsbMod(fs, 0.0, 1.0, 0.8, device=dev),
                     audio, chunk, None),
        "PmDirectPhaseMod": (lambda: P.PmDirectPhaseMod(fs, 1.0,
                                                        device=dev),
                             audio, chunk, None),
    }
    for name, order in (("Bpsk", None), ("Qpsk", None), ("Qam", 16),
                        ("Qam", 64), ("Qam", 256)):
        label = f"{name}{order or ''}"

        def mk(o=order, nm=name):
            return getattr(P, nm + "Mod")(*((o,) if o else ()), fs,
                                          device=dev)

        def dm(o=order, nm=name):
            return getattr(P, nm + "Demod")(*((o,) if o else ()),
                                            device=dev)
        cases[label + "Mod"] = (mk, bits, 65_520, None)
        cases[label + "Demod"] = (dm, mk().process(bits), chunk, None)
    out, bad = {}, []
    for name, (make, x, size, tol) in cases.items():
        parts = s6b_chunks(x, size)

        def chunked():
            b = make()
            return np.concatenate([b.process(c) for c in parts])
        whole = make().process(x)
        got = chunked()
        err = float(np.abs(got.astype(np.complex128) - whole).max())
        ok = (np.array_equal(got, whole) if tol is None
              else err <= tol * float(np.abs(whole).max()))
        rate = with_busy(s5_rate(
            f"{name} ({len(x)} samples in {len(parts)} calls; equal to one "
            f"call: {ok}, max |diff| {err:.2e})", chunked, len(x),
            x.nbytes + got.nbytes, runs=S6B_RUNS), chunked)
        out[name] = {**rate, "max_diff_vs_one_call": err}
        if not ok:
            bad.append(name)
    if bad:
        fail(f"[49] chunked blocks part from one call: {bad}")
    return out


def ofdm_blocks(P, dev):
    """[49] OfdmMod/OfdmDemod on [48]'s grid (one row of OFDM_SYMS
    symbols behind [48]'s echo) under both equalizers: every bit back."""
    out = {}
    for order in ("qpsk", "qam16"):
        cfg, cfg_s = s6b_grid(P, order)
        for eq, c in (("training_symbol", cfg), ("pilot_interp", cfg_s)):
            bits = np.random.default_rng(S6B_SEED + 492).integers(
                0, 2, OFDM_SYMS * c.bits_per_ofdm_symbol()).astype(np.uint8)
            g = c.grid()
            sps = g.n_fft + g.cp_len
            known = s6b_known(P, g.n_fft)
            train = P.multicarrier.ofdm_assemble(
                torch.as_tensor(known[None, :], device=dev), g.cp_len)
            t0 = time.perf_counter()
            iq = P.OfdmMod(c, device=dev).process(bits)
            rx = P.multipath_apply(torch.cat([train, torch.as_tensor(
                iq, device=dev)]), *OFDM_ECHO, device=dev)
            d = P.OfdmDemod(c, eq, device=dev)
            if eq == "training_symbol":
                f0 = P.multicarrier.symbol_fft(rx[:sps], g.n_fft, g.cp_len,
                                               n_symbols=1)[0]
                d.estimate_channel(f0.cpu().numpy(), known)
            x = rx[sps:].cpu().numpy()
            got = d.process(x)
            dt = time.perf_counter() - t0
            wrong = int((got[:len(bits)] != bits).sum())
            print(f"  OfdmMod/OfdmDemod {order} {eq}: {wrong} of {len(bits)} "
                  f"bits wrong, {dt:.3f} s (first run)")
            if wrong:
                fail(f"[49] OfdmMod/OfdmDemod {order} {eq}")
            out[f"{order} {eq}"] = {**s6b_rate(
                f"OfdmDemod {order} {eq} ({len(x)} samples a call)",
                lambda d=d, x=x: d.process(x), len(x), "Msps",
                x.nbytes + len(bits)), "bits": len(bits),
                "first_run_s": dt}
    return out


def blocks_phase(P, ldpc_bp, pll, one, dev):
    """[49]: → ({kernel: launches}, {kernel: max |kernel − plain|},
    readings)."""
    n_pll, pll_err, psk = psk31_blocks(P, pll, dev)
    n_one, cw = cw_block(P, one, dev)
    n_bp, bp_err, ft8 = ft8_codec_block(P, ldpc_bp, dev)
    streams_ = stream_blocks(P, dev)
    ofdm = ofdm_blocks(P, dev)
    return ({"bp": n_bp, "pll": n_pll, "one": n_one},
            {"bp": bp_err, "pll": pll_err},
            {"psk31": psk, "cw": cw, "ft8_codec": ft8, "chunked": streams_,
             "ofdm": ofdm})


# ── [50] checkpoint / resume ─────────────────────────────────────────────────


def resumed(P, make, parts, cut, run, tmp, make_after=None):
    """Feeds ``parts`` to one receiver uninterrupted, and to another up to
    part ``cut`` (cut inside a frame), saved with save_checkpoint, loaded
    into a fresh ``make_after()`` (``make()`` by default) and fed the
    rest. ``run(rx, parts, final)`` feeds and returns the outputs (with the
    flush when ``final``). → (uninterrupted, cut + resumed, bytes, save s,
    load s, the cut receiver, the file)."""
    whole = run(make(), parts, True)
    a = make()
    first = run(a, parts[:cut], False)
    path = os.path.join(tmp, "ckpt.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    P.save_checkpoint(path, a)
    t_save = time.perf_counter() - t0
    fresh = (make_after or make)()
    t0 = time.perf_counter()
    b = P.load_checkpoint(path, fresh)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    return (whole, first + run(b, parts[cut:], True),
            os.path.getsize(path), t_save, t_load, a, path)


def feed_list(rx, parts, final):
    out = []
    for c in parts:
        out += rx.feed(c)
    return out + (rx.flush() if final else [])


def feed_text(rx, parts, final):
    return "".join(rx.feed(c) for c in parts) + (rx.flush() if final
                                                  else "")


def feed_only(rx, parts, final):
    """FT8's stream decoder: its flush decodes the held buffer again."""
    return feed_list(rx, parts, False)


def feed_band(rx, parts, final):
    got = {}
    for c in parts:
        for ch, res in rx.feed(c).items():
            got.setdefault(ch, []).extend(res)
    if final:
        for ch, res in rx.flush().items():
            got.setdefault(ch, []).extend(res)
    return [(ch, r) for ch in sorted(got) for r in got[ch]]


def frame_key(P, r):
    """What a stream result says: the payload bytes of a frame (HP and LP
    for a hierarchical one), the message of an FT8 decode, else the error's
    kind."""
    if type(r) is tuple:                  # (channel, result) of a band
        return (r[0], frame_key(P, r[1]))
    if isinstance(r, P.RxFrame):
        return ("cofdm", r.packet.payload.tobytes())
    if isinstance(r, P.DvbTHierRxFrame):
        return ("hier", r.hp_payload.tobytes(),
                None if r.lp_payload is None else r.lp_payload.tobytes())
    if isinstance(r, P.DvbTRxFrame):
        return ("dvbt", r.payload.tobytes())
    if isinstance(r, P.Ft8DecodeResult):
        return ("ft8", repr(r.message))
    return ("error", repr(r))


def checkpoint_phase(P, ldpc_bp, viterbi, pll, dev):
    """[50] six streams cut mid-frame, checkpointed to a file and resumed
    in a fresh receiver on the card, and a QPSK31 stream moved from the
    card to the CPU: → ({kernel: launches}, {kernel: max |kernel −
    plain|}, readings)."""
    from orion_sdr_tpu_torch.demodulate import psk31 as psk31_mod
    rng = np.random.default_rng(S6B_SEED + 50)
    cfg, pre, table = link(P)
    cases = {}
    buf, payloads = stream_capture(P, dev, rng)        # [5]'s recipe
    cases["OfdmFrameStreamDemod ([5]'s 4 frames)"] = (
        lambda: P.OfdmFrameStreamDemod(cfg, table, pre, device=dev),
        s6b_chunks(buf, 20_000), feed_list, len(payloads))
    params = P.DvbTFrameParams(P.DvbTLinkParams("1/8", "qpsk", "1/2"), 0, 5)
    n_bytes = dvb_t_full_payload(P, params)
    mod = P.DvbTFrameMod(params, device=dev)
    parts = []
    for _ in range(CKPT_DVB_FRAMES):
        parts.append(np.zeros(int(rng.integers(0, 2000)), np.complex64))
        parts.append(mod.modulate(rng.integers(0, 256, n_bytes).astype(
            np.uint8)).iq)
    dbuf = add_noise(np.concatenate(parts + [np.zeros(3000, np.complex64)]),
                     10.0, rng)
    cases["DvbTFrameStreamDemod (QPSK r1/2)"] = (
        lambda: P.DvbTFrameStreamDemod(params, 68, n_bytes, device=dev),
        s6b_chunks(dbuf, STREAM_CHUNK), feed_list, CKPT_DVB_FRAMES)
    hlink, (n_hp, n_lp) = full_hier_payloads(P)
    hparams = P.DvbTHierFrameParams(hlink)
    hmod = P.DvbTHierFrameMod(hparams, device=dev)
    hbuf = np.concatenate(
        [np.zeros(500, np.complex64)]
        + [hmod.modulate(rng.integers(0, 256, n_hp).astype(np.uint8),
                         rng.integers(0, 256, n_lp).astype(np.uint8)).iq
           for _ in range(2)] + [np.zeros(300, np.complex64)])
    cases["DvbTHierFrameStreamDemod"] = (
        lambda: P.DvbTHierFrameStreamDemod(hparams, 68, n_hp, n_lp,
                                           device=dev),
        s6b_chunks(hbuf, STREAM_CHUNK), feed_list, 2)
    text = "CHECKPOINT ON THE CARD, RESUMED IN A FRESH RECEIVER"
    qiq = P.qpsk31_mod_text(text, 8000.0, 1000.0, device=dev).cpu().numpy()
    cases["Psk31Stream QPSK"] = (
        lambda: P.Psk31Stream.new_qpsk(8000.0, 1000.0, device=dev),
        s6b_chunks(qiq, 3001), feed_text, text)
    ht = P.CallsignHashTable()
    msg = P.Ft8Standard("CQ", "W1AW", "FN31")
    fiq = P.ft8_mod(P.ft8_encode(P.pack77(msg, ht), device=dev), FT_FS,
                    1012.5, device=dev)
    fbuf = np.concatenate([fiq.cpu().numpy(), np.zeros(28_320,
                                                       np.complex64)])
    fbuf = fbuf + host_noise(rng, len(fbuf), 0.05)
    cases["Ft8StreamDecoder"] = (
        lambda: P.Ft8StreamDecoder.new_ft8(FT_FS, 950.0, 1150.0, device=dev),
        s6b_chunks(fbuf, 30_000), feed_only, 1)
    bpay = [rng.integers(0, 256, 120).astype(np.uint8) for _ in range(3)]
    bmod = P.OfdmFrameMod(cfg, table, pre, device=dev)
    frames = [bmod.modulate_frame(P.FramePacket(P.FrameMetadata(i, 1), p), i)
              for i, p in enumerate(bpay)]
    centers = [-2.1e6, 0.3e6, 1.5e6]
    wide = wideband([f / 8.0 for f in frames], centers,
                    [3000 + 9000 * i for i in range(3)], 120_000, 8e6, 8,
                    rng, 0.001)
    cases["OfdmFrameBandStreamDemod ([33]'s 3 links)"] = (
        lambda: P.OfdmFrameBandStreamDemod(cfg, table, pre, centers, 8e6,
                                           device=dev),
        s6b_chunks(wide, 37_003), feed_band, 3)
    out, bad = {}, []
    ldpc_bp.bp_decode_kernel.launches = 0
    zero_vit(viterbi)
    pll.psk31_pll.launches = 0
    with tempfile.TemporaryDirectory() as tmp, \
            recording_kernel(ldpc_bp, "bp_decode_kernel",
                             ("launches", "launches_edge")) as seen_bp, \
            recording_kernel(viterbi, "viterbi_chunks_kernel",
                             ("launches", "launches_radix4")) as seen_vit, \
            recording(psk31_mod, "psk31_pll") as seen_pll:
        for name, (make, parts, run, want) in cases.items():
            cut = len(parts) // 2
            t0 = time.perf_counter()
            whole, got, size, t_save, t_load, cut_rx, path = resumed(
                P, make, parts, cut, run, tmp)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if isinstance(want, str):
                same, n_ok = whole == got, int(want in got)
                ok = same and want in whole
            else:
                kw, kg = ([frame_key(P, r) for r in x] for x in (whole, got))
                n_ok = sum(k[0] != "error" for k in kg)
                same = kw == kg
                ok = same and sum(k[0] != "error" for k in kw) == want
            print(f"  {name}: cut at part {cut} of {len(parts)}; resumed "
                  f"output equal to the uninterrupted run {same}, "
                  f"{n_ok} frames/texts back; checkpoint {size} bytes, save "
                  f"{t_save * 1e3:.2f} ms, load {t_load * 1e3:.2f} ms "
                  f"({dt:.2f} s for both runs)")
            fresh = make()
            out[name] = {
                "equal": same, "back": n_ok, "bytes": size,
                "first_save_ms": t_save * 1e3, "first_load_ms": t_load * 1e3,
                "save": s6b_rate(f"save_checkpoint ({size} bytes)",
                                 lambda: P.save_checkpoint(path, cut_rx), 1,
                                 "calls/s", size),
                "load": s6b_rate(f"load_checkpoint ({size} bytes)",
                                 lambda: P.load_checkpoint(path, fresh), 1,
                                 "calls/s", size)}
            if not ok:
                bad.append(name)
        torch.cuda.synchronize()
    n_bp = ldpc_bp.bp_decode_kernel.launches
    n_vit = read_vit(viterbi)
    n_pll = pll.psk31_pll.launches
    bp_exact, bp_err = held_to_plain(seen_bp, ldpc_bp.bp_decode_reference)
    vit_exact, vit_err = held_to_plain(
        seen_vit, lambda c0, c1, pm0, code:
        viterbi.viterbi_chunks_reference(c0, c1, pm0, code, 2))
    pll_exact, pll_err = held_to_plain(seen_pll, pll.psk31_pll_reference)
    print(f"  [50] launches: BP {n_bp}, Viterbi radix 2 {n_vit[0]} radix 4 "
          f"{n_vit[1]}, PSK31 PLL {n_pll}; each against its plain version: "
          f"exact {bp_exact}, {vit_exact}, {pll_exact}")
    if (bad or n_bp <= 0 or n_vit[0] <= 0 or n_vit[1] or n_pll <= 0
            or (n_bp, n_vit[0], n_pll)
            != (len(seen_bp), len(seen_vit), len(seen_pll))
            or not (bp_exact and vit_exact and pll_exact)):
        fail(f"[50] checkpoint/resume: {bad}")
    # the cross-device case: checkpointed on the card, finished on the CPU
    make, parts, run, want = cases["Psk31Stream QPSK"]
    with tempfile.TemporaryDirectory() as tmp:
        whole, got, size, t_save, t_load, _, _ = resumed(
            P, make, parts, len(parts) // 2, run, tmp,
            make_after=lambda: P.Psk31Stream.new_qpsk(8000.0, 1000.0,
                                                      device="cpu"))
    print(f"  Psk31Stream QPSK checkpointed on the card, finished on the "
          f"CPU: text equal {got == whole} ({size} bytes, save "
          f"{t_save * 1e3:.2f} ms, load {t_load * 1e3:.2f} ms)")
    if got != whole or want not in got:
        fail("[50] the card-to-CPU resume")
    out["Psk31Stream QPSK card -> CPU"] = {"equal": True, "bytes": size}
    return ({"bp": n_bp, "vit": n_vit, "pll": n_pll},
            {"bp": bp_err, "vit": vit_err, "pll": pll_err}, out)


# ── slice 7 (phase 51): the multi-device layer ──────────────────────────────

def s7_close(bad, label, got, ref, atol, rtol=0.0):
    """``got`` against ``ref`` (tensors on the card) within atol + rtol ×
    |ref|, printed; a failure is noted in ``bad``. → max |diff|."""
    ok = got.shape == ref.shape
    err = max_diff([got], [ref]) if ok else float("inf")
    ok = ok and bool(torch.allclose(got, ref, atol=atol, rtol=rtol))
    print(f"    {label}: {tuple(got.shape)}, max |sharded - one device| "
          f"{err:.3g} (tolerance {atol:g} + {rtol:g} x |ref|): "
          f"{'ok' if ok else 'FAILED'}")
    if not ok:
        bad.append(label)
    return err


def s7_overhead(label, fn8, fn1, shards=S7_SHARDS):
    """The sharded path ``fn8`` on the 8-shard mesh against ``fn1``, the
    same function on a 1-shard mesh of the card, for the same work: host ms
    of each (median of S7_RUNS runs after a warm-up), one run of each under
    torch.profiler (busy share), and the bytes each collective of one run
    of ``fn8`` moved between shards (parallel.mesh.traffic); printed."""
    from orion_sdr_tpu_torch.parallel import mesh as pmesh
    out = {}
    for name, fn in ((f"{shards} shards", fn8), ("1 shard", fn1)):
        med, runs = median_ms(fn, S7_RUNS)
        out[name] = with_busy({"median_ms": med, "runs_ms": runs}, fn)
    pmesh.traffic.clear()
    fn8()
    torch.cuda.synchronize()
    out["collective_bytes"] = dict(pmesh.traffic)
    r8, r1 = out[f"{shards} shards"], out["1 shard"]
    out["overhead"] = r8["median_ms"] / r1["median_ms"]
    print(f"  {label}: {shards} shards {r8['median_ms']:.4f} ms, 1 shard "
          f"{r1['median_ms']:.4f} ms ({out['overhead']:.3f}x; shards on one "
          f"card: overhead, not scaling); busy "
          f"{r8['busy_share'] and round(r8['busy_share'], 3)} / "
          f"{r1['busy_share'] and round(r1['busy_share'], 3)}; bytes "
          f"between shards {out['collective_bytes']}")
    return out


def s7_fir_fm(P, PP, mesh, one, dev, bad):
    """FIR (8 time shards) and the FM discriminator ((2, 4) shards) at
    [28]'s width, against fir_apply and the discriminator on one device."""
    from orion_sdr_tpu_torch.dsp.fir import fir_apply, kaiser_lowpass_taps
    gen = torch.Generator(device=dev).manual_seed(S7_SEED)
    x = torch.randn((FM_ROWS, 1 << FM_LOG2_N), dtype=torch.complex64,
                    device=dev, generator=gen)
    taps = kaiser_lowpass_taps(S7_FIR_TAPS, 0.25, 60.0)
    flat8, flat1 = mesh.flat(), one.flat()
    y1 = fir_apply(x, taps)[0]
    errs = {"fir": s7_close(bad, f"fir_overlap_save_sharded {FM_ROWS} x "
                            f"2^{FM_LOG2_N}, {S7_FIR_TAPS} taps",
                            PP.fir_overlap_save_sharded(x, taps, flat8), y1,
                            1e-5)}
    prev = torch.cat([torch.zeros_like(y1[:, :1]), y1[:, :-1]], dim=1)
    prod = y1 * torch.conj(prev)
    k = 1.0 / FM_DEV_HZ
    ref = (torch.atan2(prod.imag, prod.real) * k).to(torch.float32)
    fm = PP.fm_demod_sharded(x, taps, mesh, FM_FS, FM_DEV_HZ)
    errs["fm"] = s7_close(bad, f"fm_demod_sharded at {FM_FS:g} Hz, "
                          f"{FM_DEV_HZ:g} Hz deviation (from column 1)",
                          fm[:, 1:], ref[:, 1:], 1e-4)
    out = {"fir": s7_overhead(
        "fir_overlap_save_sharded",
        lambda: PP.fir_overlap_save_sharded(x, taps, flat8),
        lambda: PP.fir_overlap_save_sharded(x, taps, flat1)),
        "fm": s7_overhead(
        "fm_demod_sharded", lambda: PP.fm_demod_sharded(
            x, taps, mesh, FM_FS, FM_DEV_HZ),
        lambda: PP.fm_demod_sharded(x, taps, one, FM_FS, FM_DEV_HZ))}

    def make_fn(m):
        return PP.shard_channels(lambda z: fir_apply(z, taps)[0], m)

    def make_input(n):
        return (x[: n * S7_SCALE_ROWS],)
    rows = PP.measure_scaling(make_fn, make_input, [1, 2, 4, 8], S7_RUNS,
                              devices=[dev] * S7_SHARDS)
    print(f"  FIR by channel shards of the card ({S7_SCALE_ROWS} rows x "
          f"2^{FM_LOG2_N} a shard; shards on one card: overhead, not "
          f"scaling):")
    print("    " + PP.format_scaling_table(rows).replace("\n", "\n    "))
    out["fir_scaling_table"] = rows
    return out, errs


def s7_demap(P, PP, mesh, one, dev, bad):
    """The OFDM soft demap at [48]'s 2K grid, 64 x 68 symbols behind the
    echo at 20 dB, against soft_demap on one device: ZF with the held
    training estimate, pilot_interp, DFT precoding, CPE."""
    cfg, _ = s6b_grid(P, "qpsk")
    g = cfg.grid()
    sps = g.n_fft + g.cp_len
    _, iq = s6b_capture(P, cfg, OFDM_ROWS, OFDM_SYMS, dev, S7_SEED + 1)
    rx, _ = s6b_noise(P.multipath_apply(iq, *OFDM_ECHO, device=dev),
                      OFDM_SNR_DB, S7_SEED + 2)
    f0 = P.multicarrier.symbol_fft(rx[0, :sps], g.n_fft, g.cp_len,
                                   n_symbols=1)[0]
    est = P.channel_estimate_training(f0, s6b_known(P, g.n_fft))
    body = rx[:, sps:].contiguous()
    cases = {"ZF, held estimate": (cfg, est, 1e-4),
             "pilot_interp": (cfg.with_equalizer_method("pilot_interp"),
                              None, 1e-4),
             "DFT precoded": (cfg.with_transform_precoding(True), est, 1e-4),
             "CPE": (cfg.with_phase_tracking("cpe"), est, 1e-3)}
    errs, out = {}, {}
    for name, (c, e, tol) in cases.items():
        got = PP.ofdm_soft_demap_sharded(c, "qpsk", body, OFDM_SYMS, mesh,
                                         estimate=e)
        ref = P.soft_demap(c, "qpsk", body, OFDM_SYMS, e)
        errs[name] = s7_close(bad, f"ofdm_soft_demap_sharded {name}, "
                              f"{OFDM_ROWS} x {OFDM_SYMS} symbols", got, ref,
                              tol, tol)
        if name in ("ZF, held estimate", "CPE"):
            out[name] = s7_overhead(
                f"ofdm_soft_demap_sharded {name}",
                lambda c=c, e=e: PP.ofdm_soft_demap_sharded(
                    c, "qpsk", body, OFDM_SYMS, mesh, estimate=e),
                lambda c=c, e=e: PP.ofdm_soft_demap_sharded(
                    c, "qpsk", body, OFDM_SYMS, one, estimate=e))
    return out, errs


def s7_dvb_receive(P, PP, mesh, one, dev, rng, bad):
    """dvb_t_receive_sharded on 64 aligned frames of [8]'s link at 10 dB
    (8 modulated, each 8 times), against receive_frame_body on the
    batch."""
    from orion_sdr_tpu_torch.demodulate.dvb_t_frame import receive_frame_body
    params = P.DvbTFrameParams(P.DvbTLinkParams("1/8", "qpsk", "1/2"), 0, 3)
    mod = P.DvbTFrameMod(params, device=dev)
    n_bytes = dvb_t_full_payload(P, params)
    frames = [add_noise(mod.modulate(rng.integers(0, 256, n_bytes).astype(
        np.uint8)).iq, 10.0, rng) for _ in range(8)]
    segs = torch.as_tensor(np.stack(frames * 8), device=dev)
    args = (68, 256, 0, 2)
    got = PP.dvb_t_receive_sharded(segs, *args, mesh)
    ref = receive_frame_body(segs, *args)
    errs = {"llrs": s7_close(bad, "dvb_t_receive_sharded LLRs, 64 frames",
                             got[0], ref[0], 1e-3),
            "tps_cells": s7_close(bad, "dvb_t_receive_sharded TPS cells",
                                  got[1], ref[1], 1e-4)}
    return {"dvb_t_receive": s7_overhead(
        "dvb_t_receive_sharded, 64 frames",
        lambda: PP.dvb_t_receive_sharded(segs, *args, mesh),
        lambda: PP.dvb_t_receive_sharded(segs, *args, one))}, errs


def s7_psk31(P, PP, mesh, one, dev, seen, bad):
    """60 s of BPSK31 and QPSK31 at 8 kHz: the sharded demod against
    bpsk31_demod / qpsk31_demod on one device (1e-5), one PLL launch a
    call, and the sharded stream decode's text."""
    fs = 8000.0
    text = s6b_psk_text(P, BLOCK_PSK_S, fs)
    errs, out = {}, {}
    for name, mod, demod, qpsk in (
            ("BPSK31", P.bpsk31_mod_text, P.bpsk31_demod, False),
            ("QPSK31", P.qpsk31_mod_text, P.qpsk31_demod, True)):
        iq = mod(text, fs, device=dev)
        n0 = len(seen)
        got = PP.psk31_demod_sharded(iq, mesh, fs, qpsk=qpsk)
        if len(seen) - n0 != 1:
            bad.append(f"{name}: {len(seen) - n0} PLL launches a call")
        ref = demod(iq, fs, device=dev)
        errs[name] = s7_close(bad, f"psk31_demod_sharded {name}, "
                              f"{iq.shape[-1]} samples", got, ref, 1e-5)
        decoded = PP.psk31_stream_decode_sharded(iq, mesh, fs, qpsk=qpsk)
        print(f"    psk31_stream_decode_sharded {name}: {len(text)} "
              f"characters sent, text back {text in decoded}")
        if text not in decoded:
            bad.append(f"{name} text")
        out[name] = s7_overhead(
            f"psk31_demod_sharded {name}",
            lambda iq=iq, q=qpsk: PP.psk31_demod_sharded(iq, mesh, fs,
                                                          qpsk=q),
            lambda iq=iq, q=qpsk: PP.psk31_demod_sharded(iq, one, fs,
                                                          qpsk=q))
    return out, errs


def s7_trellis(P, PP, mesh, one, dev, iq, params, n_sym, n_bytes, bad):
    """viterbi_decode_sharded and forney_deinterleave_sharded alone, on the
    DVB-T capstone's own stream (the LLRs of its time-sharded receive, so
    their Viterbi launches are the capstone's): the decode equal to
    viterbi_decode_soft_chunked and the deinterleave to the host's
    forney_deinterleave, bit for bit; each timed at 8 shards and at 1."""
    from orion_sdr_tpu_torch.demodulate.dvb_t_frame import _ts_plan
    from orion_sdr_tpu_torch.fec.bch_device import bytes_from_bits
    from orion_sdr_tpu_torch.fec.conv import viterbi_decode_soft_chunked
    from orion_sdr_tpu_torch.fec.interleave import forney_deinterleave
    from orion_sdr_tpu_torch.sync.dvb_t_gi_sync import dvb_t_gi_sync
    from orion_sdr_tpu_torch.waveform.dvb_t_ts import TS_PAYLOAD_LEN
    cp = P.dvb_t_cp_len(params.link.guard)
    sps = 2048 + cp
    start = dvb_t_gi_sync(iq, 2048, cp, P.nb_bandwidth_fs(1e6),
                          sps).start_sample
    llrs, _ = PP.dvb_t_receive_time_sharded(
        iq[start:start + n_sym * sps], n_sym, cp, 0,
        P.BITS_PER_SYMBOL[params.link.constellation], mesh)
    inner = params.inner()
    plan = _ts_plan(-(-n_bytes // TS_PAYLOAD_LEN), inner)
    llrs = llrs.reshape(-1)[: plan.coded_bits].contiguous()
    args = (plan.outer_il_bits, inner.rate, inner.code)
    bits = PP.viterbi_decode_sharded(llrs, args[0], mesh, *args[1:])
    same_v = torch.equal(bits, viterbi_decode_soft_chunked(llrs, *args))
    byts = bytes_from_bits(bits[: bits.shape[0] // 8 * 8])
    deint = PP.forney_deinterleave_sharded(byts, mesh)
    same_f = np.array_equal(deint.cpu().numpy(),
                            forney_deinterleave(byts.cpu().numpy())[0])
    print(f"    viterbi_decode_sharded: {args[0]} trellis steps, equal to "
          f"viterbi_decode_soft_chunked {same_v}; "
          f"forney_deinterleave_sharded: {byts.shape[0]} bytes, equal to "
          f"forney_deinterleave {same_f}")
    if not (same_v and same_f):
        bad.append("viterbi / forney on the capstone's stream")
    return {"viterbi": s7_overhead(
        "viterbi_decode_sharded",
        lambda: PP.viterbi_decode_sharded(llrs, args[0], mesh, *args[1:]),
        lambda: PP.viterbi_decode_sharded(llrs, args[0], one, *args[1:])),
        "forney": s7_overhead(
        "forney_deinterleave_sharded",
        lambda: PP.forney_deinterleave_sharded(byts, mesh),
        lambda: PP.forney_deinterleave_sharded(byts, one)),
        "trellis_steps": args[0], "bytes": int(byts.shape[0])}


def s7_dvb_decode(P, PP, mesh, one, dev, rng, seen_vit, bad):
    """dvb_t_decode_time_sharded, payload- and TPS-equal to
    DvbTFrameDemod.decode: the largest whole-packet payloads that fit 1088
    symbols of 16-QAM r3/4 GI 1/32 at 18 dB and 272 symbols of
    tests/test_parallel.py's QPSK r1/2 GI 1/8 link without noise, each
    behind 1500 zeros; one Viterbi launch a shard. The first capture's
    Viterbi and Forney stages are also timed alone."""
    out = {}
    for label, (guard, order, rate, n_sym, snr) in S7_DVB.items():
        params = P.DvbTFrameParams(P.DvbTLinkParams(guard, order, rate), 0,
                                   7)
        n_bytes = dvb_t_full_payload(P, params, n_sym)
        payload = rng.integers(0, 256, n_bytes).astype(np.uint8)
        frame = P.DvbTFrameMod(params, device=dev).modulate(payload)
        iq = np.concatenate([np.zeros(1500, np.complex64), frame.iq])
        if snr is not None:
            iq = add_noise(iq, snr, rng)
        iq = torch.as_tensor(iq, device=dev)
        n0 = len(seen_vit)
        got = PP.dvb_t_decode_time_sharded(iq, frame.n_symbols, n_bytes,
                                           params, mesh)
        n_vit = len(seen_vit) - n0
        ref = P.DvbTFrameDemod(params, device=dev).decode(
            iq, frame.n_symbols, n_bytes)
        ok = (np.array_equal(got.payload, payload)
              and np.array_equal(got.payload, ref.payload)
              and got.tps == ref.tps and n_vit == S7_SHARDS)
        print(f"    dvb_t_decode_time_sharded {label}: {frame.n_symbols} "
              f"symbols, {iq.shape[0]} samples, {n_bytes} B payload: "
              f"payload and TPS equal to DvbTFrameDemod.decode and to the "
              f"sent payload {ok} ({n_vit} Viterbi launches)")
        if not ok:
            bad.append(f"dvb_t_decode_time_sharded {label}")
        r = s7_overhead(
            f"dvb_t_decode_time_sharded {label}",
            lambda iq=iq, p=params, f=frame, b=n_bytes:
            PP.dvb_t_decode_time_sharded(iq, f.n_symbols, b, p, mesh),
            lambda iq=iq, p=params, f=frame, b=n_bytes:
            PP.dvb_t_decode_time_sharded(iq, f.n_symbols, b, p, one))
        r["one_device_decode_ms"], _ = median_ms(
            lambda iq=iq, p=params, f=frame, b=n_bytes: P.DvbTFrameDemod(
                p, device=dev).decode(iq, f.n_symbols, b), S7_RUNS)
        print(f"    DvbTFrameDemod.decode on one device: "
              f"{r['one_device_decode_ms']:.4f} ms")
        out[label] = {**r, "symbols": frame.n_symbols, "samples":
                      int(iq.shape[0]), "payload_bytes": n_bytes,
                      "viterbi_launches": n_vit}
        if not out.get("stages"):
            out["stages"] = s7_trellis(P, PP, mesh, one, dev, iq, params,
                                       frame.n_symbols, n_bytes, bad)
    return out


def s7_cofdm(P, PP, mesh, one, dev, rng, seen_bp, bad):
    """ofdm_frame_decode_time_sharded on [4]'s link, one 1500-byte frame at
    each of MCS 0-3 (30 dB), and a pilot_interp + CPE link behind an echo,
    payload- and metadata-equal to OfdmFrameStreamDemod."""
    cfg, pre, table = link(P)
    plan = P.CarrierPlan(256, 64).with_pilot_carriers(PILOT_CARRIERS)
    pcfg = P.OfdmConfig(plan.with_contiguous_data(edge_guard=16), fs=1e6) \
        .with_equalizer_method("pilot_interp").with_phase_tracking("cpe")
    cases = [(f"MCS {m}", cfg, m, None) for m in range(4)] + [
        ("pilot_interp + CPE, MCS 1, echo", pcfg, 1, ([0, 5], [1.0, 0.4]))]
    out, bufs = {}, {}
    for label, c, mcs, echo in cases:
        payload = rng.integers(0, 256, PAYLOAD_BYTES).astype(np.uint8)
        meta = P.FrameMetadata(500 + mcs, mcs, 17 + mcs)
        iq = P.OfdmFrameMod(c, table, pre, device=dev).modulate_frame(
            P.FramePacket(meta, payload), 40 + mcs)
        buf = np.concatenate([np.zeros(700, np.complex64), iq,
                              np.zeros(300, np.complex64)])
        if echo is not None:
            buf = P.multipath_apply(buf, *echo, normalize=False,
                                    device="cpu").numpy()
        buf = torch.as_tensor(add_noise(buf, S7_COFDM_SNR_DB, rng), device=dev)
        n0 = len(seen_bp)
        got = PP.ofdm_frame_decode_time_sharded(c, table, pre, buf, mesh)
        n_bp = len(seen_bp) - n0
        s = P.OfdmFrameStreamDemod(c, table, pre, device=dev)
        ref = [r.packet for r in s.feed(buf) + s.flush()
               if hasattr(r, "packet")]
        ok = (len(ref) == 1 and np.array_equal(got.payload, payload)
              and np.array_equal(got.payload, ref[0].payload)
              and got.metadata == ref[0].metadata == meta and n_bp >= 2)
        print(f"    ofdm_frame_decode_time_sharded {label}: payload and "
              f"metadata equal to OfdmFrameStreamDemod and to the sent frame "
              f"{ok} ({n_bp} BP launches)")
        if not ok:
            bad.append(f"ofdm_frame_decode_time_sharded {label}")
        bufs[label] = (c, buf)
    c, buf = bufs["MCS 3"]
    out["MCS 3"] = s7_overhead(
        "ofdm_frame_decode_time_sharded MCS 3",
        lambda: PP.ofdm_frame_decode_time_sharded(c, table, pre, buf, mesh),
        lambda: PP.ofdm_frame_decode_time_sharded(c, table, pre, buf, one))
    return out


def s7_metrics(P, PP, mesh, one, dev, bad):
    """ber_sharded and power_spectrum_sharded on 64 x 2^20, against the
    same sums on one device."""
    gen = torch.Generator(device=dev).manual_seed(S7_SEED + 3)
    bits = torch.randint(0, 2, (FM_ROWS, 1 << FM_LOG2_N), generator=gen,
                         device=dev, dtype=torch.uint8)
    flips = (torch.rand(bits.shape, generator=gen, device=dev)
             < 1e-3).to(torch.uint8)
    hat = bits ^ flips
    flat8, flat1 = mesh.flat("ch"), one.flat("ch")
    ber, errs, n = PP.ber_sharded(bits, hat, flat8)
    want = (int(flips.sum()), bits.numel())
    print(f"    ber_sharded: {errs} errors of {n} bits (one device: "
          f"{want[0]} of {want[1]}), ber {ber:.6g}")
    if (errs, n) != want:
        bad.append("ber_sharded")
    x = torch.randn((FM_ROWS, 1 << FM_LOG2_N), dtype=torch.complex64,
                    device=dev, generator=gen)
    nfft = 1024
    spec = PP.power_spectrum_sharded(x, flat8, nfft)
    segs = x.reshape(FM_ROWS, -1, nfft)
    ref = (torch.fft.fft(segs, dim=-1).abs() ** 2).mean(dim=(0, 1))
    err = s7_close(bad, f"power_spectrum_sharded nfft {nfft}", spec, ref,
                   0.0, 2e-4)
    return {"ber": s7_overhead(
        "ber_sharded", lambda: PP.ber_sharded(bits, hat, flat8),
        lambda: PP.ber_sharded(bits, hat, flat1)),
        "power_spectrum": s7_overhead(
        "power_spectrum_sharded",
        lambda: PP.power_spectrum_sharded(x, flat8, nfft),
        lambda: PP.power_spectrum_sharded(x, flat1, nfft))}, err


def s7_two_processes(dev, bad):
    """tools/torch_distributed_smoke.py on the card: two processes join
    one gloo group, each counts its own rows' errors on the card, and
    ber_sharded's counts are all-reduced across them."""
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "torch_distributed_smoke.py")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([sys.executable, tool, "--device", str(dev),
                            "--rendezvous", tmp, "--timeout", "120"],
                           capture_output=True, text=True, timeout=150)
    dt = time.perf_counter() - t0
    ok = r.returncode == 0 and "PASS" in r.stdout
    lines = [ln for ln in r.stdout.splitlines() if "proc " in ln]
    print(f"    two processes under gloo, the local work on {dev}: "
          f"{'; '.join(lines)} ({dt:.1f} s): {'ok' if ok else 'FAILED'}")
    if not ok:
        print(r.stdout[-2000:], r.stderr[-2000:])
        bad.append("two-process gloo ber_sharded")
    return {"ok": ok, "seconds": dt}


def parallel_phase(P, ldpc_bp, viterbi, pll, outer_fec, bd, dev):
    """[51] the multi-device layer on one Mesh of 8 shards of the card,
    each sharded path against the port's one-device path on the same
    inputs; every BP, Viterbi, PSK31 PLL and outer-code launch recorded and
    held to its plain version: → ({kernel: launches}, {kernel: max |kernel
    − plain|}, readings)."""
    from orion_sdr_tpu_torch import graft_entry
    from orion_sdr_tpu_torch import parallel as PP
    from orion_sdr_tpu_torch.demodulate import psk31 as psk31_mod
    devs = [dev] * S7_SHARDS
    mesh = PP.make_mesh(S7_SHARDS, shape=S7_SHAPE, devices=devs)
    one = PP.make_mesh(1, shape=(1, 1), devices=devs[:1])
    rng = np.random.default_rng(S7_SEED)
    bad, out, errs = [], {}, {}
    ldpc_bp.bp_decode_kernel.launches = 0
    zero_vit(viterbi)
    pll.psk31_pll.launches = 0
    OUTER.zero()
    with recording_kernel(ldpc_bp, "bp_decode_kernel",
                          ("launches", "launches_edge")) as seen_bp, \
            recording_kernel(viterbi, "viterbi_chunks_kernel",
                             ("launches", "launches_radix4")) as seen_vit, \
            recording_kernel(pll, "psk31_pll") as seen_pll, \
            recording(psk31_mod, "psk31_pll") as seen_pll_1, \
            recording_kernel(outer_fec, "bch_decode_kernel") as seen_bch, \
            recording_kernel(outer_fec, "rs_decode_kernel") as seen_rs:
        t0 = tick = time.perf_counter()

        def took():
            nonlocal tick
            now = time.perf_counter()
            print(f"    ({now - tick:.1f} s)")
            tick = now
        print(f"  [51] FIR and FM at {FM_ROWS} x 2^{FM_LOG2_N}, {FM_FS:g} "
              f"Hz, {S7_FIR_TAPS} taps")
        out["fir_fm"], errs["fir_fm"] = s7_fir_fm(P, PP, mesh, one, dev, bad)
        took()
        print(f"  [51] OFDM soft demap, {OFDM_ROWS} x {OFDM_SYMS} symbols of "
              f"the 2K grid")
        out["ofdm_demap"], errs["ofdm_demap"] = s7_demap(P, PP, mesh, one,
                                                         dev, bad)
        took()
        print("  [51] service-parallel DVB-T receive, 64 frames")
        out["dvb_t_receive"], errs["dvb_t_receive"] = s7_dvb_receive(
            P, PP, mesh, one, dev, rng, bad)
        took()
        print(f"  [51] PSK31, {BLOCK_PSK_S:g} s at 8 kHz")
        out["psk31"], errs["psk31"] = s7_psk31(P, PP, mesh, one, dev,
                                               seen_pll, bad)
        took()
        print("  [51] dvb_t_decode_time_sharded")
        out["dvb_t_decode"] = s7_dvb_decode(P, PP, mesh, one, dev, rng,
                                            seen_vit, bad)
        took()
        print("  [51] ofdm_frame_decode_time_sharded")
        out["cofdm_decode"] = s7_cofdm(P, PP, mesh, one, dev, rng, seen_bp,
                                       bad)
        took()
        print(f"  [51] ber_sharded and power_spectrum_sharded, {FM_ROWS} x "
              f"2^{FM_LOG2_N}")
        out["metrics"], errs["power_spectrum"] = s7_metrics(P, PP, mesh, one,
                                                            dev, bad)
        took()
        print("  [51] cross-process: two processes under gloo")
        out["two_processes"] = s7_two_processes(devs[0], bad)
        took()
        t1 = time.perf_counter()
        graft_entry.dryrun_multichip(S7_SHARDS, devs)
        fn, args = graft_entry.entry(device=dev)
        shape = tuple(fn(*args).shape)
        torch.cuda.synchronize()
        print(f"    dryrun_multichip({S7_SHARDS}, {S7_SHARDS} x {devs[0]}): "
              f"every path and both capstones ok "
              f"({time.perf_counter() - t1:.1f} s); entry() -> {shape}")
        out["dryrun_s"] = time.perf_counter() - t1
        out["paths_s"] = time.perf_counter() - t0
    n_bp = ldpc_bp.bp_decode_kernel.launches
    n_vit = read_vit(viterbi)
    n_pll = pll.psk31_pll.launches
    outer = OUTER.read("51")
    t2 = time.perf_counter()
    bp_exact, bp_err = held_to_plain(seen_bp, ldpc_bp.bp_decode_reference)
    vit_exact, vit_err = held_to_plain(
        seen_vit, lambda c0, c1, pm0, code:
        viterbi.viterbi_chunks_reference(c0, c1, pm0, code, 2))
    pll_exact, pll_err = held_to_plain(seen_pll + seen_pll_1,
                                       pll.psk31_pll_reference)
    bch_exact, bch_err = held_to_plain(seen_bch,
                                       bd.bch_decode_batch_reference)
    rs_exact, rs_err = held_to_plain(seen_rs, bd.rs_decode_batch_reference)
    out["held_s"] = time.perf_counter() - t2
    print(f"  [51] launches: BP {n_bp}, Viterbi radix 2 {n_vit[0]} radix 4 "
          f"{n_vit[1]}, PSK31 PLL {n_pll}, BCH {outer['bch']}, RS "
          f"{outer['rs']}; each against its plain version on its own inputs "
          f"({out['held_s']:.1f} s): exact {bp_exact}, {vit_exact}, "
          f"{pll_exact}, {bch_exact}, {rs_exact}")
    if (bad or n_bp <= 0 or n_vit[0] <= 0 or n_vit[1] or n_pll <= 0
            or outer["rs"] <= 0
            or (n_bp, n_vit[0], n_pll, outer["bch"], outer["rs"])
            != (len(seen_bp), len(seen_vit), len(seen_pll) + len(seen_pll_1),
                len(seen_bch), len(seen_rs))
            or not (bp_exact and vit_exact and pll_exact and bch_exact
                    and rs_exact)):
        fail(f"[51] the multi-device layer: {bad}")
    return ({"bp": n_bp, "vit": n_vit, "pll": n_pll, "outer": outer},
            {"bp": bp_err, "vit": vit_err, "pll": pll_err,
             "outer": max(bch_err, rs_err), "paths": errs}, out)


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

    from orion_sdr_tpu_torch.ops import outer_fec, viterbi
    from orion_sdr_tpu_torch.fec import bch_device
    from orion_sdr_tpu_torch.frame import chain
    from orion_sdr_tpu_torch.ops import onepole_two_rate, psk31_pll
    from orion_sdr_tpu_torch.ops import dd_pll, gardner, gnss_track
    with ThreadPoolExecutor(8) as pool:       # one nvcc per source, together
        builds = [pool.submit(m.build) for m in (
            ldpc_bp, viterbi, outer_fec, psk31_pll, onepole_two_rate, dd_pll,
            gardner, gnss_track)]
        (built, vit_built, outer_built, pll_built, one_built, dd_built,
         ga_built, tk_built) = [b.result() for b in builds]
    global OUTER
    OUTER = OuterSpy(chain, outer_fec, bch_device)
    print(f"[2] built {built.path} in {built.seconds:.2f} s")
    print_ptxas(built)
    bp_plans = print_bp_plans(ldpc_bp)

    rng = np.random.default_rng(SEED)
    print(f"[3] BP kernel vs plain version (exact), B={BP_BATCH}+{BP_GARBAGE}")
    max_err, times, bp_bnd, bp_iters = kernel_vs_plain(ldpc_bp, dev, rng)

    print(f"[4] batch path: {N_FRAMES} frames x {PAYLOAD_BYTES} B")
    # BP launches of each run that drives a decode path, counted from 0 just
    # before it, as the Viterbi launches below
    OUTER.zero()
    bp_runs, recorded = batch_path(P, ldpc_bp, dev, rng)
    outer_runs = {"4": OUTER.read("4")}
    bp_runs = {f"4 {rule}": n for rule, n in bp_runs.items()}
    batches = path_batches(recorded)
    print("[3] (cont.) kernel vs plain version (exact) and sum_product times "
          "at the batches [4] handed the BP kernel")
    path_err, bp_path = bp_path_times(ldpc_bp, batches, "sum_product")
    max_err = max(max_err, path_err)

    print("[5] stream path: 4 frames, 37 Hz CFO, 20000-sample chunks")
    OUTER.zero()
    bp_runs["5"] = stream_path(P, ldpc_bp, dev, rng)
    outer_runs["5"] = OUTER.read("5")

    print(f"[6] built {vit_built.path} in {vit_built.seconds:.2f} s")
    print_ptxas(vit_built)
    plans = print_plans(viterbi)

    print(f"[7] Viterbi kernel vs plain version (exact): chunked dvb_k7 "
          f"L={VIT_LANES} x {VIT_SPAN}, terminated 128 x 4096")
    vit_err, vit_ms, vit_plain_ms = viterbi_vs_plain(viterbi, dev, rng)

    print(f"[8] DVB-T batch: {DVB_FRAMES} QPSK r1/2 GI 1/8 frames at 6 dB, "
          f"{DVB_QAM_FRAMES} 16-QAM r3/4 frames at 15 dB")
    # (radix-2, radix-4) launches of each run that drives a decode path,
    # counted from 0 just before it (comparisons with the plain versions are
    # not counted); every run but [13]'s forced one is a default path
    OUTER.zero()
    vit_runs = {"8": dvb_t_batch(P, viterbi, dev, rng)}
    outer_runs["8"] = OUTER.read("8")

    print("[9] DVB-T single frame at an unknown offset, 4 dB")
    zero_vit(viterbi)
    OUTER.zero()
    dvb_t_unknown_offset(P, dev)
    vit_runs["9"] = read_vit(viterbi)
    outer_runs["9"] = OUTER.read("9")

    print(f"[10] COFDM conv+RS link: {COFDM_CONV_FRAMES} frames x 300 B")
    OUTER.zero()
    vit_runs["10"] = cofdm_conv_batch(P, viterbi, dev, rng)
    outer_runs["10"] = OUTER.read("10")

    print(f"[11] radix-4 Viterbi kernel vs plain version (exact): chunked "
          f"dvb_k7 L={VIT_LANES} x {VIT_SPAN}, terminated k5 128 x 4096")
    r4_err, r4_ms, r4_plain_ms = radix4_vs_plain(viterbi, dev, rng)

    print(f"[12] BP sum_product_edge vs plain version (exact), "
          f"B={BP_BATCH}+{BP_GARBAGE}")
    (edge_err, edge_ms, edge_plain_ms, edge_bnd, edge_launches, edge_iters,
     edge_path) = edge_vs_plain(ldpc_bp, dev, rng, batches)

    print(f"[13] hierarchical link: {HIER_FRAMES} full 16-QAM a=2 GI 1/8 "
          f"frames, HP r1/2 + LP r3/4, radix 2 then radix 4")
    OUTER.zero()
    vit_runs["13"], vit_runs[FORCED], (path_err, path_ms, path_lanes) = \
        hier_link(P, viterbi, dev, rng)
    outer_runs["13"] = OUTER.read("13")
    vit_err = max(vit_err, path_err[2])
    r4_err = max(r4_err, path_err[4])

    print("[14] super-frame: 4 full QPSK r1/2 frames, 12 dB")
    zero_vit(viterbi)
    OUTER.zero()
    super_frame(P, dev, rng)
    vit_runs["14"] = read_vit(viterbi)
    outer_runs["14"] = OUTER.read("14")

    print(f"[15] streams: {STREAM_FRAMES} QPSK frames at random gaps < 2000 "
          f"samples, 10 dB, "
          f"{STREAM_CHUNK}-sample chunks; 2 hierarchical frames")
    zero_vit(viterbi)
    OUTER.zero()
    streams(P, dev, rng)
    vit_runs["15"] = read_vit(viterbi)
    outer_runs["15"] = OUTER.read("15")

    print("[16] blind decode: a plain and a hierarchical frame")
    zero_vit(viterbi)
    OUTER.zero()
    blind(P, dev, rng)
    vit_runs["16"] = read_vit(viterbi)
    outer_runs["16"] = OUTER.read("16")
    default = [p for p in vit_runs if p != FORCED]
    by_phase = {radix: {p: n[k] for p, n in vit_runs.items()}
                for k, radix in enumerate((2, 4))}
    print(f"  Viterbi launches by phase, radix 2: {by_phase[2]}; radix 4: "
          f"{by_phase[4]} (default paths: all but {FORCED!r})")
    if any(by_phase[4][p] for p in default):
        fail("a default path launched the radix-4 Viterbi kernel")
    print(f"  BP launches by phase: slab rules {bp_runs}; sum_product_edge "
          f"{{'12': {edge_launches}}}")

    OUTER.hold = False
    print(f"[17] outer-code kernel vs plain version vs native host decoder "
          f"(exact): every BCH and RS launch of [4]-[16], BCH t=8 at "
          f"{BCH_ROWS}, RS(204,188) at {RS_ROWS}, small batches, and the "
          f"{len(OUTER.recorded)} batches [4] and [8] handed the outer "
          f"decoder")
    print(f"  built {outer_built.path} in {outer_built.seconds:.2f} s")
    outer_regs = outer_ptxas(outer_built)
    outer_err, outer_held_n = outer_held(P, bch_device, OUTER.take_held(),
                                         "[4]-[16]")
    err17, outer_main = outer_phase_exact(P, outer_fec, bch_device, dev, rng)
    outer_err = max(outer_err, err17)
    print("[18] outer-code times: kernel at each batch with its bound and "
          "launch plan, plain version (CUDA events), the lanes and "
          "blocks-an-SM sweep, the chain's outer decode on each path (host "
          "clock, copies included) and the block-count sweep")
    outer_t = outer_phase_times(P, outer_fec, bch_device, outer_main, dev)
    OUTER.hold = True
    outer_runs.update(new_links(P, dev, rng))
    print(f"  outer-kernel launches by phase (BCH / RS; decodes due at the "
          f"threshold {chain._DEVICE_OUTER_MIN_BLOCKS}): " + "; ".join(
              f"[{ph}] {r['bch']} / {r['rs']} ({r['due']} due of "
              f"{r['decodes']} decodes, up to {r['max_blocks']} blocks)"
              for ph, r in outer_runs.items()))

    t_ft = time.perf_counter()
    print(f"[25] FT8/FT4 batched receive: ft8_decode_windows / "
          f"ft4_decode_windows(device='cuda') on {FT_WINDOWS} windows, "
          f"{FT_SIGNALS} frames, then with ft8_ap_prior('CQ')")
    ft_batches, ft_stats = {}, {}
    for mode in ("ft8", "ft4"):
        runs, b, ft_stats[mode] = ft_receive(P, ldpc_bp, dev, rng, mode)
        bp_runs.update(runs)
        ft_batches.update(b)
    print(f"  [25] took {time.perf_counter() - t_ft:.1f} s")
    t_ft = time.perf_counter()
    print(f"[26] BP kernel on ft8_174_91 (D 7, exact width 7) vs plain "
          f"version (exact): [25]'s batches, {FT_BP_ROWS} + {BP_GARBAGE} rows")
    ft_err, ft_k_ms, ft_p_ms, ft_bnd, ft_at25, ft_regs = ft_bp_phase(
        ldpc_bp, built, dev, rng, ft_batches)
    max_err = max(max_err, ft_err)
    print(f"  [26] took {time.perf_counter() - t_ft:.1f} s")
    t_ft = time.perf_counter()
    print("[27] FT8/FT4 TX and the other decoders: ft8_mod_batch + "
          "ft8_demod, the stream decoders at their floors, multi-frame, "
          "multi-signal")
    bp_runs.update(ft_others(P, ldpc_bp, dev, rng))
    print(f"  [27] took {time.perf_counter() - t_ft:.1f} s")
    print(f"  BP launches by phase: slab rules {bp_runs}; sum_product_edge "
          f"{{'12': {edge_launches}}}")

    t_s4 = time.perf_counter()
    print(f"[28] FM chain (the JAX bench's fm_demod_chain_throughput): "
          f"{FM_ROWS} x 2^{FM_LOG2_N} at {FM_FS:g} Hz, then fm_mod -> "
          f"fm_demod of a 1 kHz tone at 75 kHz deviation")
    fm_stats = fm_phase(P, dev)
    print(f"  [28] took {time.perf_counter() - t_s4:.1f} s")
    t_s4 = time.perf_counter()
    print(f"[29] PSK31 roundtrip (psk31_roundtrip_throughput): {PSK_ROWS} x "
          f"{PSK_BITS} bits, batched DBPSK crossfade -> bpsk31_demod; PLL "
          f"kernel vs plain version")
    for line in pll_built.log.splitlines():
        if "registers" in line or "spill" in line:
            print("   ", line.strip())
    pll_runs = {}
    pll_runs["29"], psk_stats, pll_stats = psk31_phase(P, psk31_pll, dev)
    print(f"  [29] took {time.perf_counter() - t_s4:.1f} s")
    t_s4 = time.perf_counter()
    print("[30] PSK31 receivers: three-carrier band decode, QPSK band, "
          "Psk31Stream at -5 / -6 dB (five seeds each), batch Viterbi")
    runs30, vit_psk_ms = psk31_receivers(P, psk31_pll, dev)
    pll_runs.update(runs30)
    print(f"  PLL launches by phase: {pll_runs}")
    print(f"  [30] took {time.perf_counter() - t_s4:.1f} s")
    t_s4 = time.perf_counter()
    print(f"[31] two-rate one-pole kernel: agc_rms (real, complex) and cw_mod "
          f"vs plain version at {ONEPOLE_ROWS} x {ONEPOLE_CMP}; agc_rms and "
          f"cw_mod at {ONEPOLE_ROWS} x 2^{ONEPOLE_LOG2_N}")
    for line in one_built.log.splitlines():
        if "registers" in line or "spill" in line:
            print("   ", line.strip())
    one_stats = onepole_phase(P, onepole_two_rate, dev)
    print(f"  [31] took {time.perf_counter() - t_s4:.1f} s")

    t_s5 = time.perf_counter()
    print(f"[32] PFB channelizer (pfb_channelizer_throughput): C={PFB_C}, "
          f"n=2^{PFB_LOG2_N}")
    pfb_stats = pfb_phase(P, dev)
    print(f"  [32] took {time.perf_counter() - t_s5:.1f} s")
    t_s5 = time.perf_counter()
    print("[33] band receivers on the card: COFDM (three links, BP), DVB-T "
          "(two muxes, Viterbi), AM blind scan, SSB, FM band stereo + RDS, "
          "the channelizer under two chunkings")
    (bp_runs["33"], edge33, bp33_err, vit_runs["33"], vit33_err,
     band_stats) = band_phase(P, ldpc_bp, viterbi, dev, rng)
    max_err = max(max_err, bp33_err)
    vit_err = max(vit_err, vit33_err)
    default = [p for p in vit_runs if p != FORCED]
    by_phase = {radix: {p: n[k] for p, n in vit_runs.items()}
                for k, radix in enumerate((2, 4))}
    if any(by_phase[4][p] for p in default):
        fail("a default path launched the radix-4 Viterbi kernel")
    print(f"  BP launches by phase: slab rules {bp_runs}; sum_product_edge "
          f"{{'12': {edge_launches}, '33': {edge33}}}; Viterbi radix 2: "
          f"{by_phase[2]}")
    print(f"  [33] took {time.perf_counter() - t_s5:.1f} s")
    t_s5 = time.perf_counter()
    print(f"[34] FM stereo + RDS (fm_stereo_rds_throughput): _stereo_device "
          f"at 1 and {STEREO_ROWS} x 2^{STEREO_LOG2_N}, RDS text, "
          f"separation")
    stereo_stats = stereo_phase(P, dev)
    print(f"  [34] took {time.perf_counter() - t_s5:.1f} s")
    t_s5 = time.perf_counter()
    print(f"[35] CSS (css_dechirp_throughput): SF {CSS_SF} x {CSS_SYMS} "
          f"symbols; roundtrip SF 7-12")
    css_stats = css_phase(P, dev)
    print(f"  [35] took {time.perf_counter() - t_s5:.1f} s")
    t_s5 = time.perf_counter()
    print("[36] WSPR (wspr_energy_grid_throughput): 166 x 8192, 9 dt x 7 "
          "df; three-beacon band decode")
    wspr_stats = wspr_phase(P, dev)
    print(f"  [36] took {time.perf_counter() - t_s5:.1f} s")

    t_s5 = time.perf_counter()
    print(f"[37] DD-PLL kernel vs plain version (exact), every order, "
          f"{' and '.join(str(r) for r in BURST_ROWS)} x {BURST_SYMS} "
          f"symbols")
    for b in (dd_built, ga_built, tk_built):
        print(f"  built {b.path} in {b.seconds:.2f} s")
        print_ptxas(b)
    dd_err, dd_stats = dd_pll_phase(P, dd_pll, dev)
    print(f"  [37] took {time.perf_counter() - t_s5:.1f} s")
    t_s5 = time.perf_counter()
    print(f"[38] Gardner kernel vs plain version (exact): {GARDNER_ROWS} x "
          f"2^{GARDNER_LOG2_N} samples, sps {BURST_SPS}")
    ga_err, ga_stats = gardner_phase(P, gardner, dev)
    print(f"  [38] took {time.perf_counter() - t_s5:.1f} s")
    t_s5 = time.perf_counter()
    print(f"[39] burst modem (burst_modem_throughput): {BURST_ROWS} x "
          f"{BURST_SYMS * BURST_SPS} samples; burst_mod -> burst_demod for "
          f"every order; digital_mod -> digital_demod at 12 kHz")
    dd_runs, burst_stats, burst_err = burst_phase(P, dd_pll, dev)
    dd_err = max(dd_err, burst_err)
    print(f"  [39] took {time.perf_counter() - t_s5:.1f} s")
    t_s5 = time.perf_counter()
    print("[40] GNSS acquisition (gnss_acquisition_throughput): 32 PRNs x "
          "41 Dopplers x 2048, 4 blocks; gps_acquire on three satellites")
    acq_stats = acquire_phase(P, dev)
    print(f"  [40] took {time.perf_counter() - t_s5:.1f} s")
    t_s5 = time.perf_counter()
    print(f"[41] tracking kernel vs plain version (exact): {TRACK_SATS} "
          f"satellites x {TRACK_EPOCHS} epochs; gnss_tracking_throughput; "
          f"the ~18.7 s capture -> ephemeris path")
    tk_err, tk_runs, tk_stats = track_phase(P, gnss_track, dev)
    print(f"  [41] took {time.perf_counter() - t_s5:.1f} s")
    t_s5 = time.perf_counter()
    print(f"[42] 2-FSK family (fsk2_engine_throughput): fsk2_decision at "
          f"{FSK_ROWS} x 2^{FSK_LOG2_N}; AX.25, the stream TNC, RTTY, POCSAG,"
          f" AIS")
    fsk_stats = fsk2_phase(P, dev)
    print(f"  [42] took {time.perf_counter() - t_s5:.1f} s")
    ga_runs, ga_path_err = gardner_path(P, gardner, dev)
    ga_err = max(ga_err, ga_path_err)
    print(f"  launches by phase: DD-PLL {dd_runs}, Gardner {ga_runs}, "
          f"tracking {tk_runs}")

    t_s6 = time.perf_counter()
    print(f"[43] capture I/O (2^{IO_LOG2_N} samples) and the channel "
          f"simulator: the seven impairments at {CH_ROWS} x 2^{CH_LOG2_N}; "
          f"COFDM, DVB-T and FT8 links through the channel")
    bp43, vit_runs["43"], bp43_err, vit43_err, ch_stats = channel_phase(
        P, ldpc_bp, viterbi, dev)
    bp_runs["43"] = bp43
    max_err = max(max_err, bp43_err)
    vit_err = max(vit_err, vit43_err)
    print(f"  [43] took {time.perf_counter() - t_s6:.1f} s")
    t_s6 = time.perf_counter()
    print(f"[44] Morse: a {MORSE_N / MORSE_FS:g} s {MORSE_FS / 1e3:g} kHz CW "
          f"band of {MORSE_SIGS} stations through morse_decode_band")
    one_runs = {"31": one_stats["launches"]}
    one_runs["44"], morse_stats = morse_phase(P, onepole_two_rate, dev)
    print(f"  [44] took {time.perf_counter() - t_s6:.1f} s")
    t_s6 = time.perf_counter()
    print(f"[45] band monitor: band_survey + band_decode on a "
          f"{BAND_FS / 1e6:g} Msps capture of 2^{BAND_LOG2_N} samples; CW, "
          f"RTTY and PSK31 at the JAX tests' widths")
    pll_runs["45"], pll45_err, one_runs["45"], band6_stats = band_phase6(
        P, onepole_two_rate, psk31_pll, dev)
    print(f"  [45] took {time.perf_counter() - t_s6:.1f} s")
    t_s6 = time.perf_counter()
    print(f"[46] ADS-B: {ADSB_PLANES * 5} DF17 frames from {ADSB_PLANES} "
          f"aircraft at {ADSB_FS / 1e6:g} Msps, 2^{ADSB_LOG2_N} samples")
    adsb_stats = adsb_phase(P, dev)
    print(f"  [46] took {time.perf_counter() - t_s6:.1f} s")
    t_s6 = time.perf_counter()
    print(f"[47] SSTV: a 320 x 256 Martin M1 picture at "
          f"{' and '.join(f'{f:g}' for f in SSTV_RATES)} Hz")
    sstv_stats = sstv_phase(P, dev)
    print(f"  [47] took {time.perf_counter() - t_s6:.1f} s")
    t_s6b = t_s6 = time.perf_counter()
    print(f"[48] generic OFDM receive and OTFS on dvb_t_config(\"1/4\", "
          f"{OFDM_BW:g}) (n_fft 2048, cp 512), QPSK and 16-QAM, "
          f"{OFDM_ROWS} x {OFDM_SYMS} symbols (OTFS {OTFS_SYMS}, n_doppler "
          f"{OTFS_DOPPLER}): echo {OFDM_ECHO[0]}, {OFDM_SNR_DB:g} dB, "
          f"Watterson")
    from orion_sdr_tpu_torch.demodulate import psk31 as psk31_mod
    ldpc_bp.bp_decode_kernel.launches = 0
    zero_vit(viterbi)
    psk31_pll.psk31_pll.launches = 0
    onepole_two_rate.onepole_two_rate.launches = 0
    with recording_kernel(ldpc_bp, "bp_decode_kernel",
                          ("launches", "launches_edge")) as seen_bp, \
            recording_kernel(viterbi, "viterbi_chunks_kernel",
                             ("launches", "launches_radix4")) as seen_vit, \
            recording(psk31_mod, "psk31_pll") as seen_pll:
        ofdm48_stats = ofdm_rx_phase(P, dev)
        torch.cuda.synchronize()
    n48 = (ldpc_bp.bp_decode_kernel.launches, read_vit(viterbi),
           psk31_pll.psk31_pll.launches,
           onepole_two_rate.onepole_two_rate.launches)
    print(f"  [48] launches of BP, Viterbi (radix 2, 4), the PSK31 PLL and "
          f"kernel B: {n48} (the path is torch.fft and elementwise work); "
          f"{time.perf_counter() - t_s6:.1f} s")
    if (n48[0] or any(n48[1]) or n48[2] or n48[3] or seen_bp or seen_vit
            or seen_pll):
        fail("[48] launched a kernel its path should not reach")
    t_s6 = time.perf_counter()
    print(f"[49] the Block classes: {BLOCK_PSK_S:g} s of BPSK31 and QPSK31 "
          f"in {BLOCK_PSK_CHUNK}-sample calls, {BLOCK_CW_S:g} s of CW at "
          f"{BLOCK_CW_FS / 1e3:g} kHz, Ft8Codec on {BLOCK_FT8_ROWS} "
          f"codewords, 2^{BLOCK_LOG2_N} samples of the analog and digital "
          f"blocks in 2^{BLOCK_LOG2_CHUNK}-sample calls, OfdmMod/OfdmDemod")
    n49, err49, blocks49_stats = blocks_phase(P, ldpc_bp, psk31_pll,
                                              onepole_two_rate, dev)
    bp_runs["49"], pll_runs["49"], one_runs["49"] = (n49["bp"], n49["pll"],
                                                     n49["one"])
    max_err = max(max_err, err49["bp"])
    print(f"  [49] took {time.perf_counter() - t_s6:.1f} s")
    t_s6 = time.perf_counter()
    print("[50] checkpoint/resume: six streams cut mid-frame, saved, loaded "
          "into a fresh receiver on the card; a QPSK31 stream from the card "
          "to the CPU")
    n50, err50, ckpt50_stats = checkpoint_phase(P, ldpc_bp, viterbi,
                                                psk31_pll, dev)
    bp_runs["50"], vit_runs["50"], pll_runs["50"] = (n50["bp"], n50["vit"],
                                                     n50["pll"])
    max_err = max(max_err, err50["bp"])
    vit_err = max(vit_err, err50["vit"])
    pll6b_err = max(err49["pll"], err50["pll"])
    print(f"  [50] took {time.perf_counter() - t_s6:.1f} s; [48]-[50] "
          f"{time.perf_counter() - t_s6b:.1f} s")
    t_s7 = time.perf_counter()
    print(f"[51] the multi-device layer on one Mesh of {S7_SHARDS} shards of "
          f"the card, shape {S7_SHAPE}: each sharded path against the "
          f"one-device path, 8 shards against 1 for the same work")
    OUTER.hold = False           # [51] holds its own launches
    err_rest, n_rest = outer_held(P, bch_device, OUTER.take_held(),
                                  "[19]-[50]")
    outer_err = max(outer_err, err_rest)
    outer_held_n = {k: outer_held_n[k] + n_rest[k] for k in outer_held_n}
    n51, err51, par51_stats = parallel_phase(P, ldpc_bp, viterbi, psk31_pll,
                                             outer_fec, bch_device, dev)
    bp_runs["51"], vit_runs["51"], pll_runs["51"] = (n51["bp"], n51["vit"],
                                                     n51["pll"])
    outer_runs["51"] = n51["outer"]
    max_err = max(max_err, err51["bp"])
    vit_err = max(vit_err, err51["vit"])
    outer_err = max(outer_err, err51["outer"])
    pll6b_err = max(pll6b_err, err51["pll"])
    print(f"  [51] took {time.perf_counter() - t_s7:.1f} s")
    default = [p for p in vit_runs if p != FORCED]
    by_phase = {radix: {p: n[k] for p, n in vit_runs.items()}
                for k, radix in enumerate((2, 4))}
    if any(by_phase[4][p] for p in default):
        fail("a default path launched the radix-4 Viterbi kernel")
    print(f"  slice 6a launches: BP {bp43} ([43]), Viterbi radix 2 "
          f"{by_phase[2]['43']} ([43]), two-rate one-pole "
          f"{ {p: one_runs[p] for p in ('44', '45')} }, PSK31 "
          f"PLL {pll_runs['45']} ([45]), each held to its plain version")
    print(f"  slice 6b launches: BP {bp_runs['49']} ([49]) + "
          f"{bp_runs['50']} ([50]), Viterbi radix 2 {by_phase[2]['50']} "
          f"([50]), PSK31 PLL {pll_runs['49']} ([49]) + {pll_runs['50']} "
          f"([50]), two-rate one-pole {one_runs['49']} ([49]), each held to "
          f"its plain version; [48] none")
    print(f"  slice 7 launches ([51]): BP {bp_runs['51']}, Viterbi radix 2 "
          f"{by_phase[2]['51']}, PSK31 PLL {pll_runs['51']}, outer BCH / RS "
          f"{outer_runs['51']['bch']} / {outer_runs['51']['rs']}, each held "
          f"to its plain version")

    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd,
              **extra):
        return {"name": name, "route": "cuda",
                "source": f"orion_sdr_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
                **extra}

    def vit_extra(radix):
        plan = plans[radix]
        return {"launches_by_phase": by_phase[radix],
                "default_path_launches": sum(by_phase[radix][p]
                                             for p in default),
                "lanes_per_sm": plan["lanes_per_sm"], "waves": plan["waves"],
                "ms_at_13": {f"{plane} {path_lanes[plane]}x{VIT_SPAN}":
                             path_ms[plane, radix] for plane in ("HP", "LP")}}

    def bp_extra(rule, by_phase, iters, path):
        # N512R12 runs the exact-width (D = 5) instantiation
        code = ldpc_bp._RULE_CODE[rule]
        return {"launches_by_phase": by_phase,
                "registers": ptxas_registers(built, code, 5),
                "launch_plan": bp_plans[rule],
                "ms_by_max_iter": {str(i): ms for i, ms in iters.items()},
                "ms_at_4": {k: v[0] for k, v in path.items()},
                "bound_ms_at_4": {k: v[1][0] for k, v in path.items()}}

    ft8_bp = {"ms_at_25": {k: v[0] for k, v in ft_at25.items()},
              "bound_ms_at_25": {k: v[1][0] for k, v in ft_at25.items()},
              "ft8_174_91": {"rows": FT_BP_ROWS, "ms": ft_k_ms,
                             "plain_ms": ft_p_ms, "bound_ms": ft_bnd[0],
                             "bound_by": ft_bnd[1],
                             "registers_width7": ft_regs},
              "ft_receive": ft_stats}

    def outer_entry(kind, name, replaces):
        t = outer_t[kind]
        return entry(
            name, "outer_fec.cu", replaces,
            sum(r[kind] for r in outer_runs.values()), outer_err, t["ms"],
            t["plain_ms"], t["bound"],
            pallas_counterpart=None,
            note="no Pallas kernel in the JAX package computes this: it "
                 "replaces a jnp program",
            launches_by_phase={ph: r[kind] for ph, r in outer_runs.items()},
            launches_held_outside_51=outer_held_n[kind],
            registers=outer_regs[kind][t["plan"]["lanes"]],
            registers_by_lanes={str(G): r for G, r in
                                outer_regs[kind].items()},
            launch_plan=t["plan"],
            at={name: {k: v for k, v in a.items() if k != "plan"}
                | {"grid": a["plan"]["grid"],
                   "groups_per_block": a["plan"]["groups_per_block"]}
                for name, a in t["at"].items()},
            lane_sweep_ms=t["lane_sweep"],
            rows=t["rows"], host_path_ms=t["host_ms"],
            card_path_ms=t["card_path_ms"], ms_at_path_blocks=t["ms_at_path"],
            sweep_host_card_ms={name: {str(nb): [h, d] for nb, h, d in sw}
                                for name, (sw, _) in t["sweeps"].items()},
            crossover_blocks={name: c for name, (_, c) in t["sweeps"].items()},
            threshold_blocks=chain._DEVICE_OUTER_MIN_BLOCKS)

    k_ms, p_ms = times["sum_product"]
    vit_bnd = viterbi_bound(VIT_LANES, VIT_SPAN, "dvb_k7", 2)
    r4_bnd = viterbi_bound(VIT_LANES, VIT_SPAN, "dvb_k7", 4)
    print(json.dumps({"kernels": [
        entry("ldpc_bp_decode", "ldpc_bp.cu",
              "orion_sdr_tpu/ops/ldpc_bp.py:256", sum(bp_runs.values()),
              max_err, k_ms, p_ms, bp_bnd,
              **bp_extra("sum_product", bp_runs, bp_iters, bp_path),
              **ft8_bp),
        entry("ldpc_bp_decode_sum_product_edge", "ldpc_bp.cu",
              "orion_sdr_tpu/ops/ldpc_bp.py:200", edge_launches + edge33,
              edge_err, edge_ms, edge_plain_ms, edge_bnd,
              **bp_extra("sum_product_edge",
                         {"12": edge_launches, "33": edge33},
                         edge_iters, edge_path)),
        entry("viterbi_acs_traceback", "viterbi.cu",
              "orion_sdr_tpu/ops/viterbi.py:200", sum(by_phase[2].values()),
              vit_err, vit_ms, vit_plain_ms, vit_bnd, **vit_extra(2)),
        entry("viterbi_acs_traceback_radix4", "viterbi.cu",
              "orion_sdr_tpu/ops/viterbi.py:347", sum(by_phase[4].values()),
              r4_err, r4_ms, r4_plain_ms, r4_bnd, **vit_extra(4)),
        outer_entry("bch", "outer_bch_decode",
                    "orion_sdr_tpu/fec/bch_device.py:87"),
        outer_entry("rs", "outer_rs_decode",
                    "orion_sdr_tpu/fec/bch_device.py:206"),
        entry("psk31_pll", "psk31_pll.cu",
              "orion_sdr_tpu/demodulate/psk31.py:65",
              sum(pll_runs.values()),
              max([v["max_abs_err"] for v in pll_stats.values()]
                  + [pll45_err, pll6b_err]),
              pll_stats["bpsk"]["ms"], pll_stats["bpsk"]["plain_ms"],
              pll_stats["bpsk"]["bound"], pallas_counterpart=None,
              note="no Pallas kernel in the JAX package computes this: it "
                   "replaces the lax.scan _pll_scan; latency-bound by "
                   "design (one row a thread)",
              launches_by_phase=pll_runs,
              shape=f"{PSK_ROWS}x{PSK_BITS}",
              chain_steps_per_row=PSK_BITS,
              qpsk={k: v for k, v in pll_stats["qpsk"].items()
                    if k != "bound"},
              psk31_roundtrip=psk_stats, fm_demod_chain=fm_stats,
              viterbi_decode_torch_loop_ms=vit_psk_ms),
        entry("onepole_two_rate", "onepole_two_rate.cu",
              "orion_sdr_tpu/dsp/agc.py:59", sum(one_runs.values()),
              one_stats["max_abs_err"], one_stats["ms"],
              one_stats["plain_ms"], one_stats["bound"],
              pallas_counterpart=None,
              note="no Pallas kernel in the JAX package computes this: it "
                   "replaces the lax.scan recurrences of agc_rms "
                   "(dsp/agc.py:59-69) and cw_mod "
                   "(modulate/analog.py:40-47); latency-bound by design "
                   "(one row a thread); ms, plain_ms and bound_ms at "
                   f"{ONEPOLE_ROWS}x{ONEPOLE_CMP} (agc_rms real; the "
                   "per-step plain loop would take minutes at the full "
                   "width), the main path's "
                   f"{ONEPOLE_ROWS}x2^{ONEPOLE_LOG2_N} under ms_full and "
                   "bound_ms_full, its launches held to the plain version "
                   "step by step (steps_exact_at_full)",
              launches_by_phase=one_runs,
              shape=f"{ONEPOLE_ROWS}x{ONEPOLE_CMP}",
              shape_full=f"{ONEPOLE_ROWS}x{1 << ONEPOLE_LOG2_N}",
              chain_steps_per_row=ONEPOLE_CMP,
              chain_steps_per_row_full=1 << ONEPOLE_LOG2_N,
              ms_full=one_stats["ms_full"],
              bound_ms_full=one_stats["bound_full"][0],
              steps_exact_at_full=one_stats["steps_exact_at_full"],
              ms_at_8192=one_stats["ms_at_8192"],
              plain_ms_at_8192=one_stats["plain_ms_at_8192"]),
        entry("dd_pll", "dd_pll.cu",
              "orion_sdr_tpu/demodulate/digital.py:191",
              sum(dd_runs.values()), dd_err,
              dd_stats[f"4x{BURST_SYMS}"]["ms"],
              dd_stats[f"4x{BURST_SYMS}"]["plain_ms"],
              dd_stats[f"4x{BURST_SYMS}"]["bound"], pallas_counterpart=None,
              note="no Pallas kernel in the JAX package computes this: it "
                   "replaces the lax.scan _dd_pll_kernel "
                   "(demodulate/digital.py:191-208); latency-bound by design "
                   "(one row a thread); ms, plain_ms, bound_ms at the "
                   f"bench's 4x{BURST_SYMS} {BURST_ORDER}",
              launches_by_phase=dd_runs, shape=f"4x{BURST_SYMS}",
              chain_steps_per_row=BURST_SYMS,
              us_per_symbol=dd_stats[f"4x{BURST_SYMS}"]["us_per_symbol"],
              sincos_mismatches=dd_stats["sincos_mismatches"],
              at_64_rows={k: (v[0] if k == "bound" else v) for k, v in
                          dd_stats[f"64x{BURST_SYMS}"].items()}),
        entry("gardner", "gardner.cu",
              "orion_sdr_tpu/demodulate/digital.py:127", sum(ga_runs.values()),
              ga_err, ga_stats["ms"], ga_stats["plain_ms"], ga_stats["bound"],
              pallas_counterpart=None,
              note="no Pallas kernel in the JAX package computes this: it "
                   "replaces the lax.scan _gardner_kernel "
                   "(demodulate/digital.py:127-161); latency-bound by design "
                   "(one row a thread, each step's reads set by the last)",
              launches_by_phase=ga_runs, shape=ga_stats["shape"],
              chain_steps_per_row=ga_stats["n_out"]),
        entry("gnss_track", "gnss_track.cu", "orion_sdr_tpu/gnss.py:200",
              sum(tk_runs.values()), tk_err, tk_stats["ms"],
              tk_stats["plain_ms"], tk_stats["bound"],
              pallas_counterpart=None,
              note="no Pallas kernel in the JAX package computes this: it "
                   "replaces the lax.scan _track_scan (gnss.py:200-254); "
                   "latency-bound by design (one block a satellite, "
                   "dependent epochs)",
              launches_by_phase=tk_runs,
              shape=f"{TRACK_SATS}x{TRACK_EPOCHS}",
              chain_steps_per_row=TRACK_EPOCHS,
              ms_at_100_epochs=tk_stats["ms_short"],
              us_per_epoch=tk_stats["per_epoch_ms"] * 1e3,
              threads=tk_stats["threads"], sweep=tk_stats["sweep"],
              window_misses=tk_stats["window_misses"],
              ephemeris_epochs=tk_stats["ephemeris_epochs"],
              ephemeris_launch_ms=tk_stats["ephemeris_launch_ms"],
              ephemeris_window_misses=tk_stats[
                  "ephemeris_window_misses"])],
        "slice5": {"32 pfb_channelizer_throughput": pfb_stats,
                   "33 band_receivers": band_stats,
                   "34 fm_stereo_rds_throughput": stereo_stats,
                   "35 css_dechirp_throughput": css_stats,
                   "36 wspr_energy_grid_throughput": wspr_stats},
        "slice5b": {"39 burst_modem_throughput": burst_stats,
                    "40 gnss_acquisition_throughput": acq_stats,
                    "41 gnss_tracking_throughput": {
                        "msps": tk_stats["msps"],
                        "per_epoch_ms": tk_stats["per_epoch_ms"],
                        "bound_ms_per_epoch": tk_stats["bound"][0]
                        / TRACK_EPOCHS,
                        "bound_by": tk_stats["bound"][1],
                        "ephemeris_path_s": tk_stats["ephemeris_s"]},
                    "42 fsk2_engine_throughput": fsk_stats},
        "slice6a": {"43 channel": ch_stats, "44 morse_skimmer": morse_stats,
                    "45 band_monitor": band6_stats, "46 adsb": adsb_stats,
                    "47 sstv": sstv_stats},
        "slice6b": {"48 ofdm_otfs_receive": ofdm48_stats,
                    "49 blocks": blocks49_stats,
                    "50 checkpoint_resume": ckpt50_stats},
        "slice7": {"51 parallel": {**par51_stats,
                                   "max_abs_err_by_path": err51["paths"]}}}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
