#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sigdigger_tpu_torch) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --pairs PARENT_TREE N
    python3 chip_smoke.py --kernel-pairs PARENT_TREE N

The second form runs only the end-to-end phases (3, 3b, 3c, 3f, 3g) of
another checkout (its own chip_smoke.py's phase functions, e.g. the
parent commit unpacked with ``git archive``) and of this one in turns, N
pairs in fresh processes on the same card, and prints each metric's
runs, medians and the pairs the change won.  The third does the same
with phase 2's timings of kernel2 and the PSD kernels (event times,
traced stages, the FFT and composition yardsticks), of the drain packer
(event time and traced device time at the bench layout, traced device
time at the grouped one) and of the line resampler (event time and
traced device time of 64 framed lines), of the v1 channelizer (event
time in turns with the channelize matmul, traced device time) and of the
CMA bank (event time and traced device time).

Phases, each fatal on failure (any exception exits nonzero), each
printing the seconds it took:

1. device and build: the card's name and power limit; every CUDA
   kernel of the port built with nvcc from ``kernels/csrc`` (one nvcc
   per source, all at once); the HGMMA (tensor-core) instructions in
   the SASS of each tensor-core stage (``raw_rot_tc``, and
   ``chan_rot_disc_tc`` in kernel2's and the v1 kernel's sources), which
   must all hold some.
2. each kernel against its plain version on the card, with CUDA-event
   times of the kernel, its plain version and a library yardstick, and
   for the tensor-core forms their bound at the TF32 peak beside the
   bound of the same work on the CUDA cores: the fused FM channelizer
   (``kernel2``) over 3 chained blocks at the full bench width, f32 in /
   f32 audio and int16 in / bf16 audio; the standalone PSD
   (``psd_kernel``) at N = 4096, F = 128 over 3 blocks, two launches
   bit-equal (yardsticks: the FFT alone, and the PyTorch composition of
   window, FFT, |X|² and frame sum, also timed in turns with the kernel;
   its traced stages (``psd_frames``; the general form's ``psd_sum``),
   the HBM rate they reach and the wrapper's host time, part by part),
   then at N 16, 64, 128, 1536 and 32768 (the factorings
   outside the templated stages; 32768 in two passes); the raw bank
   (``raw_kernel``) at 1024 channels, M = 8192 over 3 chained blocks;
   the recovery bank (``recovery_kernel``) with the psk receiver's own
   1024 lanes (sps 8, RRC matched filter) on QPSK at the
   main path's M = 8192, chained into a block of 1024, and with 1024
   lanes of every kind over 2 chained blocks of 1024 (the plain version
   is a Python loop of ~150 small operations per sample: ~35 s for the
   full block), then at 100 lanes (ragged) over blocks of 1000 and 40
   rows, keq 1 and 8, and K = 1, every case bit-equal; its time beside
   its latency floor, from the cycles a step of its carrier loop,
   Gardner clock and CMA (timed with clock64) at the SM clock.  Then the
   forms this slice added: kernel2 unfused with
   the cos/sin rotator, live phase chained over 3 blocks at the full
   bench width (int16 in, bf16 audio); the PSD read from the window
   buffer (``psd_xw_kernel``) at N 4096 (A 64) and N 2048 (A 32) on the
   int16 [16384, 64] upload with frame_stride 1 and 4, and with the
   device EMA (``psd_xw_ema_kernel``) chained over 3 blocks; the v1
   channelizer (``kernel1``) at ``__graft_entry__.entry()``'s geometry
   (256 channels, 25.6 Msps, decimation 64, M 1024, audio at 1/8)
   chained over 3 blocks, its tensor-core bound beside the CUDA-core
   one.  Then the analyzer's kernels: the audio bank
   (``audio_kernel``) at the engine's bench shapes (1024 slots of every
   mode, M 8192, m_tile 2048, audio at 1/32, int16 packed upload) over 3
   chained blocks with the hang AGC and 3 without, its hang walk's gain
   plane and carry rows bit-equal to the plain recurrence on the
   kernel's own rotated planes at seed_tile 0 and 1, its branch-free
   square root and reciprocal against the IEEE intrinsics on every
   float32 of their ranges, and the walker's clock64 cycles a step with
   the latency floor they set; the column compactor
   (``compact_kernel``) on 3 planes [8192, 1024] at width 1024 (every
   slot), 64 (a scattered map), 77 (a tail run) and 1024 shifted by one
   column (no aligned run), float32, bfloat16 and int16, bit-equal, timed
   in turns with ``torch.index_select``; the symbol squeeze
   (``squeeze_kernel``) bit-equal at R 2, 4 and 8 on 3 x [8192, 1024]
   float32 with strobes at sps 8 (the float4 path), at C 1022 and on
   views one column into their buffers (the scalar path), then timed at
   R 4 in turns with ``torch.sum`` (medians of 21) and both traced; the
   drain packer
   (``pack_kernel``) at the bench session's layout (width 1024, 832 live
   audio columns, the status tile), at a grouped one (G 2 in every
   section, squeezed digital rows, a raw section), at width 8, the status
   tile alone, an unsorted map and maps with empty lanes inside a group,
   bit-equal, each layout's traced device time beside its live-byte and
   32-byte-sector bounds, and the wrapper's host time by part.  Then the
   TV line resampler (``tv_kernel``) at ``cli tv``'s geometry (W 512, px
   384) in the main path's stream form (64 windows read from a block's
   samples, starts clipped at both ends) against its plain version, the
   framed form and ``LineResampler.resample_lines``, then on 3 dispatches
   of 64 framed lines and one of 256, within 2e-6, with the stream form's
   times, the wrapper's host time by part and the resampler's upload,
   kernel and fetch; and the
   CMA bank (``cma_kernel``) at 1024 lanes x 1024 symbols, K 5, over 3
   chained blocks and a block with a lane past the walker's fast range
   (its IEEE fallback), bit-equal, its time beside its latency floor
   (the walker's clock64 cycles a step at the SM clock).
3. FM end to end: ``KernelReceiver(mode="fm")`` at the bench geometry
   (1024 channels, 102.4 Msps, block_out 8192, int16 in, bf16 audio,
   fused PSD) over synthetic FM made from a seed, through
   ``run(pipeline_depth=3)``; every block must go through the kernel,
   the audio of modulated channels must peak at their tones and the PSD
   at the pure carrier.
3b. digital end to end: ``KernelReceiver(mode="psk")`` at the same
   width (psd_fft 4096, 200 kbaud = 8 samples per symbol, bw 400 kHz)
   over synthetic QPSK on a few channels, a pure carrier and noise,
   through ``run(pipeline_depth=3)`` over 12 blocks: the PSD, raw and
   recovery kernels must each launch once per block, the strobed QPSK
   symbols must concentrate (4th power > 0.85) and the PSD peak on the
   carrier; then a synchronous per-layer breakdown, and ``fsk`` and
   ``ask`` for 3 blocks each.
3c. FM at every geometry: ``KernelReceiver(mode="fm", snap_grid=False)``
   at the bench geometry (live phase, cos/sin rotator, PSD read from the
   upload) through ``run(pipeline_depth=3)`` over 12 blocks: kernel2 and
   ``psd_xw_kernel`` each launch once per block, the audio peaks at the
   tones and the PSD on the off-grid pure carrier; a synchronous
   per-layer breakdown; then 3 blocks each of ``decimation=32``
   (standalone PSD) and ``psd_fft=2048`` snapped (A = 32).
3d. the device-EMA spectrum (``PSDFromXW.feed_ema`` over 12 bench
   uploads, read once with ``shifted()``) and the v1 channelizer
   (``MatChannelizer.feed`` at the entry's geometry over 4 blocks of an
   FM tone).
3e. the analyzer session on the compactor drain: ``KernelAnalyzer`` at
   ``bench.py:255-259``'s geometry with ``drain_pack=False`` and
   ``symbol_group=1`` (1024 slots,
   102.4 Msps, decimation 64, audio at 1/32, PSD 4096, compact width
   1024, depth 3, threaded drain, int16 upload, bf16 drain) with the
   bench's 1024-inspector mix, over 12 blocks after 2 warm-up blocks of
   a ring of distinct synthetic blocks: 1024 OPEN acks with their
   request ids; the audio, raw, recovery and device-EMA PSD kernels once
   per block and the compactor twice; FM tones, QPSK concentration, the
   PSD on the carrier and the carrier's power; block wall time and Msps
   (the final drain join included) and a synchronous per-layer
   breakdown; then 3 blocks of a 128-slot session with AM/USB/LSB/RAW
   audio, raw, unaligned power and a psk inspector with both estimators
   (the raw compactor and the standalone PSD launch), a retune and a
   close.
3f. ``bench.py:255-259``'s exact session: the same with the packed drain
   (``drain_pack=True``) and ``symbol_group=4``, over 12 blocks after 2
   warm-up blocks: 1024 OPEN acks; the audio, raw, recovery, device-EMA
   PSD, squeeze and pack kernels once per block and the compactor once
   (the digital section's int16 side); every drained block at every
   inspector, FM tones, the squeezed QPSK symbols' concentration, the
   PSD and the carrier's power; block wall time and Msps and the
   per-layer breakdown with the drain's bytes; then 3 blocks on the int8
   upload (``bench.py:216``); then a 128-slot packed session read from a
   capture file in a temporary directory, saved with
   ``save_checkpoint`` after 2 blocks: the session ``load_checkpoint``
   restores gives the next 3 blocks bit for bit.
3g. the analog-TV decode as users run it: ``cli.main(["tv", ...])`` on
   a 26-field synthetic AM PAL capture (8 Msps complex, carrier at +1
   MHz, ``tests/test_tv_pal.py``'s field pattern, noise from a seed) in
   a temporary directory, at the CLI's defaults (312 lines, 384 pixels,
   25 frames): exit 0 and 25 PNGs, the line resampler launched, the
   white band and the row gradient of the PNGs read back; fields per
   second; then the decode again per layer, synchronously: the device
   backend, one line resampler launch per analyzer block that produced
   lines (each block after lock), the device frames held against the
   host backend's on the same luminance; then 3 fields in FM.
3h. the CMA bank through its own entry point (``CMABank``; the system
   launches it through the class path's psk equalizer, phase 3i): 1024
   lanes, 1024 symbols, 5 taps, 3 blocks of QPSK through ISI; its
   modulus error must halve.
3i. the class-path command line as users run it: ``cli.main([...,
   "--device", "cuda"])`` on a 2^19-sample capture at 1.024 Msps (0.512
   s, 16 analyzer blocks) written from a seed (QPSK at 4800 baud, an FM
   tone, OOK, 2-FSK, noise): ``info``; ``psd --waterfall`` (the peak on
   the FM carrier, ``psd_kernel`` launched rows + 1 times, the PNG's
   rows; then on the same chunks every row's PSD (N 4096, F 1) through
   the kernel and its plain version within each bin's float64 bound,
   ``psd_f64_bound``, and the mean's (F 128) within TOL_PSD_BIN of the
   plain version, and the CLI's CSV, peak and floor against the plain
   mean); ``demod fm`` (the WAV peaks at the tone); ``symbols`` psk
   (with ``--symview``), fsk and ask (each >= 99% of its known sequence
   after lock); ``rms`` (the FM level within 1 dB); each command's wall
   time.  Then the psk chain with the CMA equalizer through
   ``Analyzer(device="cuda")`` per layer (channelizer, AGC, Costas, MF,
   CMA, Gardner, the rest): ``cma_kernel`` once per block fed to the
   unlocked equalizer (a locked one runs its FIR without the kernel),
   every call bit-equal to ``cma_kernel_reference`` at C 1.
3j. the spectrum users off the main path: ``cli.main(["scan", ...])`` at
   its defaults over 88-108 MHz (2.048 Msps, FFT 2048, 4 frames a hop,
   200 progressive hops, four emitters): coverage >= 0.99, a hot bin
   within 8 view bins of each emitter, ``psd_kernel`` once a hop; the
   wall per hop and a hop's layers (retune + read, framing, H2D, kernel,
   rebin matmul, span D2H, stitch); a 20 Msps sweep at N 32768 and 65536
   (the FFT cap; both the PSD's two-pass form), the kernel held against
   its plain version on a hop's capture, the emitters found;
   ``CarrierDetector`` and ``DopplerCalculator`` on the card, each
   within a bin of a seeded tone's offset, one ``psd_kernel`` launch
   each; ``cli doppler`` on an ISS element set (elevation, azimuth,
   range and Doppler physical); then phase 3f's session on a 437.5 MHz
   source with 64 FM inspectors under Doppler correction by the ISS
   predictor, anchored where the pass's Doppler moves fastest and
   advanced 0.5 s of pass a block, the four FM-tone carriers shifted by
   the same Doppler in the source: 64 retunes a block, each corrected
   centre within 2 Hz of its offset plus the predicted Doppler at each
   block, the FM-tone slots' audio centred within 50 Hz of their
   carriers while the carriers move over 500 Hz, ORBIT_REPORTs,
   ``audio_kernel`` once a block, the session's Msps beside phase 3f's
   and the corrections' host time a block.
3k. the live session and ``pipeline.py`` (the user-facing layer): (a)
   ``app.LiveSession`` around phase 3f's engine (the same options) on a
   capture of 14 session blocks written to a temporary directory and
   replayed with throttle off, with every consumer on: the suscan-wire
   server (user and password), the REPL, the web view, the raw-IQ
   recorder, the waterfall PNG and an FM audio inspector to a WAV (null
   playback).  The 1024-inspector mix opens while a gate holds the
   analyzer's first step: the four FM-tone slots through the port's
   ``SuscanWireClient`` (their OPEN acks carry the request ids), one
   through the web view's POST, the session's own audio inspector in
   slot 831's place, the rest in-process under ``bulk_config``; the REPL
   retunes.  Every kernel once a block (as 3f), no drain error, every
   inspector's SAMPLES at the session's pump every block, the wire's
   PSDs on the carrier and its inspectors' audio on their tones (the
   wire's tap drops its oldest: the drops are counted), the retune at
   the engine, ``/psd.json`` = the last PSD row and ``/waterfall.png`` a
   PNG, the recording the capture byte for byte, the WAV's tone; the
   session's Msps beside phase 3f's, each consumer's host milliseconds
   a block (wire encode, framing and sends; the pump; the recorder; the
   web feed) and the web GETs.  (b) ``cli.main(["live", ...])`` in a
   thread at its defaults on the card (1.024 Msps FM capture replayed at
   its rate, wire, REPL, web, audio WAV, recording) and
   ``cli.main(["remote", ...])`` against it: both exit 0, remote's PSDs
   in the FM swing, both WAVs on the tone, the recording the capture's
   prefix.  (c) ``pipeline.py`` at ``benchmarks.py:61-79``'s geometry
   (8.192 Msps, FFT 2048, 256 channels, n_sub 64, block 2^17): fm, am
   and raw against the same function on the CPU, each one's Msps; psk
   (per-sample loops) on one block of 2^13 samples, its time.
3l. the multi-device path (``parallel/``) on one card: (a) phase 3f's
   bench mix (1024 slots, block 8192·64, synchronous drain, a PSD every
   block) in a meshed ``KernelAnalyzer`` on a one-device mesh, a ("ch",)
   mesh of 2 and a ("time", "ch") mesh of 2 x 2, every cell on cuda:0
   (shards run one after another: the Msps is not a scale-out figure);
   each meshed session against the one-device one (audio share beyond
   TOL_AUDIO_BANK at most TOL_AUDIO_FRAC, PSD TOL_PSD_BIN, power
   TOL_RAW, digital symbols equal up to the first moved strobe);
   ``psd_kernel``, ``raw_kernel``, ``recovery_kernel`` and
   ``audio_kernel`` launched blocks x shards times (x 2 for the exact
   audio passes), each shard launch held against its plain version at
   its local shape (the time mesh's audio at seed_tile 2 with the
   power-EMA AGC; recovery on its first 512 rows, bit-equal); the time
   mesh's recovery hand-off bit-equal to one unsharded launch; each
   session's layers on ``utils/profiling.StageTimer``.  (b)
   ``shard_pipeline`` on the 2 x 2 mesh at ``benchmarks.py:61-79``'s
   geometry against ``jit_pipeline`` on the card (fm, am, raw; psk with
   the exact hand-off).  (c) two processes on the card in a gloo group
   (``parallel.distributed``), each its channel half of a hybrid mesh,
   rank 0 against the single-process step.
4. the TPU kernel list (all 13 ported, each with its bound at the inputs
   phase 2 timed) and the ``kernels`` line (``cma_kernel``'s launches
   from phase 3i, the system path).
5. last line: ``{"ok": true, "device": {...}}``.

Needs CUDA and the rest of the repository; it prints no result without
them.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

from sigdigger_tpu_torch.utils.profiling import StageTimer
# the H100's published peaks and the phase-2 bounds (one home for both)
from sigdigger_tpu_torch.utils.roofline import (
    bound,
    bound_line,
    kernel2_bound_ms,
    psd_bound,
    psd_xw_bound,
    raw_bound,
    tc_bounds,
)

SEED = 1234
FS = 102_400_000.0
N_CHANNELS = 1024
F0S = np.linspace(-48e6, 48e6, N_CHANNELS)
BW = 800e3
BLOCK_OUT = 8192
AUDIO_DECIM = 32
E2E_BLOCKS = 12

# kernel vs plain version on the card (both float32, no TF32):
# - PSD block, rotated carry row: 1e-4 of the largest value (summation
#   order of the float32 products); every PSD bin also 1e-4 of itself,
#   since the noise bins sit some 1e5 below the carrier bins;
# - audio: an element disagrees when |d| > 1e-4 (+ one bf16 step, 2^-7
#   of the value, for bf16 audio); the FIR tail (unfiltered
#   discriminator output) when |d| > 1e-3, since on noise-only channels
#   |Y| is small next to the product's terms and the rounding becomes a
#   larger phase error.  The discriminator's atan2 sits on its branch
#   cut when the phase step is ~±π (noise-only and beating channels),
#   where summation-order rounding picks the sign: f then flips by ~2
#   and up to two audio samples by one tap's weight.  At most 1e-4 of
#   the elements (and never fewer than 2) may disagree.
TOL_REL = 1e-4
TOL_PSD_BIN = 1e-4


def psd_f64_bound(xp: np.ndarray, a: int, b: int, scale: float) -> tuple:
    """The float64 PSD of the windowed frames packed in ``xp`` [2A, F·B]
    (float32, the kernel's input) and each bin's bound, both [A, B] in
    (k1, k2) order.  A bin of one frame's periodogram can sit far under
    the frame's energy (a single frame averages nothing), and no float32
    FFT holds it within TOL_PSD_BIN of itself.  Its bound is TOL_PSD_BIN
    of itself plus its conditioning: |ΔX| <= g·Σ|x| for a log2(N)-level
    sum, g = 8u·log2(N) (the constant of tests/test_torch_channelizer2.py's
    ``tail_tol``), so |ΔP| <= scale·Σ_frames (2g|X|·Σ|x| + (g·Σ|x|)²).
    """
    n = a * b
    xd = xp.astype(np.float64)
    frames = xd.shape[1] // b
    fr = (xd[:a] + 1j * xd[a:]).reshape(a, frames, b).transpose(1, 0, 2)
    fr = fr.reshape(frames, n)
    x = np.fft.fft(fr, axis=1)
    g = 8 * 2.0 ** -24 * np.log2(n)
    l1 = np.abs(fr).sum(1, keepdims=True)
    p64 = (np.abs(x) ** 2).sum(0) * scale
    bound = TOL_PSD_BIN * p64 + scale * (2 * g * np.abs(x) * l1
                                         + (g * l1) ** 2).sum(0)
    return tuple(np.ascontiguousarray(v.reshape(b, a).T)
                 for v in (p64, bound))
TOL_AUDIO = 1e-4
TOL_TAIL = 1e-3
TOL_FRAC = 1e-4
# raw bank planes and power: 1e-5 of the largest value / of itself
# (float32 summation order; both round the rotator phase once)
TOL_RAW = 1e-5
# recovery, per lane: symbols within 2e-3 up to the first strobe that
# differs (the loops feed back, so a one-ulp difference can move a
# strobe), then the strobe count within ±1, period within 1%, the
# tail's M-th-power concentration within 0.02 (tests/test_torch_recovery)
TOL_SYM = 2e-3

# the digital receiver of phase 3b
DIG_BW = 400e3
DIG_SPS = 8
QPSK_CHANNELS = (100, 300, 500, 700, 900)
DIG_PURE = 600
DIG_BLOCKS = 12
REC_BLOCK = 1024

# audio bank kernel vs plain version (both float32 on the card): an
# element disagrees when |d| > 1e-4·(1 + |value|) — the channelize
# product, the decimating FIR and the DC follower (a recurrence in the
# kernel, the closed-form Toeplitz in the plain version) sum in other
# orders; the FM discriminator's atan2 picks its ±π branch, and the hang
# AGC its |y| > slow branch, by that rounding — so at most 1e-3 of the
# audio and carry elements (and never fewer than 2) may disagree
TOL_AUDIO_BANK = 1e-4
TOL_AUDIO_FRAC = 1e-3

# the analyzer session of phase 3e (bench.py:255-284, drain_pack=False
# and symbol_group=1): 1024 slots, decimation 64, audio at 1/32, PSD
# 4096, block 8192·64, compact width 1024, depth 3, threaded drain
SESSION_BLOCKS = 12
SESSION_WARM = 2
# the session Msps of phase 3f, read by phase 3j in the same process
SESSION_MSPS: dict = {}
FM_SLOTS = {40: 1000.0, 120: 1500.0, 200: 2000.0, 280: 2500.0}
QPSK_SLOTS = (2, 10, 20)
CARRIER_POWER_SLOT = 64

TPU_KERNELS = [
    ("kernels/channelizer2.py:126 _kernel2", "ported"),
    ("kernels/fft.py:283 _psd_kernel_xw", "ported"),
    ("kernels/fft.py:264 _psd_kernel_xw_ema", "ported"),
    ("kernels/fft.py:65 _psd_kernel", "ported"),
    ("kernels/rawbank.py:61 _raw_kernel", "ported"),
    ("kernels/recovery.py:90 _recovery_kernel", "ported"),
    ("kernels/audio.py:193 _audio_kernel", "ported"),
    ("kernels/symsqueeze.py:71 _squeeze_kernel", "ported"),
    ("kernels/compact.py:64 _compact_kernel", "ported"),
    ("kernels/drainpack.py:188 _pack_kernel", "ported"),
    ("kernels/tvline.py:54 _tv_kernel", "ported"),
    ("kernels/equalizer.py:42 _cma_kernel", "ported"),
    ("kernels/channelizer.py:124 _kernel", "ported"),
]


def check(cond, detail=None) -> None:
    """A smoke check that holds under ``python -O`` too."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {detail!r}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def synth_iq(f0s_snapped: np.ndarray, n: int, seed: int):
    """FM carriers on a few channels, one pure carrier, and noise.
    Returns (iq complex64, {channel: tone Hz}, pure-carrier channel)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64) / FS
    x = 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    tones = {128: 1000.0, 384: 1500.0, 640: 2000.0, 896: 2500.0}
    for ch, tone in tones.items():
        phase = 2 * np.pi * f0s_snapped[ch] * t + 2 * np.pi * 50e3 * \
            np.cumsum(np.sin(2 * np.pi * tone * t)) / FS
        x += 0.25 * np.exp(1j * phase)
    pure = 512
    x += 0.5 * np.exp(2j * np.pi * f0s_snapped[pure] * t)
    return x.astype(np.complex64), tones, pure


def time_ms(fn, reps: int) -> float:
    import torch

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


def interleaved_ms(fns: dict, reps: int = 21, calls: int = 5) -> dict:
    """Median CUDA-event time of one call of each function of ``fns``,
    the functions taking turns ``reps`` times (``calls`` calls a turn,
    after one warm-up call each), so that drift in clocks and power
    reaches them alike."""
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end) / calls)
    return {k: float(np.median(v)) for k, v in times.items()}


def disagree(got, ref, tol: float, bf16: bool) -> tuple[float, float]:
    """(share of elements that disagree beyond their allowance, max abs
    difference); the share is 0 while at most 2 elements disagree."""
    d = (got.float() - ref.float()).abs()
    lim = tol + (2.0 ** -7 * ref.float().abs() if bf16 else 0.0)
    bad = int((d > lim).sum())
    return (0.0 if bad <= 2 else bad / d.numel()), float(d.max())


def phase2_kernel_vs_plain(ch2, torch):
    """Kernel against plain version; returns the main-path variant's
    max abs audio error and the timings of the kernels line."""
    results = {}
    for name, kw in [("f32", dict()),
                     ("i16_bf16", dict(in_i16=True, audio_bf16=True))]:
        cfg = ch2.MatChannelizer2Config(
            sample_rate=FS, n_channels=N_CHANNELS, taps=64, decimation=64,
            audio_taps=64, audio_decim=AUDIO_DECIM, block_out=BLOCK_OUT,
            m_tile=2048, psd_fft=4096, **kw)
        chan = ch2.MatChannelizer2(cfg, F0S, BW, device="cuda")
        x, _, _ = synth_iq(chan.f0s, 3 * cfg.block_in, SEED + 1)
        ck = cp = (chan._prev_re, chan._prev_im, chan._ftail)
        bf16 = cfg.audio_bf16
        worst = {"audio_frac": 0.0, "audio_max": 0.0, "tail_frac": 0.0,
                 "carry_rel": 0.0, "psd_rel": 0.0, "psd_bin": 0.0}
        xw0 = None
        for b in range(3):
            xw = torch.from_numpy(chan._frame(
                x[b * cfg.block_in:(b + 1) * cfg.block_in])).cuda()
            xw0 = xw if xw0 is None else xw0
            ok = ch2.kernel2(xw, chan.consts, *ck, chan.params)
            op = ch2.kernel2_reference(xw, chan.consts, *cp, chan.params)
            torch.cuda.synchronize()
            ck, cp = ok[1:4], op[1:4]
            fa, ma = disagree(ok[0], op[0], TOL_AUDIO, bf16)
            ft, _ = disagree(ok[3], op[3], TOL_TAIL, False)
            pr = torch.cat([op[1], op[2]])
            carry = float((torch.cat([ok[1], ok[2]]) - pr).abs().max()
                          / pr.abs().max())
            dpsd = (ok[4] - op[4]).abs()
            psd = float(dpsd.max() / op[4].abs().max())
            psd_bin = float((dpsd / op[4].abs()).max())
            for key, v in (("audio_frac", fa), ("audio_max", ma),
                           ("tail_frac", ft), ("carry_rel", carry),
                           ("psd_rel", psd), ("psd_bin", psd_bin)):
                worst[key] = max(worst[key], v)
            check(torch.isfinite(ok[0].float()).all())
        print(f"phase2 {name}: audio disagree frac {worst['audio_frac']:.3g}"
              f" (tol {TOL_FRAC}), audio max abs err "
              f"{worst['audio_max']:.6g}, ftail disagree frac "
              f"{worst['tail_frac']:.3g}, carry rel err "
              f"{worst['carry_rel']:.3g} (tol {TOL_REL}), psd rel err "
              f"{worst['psd_rel']:.3g} (tol {TOL_REL}), psd worst bin rel "
              f"err {worst['psd_bin']:.3g} (tol {TOL_PSD_BIN})", flush=True)
        check(worst["audio_frac"] <= TOL_FRAC, worst)
        check(worst["tail_frac"] <= TOL_FRAC, worst)
        check(worst["carry_rel"] <= TOL_REL, worst)
        check(worst["psd_rel"] <= TOL_REL, worst)
        check(worst["psd_bin"] <= TOL_PSD_BIN, worst)
        results[name] = dict(worst, chan=chan, xw=xw0)

    # timings at the main path's variant (int16 in, bf16 audio)
    chan, xw = results["i16_bf16"]["chan"], results["i16_bf16"]["xw"]
    carries = (chan._prev_re, chan._prev_im, chan._ftail)
    ms = time_ms(lambda: ch2.kernel2(xw, chan.consts, *carries,
                                     chan.params), 20)
    plain_ms = time_ms(lambda: ch2.kernel2_reference(
        xw, chan.consts, *carries, chan.params), 5)
    xc = torch.complex(xw[:BLOCK_OUT].float() * chan.params.in_gain,
                       xw[BLOCK_OUT:].float() * chan.params.in_gain)
    hc = torch.complex(chan.consts["h_re"], chan.consts["h_im"])
    library_ms = time_ms(lambda: torch.matmul(xc, hc), 20)
    stages = profile_stages(
        lambda: ch2.kernel2(xw, chan.consts, *carries, chan.params),
        ("chan_rot_disc_tc", "psd_frames", "audio_fir", "tail_copy",
         "psd_sum"))
    bounds = kernel2_bound_ms(BLOCK_OUT, N_CHANNELS, 2, 2, 64, AUDIO_DECIM)
    bound, bound_by = bounds[:2]
    print(f"phase2 timing: kernel2 {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"channelize matmul (library yardstick) {library_ms:.4f} ms, "
          f"{bound_line(*bounds)}; stages {stages}", flush=True)
    return dict(max_abs_err=results["i16_bf16"]["audio_max"], ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                bound_by=bound_by)


def profile_stages(fn, stages: tuple, reps: int = 5) -> dict:
    """Device time per CUDA function (ms per launch) of ``fn``, from
    torch.profiler over ``reps`` calls ("not measured" when the trace
    holds no device time of any stage in three traces: a trace of a
    short run sometimes holds no device events).  Each stage's total is
    divided by the launches the trace holds, not by ``reps``: the
    profiler may keep only the last calls of a long run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            dev_us = getattr(ev, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "cuda_time_total", 0.0)
            if dev_us > 0 and len(seen) < 4:
                seen.append(ev.key[:48])
            for stage in stages:
                if stage in ev.key:
                    out[stage] = round(dev_us / max(ev.count, 1) / 1e3, 4)
        if out:
            return out
    # what the traces held instead, for the record
    return {"stages": "not measured", "device keys": "; ".join(seen)}


def time_once_ms(fn) -> tuple:
    """(CUDA-event time of one call without a warm-up call, its result)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


# operations of the recovery bank, counted from kernels/recovery.py at
# what each lane's kind needs (the kernel blends every arm on every lane;
# an arm weighted by zero reaches no output or state row):
# - carrier loop (PSK, coherent ASK), per sample: derotation 6,
#   magnitude 5, unit vector 2, loop 4, cos and sin 2, LO update and
#   renormalisation 12, plus the phase detector of its order;
# - FSK, per sample: quadrature product or rotation 6, atan2 ~20, scale 1;
# - ASK, per sample: the envelope's magnitude 5 (envelope lanes) and the
#   DC tracker 4;
# - Gardner clock, per sample on every lane: 47;
# - the fused CMA, per strobe (push is zero between strobes, and the
#   emitted symbol is read only at strobes): 30 + 30 per equalizer tap.
REC_LOOP_OPS = 31
REC_ORDER_OPS = {1: 0, 2: 3, 4: 8, 8: 13}
REC_FSK_OPS = 27
REC_ENV_OPS, REC_DC_OPS = 5, 4
REC_GARDNER_OPS = 47
REC_CMA_OPS, REC_EQ_TAP_OPS = 30, 30


def recovery_front_ops(bank) -> int:
    """Front-end operations per sample, summed over the bank's lanes."""
    from sigdigger_tpu_torch.kernels.recovery import KIND_ASK, KIND_PSK

    total = 0
    for kind, order, pll in zip(bank._kind, bank._order, bank._pll):
        if kind == KIND_PSK:
            total += REC_LOOP_OPS + REC_ORDER_OPS[int(order)]
        elif kind == KIND_ASK:
            total += REC_DC_OPS + (REC_LOOP_OPS if pll else REC_ENV_OPS)
        else:
            total += REC_FSK_OPS
    return total


def recovery_bound(m: int, bank, strobes: int) -> tuple:
    """Ops: each lane's front end at its kind, the Gardner clock on every
    lane, the matched filter at the bank's nonzero taps (a multiply and
    an add per tap and plane) and the CMA at this run's ``strobes``;
    bytes: the y planes, state, parameter rows and taps read once,
    symbols, strobes and state written once."""
    c, keq, rows = bank.cfg.n_channels, bank.cfg.eq_taps, bank.STATE_ROWS
    nnz = int(np.count_nonzero(bank._mf))
    ops = (m * (recovery_front_ops(bank) + c * REC_GARDNER_OPS + 4 * nnz)
           + strobes * (REC_CMA_OPS + REC_EQ_TAP_OPS * keq))
    nbytes = (2 * m * c + 2 * rows * c + 20 * c + bank._mf.size
              + 3 * m * c) * 4
    return bound(ops, nbytes) + (ops, nbytes)


def psd_composed(frames, win):
    """The PSD's function as PyTorch calls (a yardstick only): window the
    complex [F, N] frames, FFT, |X|² and the sum over frames."""
    import torch

    spec = torch.fft.fft(frames * win)
    return (spec.real * spec.real + spec.imag * spec.imag).sum(0)


def host_us(fn, reps: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to return (launches
    enqueued, no synchronise inside the timed loop)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def psd_host_parts(fftm, torch, xp, psd) -> dict:
    """Host µs a call of the parts of ``psd_kernel``'s CUDA path: the
    output's allocation, the stream lookup, the stream's scratch, the C
    entry alone (its two launches) and the whole wrapper; the rest of
    the wrapper is its Python glue (the checked-once key, the count)."""
    from sigdigger_tpu_torch.kernels import _build

    a, b, dev = psd.params.a, psd.params.b, xp.device
    f = xp.shape[1] // b
    count = _build.scratch(dev, fftm.psd_parts(f) * a * b).data_ptr()
    out = torch.empty((a, b), device=dev)
    lib = _build.load_library("psd")
    args = (xp.data_ptr(), int(xp.dtype != torch.float32),
            psd.params.in_gain, psd.consts["pack"].data_ptr(),
            out.data_ptr(), count + 4 * _build.SCRATCH_COUNTERS, None, count,
            a, b, f, psd.params.scale,
            torch.cuda.current_stream().cuda_stream)
    return {k: round(v, 2) for k, v in {
        "empty": host_us(lambda: torch.empty((a, b), device=dev)),
        "stream": host_us(lambda: torch._C._cuda_getCurrentRawStream(
            torch.cuda.current_device())),
        "scratch": host_us(lambda: _build.scratch(dev, 1)),
        "entry": host_us(lambda: lib.sd_psd(*args)),
        "wrapper": host_us(lambda: fftm.psd_kernel(xp, psd.consts,
                                                   psd.params))}.items()}


def psd_stage_line(stages: dict, ms: float, nbytes: float,
                   turns: dict) -> str:
    """The FFT stages' traced device times, the HBM rate they reach (the
    function's bytes over the event time and over the traced stages'
    sum) and the medians of the kernel taking turns with its
    yardsticks."""
    dev = sum(v for k, v in stages.items() if k in ("psd_frames",
                                                    "psd_sum"))
    out = (f"stages traced (ms per launch) {stages}; "
           f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s at the event time")
    if dev > 0:
        out += (f", {nbytes / (dev * 1e-3) / 1e9:.1f} GB/s at the traced "
                f"{dev:.4f} ms")
    if turns:
        out += "; interleaved_ms (medians of 21 turns) " + ", ".join(
            f"{k} {v:.4f}" for k, v in turns.items())
    return out


def phase2_psd(fftm, torch) -> dict:
    """The standalone PSD kernel against its plain version, N = 4096,
    F = 128 (the digital receiver's PSD at the bench width), 3 blocks."""
    n = 4096
    frames = BLOCK_OUT * 64 // n
    psd = fftm.PSD(fftm.PSDConfig(fft_size=n, frames_per_block=frames),
                   FS, device="cuda")
    x, _, _ = synth_iq(F0S, 3 * psd.cfg.block_in, SEED + 2)
    worst_bin, max_abs = 0.0, 0.0
    for b in range(3):
        blk = x[b * psd.cfg.block_in:(b + 1) * psd.cfg.block_in]
        xp = torch.from_numpy(psd.prepare(blk)).cuda()
        got = fftm.psd_kernel(xp, psd.consts, psd.params)
        want = fftm.psd_kernel_reference(xp, psd.consts, psd.params)
        torch.cuda.synchronize()
        check(torch.isfinite(got).all())
        d = (got - want).abs()
        worst_bin = max(worst_bin, float((d / want.abs()).max()))
        max_abs = max(max_abs, float(d.max()))
    again = fftm.psd_kernel(xp, psd.consts, psd.params)
    same = bool(torch.equal(got, again))
    print(f"phase2 psd: worst bin rel err {worst_bin:.3g} (tol "
          f"{TOL_PSD_BIN}), max abs err {max_abs:.3g}, two launches "
          f"bit-equal {same}", flush=True)
    check(worst_bin <= TOL_PSD_BIN, worst_bin)
    check(same)
    ms = time_ms(lambda: fftm.psd_kernel(xp, psd.consts, psd.params), 20)
    plain_ms = time_ms(lambda: fftm.psd_kernel_reference(
        xp, psd.consts, psd.params), 3)
    frames_c = torch.from_numpy(
        (blk.reshape(frames, n) * psd._taps.astype(np.float32)).astype(
            np.complex64)).cuda()
    library_ms = time_ms(lambda: torch.fft.fft(frames_c), 20)
    raw = torch.from_numpy(blk.reshape(frames, n)).cuda()
    win = torch.from_numpy(psd._taps.astype(np.float32)).cuda()
    composed_ms = time_ms(lambda: psd_composed(raw, win), 20)
    bms, by, ops, nbytes = psd_bound(n, frames, 4)
    stages = profile_stages(
        lambda: fftm.psd_kernel(xp, psd.consts, psd.params),
        ("psd_frames", "psd_sum"))
    args = (xp, psd.consts, psd.params)
    turns = interleaved_ms({
        "psd_kernel": lambda: fftm.psd_kernel(*args),
        "torch.fft.fft": lambda: torch.fft.fft(frames_c),
        "psd_composed": lambda: psd_composed(raw, win)})
    print(f"phase2 psd timing: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
          f" torch.fft.fft of the [{frames}, {n}] windowed frames (library "
          f"yardstick, FFT only) {library_ms:.4f} ms, the PyTorch "
          f"composition (second yardstick: window, torch.fft.fft, |X|², "
          f"frame sum) {composed_ms:.4f} ms, bound {bms:.5f} ms by "
          f"{by} ({ops / 1e9:.4f} GFLOP, {nbytes / 2 ** 20:.2f} MiB); "
          f"stages {stages}; {psd_stage_line(stages, ms, nbytes, turns)}; "
          f"host µs a call {psd_host_parts(fftm, torch, xp, psd)}",
          flush=True)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bms, bound_by=by)


def psd_err(got, want) -> float:
    """The PSD kernel against its plain version, in units of phase 2's
    tolerance: every bin within TOL_PSD_BIN of itself; at B 256 and more
    each magnitude within 1e-5 of itself plus 1e-6 of the largest
    (tests/test_torch_psd.py: a 256-term float32 sum rounds the tone's
    terms into noise bins some 1e7 below it)."""
    if got.shape[1] >= 256:
        mg, mw = got.double().sqrt(), want.double().sqrt()
        return float(((mg - mw).abs() / (1e-5 * mw + 1e-6 * mw.max())).max())
    return float(((got - want).abs() / (TOL_PSD_BIN * want.abs())).max())


# the four-step PSD at factorings outside the fast path's powers of two
# in [16, 128]: (N, frames, A or 0 for the reference's rule)
PSD_SIZES = [(16, 8, 0), (64, 8, 0), (128, 8, 0), (1536, 8, 0),
             (32768, 4, 0)]


def phase2_psd_sizes(fftm, torch) -> None:
    """The standalone PSD kernel against its plain version at N 16 (A 4),
    64 and 128 (A 8, the offset estimator's sizes), 1536 (B 48) and
    32768 (B 256, the two-pass form).  Every bin within TOL_PSD_BIN of
    itself; at B 256 each magnitude within 1e-5 of itself plus 1e-6 of
    the largest (tests/test_torch_psd.py: a 256-term float32 sum rounds
    the tone's terms into noise bins some 1e7 below it)."""
    rng = np.random.default_rng(SEED + 11)
    out = []
    for n, frames, a in PSD_SIZES:
        p = fftm.PSD(fftm.PSDConfig(fft_size=n, frames_per_block=frames,
                                    a=a, frames_per_program=frames), FS,
                     device="cuda")
        k = np.arange(n * frames)
        x = (0.05 * (rng.standard_normal(len(k)) + 1j * rng.standard_normal(
            len(k))) + 0.8 * np.exp(2j * np.pi * 0.2 * k)).astype(
                np.complex64)
        xp = torch.from_numpy(p.prepare(x)).cuda()
        before = fftm.psd_kernel.launches
        got = fftm.psd_kernel(xp, p.consts, p.params)
        want = fftm.psd_kernel_reference(xp, p.consts, p.params)
        torch.cuda.synchronize()
        check(fftm.psd_kernel.launches == before + 1, n)
        check(got.shape == (p.cfg.a, p.cfg.b) and torch.isfinite(got).all())
        err = psd_err(got, want)
        check(err <= 1.0, (n, err))
        form = ", two passes" if fftm.psd_two_pass(p.cfg.a, p.cfg.b) else ""
        out.append(f"N {n} (A {p.cfg.a}, B {p.cfg.b}{form}): {err:.3g} of "
                   f"its tolerance")
    print("phase2 psd at every factoring: " + "; ".join(out), flush=True)


def sass_hgmma(srcs: dict) -> dict:
    """HGMMA instructions in the SASS of each tensor-core stage
    (``kernels/sass_report.py``), the reports of all sources at once."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from sigdigger_tpu_torch.kernels import _build, sass_report

    with ThreadPoolExecutor(len(srcs)) as pool:
        reports = dict(zip(srcs, pool.map(
            lambda f: sass_report.report(os.path.join(_build.CSRC, f)),
            srcs)))
    return {f"{src}:{k['kernel'][:60]}": k["hgmma"]
            for src, stage in srcs.items() for k in reports[src]
            if stage in k["kernel"]}


def phase2_raw(rawm, torch) -> dict:
    """The raw bank kernel against its plain version at 1024 channels,
    M = 8192 (m_tile 2048), two float32 planes, 3 chained blocks."""
    cfg = rawm.RawBankConfig(sample_rate=FS, n_channels=N_CHANNELS, taps=64,
                             decimation=64, block_out=BLOCK_OUT,
                             m_tile=2048)
    bank = rawm.RawBank(cfg, device="cuda")
    bank.begin_defer()
    for i, f0 in enumerate(F0S):
        bank.configure_channel(i, f0=float(f0), bw=DIG_BW)
    bank.end_defer()
    x, _, _ = synth_iq(F0S, 3 * cfg.block_in, SEED + 3)
    worst_plane, worst_pow, max_abs = 0.0, 0.0, 0.0
    for b in range(3):
        blk = x[b * cfg.block_in:(b + 1) * cfg.block_in]
        xr, xi = (torch.from_numpy(a).cuda() for a in bank.frame(blk))
        phi0 = torch.from_numpy(bank._phi_tiles()).cuda()
        args = (xr, xi, bank.consts["h_re"], bank.consts["h_im"],
                bank.consts["theta"], phi0, bank.params)
        got = rawm.raw_kernel(*args, bank.consts["bmat"])
        want = rawm.raw_kernel_reference(*args)
        torch.cuda.synchronize()
        top = max(float(want[0].abs().max()), float(want[1].abs().max()))
        for g, w in zip(got[:2], want[:2]):
            check(torch.isfinite(g).all())
            d = float((g - w).abs().max())
            max_abs = max(max_abs, d)
            worst_plane = max(worst_plane, d / top)
        worst_pow = max(worst_pow, float(
            ((got[2] - want[2]).abs() / want[2]).max()))
        # chain the rotator phase as RawBank._launch does
        bank._phi = np.mod(bank._phi + bank._theta64 * cfg.block_out,
                           2 * np.pi)
    print(f"phase2 raw: planes max abs err {max_abs:.3g} ({worst_plane:.3g}"
          f" of the largest, tol {TOL_RAW}), power worst rel err "
          f"{worst_pow:.3g} (tol {TOL_RAW})", flush=True)
    check(worst_plane <= TOL_RAW and worst_pow <= TOL_RAW,
          (worst_plane, worst_pow))
    bmat = bank.consts["bmat"]
    ms = time_ms(lambda: rawm.raw_kernel(*args, bmat), 20)
    plain_ms = time_ms(lambda: rawm.raw_kernel_reference(*args), 3)
    xc = torch.complex(xr, xi)
    hc = torch.complex(bank.consts["h_re"], bank.consts["h_im"])
    yard_ms = time_ms(lambda: torch.matmul(xc, hc), 20)
    bounds = raw_bound(BLOCK_OUT, 64, N_CHANNELS, BLOCK_OUT // 2048)
    bms, by = bounds[:2]
    stages = profile_stages(lambda: rawm.raw_kernel(*args, bmat),
                            ("raw_rot_tc", "raw_power"))
    print(f"phase2 raw timing: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"channelize matmul (yardstick, no rotator or power) "
          f"{yard_ms:.4f} ms, {bound_line(*bounds)}; stages {stages}",
          flush=True)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bms, bound_by=by)


# recovery lanes of every kind: (name, configure_channel keys, signal,
# concentration power, or 0 for none)
REC_VARIANTS = [
    ("psk2", dict(kind=0, order=2), "psk", 2),
    ("psk4", dict(kind=0, order=4), "psk", 4),
    ("psk8", dict(kind=0, order=8), "psk", 8),
    ("fsk_quad", dict(kind=1, use_mf=False), "fsk", 0),
    ("fsk_phase", dict(kind=1, use_mf=False, quad_demod=False,
                       fsk_phase=0.3), "fsk", 0),
    ("ask_env", dict(kind=2, use_mf=False), "ask", 0),
    ("ask_coh", dict(kind=2, use_mf=False, pll=True), "ask", 0),
    ("psk4_eq", dict(kind=0, order=4, eq_enabled=True), "psk", 4),
    ("psk4_manual", dict(kind=0, order=4, manual_clock=True,
                         clock_phase=0.25), "psk", 4),
    ("psk4_stopped", dict(kind=0, order=4, running=False), "psk", 0),
]


def recovery_lanes(n: int, seed: int):
    """[n, 1024] complex64 lane signals, lane i of variant i % 10 (PSK
    at sps 4 with RRC shaping and a small carrier offset, FSK and ASK at
    sps 8), plus light noise; returns (y, per-lane variant index)."""
    from sigdigger_tpu_torch.dsp.filters import rrc_taps

    rng = np.random.default_rng(seed)
    taps = rrc_taps(4.0, span=6, rolloff=0.35)
    k = np.arange(n)
    y = np.empty((n, N_CHANNELS), np.complex64)
    var = np.arange(N_CHANNELS) % len(REC_VARIANTS)
    for lane in range(N_CHANNELS):
        name, kw, sig, _ = REC_VARIANTS[var[lane]]
        if sig == "psk":
            order = kw["order"]
            up = np.zeros(n, np.complex128)
            up[::4] = np.exp(2j * np.pi * rng.integers(0, order, n // 4)
                             / order)
            z = np.convolve(up, taps)[:n] * np.exp(
                2j * np.pi * rng.uniform(-2e-3, 2e-3) * k)
        elif sig == "fsk":
            bits = rng.integers(0, 2, n // 8 + 1)
            z = np.exp(1j * np.cumsum((2 * bits - 1).repeat(8)[:n]
                                      * 0.1 * np.pi))
        else:
            bits = rng.integers(0, 2, n // 8 + 1)
            z = (0.4 + 0.6 * bits).repeat(8)[:n] * np.exp(
                2j * np.pi * 1e-3 * k)
        y[:, lane] = z
    y += 0.01 * (rng.standard_normal(y.shape)
                 + 1j * rng.standard_normal(y.shape))
    return y, var


def recovery_compare(recm, torch, bank, y: np.ndarray, lens) -> dict:
    """The recovery kernel and its plain version from the bank's state,
    chained over consecutive blocks of ``lens`` samples of ``y`` [T, C];
    returns both runs' symbols and strobes on the host, their final
    states, whether every output was bit-equal, and the CUDA-event time
    of the plain version's first block."""
    yr = torch.from_numpy(np.ascontiguousarray(y.real)).cuda()
    yi = torch.from_numpy(np.ascontiguousarray(y.imag)).cuda()
    consts = (bank.consts["params"], bank.consts["mf"], bank.params)
    sk = sp = torch.as_tensor(bank.state).cuda()
    outs_k, outs_p, plain_ms = [], [], None
    start = 0
    for n in lens:
        a = yr[start:start + n].contiguous()
        b = yi[start:start + n].contiguous()
        start += n
        ok = recm.recovery_kernel(a, b, sk, *consts)
        ms, op = time_once_ms(
            lambda: recm.recovery_kernel_reference(a, b, sp, *consts))
        plain_ms = ms if plain_ms is None else plain_ms
        sk, sp = ok[3], op[3]
        outs_k.append(ok)
        outs_p.append(op)
    torch.cuda.synchronize()
    bit_equal = all(torch.equal(u, v) for a, b in zip(outs_k, outs_p)
                    for u, v in zip(a, b))

    def host(outs):
        sym = torch.cat([torch.complex(o[0], o[1]) for o in outs])
        return (sym.cpu().numpy(),
                torch.cat([o[2] for o in outs]).cpu().numpy() > 0.5)

    (sym_k, st_k), (sym_p, st_p) = host(outs_k), host(outs_p)
    check(np.all(np.isfinite(sym_k)))
    return dict(sym_k=sym_k, st_k=st_k, sym_p=sym_p, st_p=st_p,
                per_k=sk[7].cpu().numpy(), per_p=sp[7].cpu().numpy(),
                bit_equal=bit_equal, plain_ms=plain_ms)


def recovery_agreement(r: dict, powers) -> dict:
    """The tolerance scheme: the symbols up to each lane's first moved
    strobe, then the strobe count, the period and the tail's M-th-power
    concentration (``powers`` per lane, 0 for none)."""
    from sigdigger_tpu_torch.kernels.recovery import strobe_agreement

    ag = strobe_agreement(r["sym_k"], r["st_k"], r["sym_p"], r["st_p"])
    dconc = 0.0
    for lane, power in enumerate(powers):
        if power:
            dconc = max(dconc, abs(
                conc(r["sym_k"][:, lane], r["st_k"][:, lane], power)
                - conc(r["sym_p"][:, lane], r["st_p"][:, lane], power)))
    out = dict(
        max_err=float(ag["max_err"].max()),
        moved=int((ag["first_diff"] < len(r["st_k"])).sum()),
        dcount=int(np.abs(ag["count_a"] - ag["count_b"]).max()),
        dper=float((np.abs(r["per_k"] - r["per_p"]) / r["per_p"]).max()),
        dconc=dconc)
    check(out["max_err"] <= TOL_SYM and out["dcount"] <= 1
          and out["dper"] <= 0.01 and out["dconc"] <= 0.02, out)
    return out


def agreement_line(r: dict, ag: dict) -> str:
    return (f"bit-equal to plain: {r['bit_equal']}; lanes whose strobes "
            f"moved {ag['moved']}; symbol max abs err before the first "
            f"moved strobe {ag['max_err']:.3g} (tol {TOL_SYM}); strobe "
            f"count diff {ag['dcount']} (tol 1); period rel diff "
            f"{ag['dper']:.3g} (tol 0.01); concentration diff "
            f"{ag['dconc']:.3g} (tol 0.02)")


# the recovery kernel beyond the main path's shape: (what it holds,
# lanes, chained block lengths, matched-filter taps K, equalizer taps keq)
# on lanes of the ten kinds of REC_VARIANTS; the kernel walks rows in
# chunks of 64 and lanes in groups of 16
REC_CASES = [
    ("ragged lanes, M not a multiple of the chunk, M < K", 100, (1000, 40),
     64, 5),
    ("keq 1", 128, (700,), 64, 1),
    ("keq 8", 128, (700,), 64, 8),
    ("K 1", 96, (517,), 1, 5),
]


def recovery_case(recm, torch, lanes: int, lens, k: int, keq: int,
                  seed: int) -> bool:
    """The recovery kernel and its plain version from one state over
    chained blocks of ``lens`` rows on ``lanes`` lanes of every kind, K
    ``k`` and keq ``keq``: whether every output and state row is equal.
    At K = 1 no lane has a matched filter (its single tap is 1), and the
    state is the bank's without the filter's tail rows."""
    n = -(-sum(lens) // 8) * 8
    y, var = recovery_lanes(n, seed)
    y = y[:sum(lens), :lanes]
    bank = recm.RecoveryBank(recm.RecoveryBankConfig(
        n_channels=lanes, block_len=lens[0], mf_taps_max=max(k, 64),
        eq_taps=keq), device="cuda")
    bank.begin_defer()
    for lane in range(lanes):
        name, kw, sig, _ = REC_VARIANTS[var[lane]]
        kw = dict(kw, use_mf=False) if k == 1 else kw
        bank.configure_channel(lane, sps=4.0 if sig == "psk" else 8.0,
                               loop_bw=0.005, clock_gain=0.08, **kw)
    bank.end_defer()
    state, mf, p = np.asarray(bank.state), bank.consts["mf"], bank.params
    if k == 1:
        state = np.concatenate([state[:16], state[16 + 2 * 63:]])
        mf = torch.ones((1, lanes), device="cuda")
        p = recm.RecoveryParams(k=1, keq=keq, adc=p.adc,
                                one_m_adc=p.one_m_adc)
    sk = sp = torch.from_numpy(np.ascontiguousarray(state)).cuda()
    yr = torch.from_numpy(np.ascontiguousarray(y.real)).cuda()
    yi = torch.from_numpy(np.ascontiguousarray(y.imag)).cuda()
    equal, start = True, 0
    for m in lens:
        a = yr[start:start + m].contiguous()
        b = yi[start:start + m].contiguous()
        start += m
        ok = recm.recovery_kernel(a, b, sk, bank.consts["params"], mf, p)
        op = recm.recovery_kernel_reference(a, b, sp, bank.consts["params"],
                                            mf, p)
        torch.cuda.synchronize()
        equal &= all(torch.equal(u, v) for u, v in zip(ok, op))
        sk, sp = ok[3], op[3]
    return equal


def qpsk_lanes(n: int, sps: int, seed: int) -> np.ndarray:
    """[n, 1024] complex64: QPSK at ``sps`` samples per symbol with RRC
    shaping (roll-off 0.35), a small carrier offset per lane, and light
    noise: what the psk receiver's recovery bank reads on modulated
    channels."""
    from sigdigger_tpu_torch.dsp.filters import rrc_taps

    rng = np.random.default_rng(seed)
    taps = rrc_taps(float(sps), span=8, rolloff=0.35)
    k = np.arange(n)
    y = np.empty((n, N_CHANNELS), np.complex64)
    for lane in range(N_CHANNELS):
        up = np.zeros(n, np.complex128)
        up[::sps] = np.exp(0.5j * np.pi * rng.integers(0, 4, len(up[::sps])))
        y[:, lane] = np.convolve(up, taps)[:n] * np.exp(
            2j * np.pi * rng.uniform(-5e-4, 5e-4) * k)
    y += 0.01 * (rng.standard_normal(y.shape)
                 + 1j * rng.standard_normal(y.shape))
    return y


def phase2_recovery(recm, torch) -> dict:
    """The recovery kernel against its plain version.  Main path: the
    psk receiver's own bank (1024 lanes, sps 8, 49-tap RRC matched
    filter) on QPSK at M = 8192, chained into a second block of 1024,
    where the plain version's first call is also its time.  Every kind:
    1024 lanes of the ten kinds and options over 2 chained blocks of
    1024 (the plain version is a Python loop of ~150 small operations
    per sample)."""
    # main path
    bank = digital_receiver("psk")._rec
    check(bank.cfg.block_len == BLOCK_OUT
          and int(np.count_nonzero(bank._mf[:, 0])) == 6 * DIG_SPS + 1)
    y_main = qpsk_lanes(BLOCK_OUT + REC_BLOCK, DIG_SPS, SEED + 6)
    r = recovery_compare(recm, torch, bank, y_main, (BLOCK_OUT, REC_BLOCK))
    ag = recovery_agreement(r, [4] * N_CHANNELS)
    check(r["bit_equal"], "recovery psk lanes")
    concs = [conc(r["sym_k"][:BLOCK_OUT, i], r["st_k"][:BLOCK_OUT, i], 4)
             for i in range(N_CHANNELS)]
    print(f"phase2 recovery, psk receiver lanes: {N_CHANNELS} lanes x "
          f"blocks of {BLOCK_OUT} and {REC_BLOCK}, "
          f"{agreement_line(r, ag)}; kernel's QPSK concentration over the "
          f"first block's second half: min {min(concs):.4f}", flush=True)
    max_err = ag["max_err"]

    # every kind
    mixed = recm.RecoveryBank(recm.RecoveryBankConfig(
        n_channels=N_CHANNELS, block_len=REC_BLOCK), device="cuda")
    y, var = recovery_lanes(2 * REC_BLOCK, SEED + 4)
    mixed.begin_defer()
    for lane in range(N_CHANNELS):
        name, kw, sig, _ = REC_VARIANTS[var[lane]]
        mixed.configure_channel(lane, sps=4.0 if sig == "psk" else 8.0,
                                loop_bw=0.005, clock_gain=0.08, **kw)
    mixed.end_defer()
    rm = recovery_compare(recm, torch, mixed, y, (REC_BLOCK, REC_BLOCK))
    agm = recovery_agreement(rm, [REC_VARIANTS[v][3] for v in var])
    check(rm["bit_equal"], "recovery every kind")
    sym_k, st_k, sym_p, st_p = rm["sym_k"], rm["st_k"], rm["sym_p"], rm["st_p"]
    # ASK: the DC tracker (pole 0.9995) has not settled in 2048 samples,
    # so the envelope statistics are held against the plain version's
    fsk_bimodal, dask = 1.0, 0.0
    for lane in range(N_CHANNELS):
        name = REC_VARIANTS[var[lane]][0]
        tk, tp = (np.real(s[:, lane][st[:, lane]])
                  for s, st in ((sym_k, st_k), (sym_p, st_p)))
        tk, tp = tk[len(tk) // 2:], tp[len(tp) // 2:]
        if name == "fsk_quad":
            fsk_bimodal = min(fsk_bimodal, float(np.mean(
                np.abs(np.abs(tk) - 0.1) < 0.03)))
        if name.startswith("ask"):
            dask = max(dask, abs(tk.mean() - tp.mean()),
                       abs(tk.std() / tp.std() - 1.0))
        if name == "psk4_stopped":
            check(not st_k[:, lane].any(), lane)
    print(f"phase2 recovery, every kind: {N_CHANNELS} lanes x 2 blocks of "
          f"{REC_BLOCK}, {agreement_line(rm, agm)}; fsk bimodal share "
          f"{fsk_bimodal:.3f} (> 0.9); ask tail mean / spread diff "
          f"{dask:.3g} (tol 0.02)", flush=True)
    check(fsk_bimodal > 0.9 and dask <= 0.02, (fsk_bimodal, dask))
    max_err = max(max_err, agm["max_err"])

    # the fused kernel's edges: lanes, rows, taps and equalizer lengths
    for i, (name, lanes, lens, k, keq) in enumerate(REC_CASES):
        check(recovery_case(recm, torch, lanes, lens, k, keq,
                            SEED + 30 + i), name)
        print(f"phase2 recovery, {name}: {lanes} lanes of every kind, "
              f"blocks of {lens} rows, K {k}, keq {keq}: bit-equal to the "
              f"plain version", flush=True)

    # timing at the main path's shape and lanes
    consts = (bank.consts["params"], bank.consts["mf"], bank.params)
    yr = torch.from_numpy(np.ascontiguousarray(y_main[:BLOCK_OUT].real))
    yi = torch.from_numpy(np.ascontiguousarray(y_main[:BLOCK_OUT].imag))
    yr, yi = yr.cuda(), yi.cuda()
    state0 = torch.as_tensor(bank.state).cuda()
    ms = time_ms(lambda: recm.recovery_kernel(yr, yi, state0, *consts), 5)
    strobes = int(r["st_k"][:BLOCK_OUT].sum())
    bms, by, ops, nbytes = recovery_bound(BLOCK_OUT, bank, strobes)
    stages = profile_stages(
        lambda: recm.recovery_kernel(yr, yi, state0, *consts),
        ("rec_fused",), reps=2)
    cyc = recm.recovery_step_cycles(yr, yi, state0, consts[0], bank.params)
    lane_strobes = int(r["st_k"][:BLOCK_OUT].sum(0).max())
    floor_ms = recm.latency_floor_ms(cyc, BLOCK_OUT, lane_strobes)
    print(f"phase2 recovery timing at M = {BLOCK_OUT}, psk receiver lanes: "
          f"kernel {ms:.4f} ms ({ms * 1e6 / BLOCK_OUT:.1f} ns a row), plain "
          f"(one call) {r['plain_ms']:.1f} ms, bound {bms:.4f} ms by {by} "
          f"({ops / 1e9:.3f} GFLOP at {strobes} strobes, "
          f"{nbytes / 2 ** 20:.1f} MiB); latency floor {floor_ms:.4f} ms: "
          f"the carrier loop {cyc['front']:.1f}, the Gardner clock "
          f"{cyc['clock']:.1f} cycles a row, the CMA {cyc['cma']:.1f} "
          f"cycles a strobe ({lane_strobes} on the busiest lane) at "
          f"{cyc['ghz']:.3f} GHz; device time per launch from the trace "
          f"{stages}", flush=True)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=r["plain_ms"],
                library_ms=None, bound_ms=bms, bound_by=by,
                floor_ms=floor_ms)


def conc(sym: np.ndarray, strobe: np.ndarray, power: int) -> float:
    """|mean(e^{j·power·angle})| of the second half of the strobed
    symbols: 1 for a clean constellation of that order."""
    got = sym[strobe]
    tail = got[len(got) // 2:]
    return float(np.abs(np.mean(np.exp(1j * power * np.angle(tail)))))


class ArraySource:
    def __init__(self, x: np.ndarray) -> None:
        self.x, self.pos = x, 0

    @property
    def eos(self) -> bool:
        return self.pos >= len(self.x)

    def read(self, n: int) -> np.ndarray:
        out = self.x[self.pos:self.pos + n]
        self.pos += n
        return out


def phase3_end_to_end(ch2, torch, card: str) -> int:
    from sigdigger_tpu_torch import KernelReceiver

    rx = KernelReceiver(
        sample_rate=FS, f0s=F0S, bw=BW, mode="fm", decimation=64,
        block_out=BLOCK_OUT, psd_fft=4096, in_i16=True, audio_bf16=True,
        audio_decim=AUDIO_DECIM)
    check(rx.device.type == "cuda")
    x, tones, pure = synth_iq(rx._chan.f0s, E2E_BLOCKS * rx.block_in, SEED)
    rx._chan.events = []
    # host time of each block's framing inside the pipelined run
    frame_ms: list[float] = []
    frame = rx._chan._frame

    def timed_frame(blk):
        t = time.perf_counter()
        out = frame(blk)
        frame_ms.append((time.perf_counter() - t) * 1e3)
        return out

    rx._chan._frame = timed_frame
    ch2.kernel2.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks = list(rx.run(ArraySource(x), pipeline_depth=3))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ch2.kernel2.launches
    del rx._chan._frame
    check(len(blocks) == E2E_BLOCKS, len(blocks))
    check(launches == E2E_BLOCKS, (launches, E2E_BLOCKS))

    audio = np.concatenate([b.audio for b in blocks])
    check(audio.shape == (E2E_BLOCKS * BLOCK_OUT // AUDIO_DECIM,
                           N_CHANNELS), audio.shape)
    check(np.all(np.isfinite(audio)))
    for ch, tone in tones.items():
        a = audio[2 * BLOCK_OUT // AUDIO_DECIM:, ch]
        spec = np.abs(np.fft.rfft((a - a.mean()) * np.hanning(len(a))))
        res = rx.audio_rate / len(a)
        f_pk = (np.argmax(spec[2:]) + 2) * res
        check(abs(f_pk - tone) <= 2 * res, (ch, f_pk, tone))
    psd = np.fft.fftshift(blocks[-1].psd)
    freqs = np.fft.fftshift(np.fft.fftfreq(4096, 1.0 / FS))
    pk = freqs[int(np.argmax(psd))]
    f_pure = rx._chan.f0s[pure]
    check(abs(pk - f_pure) <= 2 * FS / 4096, (pk, f_pure))
    check(np.all(np.isfinite(blocks[-1].psd)))

    kern = sorted(s.elapsed_time(e) for s, e in rx._chan.events)
    kernel_ms = kern[len(kern) // 2]
    block_ms = wall / E2E_BLOCKS * 1e3
    msps = rx.block_in / (wall / E2E_BLOCKS) / 1e6
    print(f"phase3 e2e: {E2E_BLOCKS} blocks, launches {launches}, kernel "
          f"{kernel_ms:.4f} ms (median, CUDA events), block wall "
          f"{block_ms:.3f} ms, {msps:.2f} Msps, audio peaks "
          f"{sorted(tones.values())} Hz ok, PSD peak {pk:.0f} Hz on "
          f"carrier {f_pure:.0f} Hz | card: {card}", flush=True)
    print(f"phase3 framing inside the run: median "
          f"{sorted(frame_ms)[len(frame_ms) // 2]:.4f} ms, min "
          f"{min(frame_ms):.4f} ms, max {max(frame_ms):.4f} ms over "
          f"{len(frame_ms)} blocks", flush=True)
    rx._chan.events = None
    print(f"phase3 stages (synchronous, median ms over 8 blocks after 2 "
          f"warm-up blocks): {stage_breakdown(rx, x, torch)}", flush=True)
    return launches


def stage_breakdown(rx, x: np.ndarray, torch) -> dict:
    """Host-clock time of each layer of one block, each stage ended by
    a synchronise: framing, H2D, kernel, D2H, PSD fold; medians over 8
    blocks after 2 warm-up blocks."""
    times: dict[str, list] = {k: [] for k in
                              ("frame", "h2d", "kernel", "d2h", "fold")}
    for b in range(10):
        blk = x[b * rx.block_in:(b + 1) * rx.block_in]
        t0 = time.perf_counter()
        xw = rx._chan._frame(blk)
        t1 = time.perf_counter()
        xw_d = torch.from_numpy(xw).to(rx.device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        audio = rx._chan.feed_packed(xw_d)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        audio_h, psd_h = audio.cpu(), rx._chan.psd_block.cpu().numpy()
        t4 = time.perf_counter()
        audio_h.float().numpy()
        rx._psd.fold(psd_h)
        t5 = time.perf_counter()
        if b < 2:
            continue
        for k, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                 t5 - t4)):
            times[k].append(dt * 1e3)
    return {k: round(sorted(v)[len(v) // 2], 4) for k, v in times.items()}


def synth_digital(f0s: np.ndarray, n: int, seed: int) -> np.ndarray:
    """QPSK at 200 kbaud (RRC, roll-off 0.35, held over each channel
    sample) on QPSK_CHANNELS, a pure carrier on DIG_PURE, and noise."""
    from sigdigger_tpu_torch.dsp.filters import rrc_taps

    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64) / FS
    x = 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    taps = rrc_taps(float(DIG_SPS), span=8, rolloff=0.35)
    m = n // 64
    for ch in QPSK_CHANNELS:
        up = np.zeros(m, np.complex128)
        up[::DIG_SPS] = np.exp(0.5j * np.pi * rng.integers(
            0, 4, len(up[::DIG_SPS])))
        bb = np.convolve(up, taps)[:m]
        x += 0.25 * np.repeat(bb, 64) * np.exp(2j * np.pi * f0s[ch] * t)
    x += 0.5 * np.exp(2j * np.pi * f0s[DIG_PURE] * t)
    return x.astype(np.complex64)


def digital_receiver(mode: str):
    from sigdigger_tpu_torch import KernelReceiver

    return KernelReceiver(
        sample_rate=FS, f0s=F0S, bw=DIG_BW, mode=mode, decimation=64,
        block_out=BLOCK_OUT, psd_fft=4096,
        baud=FS / 64 / DIG_SPS, psk_order=4)


def phase3b_digital(torch, card: str) -> dict:
    """The psk receiver end to end at full width, then fsk and ask;
    returns the psk run's launches per kernel."""
    from sigdigger_tpu_torch.kernels import fft, rawbank, recovery

    kernels = {"psd": fft.psd_kernel, "raw": rawbank.raw_kernel,
               "recovery": recovery.recovery_kernel}
    rx = digital_receiver("psk")
    check(rx.device.type == "cuda")
    x = synth_digital(F0S, DIG_BLOCKS * rx.block_in, SEED + 5)
    cols = list(QPSK_CHANNELS)
    sym, strobes = [], []
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = None
    for blk in rx.run(ArraySource(x), pipeline_depth=3):
        sym.append(blk.symbols[:, cols])
        strobes.append(blk.strobes[:, cols])
        check(blk.symbols.shape == (BLOCK_OUT, N_CHANNELS)
              and blk.symbols.dtype == np.complex64
              and blk.strobes.dtype == bool, blk.symbols.shape)
        last = blk
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    check(len(sym) == DIG_BLOCKS, len(sym))
    check(all(n == DIG_BLOCKS for n in launches.values()), launches)
    sym, strobes = np.concatenate(sym), np.concatenate(strobes)
    check(np.all(np.isfinite(sym)))
    half = DIG_BLOCKS * BLOCK_OUT // 2
    concs = [conc(sym[half:, i], strobes[half:, i], 4)
             for i in range(len(cols))]
    check(min(concs) > 0.85, concs)
    psd = np.fft.fftshift(last.psd)
    freqs = np.fft.fftshift(np.fft.fftfreq(4096, 1.0 / FS))
    pk = freqs[int(np.argmax(psd))]
    check(abs(pk - F0S[DIG_PURE]) <= 2 * FS / 4096, (pk, F0S[DIG_PURE]))
    check(np.all(np.isfinite(last.psd)))
    block_ms = wall / DIG_BLOCKS * 1e3
    print(f"phase3b psk e2e: {DIG_BLOCKS} blocks, launches {launches}, "
          f"block wall {block_ms:.3f} ms, "
          f"{rx.block_in / (wall / DIG_BLOCKS) / 1e6:.2f} Msps, QPSK "
          f"4th-power concentration {[round(c, 4) for c in concs]} "
          f"(> 0.85), PSD peak {pk:.0f} Hz on carrier {F0S[DIG_PURE]:.0f} "
          f"Hz | card: {card}", flush=True)
    print(f"phase3b stages (synchronous, median ms over 6 blocks after 2 "
          f"warm-up blocks): {digital_stages(rx, x, torch)}", flush=True)

    for mode in ("fsk", "ask"):
        rx = digital_receiver(mode)
        for k in kernels.values():
            k.launches = 0
        blocks = list(rx.run(ArraySource(x[:3 * rx.block_in]),
                             pipeline_depth=3))
        got = {name: k.launches for name, k in kernels.items()}
        check(len(blocks) == 3 and all(n == 3 for n in got.values()),
              (mode, got))
        check(all(np.all(np.isfinite(b.symbols)) and b.strobes.any()
                  for b in blocks), mode)
        print(f"phase3b {mode}: 3 blocks, launches {got}, strobes per "
              f"block {[int(b.strobes.sum()) for b in blocks]}", flush=True)
    return launches


def digital_stages(rx, x: np.ndarray, torch) -> dict:
    """Host-clock time of each layer of one digital block, each stage
    ended by a synchronise: framing (the PSD's, the raw bank's), H2D,
    the three kernels, D2H of symbols and strobes, PSD fold; medians
    over 6 blocks after 2 warm-up blocks."""
    from sigdigger_tpu_torch.kernels import fft

    keys = ("frame_psd", "frame_raw", "h2d", "psd", "raw", "recovery",
            "d2h", "fold")
    times: dict[str, list] = {k: [] for k in keys}
    n_blocks = len(x) // rx.block_in
    for b in range(8):
        i = b % n_blocks
        blk = x[i * rx.block_in:(i + 1) * rx.block_in]
        t = [time.perf_counter()]
        xp = rx._psd.prepare(blk)
        t.append(time.perf_counter())
        xr, xi = rx._raw.frame(blk)
        t.append(time.perf_counter())
        xp_d = torch.from_numpy(xp).to(rx.device)
        xr_d = torch.from_numpy(xr).to(rx.device)
        xi_d = torch.from_numpy(xi).to(rx.device)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        psd = fft.psd_kernel(xp_d, rx._psd.consts, rx._psd.params)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        y_re, y_im = rx._raw.feed_frames(xr_d, xi_d, fetch=False)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        sr, si, st = rx._rec.feed_planes(y_re, y_im, fetch=False)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        torch.complex(sr, si).cpu().numpy()
        (st > 0.5).cpu().numpy()
        t.append(time.perf_counter())
        rx._psd.fold(psd.cpu().numpy())
        t.append(time.perf_counter())
        if b < 2:
            continue
        for k, t0, t1 in zip(keys, t, t[1:]):
            times[k].append((t1 - t0) * 1e3)
    return {k: round(sorted(v)[len(v) // 2], 4) for k, v in times.items()}


def phase2_kernel2_cossin(ch2, torch) -> tuple:
    """kernel2 unfused with the cos/sin rotator against its plain
    version at the full bench width (int16 in, bf16 audio), live phase
    chained over 3 blocks.  Returns the kernels-line numbers and the 3
    int16 uploads (the PSD read from the window buffer reads them)."""
    cfg = ch2.MatChannelizer2Config(
        sample_rate=FS, n_channels=N_CHANNELS, taps=64, decimation=64,
        audio_taps=64, audio_decim=AUDIO_DECIM, block_out=BLOCK_OUT,
        m_tile=2048, psd_fft=4096, in_i16=True, audio_bf16=True,
        fuse_psd=False)
    chan = ch2.MatChannelizer2(cfg, F0S, BW, device="cuda", snap_grid=False)
    check(not chan._table_rot and not chan.params.fuse_psd)
    x, _, _ = synth_iq(chan.f0s, 3 * cfg.block_in, SEED + 7)
    ck = cp = (chan._prev_re, chan._prev_im, chan._ftail)
    worst = {"audio_frac": 0.0, "audio_max": 0.0, "tail_frac": 0.0,
             "carry_rel": 0.0}
    uploads = []
    for b in range(3):
        xw = torch.from_numpy(chan._frame(
            x[b * cfg.block_in:(b + 1) * cfg.block_in])).cuda()
        uploads.append(xw)
        phi0 = chan.phi0()
        ok = ch2.kernel2(xw, chan.consts, *ck, chan.params, phi0)
        op = ch2.kernel2_reference(xw, chan.consts, *cp, chan.params, phi0)
        torch.cuda.synchronize()
        check(ok[4] is None and op[4] is None)
        ck, cp = ok[1:4], op[1:4]
        fa, ma = disagree(ok[0], op[0], TOL_AUDIO, True)
        ft, _ = disagree(ok[3], op[3], TOL_TAIL, False)
        pr = torch.cat([op[1], op[2]])
        carry = float((torch.cat([ok[1], ok[2]]) - pr).abs().max()
                      / pr.abs().max())
        for key, v in (("audio_frac", fa), ("audio_max", ma),
                       ("tail_frac", ft), ("carry_rel", carry)):
            worst[key] = max(worst[key], v)
        check(torch.isfinite(ok[0].float()).all())
        if b < 2:
            chan._phi = chan._phi + chan._theta64[None, :] * cfg.block_out
    print(f"phase2 kernel2 unfused cos/sin, live phase: audio disagree frac "
          f"{worst['audio_frac']:.3g} (tol {TOL_FRAC}), audio max abs err "
          f"{worst['audio_max']:.6g}, ftail disagree frac "
          f"{worst['tail_frac']:.3g}, carry rel err {worst['carry_rel']:.3g}"
          f" (tol {TOL_REL})", flush=True)
    check(worst["audio_frac"] <= TOL_FRAC and worst["tail_frac"] <= TOL_FRAC
          and worst["carry_rel"] <= TOL_REL, worst)
    xw, phi0 = uploads[-1], chan.phi0()
    carries = (chan._prev_re, chan._prev_im, chan._ftail)
    ms = time_ms(lambda: ch2.kernel2(xw, chan.consts, *carries, chan.params,
                                     phi0), 20)
    plain_ms = time_ms(lambda: ch2.kernel2_reference(
        xw, chan.consts, *carries, chan.params, phi0), 5)
    xc = torch.complex(xw[:BLOCK_OUT].float() * chan.params.in_gain,
                       xw[BLOCK_OUT:].float() * chan.params.in_gain)
    hc = torch.complex(chan.consts["h_re"], chan.consts["h_im"])
    library_ms = time_ms(lambda: torch.matmul(xc, hc), 20)
    stages = profile_stages(
        lambda: ch2.kernel2(xw, chan.consts, *carries, chan.params, phi0),
        ("chan_rot_disc_tc", "audio_fir", "tail_copy"))
    bounds = kernel2_bound_ms(BLOCK_OUT, N_CHANNELS, 2, 2, 64, AUDIO_DECIM,
                              fused=False, mt=2048)
    bms, by = bounds[:2]
    print(f"phase2 kernel2 unfused cos/sin timing: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, channelize matmul (library yardstick) "
          f"{library_ms:.4f} ms, {bound_line(*bounds)}; stages {stages}",
          flush=True)
    return dict(max_abs_err=worst["audio_max"], ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bms, bound_by=by), uploads


def phase2_psd_xw(fftm, torch, uploads) -> tuple:
    """The PSD read from the window buffer against its plain version on
    the int16 [16384, 64] uploads of phase 2's live-phase blocks: N 4096
    (A 64) and N 2048 (A 32), frame_stride 1 and 4; then the device EMA
    chained over the 3 blocks.  Returns the kernels-line numbers of both
    forms."""
    worst_bin, max_abs, main = 0.0, 0.0, None
    for n in (4096, 2048):
        for stride in (1, 4):
            frames = BLOCK_OUT * 64 // n
            psd = fftm.PSDFromXW(
                fftm.PSDConfig(fft_size=n, frames_per_block=frames,
                               frames_per_program=8),
                BLOCK_OUT, FS, in_scale=1.0 / 4096.0, frame_stride=stride,
                device="cuda")
            for xw in uploads:
                got = fftm.psd_xw_kernel(xw, psd.consts, psd.xw_params)
                want = fftm.psd_xw_kernel_reference(xw, psd.consts,
                                                    psd.xw_params)
                torch.cuda.synchronize()
                check(torch.isfinite(got).all())
                d = (got - want).abs()
                worst_bin = max(worst_bin, float((d / want.abs()).max()))
                max_abs = max(max_abs, float(d.max()))
            if n == 4096 and stride == 1:
                main = psd
            if n == 4096 and stride == 4:
                strided = psd
    xw = uploads[-1]
    once = fftm.psd_xw_kernel(xw, main.consts, main.xw_params)
    same = bool(torch.equal(once, fftm.psd_xw_kernel(xw, main.consts,
                                                     main.xw_params)))
    print(f"phase2 psd_xw (N 4096 and 2048, stride 1 and 4, 3 blocks): "
          f"worst bin rel err {worst_bin:.3g} (tol {TOL_PSD_BIN}), max abs "
          f"err {max_abs:.3g}, two launches bit-equal {same}", flush=True)
    check(worst_bin <= TOL_PSD_BIN, worst_bin)
    check(same)
    # the device EMA, chained
    prev_k = prev_p = torch.zeros((64, 64), device="cuda")
    ema_bin, ema_abs = 0.0, 0.0
    for b, xw in enumerate(uploads):
        alpha = 1.0 if b == 0 else main.alpha_block
        prev_k = fftm.psd_xw_ema_kernel(xw, main.consts, main.xw_params,
                                        prev_k, alpha)
        prev_p = fftm.psd_xw_kernel_reference(xw, main.consts,
                                              main.xw_params, prev_p, alpha)
        torch.cuda.synchronize()
        d = (prev_k - prev_p).abs()
        ema_bin = max(ema_bin, float((d / prev_p.abs()).max()))
        ema_abs = max(ema_abs, float(d.max()))
    print(f"phase2 psd_xw ema (3 chained blocks): worst bin rel err "
          f"{ema_bin:.3g} (tol {TOL_PSD_BIN}), max abs err {ema_abs:.3g}",
          flush=True)
    check(ema_bin <= TOL_PSD_BIN, ema_bin)

    xw, p, c = uploads[-1], main.xw_params, main.consts
    ms = time_ms(lambda: fftm.psd_xw_kernel(xw, c, p), 20)
    plain_ms = time_ms(lambda: fftm.psd_xw_kernel_reference(xw, c, p), 3)
    ema_ms = time_ms(lambda: fftm.psd_xw_ema_kernel(xw, c, p, prev_k, 0.5),
                     20)
    ema_plain_ms = time_ms(lambda: fftm.psd_xw_kernel_reference(
        xw, c, p, prev_k, 0.5), 3)
    frames = BLOCK_OUT // 64
    win = c["w2d"].reshape(-1)
    xr = xw[:BLOCK_OUT].reshape(frames, 4096).float() * win
    xi = xw[BLOCK_OUT:].reshape(frames, 4096).float() * win
    frames_c = torch.complex(xr, xi)
    library_ms = time_ms(lambda: torch.fft.fft(frames_c), 20)
    xs = xw.reshape(2, frames, 4096)
    composed_ms = time_ms(lambda: psd_composed(
        torch.complex(xs[0].float(), xs[1].float()), win), 20)
    bms, by, ops, nbytes = psd_xw_bound(4096, frames, 2, False)
    ems, eby, eops, ebytes = psd_xw_bound(4096, frames, 2, True)
    stages = profile_stages(lambda: fftm.psd_xw_kernel(xw, c, p),
                            ("psd_frames", "psd_sum"))
    turns = interleaved_ms({
        "psd_xw_kernel": lambda: fftm.psd_xw_kernel(xw, c, p),
        "torch.fft.fft": lambda: torch.fft.fft(frames_c),
        "psd_composed": lambda: psd_composed(
            torch.complex(xs[0].float(), xs[1].float()), win)})
    # frame_stride 4: 32 of the 128 frames
    sp = strided.xw_params
    s_ms = time_ms(lambda: fftm.psd_xw_kernel(xw, strided.consts, sp), 20)
    s_stages = profile_stages(
        lambda: fftm.psd_xw_kernel(xw, strided.consts, sp),
        ("psd_frames", "psd_sum"))
    sbytes = psd_xw_bound(4096, frames // 4, 2, False)[3]
    print(f"phase2 psd_xw timing (N 4096, {frames} int16 frames): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, ema kernel {ema_ms:.4f} "
          f"ms, ema plain {ema_plain_ms:.4f} ms, torch.fft.fft of the "
          f"[{frames}, 4096] windowed frames (library yardstick, FFT only) "
          f"{library_ms:.4f} ms, the PyTorch composition from the upload "
          f"(second yardstick: int16 to complex, window, torch.fft.fft, "
          f"|X|², frame sum) {composed_ms:.4f} ms, bound {bms:.5f} ms by "
          f"{by} ({ops / 1e9:.4f} GFLOP, {nbytes / 2 ** 20:.2f} MiB), ema bound "
          f"{ems:.5f} ms by {eby}; stages {stages}; "
          f"{psd_stage_line(stages, ms, nbytes, turns)}; frame_stride 4 "
          f"({frames // 4} frames): kernel {s_ms:.4f} ms, "
          f"{psd_stage_line(s_stages, s_ms, sbytes, {})}; host "
          f"{host_us(lambda: fftm.psd_xw_kernel(xw, c, p)):.2f} µs a call",
          flush=True)
    return (dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                 library_ms=library_ms, bound_ms=bms, bound_by=by),
            dict(max_abs_err=ema_abs, ms=ema_ms, plain_ms=ema_plain_ms,
                 library_ms=library_ms, bound_ms=ems, bound_by=eby))


# the v1 channelizer at __graft_entry__.entry()'s geometry
V1_FS = 25_600_000.0
V1_CHANNELS = 256
V1_BLOCK = 1024
V1_F0S = np.linspace(-12e6, 12e6, V1_CHANNELS)


def v1_channelizer(ch1):
    cfg = ch1.MatChannelizerConfig(
        sample_rate=V1_FS, n_channels=V1_CHANNELS, taps=64, decimation=64,
        audio_taps=64, audio_decim=8, block_out=V1_BLOCK)
    return ch1.MatChannelizer(cfg, V1_F0S, bw=200e3, device="cuda")


def v1_signal(n: int, seed: int):
    """FM tones (±25 kHz deviation) on a few v1 channels plus noise;
    returns (iq, {channel: tone Hz})."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64) / V1_FS
    x = 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    tones = {40: 2000.0, 130: 3000.0, 220: 5000.0}
    for ch, tone in tones.items():
        x += 0.3 * np.exp(1j * (2 * np.pi * V1_F0S[ch] * t + 2 * np.pi
                                * 25e3 * np.cumsum(np.sin(
                                    2 * np.pi * tone * t)) / V1_FS))
    return x.astype(np.complex64), tones


def v1_bound(m: int, c: int, ka: int, da: int) -> tuple:
    """The complex product (8·M·K·C) in TC_PASSES TF32 passes on the
    tensor cores, 36 per channel sample for the cos/sin rotator,
    discriminator and atan2 and the FIR (2 per tap and audio sample) on
    the CUDA cores; bytes: both float32 window planes, the taps, θ, φ0
    and the carried row read once, audio and the last row written.
    Returns ``tc_bounds``' (bound, by, operations, bytes, CUDA-core
    bound)."""
    product = 8 * m * 64 * c
    rest = 36 * m * c + 2 * ka * (m // da) * c
    nbytes = 2 * m * 64 * 4 + 2 * 64 * c * 4 + 4 * c * 4 + ka * 4 \
        + (m // da) * c * 4 + 2 * c * 4
    return tc_bounds(product, rest, nbytes)


def kernel1_host_parts(ch1, torch, args) -> dict:
    """Host µs a call of the parts of ``kernel1``'s CUDA path: the
    outputs' allocation, the scratch lookup, the C entry alone (its two
    launches) and the whole wrapper; the rest of the wrapper is its
    Python glue (the checked-once key, the pointers, the count)."""
    from sigdigger_tpu_torch.kernels import _build

    xr, xi, consts, phi0, prev_re, prev_im, p = args
    m, c = xr.shape[0], phi0.shape[1]
    ma = m // p.da
    out = torch.empty((ma + 2, c), device="cuda")
    f_scr = _build.scratch(xr.device, m * c).data_ptr() \
        + 4 * _build.SCRATCH_COUNTERS
    lib = _build.load_library("channelizer")
    o, row = out.data_ptr(), 4 * c
    cargs = (xr.data_ptr(), xi.data_ptr(), consts["bmat"].data_ptr(),
             consts["theta"].data_ptr(), phi0.data_ptr(),
             prev_re.data_ptr(), prev_im.data_ptr(),
             consts["ataps"].data_ptr(), o, o + ma * row,
             o + (ma + 1) * row, f_scr, m, c, p.ka, p.da, p.quad_gain,
             torch.cuda.current_stream().cuda_stream)
    return {k: round(v, 2) for k, v in {
        "empty": host_us(lambda: torch.empty((ma + 2, c), device="cuda")),
        "scratch": host_us(lambda: _build.scratch(xr.device, m * c)),
        "entry": host_us(lambda: lib.sd_kernel1(*cargs)),
        "wrapper": host_us(lambda: ch1.kernel1(*args))}.items()}


def phase2_kernel1(ch1, torch) -> dict:
    """The v1 kernel against its plain version at the entry's geometry,
    3 chained blocks (phase and carried row advanced as
    ``MatChannelizer.feed`` does)."""
    chan = v1_channelizer(ch1)
    cfg = chan.cfg
    x, _ = v1_signal(3 * cfg.block_in, SEED + 8)
    ck = cp = (torch.zeros((1, V1_CHANNELS), device="cuda"),) * 2
    worst_frac, max_abs, carry_rel = 0.0, 0.0, 0.0
    hist = np.zeros(63, np.complex64)
    for b in range(3):
        xw, hist = ch1.make_windows(
            cfg, x[b * cfg.block_in:(b + 1) * cfg.block_in], hist)
        xr = torch.from_numpy(np.ascontiguousarray(xw.real)).cuda()
        xi = torch.from_numpy(np.ascontiguousarray(xw.imag)).cuda()
        phi0 = torch.from_numpy(np.mod(chan._phi, 2 * np.pi).astype(
            np.float32)).cuda()
        ok = ch1.kernel1(xr, xi, chan.consts, phi0, *ck, chan.params)
        op = ch1.kernel1_reference(xr, xi, chan.consts, phi0, *cp,
                                   chan.params)
        torch.cuda.synchronize()
        check(torch.isfinite(ok[0]).all())
        ck, cp = ok[1:], op[1:]
        fa, ma = disagree(ok[0], op[0], TOL_AUDIO, False)
        pr = torch.cat(op[1:])
        carry_rel = max(carry_rel, float((torch.cat(ok[1:]) - pr).abs().max()
                                         / pr.abs().max()))
        worst_frac, max_abs = max(worst_frac, fa), max(max_abs, ma)
        chan._phi = chan._phi + chan._theta64[None, :] * cfg.block_out
    print(f"phase2 kernel1 (v1, {V1_CHANNELS} channels, M {V1_BLOCK}): audio "
          f"disagree frac {worst_frac:.3g} (tol {TOL_FRAC}), audio max abs "
          f"err {max_abs:.6g}, carry rel err {carry_rel:.3g} (tol "
          f"{TOL_REL})", flush=True)
    check(worst_frac <= TOL_FRAC and carry_rel <= TOL_REL,
          (worst_frac, carry_rel))
    args = (xr, xi, chan.consts, phi0, *ck, chan.params)
    xc = torch.complex(xr, xi)
    hc = torch.complex(chan.consts["h_re"], chan.consts["h_im"])
    # the kernel and the channelize matmul in turns (medians)
    turns = interleaved_ms({"kernel": lambda: ch1.kernel1(*args),
                            "matmul": lambda: torch.matmul(xc, hc)})
    ms, library_ms = turns["kernel"], turns["matmul"]
    plain_ms = time_ms(lambda: ch1.kernel1_reference(*args), 5)
    bounds = v1_bound(V1_BLOCK, V1_CHANNELS, 64, 8)
    stages = profile_stages(lambda: ch1.kernel1(*args),
                            ("chan_rot_disc", "audio_fir"))
    host = kernel1_host_parts(ch1, torch, args)
    print(f"phase2 kernel1 timing: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, channelize matmul (library yardstick) {library_ms:.4f} ms "
          f"(medians of 21 turns), {bound_line(*bounds)}; stages {stages}; "
          f"host µs a call {host}", flush=True)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bounds[0],
                bound_by=bounds[1])


def fm_checks(rx, blocks, tones: dict, f_pure: float, n_fft: int) -> float:
    """Audio of the modulated channels peaks at their tones (after the
    first two blocks) and the last PSD on the pure carrier; returns the
    PSD peak's frequency."""
    audio = np.concatenate([b.audio for b in blocks])
    check(audio.shape == (len(blocks) * rx.cfg.audio_out, N_CHANNELS),
          audio.shape)
    check(np.all(np.isfinite(audio)))
    for ch, tone in tones.items():
        a = audio[2 * rx.cfg.audio_out:, ch]
        spec = np.abs(np.fft.rfft((a - a.mean()) * np.hanning(len(a))))
        res = rx.audio_rate / len(a)
        f_pk = (np.argmax(spec[2:]) + 2) * res
        check(abs(f_pk - tone) <= 2 * res, (ch, f_pk, tone))
    psd = np.fft.fftshift(blocks[-1].psd)
    freqs = np.fft.fftshift(np.fft.fftfreq(n_fft, 1.0 / FS))
    pk = freqs[int(np.argmax(psd))]
    check(abs(pk - f_pure) <= 2 * FS / n_fft, (pk, f_pure))
    check(np.all(np.isfinite(blocks[-1].psd)))
    return float(pk)


def fm_receiver(**kw):
    from sigdigger_tpu_torch import KernelReceiver

    args = dict(sample_rate=FS, f0s=F0S, bw=BW, mode="fm", decimation=64,
                block_out=BLOCK_OUT, psd_fft=4096, in_i16=True,
                audio_bf16=True, audio_decim=AUDIO_DECIM)
    args.update(kw)
    return KernelReceiver(**args)


def phase3c_every_geometry(ch2, fftm, torch, card: str) -> dict:
    """The unsnapped FM receiver at the full bench width over 12 blocks,
    then 3 blocks each of decimation 32 and psd_fft 2048; returns the
    first run's launches of kernel2 and psd_xw_kernel."""
    rx = fm_receiver(snap_grid=False)
    check(rx.device.type == "cuda" and not rx.cfg.fuse_psd
          and not rx._chan._table_rot and rx._shared_psd)
    x, tones, pure = synth_iq(rx._chan.f0s, E2E_BLOCKS * rx.block_in,
                              SEED + 9)
    grid = FS / rx.block_in
    check(abs(rx._chan.f0s[pure] / grid - round(rx._chan.f0s[pure] / grid))
          > 0.1, "the pure carrier must lie off the block-rate grid")
    ch2.kernel2.launches = 0
    fftm.psd_xw_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks = list(rx.run(ArraySource(x), pipeline_depth=3))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"kernel2_cossin": ch2.kernel2.launches,
                "psd_xw": fftm.psd_xw_kernel.launches}
    check(len(blocks) == E2E_BLOCKS, len(blocks))
    check(all(n == E2E_BLOCKS for n in launches.values()), launches)
    pk = fm_checks(rx, blocks, tones, rx._chan.f0s[pure], 4096)
    block_ms = wall / E2E_BLOCKS * 1e3
    print(f"phase3c fm unsnapped e2e: {E2E_BLOCKS} blocks, launches "
          f"{launches}, block wall {block_ms:.3f} ms, "
          f"{rx.block_in / (wall / E2E_BLOCKS) / 1e6:.2f} Msps, audio peaks "
          f"{sorted(tones.values())} Hz ok, PSD peak {pk:.0f} Hz on off-grid "
          f"carrier {rx._chan.f0s[pure]:.1f} Hz | card: {card}", flush=True)
    print(f"phase3c stages (synchronous, median ms over 8 blocks after 2 "
          f"warm-up blocks): {unfused_stages(rx, x, torch, fftm)}",
          flush=True)

    for name, kw, kernel in (
            ("decimation 32, standalone PSD", dict(decimation=32),
             fftm.psd_kernel),
            ("psd_fft 2048 snapped, A = 32", dict(psd_fft=2048),
             fftm.psd_xw_kernel)):
        rx = fm_receiver(**kw)
        check(not rx.cfg.fuse_psd and rx._chan._table_rot)
        x, tones, pure = synth_iq(rx._chan.f0s, 3 * rx.block_in, SEED + 10)
        ch2.kernel2.launches = kernel.launches = 0
        blocks = list(rx.run(ArraySource(x), pipeline_depth=3))
        got = (ch2.kernel2.launches, kernel.launches)
        check(len(blocks) == 3 and got == (3, 3), (name, got))
        audio = np.concatenate([b.audio for b in blocks])
        check(np.all(np.isfinite(audio)) and all(
            np.all(np.isfinite(b.psd)) for b in blocks), name)
        n_fft = kw.get("psd_fft", 4096)
        freqs = np.fft.fftshift(np.fft.fftfreq(n_fft, 1.0 / FS))
        pk = freqs[int(np.argmax(np.fft.fftshift(blocks[-1].psd)))]
        check(abs(pk - rx._chan.f0s[pure]) <= 2 * FS / n_fft, (name, pk))
        print(f"phase3c fm {name}: 3 blocks, launches (kernel2, PSD) {got}, "
              f"PSD peak {pk:.0f} Hz on carrier {rx._chan.f0s[pure]:.0f} Hz",
              flush=True)
    return launches


def unfused_stages(rx, x: np.ndarray, torch, fftm) -> dict:
    """Host-clock time of each layer of one unsnapped block, each stage
    ended by a synchronise: framing, H2D, kernel2 (with the tile-phase
    upload), the PSD from the upload, D2H, PSD fold; medians over 8
    blocks after 2 warm-up blocks."""
    keys = ("frame", "h2d", "kernel2", "psd_xw", "d2h", "fold")
    times: dict[str, list] = {k: [] for k in keys}
    for b in range(10):
        blk = x[b * rx.block_in:(b + 1) * rx.block_in]
        t = [time.perf_counter()]
        xw = rx._chan._frame(blk)
        t.append(time.perf_counter())
        xw_d = torch.from_numpy(xw).to(rx.device)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        audio = rx._chan.feed_packed(xw_d)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        psd = rx._psd.feed_async(xw_d)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        audio_h, psd_h = audio.cpu(), psd.cpu().numpy()
        t.append(time.perf_counter())
        audio_h.float().numpy()
        rx._psd.fold(psd_h)
        t.append(time.perf_counter())
        if b < 2:
            continue
        for k, t0, t1 in zip(keys, t, t[1:]):
            times[k].append((t1 - t0) * 1e3)
    return {k: round(sorted(v)[len(v) // 2], 4) for k, v in times.items()}


def phase3d_ema_and_v1(ch1, ch2, fftm, torch) -> dict:
    """The spectrum with the device EMA (``PSDFromXW.feed_ema`` on 12
    bench uploads, read once) and the v1 channelizer
    (``MatChannelizer.feed``, 4 blocks at the entry's geometry); returns
    the launches of each."""
    chan = ch2.MatChannelizer2(ch2.MatChannelizer2Config(
        sample_rate=FS, n_channels=N_CHANNELS, block_out=BLOCK_OUT,
        audio_decim=AUDIO_DECIM, in_i16=True, fuse_psd=False), F0S, BW,
        device="cuda", snap_grid=False)
    spec = fftm.PSDFromXW(
        fftm.PSDConfig(fft_size=4096, frames_per_block=BLOCK_OUT // 64,
                       frames_per_program=8),
        BLOCK_OUT, FS, in_scale=1.0 / 4096.0, device="cuda")
    x, _, pure = synth_iq(F0S, E2E_BLOCKS * chan.cfg.block_in, SEED + 11)
    n = chan.cfg.block_in
    uploads = [chan._frame(x[b * n:(b + 1) * n]) for b in range(E2E_BLOCKS)]
    fftm.psd_xw_ema_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for xw in uploads:
        spec.feed_ema(xw)
    shifted = spec.shifted()
    wall = time.perf_counter() - t0
    ema_launches = fftm.psd_xw_ema_kernel.launches
    check(ema_launches == E2E_BLOCKS, ema_launches)
    freqs = np.fft.fftshift(np.fft.fftfreq(4096, 1.0 / FS))
    pk = freqs[int(np.argmax(shifted))]
    check(np.all(np.isfinite(shifted)) and abs(pk - F0S[pure])
          <= 2 * FS / 4096, (pk, F0S[pure]))
    print(f"phase3d spectrum, device EMA: {E2E_BLOCKS} blocks, launches "
          f"{ema_launches}, {wall / E2E_BLOCKS * 1e3:.3f} ms per block "
          f"(upload and launch, one fetch at the end), peak {pk:.0f} Hz on "
          f"carrier {F0S[pure]:.0f} Hz", flush=True)

    v1 = v1_channelizer(ch1)
    x, tones = v1_signal(4 * v1.cfg.block_in, SEED + 12)
    ch1.kernel1.launches = 0
    t0 = time.perf_counter()
    audio = np.concatenate([v1.feed(x[b * v1.cfg.block_in:
                                      (b + 1) * v1.cfg.block_in])
                            for b in range(4)])
    wall = time.perf_counter() - t0
    v1_launches = ch1.kernel1.launches
    check(v1_launches == 4 and audio.shape == (4 * V1_BLOCK // 8,
                                               V1_CHANNELS), v1_launches)
    check(np.all(np.isfinite(audio)))
    rate = V1_FS / 64 / 8
    for ch, tone in tones.items():
        a = audio[V1_BLOCK // 8:, ch]
        sp = np.abs(np.fft.rfft((a - a.mean()) * np.hanning(len(a))))
        f_pk = (np.argmax(sp[2:]) + 2) * rate / len(a)
        check(abs(f_pk - tone) <= 2 * rate / len(a), (ch, f_pk, tone))
    print(f"phase3d v1 channelizer: 4 blocks, launches {v1_launches}, "
          f"{wall / 4 * 1e3:.3f} ms per block (framing, upload, launch, "
          f"fetch), audio peaks {sorted(tones.values())} Hz ok", flush=True)
    return {"psd_xw_ema": ema_launches, "kernel1": v1_launches}


def beyond(got, ref, tol: float) -> tuple[float, float]:
    """(share of elements with |d| > tol·(1 + |ref|), max abs
    difference); the share is 0 while at most 2 elements are beyond."""
    d = (got.float() - ref.float()).abs()
    bad = int((d > tol * (1.0 + ref.float().abs())).sum())
    return (0.0 if bad <= 2 else bad / d.numel()), float(d.max())


def session_slot_config(i: int) -> dict:
    """Audio slot i of a mix of every mode: FM, AM, USB, LSB, RAW and
    disabled; squelch on a quarter, AGC off on a third, agc.ts on a
    fifth."""
    return dict(f0=-48e6 + i * 93.75e3, bw=100e3, mode=i % 6,
                cutoff=5000.0, volume=1.0, squelch=i % 4 == 0,
                squelch_level=1e-4 * (i % 3), agc=i % 3 != 0,
                agc_ts=20.0 if i % 5 == 0 else 0.0)


# operations of the audio bank per channel sample, counted from
# kernels/audio.py: the rotator 10 (phase, sin and cos, rotation), the
# tile power 3, the discriminator 6 and its atan2 ~20, the envelope 5,
# the one-hot mix of the arms 8, the hang follower 10; per audio sample
# and plane the decimating FIR (2 per tap) and the slot FIR (2 per tap),
# then the Weaver shift 8 and the DC follower, gate and volume 6
AUDIO_SAMPLE_OPS = 62
AUDIO_OUT_OPS = 14


def audio_bound(m: int, c: int, mt: int, da: int, in_bytes: int,
                hang: bool) -> tuple:
    """The complex product (8·M·K·C), the per-sample and per-audio-sample
    work above on both planes; bytes: the windows, the taps and rows, the
    tile phases and every carry read once, the audio, the carries and
    the power written once."""
    k, ka, ka2, ma = 64, 64, 64, m // da
    per_sample = AUDIO_SAMPLE_OPS - (0 if hang else 10)
    ops = (8 * m * k * c + per_sample * m * c
           + ma * c * (2 * (2 * ka + 2 * ka2) + AUDIO_OUT_OPS))
    carries = (2 + 2 * (ka - 1) + 2 * (ka2 - 1) + 2 + 8) * c * 4
    nbytes = (2 * m * k * in_bytes + 2 * k * c * 4 + (16 + ka2) * c * 4
              + ka * 4 + 2 * (m // mt) * c * 4 + 2 * carries
              + ma * c * 4 + c * 4)
    return bound(ops, nbytes) + (ops, nbytes)


def audio_bank(audiom, hang: bool):
    """The engine's audio bank at the bench session's geometry (the
    shapes kernel_engine.py:355-375 gives it), with the slot mix of
    session_slot_config."""
    bank = audiom.AudioBank(audiom.AudioBankConfig(
        sample_rate=FS, n_channels=N_CHANNELS, decimation=64,
        audio_decim=AUDIO_DECIM, block_out=BLOCK_OUT, m_tile=2048,
        enable_ssb=True, in_scale=4096.0, fir_tile=1024,
        hang_agc=hang), device="cuda")
    bank.begin_defer()
    for i in range(N_CHANNELS):
        bank.configure_channel(i, **session_slot_config(i))
    bank.end_defer()
    return bank


def phase2_audio(audiom, torch) -> dict:
    """The audio bank kernel against its plain version at the bench
    session's shapes on 3 chained int16 packed uploads, hang AGC on, then
    off: the audio and every carry."""
    from sigdigger_tpu_torch.native import frame_windows_packed_i16

    max_abs = 0.0
    for hang in (True, False):
        worst = {"audio_frac": 0.0, "audio_max": 0.0, "carry_frac": 0.0}
        bank = audio_bank(audiom, hang)
        x, _, _ = synth_iq(np.array([session_slot_config(i)["f0"]
                                     for i in range(N_CHANNELS)]),
                           3 * bank.cfg.block_in, SEED + 13)
        ck = cp = tuple(torch.as_tensor(getattr(bank, s)).cuda()
                        for s in audiom.STATE)
        hist = np.zeros(63, np.complex64)
        for b in range(3):
            ext = np.concatenate([hist, x[b * bank.cfg.block_in:
                                          (b + 1) * bank.cfg.block_in]])
            hist = ext[-63:]
            xw = torch.from_numpy(frame_windows_packed_i16(
                ext, BLOCK_OUT, 64, 64, 4096.0)).cuda()
            phi0 = torch.from_numpy(bank._phase_tiles(
                bank._phi, bank._theta64, 2048)).cuda()
            phs0 = torch.from_numpy(bank._phase_tiles(
                bank._phs_a, bank._omega_a64, 2048 // AUDIO_DECIM)).cuda()
            args = (xw[:BLOCK_OUT], xw[BLOCK_OUT:], bank.consts)
            ok = audiom.audio_kernel(*args, ck, phi0, phs0, bank.params)
            op = audiom.audio_kernel_reference(*args, cp, phi0, phs0,
                                               bank.params)
            torch.cuda.synchronize()
            check(all(torch.isfinite(t).all() for t in ok))
            fa, ma = beyond(ok[0], op[0], TOL_AUDIO_BANK)
            carry = max(beyond(g, w, TOL_AUDIO_BANK)[0]
                        for g, w in zip(ok[1:], op[1:]))
            for key, v in (("audio_frac", fa), ("audio_max", ma),
                           ("carry_frac", carry)):
                worst[key] = max(worst[key], v)
            # chain: the kernel's carries feed the kernel, the plain
            # version's the plain version (power, ok[9], is not a carry)
            ck = ok[1:9] + ok[10:]
            cp = op[1:9] + op[10:]
            bank._phi = np.mod(bank._phi + bank._theta64 * BLOCK_OUT,
                               2 * np.pi)
            bank._phs_a = np.mod(bank._phs_a + bank._omega_a64
                                 * (BLOCK_OUT // AUDIO_DECIM), 2 * np.pi)
        if hang:
            main = (args, ck, phi0, phs0, bank)
        print(f"phase2 audio (hang_agc {hang}, 3 blocks): audio disagree "
              f"frac {worst['audio_frac']:.3g} (tol {TOL_AUDIO_FRAC}), "
              f"audio max abs err {worst['audio_max']:.6g}, carries "
              f"disagree frac {worst['carry_frac']:.3g}", flush=True)
        check(worst["audio_frac"] <= TOL_AUDIO_FRAC
              and worst["carry_frac"] <= TOL_AUDIO_FRAC, worst)
        max_abs = max(max_abs, worst["audio_max"])

    args, carries, phi0, phs0, bank = main
    # the hang walk bit for bit: the gain plane and the carry rows against
    # the plain recurrence (on the host) fed the kernel's own rotated
    # planes, with the carried follower state entering at tile 0 and 1
    for seed_tile in (0, 1):
        p = dataclasses.replace(bank.params, seed_tile=seed_tile)
        scratch = {}
        out = audiom.audio_kernel(*args, carries, phi0, phs0, p, scratch)
        torch.cuda.synchronize()
        gain, agcs = audiom.hang_agc_reference(
            audiom.magnitude(scratch["rr"].cpu(), scratch["ri"].cpu()),
            bank.consts["params"].cpu(), carries[-1].cpu(), seed_tile * 2048)
        check(torch.equal(scratch["gain"].cpu(), gain)
              and torch.equal(out[10].cpu(), agcs), ("hang walk", seed_tile))
        del scratch
    ops = audiom.hang_ops_mismatches()
    check(ops["sqrt_mismatches"] == 0 and ops["rcp_mismatches"] == 0, ops)
    print(f"phase2 audio hang walk: the gain plane and the carry rows "
          f"bit-equal to the plain recurrence on the kernel's own rr, ri at "
          f"seed_tile 0 and 1; its branch-free square root and reciprocal "
          f"equal the IEEE intrinsics on all {ops['sqrt_checked']} and "
          f"{ops['rcp_checked']} float32 values of their ranges", flush=True)
    rot = {}
    audiom.audio_kernel(*args, carries, phi0, phs0, bank.params, rot)
    cyc = audiom.audio_hang_step_cycles(rot["rr"], rot["ri"],
                                        bank.consts["params"], carries[-1],
                                        steps=BLOCK_OUT)
    floor_ms = audiom.hang_floor_ms(cyc, BLOCK_OUT)
    del rot
    ms = time_ms(lambda: audiom.audio_kernel(*args, carries, phi0, phs0,
                                             bank.params), 10)
    plain_ms = time_ms(lambda: audiom.audio_kernel_reference(
        *args, carries, phi0, phs0, bank.params), 1)
    xc = torch.complex(args[0].float() / 4096.0, args[1].float() / 4096.0)
    hc = torch.complex(bank.consts["h_re"], bank.consts["h_im"])
    yard_ms = time_ms(lambda: torch.matmul(xc, hc), 20)
    bms, by, ops, nbytes = audio_bound(BLOCK_OUT, N_CHANNELS, 2048,
                                       AUDIO_DECIM, 2, True)
    stages = profile_stages(
        lambda: audiom.audio_kernel(*args, carries, phi0, phs0, bank.params),
        ("raw_rot", "audio_tiles", "audio_hang_ws", "audio_demod",
         "audio_fir", "tail_copy", "audio_slot", "audio_dc"))
    print(f"phase2 audio timing (hang AGC, int16 in): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, channelize matmul (yardstick, part of "
          f"the function) {yard_ms:.4f} ms, bound {bms:.4f} ms by {by} "
          f"({ops / 1e9:.3f} GFLOP, {nbytes / 2 ** 20:.2f} MiB); hang AGC "
          f"{BLOCK_OUT} dependent steps per slot, the walker's chain "
          f"{cyc['cycles']:.2f} cycles a step at {cyc['ghz']:.3f} GHz: "
          f"latency floor {floor_ms:.4f} ms; stages {stages}", flush=True)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bms, bound_by=by)


def compact_bound(m: int, n: int, live: int, w: int, out_bytes: int,
                  scaled: bool) -> tuple:
    """Bytes: the mapped columns of each plane read once, the
    interleaved output and the map written/read once; operations: the
    int16 scaling and clip (3 per output), else none."""
    ops = 3 * n * m * w if scaled else 0
    nbytes = n * m * live * 4 + n * m * w * out_bytes + w * 4
    return bound(ops, nbytes) + (ops, nbytes)


def phase2_compact(compm, torch) -> dict:
    """The column compactor against its plain version (bit-equal) on the
    3 digital planes [8192, 1024], in float32, bfloat16 and int16 with
    scales: width 1024 with every slot active (the session's map: every
    run of columns read with vector loads), width 64 with a scattered
    map, width 77 (a tail run of 5 columns, stores column by column) and
    width 1024 shifted by one column (no run aligned).  Then the kernel
    at the session's map and ``torch.index_select`` timed in turns."""
    rng = np.random.default_rng(SEED + 14)
    planes = tuple(torch.from_numpy(
        (rng.standard_normal((BLOCK_OUT, N_CHANNELS)) * 0.7).astype(
            np.float32)).cuda() for _ in range(3))
    scattered = sorted(rng.choice(N_CHANNELS, 64, replace=False).tolist())
    maps = (("width 1024, every slot", N_CHANNELS, list(range(N_CHANNELS))),
            ("width 64, scattered", 64, scattered),
            ("width 77", 77, list(range(8, 85))),
            ("width 1024, shifted by one", N_CHANNELS,
             list(range(1, N_CHANNELS)) + [0]))
    outs = (("f32", {}), ("bf16", dict(out_bf16=True)),
            ("i16", dict(out_i16=True, scales=(8192.0, 8192.0, 4096.0))))
    max_abs, main = 0.0, None
    for label, width, cols in maps:
        for name, kw in outs:
            comp = compm.ColumnCompactor(compm.ColumnCompactorConfig(
                n_rows=BLOCK_OUT, n_channels=N_CHANNELS, width=width,
                n_planes=3, **kw), device="cuda")
            comp.set_mapping(cols)
            got = compm.compact_kernel(planes, comp._slots, comp._runs,
                                       comp.cfg)
            want = compm.compact_kernel_reference(planes, comp._slots,
                                                  comp.cfg)
            torch.cuda.synchronize()
            check(torch.equal(got, want), (label, name))
            max_abs = max(max_abs, float((got.float() - want.float())
                                         .abs().max()))
            if label.endswith("every slot") and name == "bf16":
                main = comp
        print(f"phase2 compact, {label} (f32/bf16/int16, "
              f"{int(comp._runs.sum())} of {comp._runs.numel()} runs "
              f"vector-loaded in int16): bit-equal to the plain version",
              flush=True)
    comp = main
    stacked = torch.cat(planes)
    idx = comp._slots.long()
    t = interleaved_ms({
        "kernel": lambda: compm.compact_kernel(planes, comp._slots,
                                               comp._runs, comp.cfg),
        "library": lambda: torch.index_select(stacked, 1, idx)})
    ms, library_ms = t["kernel"], t["library"]
    plain_ms = time_ms(lambda: compm.compact_kernel_reference(
        planes, comp._slots, comp.cfg), 5)
    bms, by, ops, nbytes = compact_bound(BLOCK_OUT, 3, N_CHANNELS,
                                         N_CHANNELS, 2, False)
    stages = profile_stages(lambda: compm.compact_kernel(
        planes, comp._slots, comp._runs, comp.cfg), ("compact<",))
    print(f"phase2 compact timing (3 x [8192, 1024] -> bf16, width 1024), "
          f"medians of 21 turns: kernel {ms:.4f} ms, torch.index_select of "
          f"the mapped columns of the 3 planes stacked (library yardstick, "
          f"float32, no interleave) {library_ms:.4f} ms; plain "
          f"{plain_ms:.4f} ms, bound {bms:.4f} ms by {by} "
          f"({nbytes / 2 ** 20:.2f} MiB, {bms / ms:.0%} of it reached); "
          f"device time per launch from the trace {stages}", flush=True)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bms, bound_by=by)


def squeeze_bound(m: int, c: int, r: int) -> tuple:
    """Bytes: 3 planes [M, C] read once, 3 planes [M/R, C] written once;
    operations: 2 products and 3 sums per input row element."""
    ops = 5 * m * c
    nbytes = 3 * m * c * 4 + 3 * (m // r) * c * 4
    return bound(ops, nbytes) + (ops, nbytes)


def strobe_plane(m: int, c: int, sps: int, rng) -> np.ndarray:
    """Strobes every ``sps`` rows from a random phase per column, with
    the Gardner loop's ±1-row jitter on a tenth of them."""
    st = np.zeros((m, c), np.float32)
    for col in range(c):
        rows = np.arange(int(rng.integers(0, sps)), m, sps)
        jit = rng.integers(-1, 2, len(rows)) * (rng.random(len(rows)) < 0.1)
        st[np.clip(rows + jit, 0, m - 1), col] = 1.0
    return st


def squeeze_planes(torch, rng, m: int, c: int, offset: int) -> tuple:
    """sr, si and a strobe plane at sps 8, float32 [m, c] on the card,
    each a view starting ``offset`` elements into its own buffer."""
    bufs = [torch.from_numpy((rng.standard_normal(m * c + offset) * 0.7)
                             .astype(np.float32)).cuda() for _ in range(2)]
    st = np.concatenate([np.zeros(offset, np.float32),
                         strobe_plane(m, c, 8, rng).ravel()])
    bufs.append(torch.from_numpy(st).cuda())
    return tuple(b[offset:].view(m, c) for b in bufs)


def phase2_squeeze(sqm, torch) -> dict:
    """The symbol squeeze against its plain version (bit-equal) at R 2, 4
    and 8 on the float4 path (3 x [8192, 1024] float32, strobes at sps
    8), the scalar path for C % 4 != 0 (C 1022) and for inputs that are
    not 16-byte aligned (views one column into their buffers); then the
    bench shape at R 4 timed in turns with ``torch.sum``, and both
    traced."""
    rng = np.random.default_rng(SEED + 16)
    m, c, r = BLOCK_OUT, N_CHANNELS, 4
    max_abs = 0.0
    for label, cc, offset, path in (
            ("C 1024", c, 0, "vector"), ("C 1022", c - 2, 0, "scalar"),
            ("C 1024 one column into the buffers", c, 1, "scalar")):
        sr, si, st = squeeze_planes(torch, rng, m, cc, offset)
        for rr in (2, 4, 8):
            got = sqm.squeeze_kernel(sr, si, st, rr)
            want = sqm.squeeze_kernel_reference(sr, si, st, rr)
            torch.cuda.synchronize()
            check(sqm.squeeze_kernel.path == path, (label, rr))
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  ("squeeze", label, rr))
            max_abs = max(max_abs, max(float((g - w).abs().max())
                                       for g, w in zip(got, want)))
        print(f"phase2 squeeze, {label}: {path} path, bit-equal to the "
              f"plain version at R 2, 4 and 8", flush=True)
    sr, si, st = squeeze_planes(torch, rng, m, c, 0)
    got = sqm.squeeze_kernel(sr, si, st, r)
    check(float(got[2].max()) <= 2.0 and float(got[2].sum())
          == float(st.sum()), "strobe count")
    pre = torch.stack([sr * st, si * st, st]).view(3, m // r, r, c)
    t = interleaved_ms({"kernel": lambda: sqm.squeeze_kernel(sr, si, st, r),
                        "library": lambda: torch.sum(pre, 2)})
    ms, library_ms = t["kernel"], t["library"]
    plain_ms = time_ms(lambda: sqm.squeeze_kernel_reference(sr, si, st, r),
                       10)
    bms, by, ops, nbytes = squeeze_bound(m, c, r)
    stages = profile_stages(lambda: sqm.squeeze_kernel(sr, si, st, r),
                            ("::squeeze<",), reps=21)
    lib_stages = profile_stages(lambda: torch.sum(pre, 2),
                                ("reduce_kernel",), reps=21)
    print(f"phase2 squeeze timing (3 x [8192, 1024] f32, R 4, sps 8, "
          f"{sqm.squeeze_kernel.path} path): max abs err {max_abs}; medians "
          f"of 21 turns: kernel {ms:.4f} ms, torch.sum over the [M/R, R, C] "
          f"view of the pre-multiplied planes (library yardstick, "
          f"reduction only) {library_ms:.4f} ms; plain {plain_ms:.4f} ms, "
          f"bound {bms:.4f} ms by {by} ({nbytes / 2 ** 20:.2f} MiB); device "
          f"time per launch from the trace: kernel {stages}, torch.sum "
          f"{lib_stages}", flush=True)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bms, bound_by=by)


def pack_bound(cfg, live: dict) -> tuple:
    """Bytes the pack moves: each section's live source columns read
    once (``live`` per section), the status rows' mapped columns, the
    maps, and the int16 buffer written once; operations: the scale and
    clip of each output element (3) and the residual split (12 per
    status value)."""
    rows = {"audio": cfg.audio_rows, "digital": cfg.digital_rows,
            "raw": cfg.n_rows}
    planes = {"audio": 1, "digital": 3, "raw": 2}
    nbytes = cfg.total_tiles * cfg.m_tile * cfg.width * 2
    nbytes += 2 * live["status"] * 4 + cfg.width * 4
    for sec, n in live.items():
        if sec != "status":
            nbytes += planes[sec] * rows[sec] * n * 4
            nbytes += getattr(cfg, f"{sec}_width") * 4
    ops = 3 * cfg.total_tiles * cfg.m_tile * cfg.width + \
        12 * 2 * live["status"]
    return bound(ops, nbytes) + (ops, nbytes)


def pack_sector_bound(cfg, maps: dict) -> tuple:
    """The pack's floor for a gather: the bytes of the 32-byte sectors
    that the maps' columns touch in each row of each plane read (a
    sparse map cannot fetch less), the maps and the buffer written once;
    operations as :func:`pack_bound`.  ``maps`` holds the numpy maps."""
    c = cfg.n_channels

    def sectors(cols, rows):
        cols = np.unique(cols[cols >= 0])
        if c % 8 == 0:
            return rows * len(np.unique(cols // 8))
        return len(np.unique((np.arange(rows)[:, None] * c
                              + cols[None, :]) // 8))

    nbytes = cfg.total_tiles * cfg.m_tile * cfg.width * 2
    nbytes += 2 * sectors(maps["status"], 1) * 32 + cfg.width * 4
    planes = {"audio": 1, "digital": 3, "raw": 2}
    for sec, n in planes.items():
        if sec in maps:
            rows = cfg.audio_rows if sec == "audio" else (
                cfg.digital_rows if sec == "digital" else cfg.n_rows)
            nbytes += n * sectors(maps[sec], rows) * 32 + len(maps[sec]) * 4
    ops = 3 * cfg.total_tiles * cfg.m_tile * cfg.width + \
        12 * 2 * int((maps["status"] >= 0).sum())
    return bound(ops, nbytes) + (ops, nbytes)


def pack_case(dpm, torch, rng, cfg, live: dict, order: str = "sorted"):
    """A packer at ``cfg`` with ``live[sec]`` random columns per section
    (every slot on the status tile when ``live["status"]`` is the
    width), ``order`` "sorted", "shuffled", or "holes" (sorted, every
    third lane of each data section empty); returns (packer, planes, sq,
    pw)."""
    c = cfg.n_channels
    pk = dpm.DrainPacker(cfg, device="cuda")
    maps = {}
    for sec, n in live.items():
        cols = rng.choice(c, n, replace=False)
        cols = rng.permutation(cols) if order == "shuffled" else np.sort(cols)
        if order == "holes" and sec != "status":
            cols[::3] = -1
        maps[sec] = cols.tolist()
    pk.set_mappings(maps.pop("status"), **maps)

    def plane(rows, scale=0.7):
        return torch.from_numpy((rng.standard_normal((rows, c)) * scale)
                                .astype(np.float32)).cuda()

    planes = {}
    if cfg.has_audio:
        planes["audio"] = plane(cfg.audio_rows, 3.0)
    if cfg.has_digital:
        planes["d_sr"] = plane(cfg.digital_rows)
        planes["d_si"] = plane(cfg.digital_rows)
        planes["d_st"] = torch.from_numpy(strobe_plane(
            cfg.digital_rows, c, 2, rng)).cuda()
    if cfg.has_raw:
        planes["y_re"] = plane(cfg.n_rows, 0.2)
        planes["y_im"] = plane(cfg.n_rows, 0.2)
    # powers and squelch EMAs from 1e-1 down to 1e-9
    pw = torch.from_numpy(np.logspace(-1, -9, c).astype(np.float32)[
        None, rng.permutation(c)]).cuda()
    sq = (pw * 0.5).contiguous()
    return pk, planes, sq, pw


def pack_host_parts(dpm, torch, pk, planes, sq, pw) -> dict:
    """Host µs a call of the parts of ``pack_kernel``'s CUDA path: the
    output's allocation, the C entry alone (its launch), the whole
    wrapper and ``DrainPacker.dispatch``; the rest of the wrapper is its
    Python glue (the checked-once key, the pointers, the count)."""
    from sigdigger_tpu_torch.kernels import _build

    cfg, maps = pk.cfg, pk._maps
    plan = dpm._PLANS[(id(cfg), sq.device)]
    shape = plan.shape
    out = torch.empty(shape, dtype=torch.int16, device="cuda")
    lib = _build.load_library("drainpack")
    args = (plan.table_ptr, plan.n_blocks,
            *(planes[n].data_ptr() if n in plan.names else 0
              for n in dpm._PLANE_ORDER),
            *(maps[s].data_ptr() if s in plan.sels else 0
              for s in ("audio", "digital", "raw")),
            maps["status"].data_ptr(), sq.data_ptr(), pw.data_ptr(),
            out.data_ptr(), *plan.ints, 1,
            torch.cuda.current_stream().cuda_stream)
    kw = {"audio": planes.get("audio"), "sq": sq, "pw": pw}
    if cfg.has_digital:
        kw["dig"] = tuple(planes[n] for n in ("d_sr", "d_si", "d_st"))
    if cfg.has_raw:
        kw["raw"] = (planes["y_re"], planes["y_im"])
    return {k: round(v, 2) for k, v in {
        "empty": host_us(lambda: torch.empty(shape, dtype=torch.int16,
                                             device="cuda")),
        "entry": host_us(lambda: lib.sd_drainpack(*args)),
        "wrapper": host_us(lambda: dpm.pack_kernel(planes, sq, pw, maps,
                                                   cfg)),
        "dispatch": host_us(lambda: pk.dispatch(**kw))}.items()}


def phase2_pack(dpm, torch) -> dict:
    """The drain packer against its plain version (bit-equal) at the
    bench session's layout (width 1024: 832 live audio columns in 4
    tiles of 64 rows, every slot on the status tile; the digital section
    left for its side compactor), at a grouped layout (G 2 in every
    section, squeezed digital rows, a raw section), at width 8 (the
    smallest), the status tile alone, the bench layout with an unsorted
    map, and the grouped one with empty lanes inside each group; each
    layout's traced device time beside its live-byte and sector
    bounds."""
    rng = np.random.default_rng(SEED + 17)
    m, c = BLOCK_OUT, N_CHANNELS
    bench_cfg = dpm.DrainPackerConfig(
        n_rows=m, audio_rows=m // AUDIO_DECIM, n_channels=c, width=1024,
        has_audio=True, has_digital=False, has_raw=False,
        audio_width=1024, digital_rows=m // 4, m_tile=64)
    grouped_cfg = dpm.DrainPackerConfig(
        n_rows=m, audio_rows=m // AUDIO_DECIM, n_channels=c, width=1024,
        audio_width=512, digital_width=512, raw_width=512,
        digital_rows=m // 4)
    check(all(grouped_cfg.group(s) == 2 for s in ("audio", "digital", "raw")))
    grouped_live = {"status": 1024, "audio": 400, "digital": 300, "raw": 200}
    cases = {
        "bench": (bench_cfg, {"status": 1024, "audio": 832}, "sorted"),
        "grouped": (grouped_cfg, grouped_live, "sorted"),
        "width 8": (dpm.DrainPackerConfig(
            n_rows=m, audio_rows=m // AUDIO_DECIM, n_channels=c, width=8,
            digital_rows=m // 4),
            {"status": 8, "audio": 5, "digital": 7, "raw": 3}, "sorted"),
        "status only": (dpm.DrainPackerConfig(
            n_rows=m, audio_rows=m // AUDIO_DECIM, n_channels=c, width=1024,
            has_audio=False, has_digital=False, has_raw=False),
            {"status": 1024}, "sorted"),
        "unsorted": (bench_cfg, {"status": 1024, "audio": 832}, "shuffled"),
        "holes": (grouped_cfg, grouped_live, "holes"),
    }
    max_abs, out = 0.0, {}
    for name, (cfg, live, order) in cases.items():
        pk, planes, sq, pw = pack_case(dpm, torch, rng, cfg, live, order)
        got = dpm.pack_kernel(planes, sq, pw, pk._maps, cfg)
        want = dpm.pack_kernel_reference(planes, sq, pw, pk._maps, cfg)
        torch.cuda.synchronize()
        check(torch.equal(got, want), name)
        max_abs = max(max_abs, float((got.float() - want.float())
                                     .abs().max()))
        sec = pk.fetch(got)
        status = pk._maps["status"].long()
        np.testing.assert_allclose(sec["power"], pw[0, status].cpu().numpy(),
                                   rtol=1e-5, atol=4e-12)
        out[name] = (cfg, live, pk, planes, sq, pw)
    print(f"phase2 pack ({', '.join(f'{k}: width {v[0].width}, '
                                    f'{v[0].total_tiles} x {v[0].m_tile} '
                                    f'rows' for k, v in cases.items())}): "
          f"bit-equal to the plain version at every layout, max abs err "
          f"{max_abs}, status powers 1e-1..1e-9 decoded within 1e-5",
          flush=True)
    res = {"max_abs_err": max_abs}
    for name, (cfg, live, pk, planes, sq, pw) in out.items():
        maps = pk._maps
        timed = name in ("bench", "grouped")
        if timed:
            ms = time_ms(lambda: dpm.pack_kernel(planes, sq, pw, maps, cfg),
                         50)
        # the event time holds the wrapper's host work; the trace gives
        # the kernel's own device time
        stages = profile_stages(
            lambda: dpm.pack_kernel(planes, sq, pw, maps, cfg), ("::pack(",))
        host_maps = {k: v.cpu().numpy() for k, v in maps.items()}
        bms, by, ops, nbytes = pack_bound(
            cfg, {k: int((v >= 0).sum()) for k, v in host_maps.items()})
        sms, _, _, sbytes = pack_sector_bound(cfg, host_maps)
        line = (f"bound {bms:.5f} ms by {by} ({nbytes / 2 ** 20:.3f} MiB: "
                f"the buffer "
                f"{cfg.total_tiles * cfg.m_tile * cfg.width * 2 / 2 ** 10:.0f}"
                f" KiB), sector bound {sms:.5f} ms ({sbytes / 2 ** 20:.3f} "
                f"MiB of 32-byte sectors); device time per launch from the "
                f"trace {stages}")
        if not timed:
            print(f"phase2 pack ({name} layout): {line}", flush=True)
            continue
        plain_ms = time_ms(lambda: dpm.pack_kernel_reference(
            planes, sq, pw, maps, cfg), 10)
        # library yardstick: index_select of each section's live columns,
        # then the quantize (no lane grouping, no status split)
        sel = {sec: maps[sec][:n].long() for sec, n in live.items()
               if sec != "status"}
        pairs = [(planes[p], sel[dpm._SEL_OF[p]], dpm._SCALES[p])
                 for p in planes]

        def library():
            for x, idx, scale in pairs:
                torch.clamp(torch.index_select(x, 1, idx) * scale,
                            -32768.0, 32767.0).to(torch.int16)

        library_ms = time_ms(library, 50)
        print(f"phase2 pack timing ({name} layout): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, torch.index_select of the live "
              f"columns then the quantize (library yardstick) "
              f"{library_ms:.4f} ms, {line}; host µs a call "
              f"{pack_host_parts(dpm, torch, pk, planes, sq, pw)}",
              flush=True)
        if name == "bench":
            res.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bms, bound_by=by)
    return res


def ring_source(blocks, freq: float = 0.0):
    """A SignalSource replaying pre-made distinct blocks, one per read
    (the reference bench's RingSource, bench.py:233-246), tuned to
    ``freq``."""
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.sources.base import SignalSource

    class RingSource(SignalSource):
        def _read_impl(self, n):
            b = blocks[(self._pos // n) % len(blocks)]
            check(len(b) == n, (len(b), n))
            return b

    return RingSource(SourceProfile(type="synth", sample_rate=int(FS),
                                    freq=freq))


def session_iq(n: int, seed: int, doppler=None) -> np.ndarray:
    """FM tones on the FM_SLOTS audio channels, QPSK at 200 kbaud on the
    QPSK_SLOTS psk channels, a pure carrier on the CARRIER_POWER_SLOT
    power channel, and noise.  ``doppler`` maps an FM slot to its
    carrier's shift in Hz in each block of BLOCK_OUT·64 samples (the
    phase stays continuous across the steps)."""
    from sigdigger_tpu_torch.dsp.filters import rrc_taps

    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64) / FS
    x = 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for slot, tone in FM_SLOTS.items():
        fc = -48e6 + slot * 115e3
        ph = 2 * np.pi * fc * t + 2 * np.pi * 50e3 * np.cumsum(
            np.sin(2 * np.pi * tone * t)) / FS
        if doppler and slot in doppler:
            ph += 2 * np.pi * np.cumsum(np.repeat(
                doppler[slot], BLOCK_OUT * 64)[:n]) / FS
        x += 0.25 * np.exp(1j * ph)
    taps = rrc_taps(8.0, span=8, rolloff=0.35)
    m = n // 64
    for slot in QPSK_SLOTS:
        up = np.zeros(m, np.complex128)
        up[::8] = np.exp(0.5j * np.pi * rng.integers(0, 4, len(up[::8])))
        bb = np.convolve(up, taps)[:m]
        x += 0.25 * np.repeat(bb, 64) * np.exp(
            2j * np.pi * (1e6 + slot * 500e3) * t)
    x += 0.5 * np.exp(2j * np.pi * (34e6 + CARRIER_POWER_SLOT * 100e3) * t)
    return x.astype(np.complex64)


def bench_mix(an) -> list:
    """bench.py:260-284's inspector mix as (class, fc, bw, config), in
    opening order: 832 FM audio, 48 psk, 8 fsk, 8 ask, 128 power."""
    mix = [("audio", -48e6 + i * 115e3, 200e3,
            {"audio.demodulator": 2, "audio.volume": 1.0,
             "audio.sample-rate": an.audio_rate}) for i in range(832)]
    for kind, f0, n, key in (("psk", 1e6, 48, "afc.bits-per-symbol"),
                             ("fsk", 26e6, 8, "fsk.bits-per-symbol"),
                             ("ask", 31e6, 8, "ask.bits-per-symbol")):
        mix += [(kind, f0 + i * 500e3, 400e3,
                 {key: 2 if kind == "psk" else 1,
                  "clock.baud": an.channel_rate / 8.0}) for i in range(n)]
    mix += [("power", 34e6 + i * 100e3, 100e3,
             {"power.integrate-samples": BLOCK_OUT}) for i in range(128)]
    return mix


def open_bench_mix(an, Channel) -> list:
    """The bench mix with request ids 1..1024; returns the handles in
    opening order."""
    return [an.open_inspector(kind, Channel(fc=fc, bw=bw),
                              request_id=i + 1, config=cfg)
            for i, (kind, fc, bw, cfg) in enumerate(bench_mix(an))]


def session_layers(an, blocks, torch) -> dict:
    """Synchronous per-layer breakdown of one session block, as
    bench.py:310-347 takes it: frame, H2D, dispatch (PSD, banks, squeeze,
    pack and compactors, synchronised), fetch (the drain to the host:
    the pack and its side compactors, or the compactors and the status
    rows) and demap (under the engine lock); medians over 4 blocks, and
    the bytes the drain copies per block."""
    (d, slots), = {
        k: [s for s in an._inspectors.values()
            if an._kslots[s.handle].bucket.decimation == k]
        for k in {an._kslots[s.handle].bucket.decimation
                  for s in an._inspectors.values()}}.items()
    bucket = an._buckets[d]
    times: dict[str, list] = {k: [] for k in
                              ("frame", "h2d", "dispatch", "fetch",
                               "demap")}
    for b in range(4):
        x = blocks[b]
        t = [time.perf_counter()]
        xw = bucket.raw.frame_packed(x, i16=an._in_i16)
        t.append(time.perf_counter())
        xw_d = torch.from_numpy(xw).to(an.device)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        an._spectrum.feed_ema(xw_d)
        h = an._dispatch_bucket(bucket, slots, x, xw_d)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        fetched = an._fetch(h)
        t.append(time.perf_counter())
        with an._lock:
            an._demap(h, *fetched)
        t.append(time.perf_counter())
        check(all(np.all(np.isfinite(a)) for a in fetched
                  if a is not None))
        for k, t0, t1 in zip(times, t, t[1:]):
            times[k].append((t1 - t0) * 1e3)
    an.poll()
    out = {k: round(sorted(v)[len(v) // 2], 4) for k, v in times.items()}
    out.update(drain_bytes(h))
    return out


def drain_bytes(h: dict) -> dict:
    """Bytes one block's drain copies to the host, by part."""
    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    if "pack" in h:
        return {"pack_bytes": nbytes(h["pack"]),
                **{f"side_{sec}_bytes": nbytes(out)
                   for sec, (_, out) in h["sides"].items()}}
    # the compactor drain: one output per part (the full planes where
    # the active slots outgrow the compact width)
    return {f"{k}_bytes": nbytes(*(h[k] if isinstance(h[k], (tuple, list))
                                   else (h[k],)))
            for k in ("audio", "sq", "power", "dig", "raw") if k in h}


def session_kernels():
    from sigdigger_tpu_torch.kernels import (
        audio,
        compact,
        drainpack,
        fft,
        rawbank,
        recovery,
        symsqueeze,
    )

    return {"audio": audio.audio_kernel, "raw": rawbank.raw_kernel,
            "recovery": recovery.recovery_kernel,
            "psd_xw_ema": fft.psd_xw_ema_kernel,
            "compact": compact.compact_kernel, "psd": fft.psd_kernel,
            "squeeze": symsqueeze.squeeze_kernel,
            "pack": drainpack.pack_kernel}


def drain_errors() -> list:
    """The errors logged since the last call, the log emptied (the
    session's drain worker logs a block it could not drain and goes
    on)."""
    from sigdigger_tpu_torch.utils.logger import Logger, Severity

    return [r.message for r in Logger.instance().drain()
            if r.severity >= Severity.ERROR]


# bench.py:255-259's KernelAnalyzer options
BENCH_OPTS = dict(n_slots=1024, decimation=64, audio_decim=AUDIO_DECIM,
                  compact_cols=1024, pipeline_depth=3, symbol_group=4,
                  drain_thread=True)


def bench_session(blocks, freq: float = 0.0, **kw):
    """``bench.py:255-259``'s ``KernelAnalyzer`` over ``blocks`` (a source
    tuned to ``freq``) with the 1024-inspector mix opened in
    ``bulk_config``; ``kw`` overrides its options.  Returns (analyzer,
    handles, seconds the opens took)."""
    from sigdigger_tpu_torch import KernelAnalyzer, MessageKind
    from sigdigger_tpu_torch.types import AnalyzerParams, Channel

    params = AnalyzerParams()
    params.window_size = 4096
    opts = dict(BENCH_OPTS, **kw)
    an = KernelAnalyzer(source=ring_source(blocks, freq), params=params,
                        block_size=BLOCK_OUT * 64, **opts)
    check(an.device.type == "cuda" and an._in_i16 and an._drain_bf16
          and an._psd_bucket is an._buckets[64])
    an.poll()
    t0 = time.perf_counter()
    with an.bulk_config():
        hs = open_bench_mix(an, Channel)
    open_s = time.perf_counter() - t0
    opens = [m for m in an.poll() if m.kind == MessageKind.INSPECTOR
             and m.inspector_kind.value == "open"]
    check(len(opens) == 1024 and [m.request_id for m in opens]
          == list(range(1, 1025)) and [m.handle for m in opens] == hs,
          len(opens))
    check(len(an._buckets[64].cmap) == 1024)
    return an, hs, open_s


def flush(an) -> None:
    """Drain the blocks still in flight through the drain worker."""
    for e in an._inflight:
        an._drain_q.put(e)
    an._inflight.clear()
    an._drain_q.join()


def drive(an, torch, n_warm: int, n_timed: int) -> tuple:
    """``n_warm`` blocks, then ``n_timed`` with every kernel's count set
    to 0 just before; returns (messages, launches, wall seconds of the
    timed blocks, the final drain join included)."""
    msgs = []
    for _ in range(n_warm):
        an.step()
        msgs += an.poll()
    kernels = session_kernels()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        an.step()
        msgs += an.poll()
    an._drain_q.join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    msgs += an.poll()
    return msgs, {name: k.launches for name, k in kernels.items()}, wall


def session_checks(an, hs, msgs, n_blocks: int) -> dict:
    """The bench mix's outputs: no logged drain error, every drained
    block at every inspector, FM tones, QPSK concentration (of the
    squeezed symbols where the drain squeezes), the PSD on the carrier
    and the carrier's power above the noise channels'."""
    from sigdigger_tpu_torch import MessageKind

    def samples(h):
        return [m for m in msgs if m.kind == MessageKind.SAMPLES
                and m.handle == h]

    # the drain worker logs a failed block and goes on: no block may
    # have failed, and every drained block reached every inspector
    errors = drain_errors()
    check(not errors, errors[:3])
    drained = n_blocks - len(an._inflight)
    counts = {h: 0 for h in hs}
    for m in msgs:
        if m.kind == MessageKind.SAMPLES:
            counts[m.handle] += 1
    check(all(n == drained for n in counts.values()),
          (drained, sorted(set(counts.values()))))
    check(all(np.all(np.isfinite(m.samples)) for m in msgs
              if m.kind == MessageKind.SAMPLES))
    out = {"drained": drained, "n_samples": sum(counts.values())}
    if drained >= 6:
        # FM audio peaks at its tones (after the first two drained blocks)
        rate = an.audio_rate
        for slot, tone in FM_SLOTS.items():
            a = np.concatenate([m.samples for m in samples(hs[slot])][2:])
            spec = np.abs(np.fft.rfft((a - a.mean()) * np.hanning(len(a))))
            f_pk = (np.argmax(spec[2:]) + 2) * rate / len(a)
            check(abs(f_pk - tone) <= 2 * rate / len(a), (slot, f_pk, tone))
        # strobed QPSK symbols concentrate
        concs = []
        for slot in QPSK_SLOTS:
            got = samples(hs[832 + slot])
            sym = np.concatenate([m.samples for m in got])
            st = np.concatenate([m.extras["strobes"] for m in got])
            check(len(st) == drained * BLOCK_OUT // an._symbol_group,
                  len(st))
            concs.append(conc(sym, st, 4))
        check(min(concs) > 0.85, concs)
        out["concs"] = [round(c, 4) for c in concs]
    # the PSD peaks on the carrier
    psd = [m for m in msgs if m.kind == MessageKind.PSD][-1]
    freqs = np.linspace(-FS / 2, FS / 2, len(psd.data), endpoint=False)
    f_car = 34e6 + CARRIER_POWER_SLOT * 100e3
    pk = freqs[int(np.argmax(psd.data))]
    check(np.all(np.isfinite(psd.data)) and abs(pk - f_car) <= 2 * FS / 4096,
          (pk, f_car))
    # power on the carrier's channel above the noise channels'
    pw = {i: np.concatenate([m.samples for m in samples(hs[896 + i])])
          for i in range(128)}
    noise = np.median([v.mean() for i, v in pw.items()
                       if abs(i - CARRIER_POWER_SLOT) > 3])
    check(pw[CARRIER_POWER_SLOT].mean() > 10 * noise,
          (pw[CARRIER_POWER_SLOT].mean(), noise))
    out.update(psd_peak=pk, f_car=f_car,
               carrier=float(pw[CARRIER_POWER_SLOT].mean()),
               noise=float(noise))
    return out


def session_line(name: str, open_s: float, launches: dict, wall: float,
                 n_timed: int, res: dict, card: str) -> str:
    block_ms = wall / n_timed * 1e3
    return (f"{name} (1024 inspectors: 832 audio, 48 psk, 8 fsk, 8 ask, "
            f"128 power; opened in {open_s:.3f} s): {n_timed} timed blocks, "
            f"launches {launches}, block wall {block_ms:.3f} ms (final drain "
            f"join included), {BLOCK_OUT * 64 / (wall / n_timed) / 1e6:.2f} "
            f"Msps; {res['n_samples']} SAMPLES messages ({res['drained']} "
            f"drained blocks x 1024 inspectors, no drain error); FM tones "
            f"{sorted(FM_SLOTS.values())} Hz ok, QPSK concentration "
            f"{res.get('concs')} (> 0.85), PSD peak {res['psd_peak']:.0f} Hz "
            f"on carrier {res['f_car']:.0f} Hz, carrier power "
            f"{res['carrier']:.4g} vs noise {res['noise']:.4g} | card: {card}")


def session_blocks(n: int, seed: int, doppler=None) -> list:
    block = BLOCK_OUT * 64
    x = session_iq(n * block, seed, doppler)
    return [x[i * block:(i + 1) * block] for i in range(n)]


def phase3e_session(torch, card: str) -> dict:
    """The analyzer session at the bench's 1024-inspector mix on the
    compactor drain (``drain_pack=False``, ``symbol_group=1``) over
    SESSION_BLOCKS blocks after SESSION_WARM warm-up blocks; returns the
    launches of its kernels over the timed blocks."""
    drain_errors()                    # start from an empty log
    blocks = session_blocks(SESSION_WARM + SESSION_BLOCKS, SEED + 15)
    an, hs, open_s = bench_session(blocks, drain_pack=False, symbol_group=1)
    msgs, launches, wall = drive(an, torch, SESSION_WARM, SESSION_BLOCKS)
    per_block = {"audio": 1, "raw": 1, "recovery": 1, "psd_xw_ema": 1,
                 "compact": 2, "psd": 0, "squeeze": 0, "pack": 0}
    check(all(launches[k] == n * SESSION_BLOCKS
              for k, n in per_block.items()), launches)
    res = session_checks(an, hs, msgs, SESSION_WARM + SESSION_BLOCKS)
    check(res["drained"] == SESSION_WARM + SESSION_BLOCKS
          - (an._pipeline_depth - 1))
    print(session_line("phase3e analyzer session, compactor drain", open_s,
                       launches, wall, SESSION_BLOCKS, res, card),
          flush=True)
    an._drain_thread_on = False
    print(f"phase3e layers (synchronous, median ms over 4 blocks; drain "
          f"bytes per block): {session_layers(an, blocks, torch)}",
          flush=True)
    short_session(torch, blocks)
    return {k: launches[k] for k in ("audio", "compact")}


def phase3f_bench_session(torch, card: str) -> dict:
    """``bench.py:255-259``'s exact session: the packed drain
    (``drain_pack=True``) and the symbol squeeze (``symbol_group=4``)
    with the 1024-inspector mix over SESSION_BLOCKS blocks after
    SESSION_WARM warm-up blocks, then 3 blocks with the int8 upload,
    then a checkpoint round trip of a 128-slot packed session from a
    capture file.  Returns the launches over the timed blocks."""
    drain_errors()
    blocks = session_blocks(SESSION_WARM + SESSION_BLOCKS, SEED + 18)
    an, hs, open_s = bench_session(blocks)
    check(an._drain_pack and an._buckets[64].squeeze is not None)
    msgs, launches, wall = drive(an, torch, SESSION_WARM, SESSION_BLOCKS)
    # the pack holds audio and status; the 64-column digital section
    # leaves it for its int16 side compactor
    per_block = {"audio": 1, "raw": 1, "recovery": 1, "psd_xw_ema": 1,
                 "squeeze": 1, "pack": 1, "compact": 1, "psd": 0}
    check(all(launches[k] == n * SESSION_BLOCKS
              for k, n in per_block.items()), launches)
    res = session_checks(an, hs, msgs, SESSION_WARM + SESSION_BLOCKS)
    check(res["drained"] == SESSION_WARM + SESSION_BLOCKS
          - (an._pipeline_depth - 1))
    bucket = an._buckets[64]
    (packer,) = bucket.packers.values()
    cfg = packer.cfg
    check((cfg.width, cfg.audio_width, cfg.m_tile, cfg.total_tiles,
           cfg.has_digital, cfg.has_raw) == (1024, 1024, 64, 5, False,
                                             False), cfg)
    check([k for k in bucket.sides] == [("digital", 64, BLOCK_OUT // 4)],
          list(bucket.sides))
    print(session_line("phase3f bench session, packed drain + squeeze",
                       open_s, launches, wall, SESSION_BLOCKS, res, card),
          flush=True)
    SESSION_MSPS["phase3f"] = BLOCK_OUT * 64 * SESSION_BLOCKS / wall / 1e6
    an._drain_thread_on = False
    print(f"phase3f layers (synchronous, median ms over 4 blocks; drain "
          f"bytes per block): {session_layers(an, blocks, torch)}",
          flush=True)
    del an

    # bench.py:216: the same session on the int8 upload
    drain_errors()
    an, hs, _ = bench_session(blocks, in_i8=True)
    i8_msgs, i8_launches, i8_wall = drive(an, torch, 0, 3)
    flush(an)
    i8_msgs += an.poll()
    check(all(i8_launches[k] == 3 * n for k, n in per_block.items()),
          i8_launches)
    res8 = session_checks(an, hs, i8_msgs, 3)
    check(res8["drained"] == 3)
    print(f"phase3f int8 upload: 3 blocks, launches {i8_launches}, "
          f"{res8['n_samples']} SAMPLES messages, PSD peak "
          f"{res8['psd_peak']:.0f} Hz, carrier power {res8['carrier']:.4g} "
          f"vs noise {res8['noise']:.4g}", flush=True)
    del an
    checkpoint_round_trip(torch, blocks[:6])
    return {k: launches[k] for k in ("squeeze", "pack")}


def checkpoint_round_trip(torch, blocks) -> None:
    """A 128-slot packed session (FM audio, psk, a raw inspector, an
    aligned and an unaligned power inspector) read from a capture file:
    2 blocks, a save, 3 more blocks; the session restored from the save
    gives those 3 blocks again, bit for bit."""
    import os
    import shutil
    import tempfile

    from sigdigger_tpu_torch import KernelAnalyzer, MessageKind
    from sigdigger_tpu_torch.analyzer.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.types import AnalyzerParams, Channel

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cap = os.path.join(tmp, "session.cf32")
        np.concatenate(blocks).tofile(cap)
        params = AnalyzerParams()
        params.window_size = 4096
        an = KernelAnalyzer(
            profile=SourceProfile(type="file", path=cap, sample_rate=int(FS)),
            params=params, block_size=BLOCK_OUT * 64, n_slots=128,
            decimation=64, audio_decim=AUDIO_DECIM, compact_cols=128,
            symbol_group=4)
        for slot in FM_SLOTS:
            an.open_inspector("audio", Channel(fc=-48e6 + slot * 115e3,
                                               bw=200e3),
                              config={"audio.demodulator": 2})
        for slot in QPSK_SLOTS:
            an.open_inspector("psk", Channel(fc=1e6 + slot * 500e3,
                                             bw=400e3),
                              config={"afc.bits-per-symbol": 2,
                                      "clock.baud": an.channel_rate / 8.0})
        an.open_inspector("raw", Channel(fc=-15.8e6, bw=200e3),
                          config={"agc.enabled": False})
        f_car = 34e6 + CARRIER_POWER_SLOT * 100e3
        an.open_inspector("power", Channel(fc=f_car, bw=100e3),
                          config={"power.integrate-samples": BLOCK_OUT})
        an.open_inspector("power", Channel(fc=f_car, bw=100e3),
                          config={"power.integrate-samples": 3000})
        an.poll()

        def run(a, n):
            out = []
            for _ in range(n):
                check(a.step())
                out += [(a._inspectors[m.handle].inspector_id, m.samples,
                         m.extras.get("strobes"))
                        for m in a.poll() if m.kind == MessageKind.SAMPLES]
            return out

        run(an, 2)
        ck = os.path.join(tmp, "session.sdckpt")
        save_checkpoint(an, ck)
        want = run(an, 3)
        # 10 active slots: every section 8 lanes of 16, lane-grouped
        (packer,) = an._buckets[64].packers.values()
        check(packer.cfg.has_raw and all(
            packer.cfg.group(sec) == 2
            for sec in ("audio", "digital", "raw")), packer.cfg)
        got = run(load_checkpoint(ck), 3)
        check(len(got) == len(want) == 3 * 10, (len(got), len(want)))
        for (i, a, sa), (j, b, sb) in zip(want, got):
            check(i == j and np.array_equal(a, b)
                  and (sa is None or np.array_equal(sa, sb)), i)
        print(f"phase3f checkpoint: a 128-slot packed session (4 FM, 3 psk "
              f"squeezed, raw, 2 power) from a capture file, saved after 2 "
              f"blocks: the restored session's next 3 blocks ({len(got)} "
              f"SAMPLES messages) equal the uninterrupted run's bit for "
              f"bit", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def short_session(torch, blocks) -> None:
    """3 blocks of a 128-slot session with AM, USB, LSB and RAW audio, a
    raw inspector, an unaligned power inspector, a psk inspector with
    the baud and offset estimators, a retune and a close mid-stream: the
    raw compactor and the PSD kernel (through the estimators) launch."""
    from sigdigger_tpu_torch import KernelAnalyzer, MessageKind
    from sigdigger_tpu_torch.types import AnalyzerParams, Channel

    params = AnalyzerParams()
    params.window_size = 4096
    an = KernelAnalyzer(source=ring_source(blocks), params=params,
                        block_size=BLOCK_OUT * 64, n_slots=128,
                        decimation=64, audio_decim=AUDIO_DECIM,
                        compact_cols=32, drain_pack=False)
    hs = [an.open_inspector("audio", Channel(fc=-48e6 + i * 115e3, bw=50e3),
                            config={"audio.demodulator": mode,
                                    "audio.cutoff": 3000.0,
                                    "agc.enabled": mode != 5})
          for i, mode in ((40, 1), (120, 3), (200, 4), (280, 5))]
    h_raw = an.open_inspector("raw", Channel(fc=-15.8e6, bw=200e3))
    h_pw = an.open_inspector("power", Channel(fc=40.4e6, bw=100e3),
                             config={"power.integrate-samples": 3000})
    h_psk = an.open_inspector("psk", Channel(fc=2e6, bw=400e3),
                              config={"afc.bits-per-symbol": 2,
                                      "clock.baud": an.channel_rate / 8.0})
    an.set_estimator(h_psk, "baud", True)
    an.set_estimator(h_psk, "offset", True)
    kernels = session_kernels()
    for k in kernels.values():
        k.launches = 0
    drain_errors()                    # start from an empty log
    msgs = []
    for b in range(3):
        an.step()
        msgs += an.poll()
        if b == 0:
            an.set_inspector_freq(hs[0], -48e6 + 41 * 115e3)
            an.close_inspector(hs[3])
    launches = {name: k.launches for name, k in kernels.items()}
    errors = drain_errors()
    check(not errors, errors[:3])
    # one SAMPLES message per block and inspector (a synchronous drain);
    # the inspector closed after the first block got that block's
    counts = {h: sum(1 for m in msgs if m.kind == MessageKind.SAMPLES
                     and m.handle == h)
              for h in (*hs, h_raw, h_pw, h_psk)}
    check(counts == {**{h: 3 for h in (*hs[:3], h_raw, h_pw, h_psk)},
                     hs[3]: 1}, counts)
    # compactors per block: audio, digital, raw
    check(launches["compact"] == 9 and launches["psd"] >= 2
          and launches["audio"] == 3, launches)
    est = [m for m in msgs if m.kind == MessageKind.INSPECTOR
           and m.inspector_kind.value == "estimator"]
    got = {m.handle for m in msgs if m.kind == MessageKind.SAMPLES}
    check({h_raw, h_pw, h_psk, *hs[:3]} <= got and est, (got, len(est)))
    check(all(np.all(np.isfinite(m.samples)) for m in msgs
              if m.kind == MessageKind.SAMPLES))
    print(f"phase3e short session (128 slots, 3 blocks, AM/USB/LSB/RAW "
          f"audio, raw, unaligned power, psk with estimators, a retune and "
          f"a close): launches {launches}, {len(est)} ESTIMATOR messages "
          f"(baud {[round(m.estimator_value) for m in est if m.estimator_id == 'baud']})",
          flush=True)


# the analog-TV decode of phase 3g at cli tv's defaults (8 Msps complex,
# 15625 Hz lines of 512 samples, 312-line fields, 384 pixels, 25 frames)
TV_FS = 8_000_000.0
TV_SPL = 512
TV_FIELDS = 26
TV_FRAMES = 25
TV_FM_FRAMES = 3
TV_STEP = TV_SPL * 0.85 / 384        # pixel step at the nominal period
# tv kernel vs plain version: three-term sums in another order than the
# plain version's two matmuls, on luminance in [0, 1]
TOL_TV = 2e-6
# the CMA bank: the psk receiver's 1024 lanes at 8 samples per symbol
# give 1024 symbols per 8192-sample block; 5 taps
CMA_C, CMA_T, CMA_K = 1024, 1024, 5


def pal_fields(n: int) -> np.ndarray:
    """``n`` clean 312-line PAL fields at 8 Msps, ``tests/test_tv_pal.py``'s
    pattern: 3 broad vsync lines, then lines of a 4.7 µs hsync tip, a back
    porch at blanking, and a horizontal ramp whose brightness grows with
    the row, with a white band at rows 100-120."""
    hsync, blank, white = int(4.7e-6 * TV_FS), 0.30, 0.95
    lines = np.zeros((312, TV_SPL), np.float32)
    lines[:3, int(0.7 * TV_SPL):] = blank
    ramp = np.linspace(0.0, 1.0, TV_SPL - hsync - 20, dtype=np.float32)
    for i in range(3, 312):
        row = i - 3
        video = blank + (white - blank) * ramp * (0.3 + 0.7 * row / 312)
        if 100 <= row < 120:
            video = np.full_like(ramp, white)
        lines[i, hsync:hsync + 20] = blank
        lines[i, hsync + 20:] = video
    return np.tile(lines.reshape(-1), n)


def tv_capture(path: str, n_fields: int, mode: str, seed: int) -> None:
    """The fields on a carrier at +1 MHz, AM (the luminance as envelope)
    or FM (±75 kHz over the luminance range), plus noise at -40 dB made
    from ``seed``; written as complex64 to ``path``."""
    v = pal_fields(n_fields).astype(np.float64)
    t = np.arange(len(v)) / TV_FS
    if mode == "am":
        x = v * np.exp(2j * np.pi * 1e6 * t)
    else:
        x = np.exp(1j * (2 * np.pi * 1e6 * t
                         + 2 * np.pi * np.cumsum(150e3 * (v - 0.5)) / TV_FS))
    rng = np.random.default_rng(seed)
    x = x + 0.01 * (rng.standard_normal(len(v))
                    + 1j * rng.standard_normal(len(v))) / np.sqrt(2.0)
    x.astype(np.complex64).tofile(path)


def tv_bound(lines: int, k: np.ndarray) -> tuple:
    """For the pixel table's columns ``k`` (−1 for a zero column) on the
    stream form: bytes, the window columns the pixels touch (0 .. max k
    + 2) and the lines' starts and offsets read once, the table (k and
    five weights) read once, the pixels written once; operations, 6
    products and 4 sums per live pixel."""
    live = int((k >= 0).sum())
    cols = int(k.max()) + 3 if live else 0
    ops = 10 * lines * live
    nbytes = lines * cols * 4 + lines * 8 + len(k) * 24 + lines * len(k) * 4
    return bound(ops, nbytes) + (ops, nbytes)


def tv_host_parts(tvm, torch, v, starts, frac, wts) -> dict:
    """Host µs a call of the parts of ``tv_kernel``'s CUDA path on the
    stream form: the output's allocation, the C entry alone (its launch)
    and the whole wrapper; the rest of the wrapper is its Python glue
    (the checked-once key, the size checks, the count)."""
    from sigdigger_tpu_torch.kernels import _build

    n, px = frac.shape[0], wts.k.shape[0]
    out = torch.empty((n, px), device="cuda")
    lib = _build.load_library("tvline")
    args = (v.data_ptr(), v.numel(), starts.data_ptr(), frac.data_ptr(),
            wts.k.data_ptr(), wts.taps.data_ptr(), out.data_ptr(), n,
            wts.w0.shape[0], px, torch.cuda.current_stream().cuda_stream)
    return {k: round(v, 2) for k, v in {
        "empty": host_us(lambda: torch.empty((n, px), device="cuda")),
        "entry": host_us(lambda: lib.sd_tvline(*args)),
        "wrapper": host_us(
            lambda: tvm.tv_kernel(v, frac, wts, starts=starts))}.items()}


def resample_ms(rs, v, starts, frac, reps: int = 50) -> float:
    """Host-clock ms of one ``LineResampler.resample_lines`` (the upload,
    the kernel, the fetch and its synchronise), median of ``reps``; the
    class's own method, past any wrapper set on the instance."""
    call = type(rs).resample_lines
    times = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        call(rs, v, starts, frac)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def phase2_tv(tvm, torch) -> dict:
    """The line resampler against its plain version (the two products
    X@W0 + frac ⊙ X@W1) at cli tv's geometry (W 512, px 384).  First the
    main path's stream form: 64 lines (one analyzer block's worth) read
    from a block of 32768 samples and a 600-sample carry at their starts,
    with starts at both ends so that the clip is exercised, against its
    plain version, against the framed form of the same windows
    (bit-equal) and through ``LineResampler.resample_lines`` (the upload,
    the kernel, the fetch); its times are the ones reported.  Then the
    reference's framed form on 3 dispatches of 64 lines and one of 256."""
    rs = tvm.LineResampler(tvm.LineResamplerConfig(512, 384), device="cuda")
    rs.set_step(TV_STEP)
    wts = rs.weights
    rng = np.random.default_rng(SEED + 30)
    n_v = 32768 + 600
    v_np = rng.random(n_v).astype(np.float32)
    starts = np.sort(rng.integers(0, n_v - 512, 64))
    starts[:2] = (0, -3)
    starts[-2:] = (n_v - 300, n_v - 2)
    frac_np = rng.random(64).astype(np.float32)
    v, f = torch.from_numpy(v_np).cuda(), torch.from_numpy(frac_np).cuda()
    st = torch.from_numpy(starts.astype(np.int32)).cuda()
    got = tvm.tv_kernel(v, f, wts, starts=st)
    want = tvm.tv_stream_reference(v, st, f, wts)
    xw = tvm.frame_windows(v, st, 512)
    framed = tvm.tv_kernel(xw, f, wts)
    lines = rs.resample_lines(v_np, starts, frac_np)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    check(max_abs <= TOL_TV, ("tv stream form", max_abs))
    check(torch.equal(got, framed), "stream form != framed form")
    check(np.array_equal(lines, got.cpu().numpy()), "resample_lines")
    framed_err = 0.0
    inputs = []
    for n in (64, 64, 64, 256):
        x = torch.from_numpy(rng.random((n, 512)).astype(np.float32)).cuda()
        frac = torch.from_numpy(rng.random(n).astype(np.float32)).cuda()
        got = tvm.tv_kernel(x, frac, wts)
        want = tvm.tv_kernel_reference(x, frac, wts)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= TOL_TV, ("tv_kernel framed", n, err))
        framed_err = max(framed_err, err)
        inputs.append((x, frac))
    max_abs = max(max_abs, framed_err)
    w0, w1 = wts.w0, wts.w1
    ms = time_ms(lambda: tvm.tv_kernel(v, f, wts, starts=st), 200)
    plain_ms = time_ms(lambda: tvm.tv_stream_reference(v, st, f, wts), 200)
    library_ms = time_ms(lambda: xw @ w0 + f[:, None] * (xw @ w1), 200)
    x, frac = inputs[0]
    framed_ms = time_ms(lambda: tvm.tv_kernel(x, frac, wts), 200)
    framed_plain_ms = time_ms(lambda: tvm.tv_kernel_reference(x, frac, wts),
                              200)
    x256, f256 = inputs[3]
    ms256 = time_ms(lambda: tvm.tv_kernel(x256, f256, wts), 200)
    rs_ms = resample_ms(rs, v_np, starts, frac_np)
    host = tv_host_parts(tvm, torch, v, st, f, wts)
    bms, by, ops, nbytes = tv_bound(64, wts.k.cpu().numpy())
    stages = profile_stages(lambda: tvm.tv_kernel(v, f, wts, starts=st),
                            ("::tvline",), reps=20)
    framed_stages = profile_stages(lambda: tvm.tv_kernel(x, frac, wts),
                                   ("::tvline",), reps=20)
    print(f"phase2 tv_kernel (W 512, px 384; the main path's stream form, "
          f"64 lines of a {n_v}-sample block, starts at 0, -3, "
          f"{n_v - 300} and {n_v - 2}): max abs err {max_abs:.3g} "
          f"(tolerance {TOL_TV}; both forms), bit-equal to the framed form "
          f"and to LineResampler.resample_lines; 64 lines: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, the two torch.matmul "
          f"form X@W0 + frac*(X@W1) on the same lines' framed windows "
          f"(library yardstick) {library_ms:.4f} ms, bound {bms:.6f} ms "
          f"by {by} ({nbytes / 2 ** 10:.1f} KiB, {ops} operations); device "
          f"time per launch from the trace {stages}; host µs a call "
          f"{host}; resample_lines (pinned upload, kernel, pinned fetch, "
          f"one synchronise) {rs_ms:.4f} ms a call", flush=True)
    print(f"phase2 tv framed form (3 x 64 lines and 256 lines of [L, 512] "
          f"windows): max abs err {framed_err:.3g} (tolerance {TOL_TV}); "
          f"64 lines: kernel {framed_ms:.4f} ms, plain {framed_plain_ms:.4f} "
          f"ms; 256 lines: kernel {ms256:.4f} ms; device time per launch "
          f"from the trace {framed_stages}", flush=True)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bms, bound_by=by)


def cma_bound(t: int, c: int, k: int) -> tuple:
    """Operations per lane and symbol: the K-tap complex product (8K),
    |y|² and the error (7), its magnitude, clip and scale (8), the power
    (4K), the gain (2) and the tap update (10K); bytes: the symbol planes
    read once, the output planes written once, the taps in and out, the
    rate and lock rows."""
    ops = (22 * k + 17) * t * c
    nbytes = 4 * t * c * 4 + 4 * k * c * 4 + 2 * c * 4
    return bound(ops, nbytes) + (ops, nbytes)


def cma_symbols(t: int, c: int, rng) -> np.ndarray:
    """QPSK [C, T] through mild static ISI (0.3 of the previous symbol,
    0.1j of the one before)."""
    s = np.exp(1j * (rng.integers(0, 4, (c, t)) * 2 + 1) * np.pi / 4)
    return (s + 0.3 * np.roll(s, 1, axis=1)
            - 0.1j * np.roll(s, 2, axis=1)).astype(np.complex64)


def phase2_cma(eqm, torch) -> dict:
    """The CMA bank against its plain version at C 1024, T 1024, K 5:
    QPSK through mild ISI, per-lane rates, a quarter of the lanes
    locked, chained over 3 blocks, then a fourth block whose last lane
    turns 1e7 times louder halfway (|e|² overflows, past the clip scale's
    fast range); bit-equal.  Its time beside its latency floor (the
    walker's chain timed with clock64)."""
    rng = np.random.default_rng(SEED + 31)
    c, t, k = CMA_C, CMA_T, CMA_K
    rate = torch.from_numpy(rng.uniform(1e-3, 4e-3, c).astype(
        np.float32)).cuda()
    locked = torch.from_numpy((np.arange(c) % 4 == 0).astype(
        np.float32)).cuda()
    tr = torch.zeros((k, c), device="cuda")
    tr[k // 2] = 1.0
    taps0 = (tr, torch.zeros((k, c), device="cuda"))
    xs = []
    for b in range(4):
        x = cma_symbols(t, c, rng).T.copy()
        if b == 3:
            x[t // 2:, c - 1] *= 1e7
        xs.append((torch.from_numpy(x.real.copy()).cuda(),
                   torch.from_numpy(x.imag.copy()).cuda()))
    # the kernel over the blocks first, then its time and trace (before
    # the plain version's some 10^5 small launches a block)
    outs, taps_k = [], taps0
    for b, (xr, xi) in enumerate(xs):
        outs.append(eqm.cma_kernel(xr, xi, *taps_k, rate, locked))
        if b < 3:
            taps_k = outs[-1][2:]
    xr, xi = xs[0]
    ms = time_ms(lambda: eqm.cma_kernel(xr, xi, *taps_k, rate, locked), 20)
    stages = profile_stages(
        lambda: eqm.cma_kernel(xr, xi, *taps_k, rate, locked),
        ("cma_ws",), reps=5)
    max_abs, plain_ms, taps_p = 0.0, None, taps0
    for b, ((xr, xi), got) in enumerate(zip(xs, outs)):
        ms_p, want = time_once_ms(lambda: eqm.cma_kernel_reference(
            xr, xi, *taps_p, rate, locked))
        plain_ms = ms_p if plain_ms is None else min(plain_ms, ms_p)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              ("cma_kernel", b, err))
        if b < 3:
            max_abs = max(max_abs, err)
            taps_p = want[2:]
    # the fallback block's last lane: |e|² of its y in float32 overflows
    y = (want[0][:, c - 1] + 1j * want[1][:, c - 1]).cpu().numpy()
    p = (np.abs(y) ** 2).astype(np.float32)
    e = (y * (p - np.float32(1.0))).astype(np.complex64)
    with np.errstate(over="ignore"):
        q = e.real * e.real + e.imag * e.imag
    fallback = int(np.isinf(q).sum())
    check(fallback > 0 and np.all(np.isfinite(y)), fallback)
    xr, xi = xs[0]
    bms, by, ops, nbytes = cma_bound(t, c, k)
    clip = eqm.clip_scale_mismatches("cuda")
    check(clip == {"mismatches": 0, "checked": 1 << 32}, clip)
    cyc = eqm.cma_step_cycles(xr, xi, *taps_k, rate, locked, steps=8192)
    floor = eqm.cma_floor_ms(cyc, t)
    traced = stages.get("cma_ws")
    share = (f"{floor / traced:.1%} of it the floor"
             if isinstance(traced, float) else "traced time not measured")
    print(f"phase2 cma_kernel (C 1024, T 1024, K 5; QPSK through ISI, "
          f"per-lane rates, a quarter locked, 3 chained blocks and a "
          f"fallback block, {fallback} steps of its last lane past the fast "
          f"range): bit-equal to the plain version, max abs err {max_abs}; "
          f"kernel {ms:.4f} ms ({ms * 1e6 / t:.1f} ns per dependent step), "
          f"plain {plain_ms:.1f} ms (a Python loop over the symbols), no "
          f"library call computes it; bound {bms:.5f} ms by {by} "
          f"({ops / 1e9:.4f} GFLOP, {nbytes / 2 ** 20:.2f} MiB); device "
          f"time per launch from the trace {stages}", flush=True)
    print(f"phase2 cma chain: the walker's step {cyc['cycles']:.1f} cycles "
          f"at {cyc['ghz']:.3f} GHz (clock64), latency floor {floor:.4f} ms "
          f"for T {t}; traced kernel {traced} ms, {share}; bytes bound "
          f"{bms:.5f} ms; the branch-free clip scale against the IEEE "
          f"operations on every float32: {clip['mismatches']} of "
          f"{clip['checked']} differ", flush=True)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bms, bound_by=by)


def frame_quality(frames) -> tuple:
    """(median row-mean vs row-index correlation, median white-band row)
    over ``frames``, skipping the band itself in the correlation."""
    sel = np.r_[10:90, 130:290]
    corrs, bands = [], []
    for f in frames:
        m = f.mean(axis=1)
        corrs.append(float(np.corrcoef(m[sel], sel)[0, 1]))
        bands.append(int(np.argmax(np.convolve(m, np.ones(20) / 20,
                                               "valid"))))
    return float(np.median(corrs)), int(np.median(bands))


def read_png(path: str) -> np.ndarray:
    """The grey plane of an RGB8 PNG as ``utils/waterfall.write_png``
    writes it (filter 0 on every row), scaled to [0, 1]."""
    import struct
    import zlib

    with open(path, "rb") as f:
        b = f.read()
    i, data = 8, b""
    while i < len(b):
        n = struct.unpack(">I", b[i:i + 4])[0]
        tag = b[i + 4:i + 8]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", b[i + 8:i + 16])
        elif tag == b"IDAT":
            data += b[i + 8:i + 8 + n]
        i += 12 + n
    raw = np.frombuffer(zlib.decompress(data), np.uint8).reshape(h, 1 + 3 * w)
    return raw[:, 1:].reshape(h, w, 3)[:, :, 0].astype(np.float64) / 255.0


def tv_cli(torch, tmp: str, mode: str, n_fields: int, frames: int,
           seed: int):
    """Write a capture and run ``cli.main`` on it as a user would: exit
    code 0, ``frames`` PNGs, the line resampler launched.  Returns (the
    frames read back from the PNGs, seconds, line-resampler launches,
    the capture's path)."""
    import os

    from sigdigger_tpu_torch import cli
    from sigdigger_tpu_torch.kernels import tvline

    path = os.path.join(tmp, "tv_8000000.cf32")
    tv_capture(path, n_fields, mode, seed)
    prefix = os.path.join(tmp, f"{mode}_")
    tvline.tv_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(["tv", path, "--freq", "1e6", "--rate", "8e6", "--mode",
                   mode, "--max-frames", str(frames), "-o", prefix])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tvline.tv_kernel.launches
    pngs = sorted(f for f in os.listdir(tmp) if f.startswith(f"{mode}_"))
    check(rc == 0 and len(pngs) == frames and launches >= 1,
          (rc, len(pngs), launches))
    return ([read_png(os.path.join(tmp, f)) for f in pngs], wall, launches,
            path)


def tv_layers(path: str, torch) -> dict:
    """The decode again, synchronously per layer (median ms per analyzer
    block): source read, spectrum, channelizer, audio inspector, the rest
    of the analyzer step (message and fetch), the TV host work, and the
    line resample (upload, kernel, fetch), and that resample again alone
    on the last block's inputs (median of 50); with a host-backend processor
    fed the same luminance beside the device one.  The device processor
    must take the device backend and launch the line resampler once for
    every block that gave lines, each block after lock.  Returns the
    layers, the device and host frames."""
    from sigdigger_tpu_torch.analyzer import Analyzer, MessageKind
    from sigdigger_tpu_torch.dsp.tv import TVProcessor, TVProcessorParams
    from sigdigger_tpu_torch.kernels import tvline
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.types import AnalyzerParams, Channel

    an = Analyzer(profile=SourceProfile(type="file", path=path,
                                        sample_rate=int(TV_FS)),
                  params=AnalyzerParams(psd_update_interval=1e9))
    an.open_inspector("audio", Channel(fc=1e6, bw=6e6), config={
        "audio.demodulator": 1, "audio.sample-rate": int(TV_FS),
        "audio.cutoff": 3e6, "audio.volume": 1.0, "agc.enabled": False})
    params = TVProcessorParams(sample_rate=TV_FS)
    dev = TVProcessor(params)
    host = TVProcessor(params, backend="host")
    check(dev.backend == "device", dev.backend)
    tvline.tv_kernel.launches = 0
    timer = StageTimer("cuda")
    timed = timer.wrap

    last: list = []

    def keep_args(fn):
        def run(*a):
            last[:] = a
            return fn(*a)
        return run

    an.source.read = timed("read", an.source.read)
    an._spectrum.feed = timed("spectrum", an._spectrum.feed)
    an._channelizer.feed = timed("channelizer", an._channelizer.feed)
    (slot,) = an._inspectors.values()
    slot.inspector.process = timed("inspector", slot.inspector.process)
    step = timed("step", an.step)
    feed = timed("tv", dev.feed)
    wrapped = False
    while step():
        for m in an.poll():
            if m.kind == MessageKind.SAMPLES:
                lum = np.real(m.samples)
                feed(lum)
                host.feed(lum)
                if dev._resampler is not None and not wrapped:
                    dev._resampler.resample_lines = timed(
                        "resample", keep_args(dev._resampler.resample_lines))
                    wrapped = True
    launches = tvline.tv_kernel.launches
    check(launches == dev.line_feeds == dev.feeds - dev.locked_at >= 1,
          (launches, dev.feeds, dev.line_feeds, dev.locked_at))
    acc = {k: timer.ms(k) for k in list(timer.stages)}
    n = len(acc["step"]) - 1         # the last step reads the EOS
    med = {k: float(np.median(v[:n] if k in ("step", "read") else v))
           for k, v in acc.items()}
    layers = {k: round(med[k], 4) for k in ("read", "spectrum",
                                            "channelizer", "inspector")}
    layers["step_other"] = round(med["step"] - sum(layers.values()), 4)
    layers["tv_host"] = round(med["tv"] - med.get("resample", 0.0), 4)
    layers["resample"] = round(med.get("resample", 0.0), 4)
    # the same call alone, 50 times on the last block's inputs
    layers["resample_alone"] = round(resample_ms(dev._resampler, *last), 4)
    layers["blocks"] = n
    layers["launches"] = launches
    layers["locked_at"] = dev.locked_at
    return layers, dev.frames, host.frames


def phase3g_tv(torch, card: str) -> dict:
    """The analog-TV decode as users run it: ``cli.main(["tv", ...])`` on
    a 26-field synthetic AM PAL capture (8 Msps, carrier at +1 MHz) at
    the CLI's defaults (25 frames), its PNGs read back; then the decode
    again per layer, with the device processor's launches and the device
    frames against the host backend's; then 3 fields in FM.  Returns the
    line resampler's launches over the AM run."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        frames, wall, launches, path = tv_cli(torch, tmp, "am", TV_FIELDS,
                                              TV_FRAMES, SEED + 32)
        check(all(f.shape == (312, 384) for f in frames))
        corr, band = frame_quality(frames)
        check(corr > 0.8 and 90 <= band <= 130, (corr, band))
        fps = TV_FRAMES / wall
        print(f"phase3g cli tv (AM, {TV_FIELDS} fields at 8 Msps, carrier "
              f"+1 MHz, defaults): exit 0, {TV_FRAMES} PNGs, tv_kernel "
              f"launches {launches}; PNGs: median row correlation "
              f"{corr:.4f} (> 0.8), white band at row {band}; {wall:.3f} s, "
              f"{fps:.2f} fields/s (real time 50) | card: {card}",
              flush=True)
        layers, fd, fh = tv_layers(path, torch)
        check(len(fd) == len(fh) >= TV_FRAMES, (len(fd), len(fh)))
        check(launches <= layers["launches"], (launches, layers))
        cs = [float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
              for a, b in zip(fh, fd)]
        ma = [float(np.mean(np.abs(a - b))) for a, b in zip(fh, fd)]
        check(min(cs) > 0.995 and max(ma) < 0.02, (min(cs), max(ma)))
        print(f"phase3g layers (synchronous, median ms per analyzer block "
              f"of 32768 samples; the whole capture, backend device, "
              f"tv_kernel launches = feeds with lines = feeds after lock): "
              f"{layers}; device vs host frames on the "
              f"same luminance: correlation min {min(cs):.5f} (> 0.995), "
              f"mean abs max {max(ma):.5f} (< 0.02) over {len(fd)} frames",
              flush=True)
        frames, wall, fm_launches, _ = tv_cli(
            torch, tmp, "fm", TV_FM_FRAMES + 1, TV_FM_FRAMES, SEED + 33)
        corr, band = frame_quality(frames)
        check(corr > 0.8 and 90 <= band <= 130, (corr, band))
        print(f"phase3g cli tv (FM, ±75 kHz): exit 0, {TV_FM_FRAMES} PNGs, "
              f"tv_kernel launches {fm_launches}; PNGs: median row "
              f"correlation {corr:.4f}, white band at row {band}; "
              f"{wall:.3f} s", flush=True)
    return {"tv": launches}


def phase3h_cma(torch) -> dict:
    """The CMA bank through its entry point (``CMABank``; the system's
    path to the kernel is the class path's psk equalizer, phase 3i): C
    1024 lanes, T 1024, K 5,
    per-lane rates, over 3 blocks of QPSK through ISI; the modulus error
    must halve.  Returns its launches."""
    from sigdigger_tpu_torch.kernels import equalizer

    rng = np.random.default_rng(SEED + 34)
    bank = equalizer.CMABank(
        equalizer.CMABankConfig(CMA_C, CMA_T, n_taps=CMA_K),
        rate=rng.uniform(2e-3, 4e-3, CMA_C).astype(np.float32))
    check(bank.device.type == "cuda")
    xs = [cma_symbols(CMA_T, CMA_C, rng) for _ in range(3)]
    equalizer.cma_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in xs:
        y = bank(x).cpu().numpy()
    wall = time.perf_counter() - t0
    launches = equalizer.cma_kernel.launches
    check(launches == 3, launches)
    evm_in = float(np.abs(np.abs(x[:, 256:]) - 1.0).mean())
    evm_out = float(np.abs(np.abs(y[:, 256:]) - 1.0).mean())
    check(np.all(np.isfinite(y)) and evm_out < 0.5 * evm_in,
          (evm_in, evm_out))
    print(f"phase3h CMABank (1024 lanes, 1024 symbols, 5 taps, 3 blocks): "
          f"launches {launches}, modulus error {evm_in:.4f} -> "
          f"{evm_out:.4f}, {wall * 1e3 / 3:.3f} ms per block (upload, "
          f"kernel, fetch)", flush=True)
    return {"cma_bank": launches}


# the class-path command line of phase 3i: a capture at 1.024 Msps of
# 2^19 samples (0.512 s, 16 analyzer blocks of 32768 at the default
# window) holding QPSK at 4800 baud, an FM tone channel, an OOK channel,
# a 2-FSK channel and noise; the symbols runs as (mode, centre, baud,
# bits per symbol, channel width)
CLI_FS = 1_024_000.0
CLI_N = 1 << 19
CLI_PSK_F, CLI_FM_F, CLI_ASK_F, CLI_FSK_F = -200e3, 150e3, 300e3, -350e3
CLI_SYMBOLS = [("psk", CLI_PSK_F, 4800.0, 2, 8000.0),
               ("fsk", CLI_FSK_F, 2400.0, 1, 12000.0),
               ("ask", CLI_ASK_F, 2400.0, 1, 8000.0)]
CLI_FM_AMP = 0.5


def cli_signal(n: int, seed: int, noise: float = 0.005) -> tuple:
    """The phase's capture [n] complex64 and its known symbol sequences:
    QPSK of root-raised-cosine pulses (beta 0.35) at 4800 baud (points at
    k·90°), FM of a 1 kHz tone at 5 kHz deviation, OOK and 2-FSK
    (±2.4 kHz) at 2400 baud NRZ, complex noise of ``noise`` a part
    (0.005: 40 dB under the FM carrier).  ``tests/test_torch_cli.py``
    builds its capture here too."""
    def rrc(t: np.ndarray, beta: float = 0.35) -> np.ndarray:
        h = np.empty_like(t)
        z = np.abs(t) < 1e-9
        s = np.abs(np.abs(4 * beta * t) - 1.0) < 1e-9
        o = ~(z | s)
        h[z] = 1.0 - beta + 4 * beta / np.pi
        h[s] = beta / np.sqrt(2) * (
            (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
            + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
        u = t[o]
        h[o] = (np.sin(np.pi * u * (1 - beta))
                + 4 * beta * u * np.cos(np.pi * u * (1 + beta))) / (
            np.pi * u * (1 - (4 * beta * u) ** 2))
        return h

    rng = np.random.default_rng(seed)
    t = np.arange(n) / CLI_FS
    known = {m: rng.integers(0, 1 << bps, int(n / CLI_FS * baud) + 8)
             for m, _, baud, bps, _ in CLI_SYMBOLS}
    st = t * 4800.0
    k0 = np.floor(st).astype(np.int64)
    psk = np.zeros(n, complex)
    pts = np.exp(0.5j * np.pi * known["psk"])
    for j in range(-6, 7):
        k = np.clip(k0 + j, 0, len(pts) - 1)
        psk += pts[k] * rrc(st - k)
    x = 0.3 * psk * np.exp(2j * np.pi * CLI_PSK_F * t)
    x += CLI_FM_AMP * np.exp(1j * (2 * np.pi * CLI_FM_F * t
                                   + 5.0 * np.sin(2 * np.pi * 1e3 * t)))
    k = (t * 2400.0).astype(np.int64)
    x += 0.3 * known["ask"][k] * np.exp(2j * np.pi * CLI_ASK_F * t)
    inst = np.where(known["fsk"][k] == 1, 2400.0, -2400.0)
    x += 0.3 * np.exp(1j * (2 * np.pi * CLI_FSK_F * t
                            + 2 * np.pi * np.cumsum(inst) / CLI_FS))
    x += noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64), known


def recovered(got: np.ndarray, known: np.ndarray, m: int,
              skip: int = 100) -> float:
    """The share of ``got[skip:]`` equal to the known sequence at the best
    lag and rotation mod ``m`` (the Costas loop's ambiguity); ``skip``
    symbols of lock first."""
    g = got[skip:].astype(np.int64)
    best = 0.0
    for rot in range(m):
        for lag in range(-40, 40):
            a, b = g[max(0, -lag):], known[skip + max(0, lag):]
            n = min(len(a), len(b))
            best = max(best, float(np.mean((b[:n] + rot) % m == a[:n])))
    return best


def cli_psd_held(x: np.ndarray, csv: str, peak: dict, torch) -> dict:
    """``cli psd``'s PSDs on the chunks it fed, through the cached PSDs
    the command used (``psdutil.prepare_mean_psd``).  Each waterfall row
    (N 4096, F 1, fpp 1): ``psd_kernel`` and ``psd_kernel_reference``
    each within every bin's bound of the float64 PSD (``psd_f64_bound``:
    one frame's bins are ill-conditioned).  The mean (F 128, fpp 8):
    the kernel within TOL_PSD_BIN of the plain version in every bin;
    then the command's CSV (printed to 0.01 dB), peak and noise floor
    within that tolerance, in dB, of the plain version's mean.  Returns
    the worst bin errors, rows in units of their bound, the mean in
    units of TOL_PSD_BIN."""
    from sigdigger_tpu_torch.kernels import fft
    from sigdigger_tpu_torch.tasks import psdutil

    n = 4096                                   # cli psd's --fft default
    usable = len(x) // n * n
    rows = min(512, usable // n)               # as cmd_psd frames them
    per_row = usable // rows // n * n
    worst = {"rows kernel": 0.0, "rows plain": 0.0}
    for i in range(rows):
        psd, _ = psdutil.prepare_mean_psd(per_row, CLI_FS, n, device="cuda")
        check((psd.cfg.frames_per_block, psd.cfg.frames_per_program)
              == (1, 1), psd.cfg)
        xp = psd.prepare(x[i * per_row:(i + 1) * per_row])
        xd = torch.from_numpy(xp).cuda()
        got = fft.psd_kernel(xd, psd.consts, psd.params)
        want = fft.psd_kernel_reference(xd, psd.consts, psd.params)
        check(bool(torch.isfinite(got).all()))
        p64, bound = psd_f64_bound(xp, psd.cfg.a, psd.cfg.b,
                                   psd.params.scale)
        for key, v in (("rows kernel", got), ("rows plain", want)):
            err = float((np.abs(v.double().cpu().numpy() - p64)
                         / bound).max())
            worst[key] = max(worst[key], err)
    psd, lock = psdutil.prepare_mean_psd(usable, CLI_FS, n, device="cuda")
    check((psd.cfg.frames_per_block, psd.cfg.frames_per_program)
          == (128, 8), psd.cfg)
    xd = torch.from_numpy(psd.prepare(x[:usable])).cuda()
    got = fft.psd_kernel(xd, psd.consts, psd.params)
    want = fft.psd_kernel_reference(xd, psd.consts, psd.params)
    worst["mean kernel"] = float(((got - want).abs()
                                  / (TOL_PSD_BIN * want.abs())).max())
    worst = {k: round(v, 4) for k, v in worst.items()}
    check(max(worst.values()) <= 1.0, worst)
    with lock:
        psd.reset()
        plain = np.fft.fftshift(psd.fold(want.cpu().numpy()).copy())
    db = 10 * np.log10(plain + 1e-30)
    tol_db = 10 * np.log10(1 + TOL_PSD_BIN)
    printed = np.loadtxt(csv, delimiter=",", skiprows=1)[:, 1]
    csv_err = float(np.abs(printed - db).max())
    check(csv_err <= 0.005 + tol_db + 1e-6
          and abs(peak["peak_db"] - float(db.max())) <= tol_db
          and abs(peak["noise_floor_db"] - float(np.median(db))) <= tol_db,
          (csv_err, peak, float(db.max()), float(np.median(db))))
    worst["csv_db"] = round(csv_err, 5)
    return worst


def cli_layers(path: str, torch) -> tuple:
    """The class path under ``cli symbols --mode psk`` again, through
    ``Analyzer(device="cuda")`` with the CMA equalizer on (``equalizer.type``
    1), synchronously per layer: median ms per analyzer block of the
    source read, spectrum, channelizer, the inspector's AGC, Costas, RRC
    matched filter, CMA equalizer and Gardner clock, the rest of the
    inspector (decisions) and of the step, the block; the kernel alone at
    this path's shape beside its bound.  The equalizer (unlocked: a
    locked one runs its FIR without the kernel) launches ``cma_kernel``
    once per block the inspector is fed; every call's y
    and taps are bit-equal to ``cma_kernel_reference`` on the same input
    and taps on the card.  Returns (layers, launches, blocks fed, T per
    call)."""
    from sigdigger_tpu_torch.analyzer import Analyzer, MessageKind
    from sigdigger_tpu_torch.kernels import equalizer
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.types import AnalyzerParams, Channel

    an = Analyzer(profile=SourceProfile(type="file", path=path,
                                        sample_rate=int(CLI_FS)),
                  params=AnalyzerParams(psd_update_interval=1e9),
                  device="cuda")
    _, freq, baud, bps, bw = CLI_SYMBOLS[0]
    h = an.open_inspector("psk", Channel(fc=freq, bw=bw), config={
        "clock.baud": baud, "clock.type": 1, "mf.type": 1,
        "afc.bits-per-symbol": bps, "equalizer.type": 1})
    insp = an._inspectors[h].inspector
    check(insp._eq is not None and insp._eq.device.type == "cuda")
    stages = {"agc": "_agc", "costas": "_costas", "mf": "_mf",
              "cma": "_eq", "gardner": "_clock"}
    taps = (lambda eq: (eq.taps_re.clone(), eq.taps_im.clone()))
    timer = StageTimer("cuda")
    timers = {k: timer.wrap(k, getattr(insp, a),
                            keep=taps if k == "cma" else None)
              for k, a in stages.items()}
    for k, a in stages.items():
        setattr(insp, a, timers[k])
    # the analyzer's layers around the inspector
    around = {"read": (an.source, "read"), "spectrum": (an._spectrum, "feed"),
              "channelizer": (an._channelizer, "feed"),
              "inspector": (insp, "process")}
    outer = {k: timer.wrap(k, getattr(o, a))
             for k, (o, a) in around.items()}
    for k, (o, a) in around.items():
        setattr(o, a, outer[k])
    outer["step"] = step = timer.wrap("step", an.step)
    equalizer.cma_kernel.launches = 0
    fed = 0
    while step():
        fed += sum(m.kind == MessageKind.SAMPLES and m.handle == h
                   for m in an.poll())
    launches = equalizer.cma_kernel.launches
    acc = {k: t.ms for k, t in outer.items()}
    calls = timers["cma"].calls
    check(launches == fed == len(calls) >= CLI_N // 32768,
          (launches, fed, len(calls)))
    # every call against the plain version on the card
    rate = torch.full((1,), float(insp._eq.rate), device="cuda")
    locked = torch.zeros(1, device="cuda")
    for (x,), (tr, ti), y, (tr2, ti2) in calls:
        want = equalizer.cma_kernel_reference(
            x.real.T.contiguous(), x.imag.T.contiguous(), tr, ti, rate,
            locked)
        got = (y.real.T.contiguous(), y.imag.T.contiguous(), tr2, ti2)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              ("cma_kernel on the class path",
               max(float((g - w).abs().max()) for g, w in zip(got, want))))
    # the kernel alone at this path's shape (C 1, T a block's channel
    # samples), on the second-to-last call's input and taps: the last
    # full block (the last call is the zero-padded block at the EOS)
    (x,), taps, _, _ = calls[-2]
    args = (x.real.T.contiguous(), x.imag.T.contiguous(), *taps, rate,
            locked)
    kernel_ms = time_ms(lambda: equalizer.cma_kernel(*args), 50)
    bms, by, _, _ = cma_bound(x.shape[1], 1, 5)
    # per block: the step less its parts, the inspector less its stages
    # (the last block fed is the zero-padded one at the EOS, and the
    # step after it reads nothing more)
    n = len(acc["inspector"])
    other = [acc["step"][i] - acc["read"][i] - acc["spectrum"][i]
             - acc["channelizer"][i] - acc["inspector"][i] for i in range(n)]
    rest = [acc["inspector"][i] - sum(t.ms[i] for t in timers.values())
            for i in range(n)]
    layers = {k: round(float(np.median(acc[k][:n - 1])), 4)
              for k in ("read", "spectrum", "channelizer")}
    layers.update({k: round(float(np.median(t.ms[:n - 1])), 4)
                   for k, t in timers.items()})
    layers["inspector_other"] = round(float(np.median(rest[:n - 1])), 4)
    layers["step_other"] = round(float(np.median(other[:n - 1])), 4)
    layers["block"] = round(float(np.median(acc["step"][:n - 1])), 4)
    layers["cma_kernel_ms"] = round(kernel_ms, 4)
    layers["cma_bound_ms"] = (bms, by)
    an.source.close()
    return layers, launches, fed, int(calls[0][0][0].shape[1])


def phase3i_cli(torch, card: str) -> dict:
    """The class-path command line as users run it: ``cli.main`` with
    ``--device cuda`` on the phase's capture (``cli_signal``) in a
    temporary directory: ``info`` (samples and rate), ``psd --waterfall``
    (the peak on the FM carrier, the strongest; ``psd_kernel`` once per
    waterfall row and once for the mean; the PNG holds the rows it
    reports; the kernel held at the rows' and the mean's shapes,
    ``cli_psd_held``), ``demod fm`` (the WAV peaks at the 1 kHz tone),
    ``symbols`` psk (with ``--symview``), fsk and ask (each at least 99%
    of its known sequence after 100 symbols of lock, up to the Costas
    rotation), and ``rms`` (the FM channel's level within 1 dB); each
    command's wall time.  Then the psk chain with the CMA equalizer per layer
    (``cli_layers``).  Returns the launches of ``psd_kernel`` and
    ``cma_kernel`` on this path."""
    import contextlib
    import io
    import os
    import re
    import tempfile

    from sigdigger_tpu_torch import cli
    from sigdigger_tpu_torch.io.wav import read_wav
    from sigdigger_tpu_torch.kernels import fft

    walls: dict = {}

    def run(name: str, argv: list) -> str:
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        walls[name] = round(time.perf_counter() - t0, 3)
        check(rc == 0, (name, rc))
        return buf.getvalue()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cap_433920000Hz_1024000sps.cf32")
        x, known = cli_signal(CLI_N, SEED + 35)
        x.tofile(path)
        info = json.loads(run("info", ["info", path]))
        check(info["samples"] == CLI_N and info["sample_rate"] == CLI_FS,
              info)
        wf = os.path.join(tmp, "wf.png")
        fft.psd_kernel.launches = 0
        out = run("psd", ["psd", path, "--waterfall", wf, "-o",
                          os.path.join(tmp, "psd.csv")])
        psd_launches = fft.psd_kernel.launches
        rows = int(re.search(r"\((\d+) rows\)", out).group(1))
        peak = json.loads(out.splitlines()[-1])
        png = read_png(wf)
        check(psd_launches == rows + 1 and png.shape == (rows, 4096)
              and abs(peak["peak_freq_hz"] - CLI_FM_F) < 6000.0,
              (psd_launches, rows, png.shape, peak))
        psd_held = cli_psd_held(x, os.path.join(tmp, "psd.csv"), peak,
                                torch)
        wav = os.path.join(tmp, "fm.wav")
        run("demod", ["demod", path, "--freq", str(CLI_FM_F), "-o", wav])
        audio, rate = read_wav(wav)
        a = audio[rate // 100:int(CLI_N / CLI_FS * rate), 0]
        spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
        f_tone = (int(np.argmax(spec[5:])) + 5) * rate / len(a)
        check(abs(f_tone - 1000.0) < 50.0, f_tone)
        rec = {}
        for mode, freq, baud, bps, bw in CLI_SYMBOLS:
            syms = os.path.join(tmp, f"{mode}.u8")
            argv = ["symbols", path, "--freq", str(freq), "--baud",
                    str(baud), "--mode", mode, "--bps", str(bps), "--bw",
                    str(bw), "-o", syms]
            if mode == "psk":
                argv += ["--symview", os.path.join(tmp, "sv.png")]
            run(mode, argv)
            got = np.fromfile(syms, np.uint8)
            rec[mode] = recovered(got[:int(CLI_N / CLI_FS * baud)],
                                  known[mode], 1 << bps)
            check(rec[mode] >= 0.99, (mode, rec[mode]))
        rms_csv = os.path.join(tmp, "rms.csv")
        run("rms", ["rms", path, "--freq", str(CLI_FM_F), "--bw", "20000",
                    "--integrate", "500", "-o", rms_csv])
        lv = np.loadtxt(rms_csv, delimiter=",", skiprows=1)[:, 1]
        level_db = float(20 * np.log10(np.median(lv[2:-4]) / CLI_FM_AMP))
        check(abs(level_db) < 1.0, level_db)
        print(f"phase3i cli (capture {CLI_N} samples at 1.024 Msps, "
              f"{CLI_N / CLI_FS:.3f} s; --device cuda): info ok; psd: peak "
              f"{peak['peak_freq_hz']} Hz (FM carrier {CLI_FM_F}), "
              f"waterfall {rows} rows, psd_kernel "
              f"launches {psd_launches} (rows + 1), the same chunks' worst "
              f"bins (rows: of their float64 bound; mean: of TOL_PSD_BIN "
              f"against psd_kernel_reference) {psd_held}; demod fm: tone at "
              f"{f_tone:.1f} Hz; symbols recovered after lock: psk "
              f"{rec['psk']:.4f}, fsk {rec['fsk']:.4f}, ask {rec['ask']:.4f} "
              f"(>= 0.99); rms: FM level {level_db:+.3f} dB of its power; "
              f"wall s per command {walls} | card: {card}", flush=True)
        layers, cma_launches, fed, t_call = cli_layers(path, torch)
    per_step = {k: round(layers[k] * 1e3 / t_call, 2)
                for k in ("agc", "costas", "gardner")}
    print(f"phase3i layers (psk, equalizer.type 1, synchronous, median ms "
          f"per analyzer block of 32768 samples, {t_call} channel samples "
          f"a block): {layers}; the step loops per channel sample (µs): "
          f"{per_step}; cma_kernel launches {cma_launches} for {fed} blocks "
          f"fed to the unlocked equalizer, each call bit-equal to "
          f"cma_kernel_reference (C 1, T {t_call}) | card: {card}",
          flush=True)
    return {"psd_cli": psd_launches, "cma": cma_launches}


# phase 3j: the spectrum users off the main path.  (a) ``cli scan`` at its
# defaults (2.048 Msps, FFT 2048, 4 frames a hop) over the FM broadcast
# band, the view's 65536 bins of 305 Hz; (b) a 20 Msps SDR swept at
# 1 kHz/bin (N 32768) and 305 Hz/bin (N 65536, the cap); (c) the carrier
# and Doppler tasks; (d) ``cli doppler`` on an ISS element set
# (tests/test_orbit.py's, checksums fixed); (e) the bench session on a
# 70 cm source with 64 FM inspectors under Doppler correction
SCAN_EMITTERS = (89.1e6, 95.8e6, 101.3e6, 104.9e6)
SCAN_HOPS = 200
WIDE_FS = 20_000_000
WIDE_EMITTERS = (433.2e6, 441.7e6, 447.9e6)
WIDE_HOPS = 4
ISS_TLE = """\
ISS (ZARYA)
1 25544U 98067A   20001.00000000  .00016717  00000-0  10270-3 0  9000
2 25544  51.6416 247.4627 0006703 130.5360 325.0288 15.49512410 21396
"""
TRACK_RF = 437.5e6                   # the 70 cm satellite band
TRACK_SITE = (40.0, -105.0, 1.6)     # lat, lon (deg), alt (km)
# 64 of the mix's FM audio inspectors, the four with FM tones among them
TRACK_SLOTS = tuple(sorted(set(range(0, 780, 13)) | set(FM_SLOTS)))
TRACK_LAPSE = 0.5                    # pass seconds added to each block


def scan_layers(sc, torch, hops: int) -> dict:
    """``hops`` calls of ``sc.hop()`` (a ``Scanner`` on the PSD kernel),
    each layer it calls wrapped in a ``StageTimer``: retune + read
    (``capture``, the settle block included), framing (``PSD.prepare``),
    H2D (``feed_async`` less framing and kernel), kernel
    (``fft.psd_kernel``), rebin matmul (``DeviceRebin.product``), span
    D2H (the rebin call less its product) and stitch
    (``SpectrumView.feed_binned``); the median ms of each and of the
    whole hop.  The wrappers are taken off again."""
    from sigdigger_tpu_torch.kernels import fft

    est, rb, view = sc._est, sc._rebin, sc.view
    kernel = fft.psd_kernel
    timer = StageTimer("cuda")
    t = {k: timer.wrap(k, fn) for k, fn in (
        ("retune_read", sc.capture), ("framing", est.prepare),
        ("feed", est.feed_async), ("kernel", kernel),
        ("rebin", rb.product), ("rebin_call", rb),
        ("stitch", view.feed_binned))}
    sc.capture, est.prepare, est.feed_async = (t["retune_read"],
                                               t["framing"], t["feed"])
    fft.psd_kernel, rb.product = t["kernel"], t["rebin"]
    sc._rebin, view.feed_binned = t["rebin_call"], t["stitch"]
    hop = timer.wrap("hop", sc.hop)
    try:
        for _ in range(hops):
            hop()
    finally:
        fft.psd_kernel, sc._rebin = kernel, rb
        for o, a in ((sc, "capture"), (est, "prepare"), (est, "feed_async"),
                     (rb, "product"), (view, "feed_binned")):
            delattr(o, a)
    ms = {k: np.array(v.ms) for k, v in t.items()}
    ms["h2d"] = ms["feed"] - ms["framing"] - ms["kernel"]
    ms["span_d2h"] = ms["rebin_call"] - ms["rebin"]
    ms["hop"] = np.array(hop.ms)
    keys = ("retune_read", "framing", "h2d", "kernel", "rebin", "span_d2h",
            "stitch", "hop")
    return {k: round(float(np.median(ms[k])), 4) for k in keys}


def hot_near(csv: str, emitters, bin_hz: float) -> dict:
    """The view bins 10 dB over the median of a scan CSV, and each
    emitter's distance in view bins to the nearest."""
    v = np.loadtxt(csv, delimiter=",", skiprows=1)
    db = 10 * np.log10(v[:, 1] + 1e-30)
    hot = v[db > np.median(db) + 10.0, 0]
    return {f: float(np.abs(hot - f).min() / bin_hz) if len(hot) else
            float("inf") for f in emitters}


def phase3j_scan(torch, card: str) -> dict:
    """(a) ``cli scan`` at its defaults over 88-108 MHz, 200 progressive
    hops, four emitters: the coverage at least 0.99, a hot bin within 8
    view bins of each emitter, ``psd_kernel`` launched once a hop; the
    command's wall per hop; then a scanner of the same band hop by hop
    through its layers.  (b) a 20 Msps sweep at N 32768 and 65536: the
    kernel held against its plain version on a hop's capture, WIDE_HOPS
    hops, each emitter standing 50x over the median.  Returns the
    launches."""
    import contextlib
    import io
    import os
    import tempfile

    from sigdigger_tpu_torch import cli
    from sigdigger_tpu_torch.analyzer.sweep import Scanner
    from sigdigger_tpu_torch.kernels import fft
    from sigdigger_tpu_torch.profiles import SourceProfile
    from sigdigger_tpu_torch.sources.synth import Emitter, SynthBandSource
    from sigdigger_tpu_torch.types import SweepStrategy

    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "scan.csv")
        argv = ["scan", "--fmin", "88e6", "--fmax", "108e6", "--hops",
                str(SCAN_HOPS), "--progressive", "--emitters",
                *[str(f) for f in SCAN_EMITTERS], "-o", csv,
                "--device", "cuda"]
        fft.psd_kernel.launches = 0
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        scan_launches = fft.psd_kernel.launches
        out = json.loads(buf.getvalue().splitlines()[-1])
        near = hot_near(csv, SCAN_EMITTERS, 20e6 / 65536)
    check(rc == 0 and out["hops"] == SCAN_HOPS and out["coverage"] >= 0.99
          and scan_launches == SCAN_HOPS
          and all(d <= 8 for d in near.values()),
          (rc, out, scan_launches, near))

    def source(rate, emitters):
        return SynthBandSource(SourceProfile(type="synth", sample_rate=rate,
                                             noise_db=-60.0),
                               [Emitter(freq=f) for f in emitters])

    sc = Scanner(source(2_048_000, SCAN_EMITTERS), 88e6, 108e6,
                 strategy=SweepStrategy.PROGRESSIVE, device="cuda")
    check(isinstance(sc._est, fft.PSD) and sc.fft_size == 2048)
    scan_layers(sc, torch, 5)                       # warm
    layers = scan_layers(sc, torch, 50)
    print(f"phase3j cli scan (88-108 MHz at 2.048 Msps, FFT {sc.fft_size}, "
          f"4 frames a hop, view 65536 bins of {20e6 / 65536:.2f} Hz, "
          f"--device cuda): {out}; psd_kernel launches {scan_launches} "
          f"(one a hop); emitters' distance to a hot bin (view bins, <= 8) "
          f"{ {f / 1e6: round(d, 2) for f, d in near.items()} }; wall "
          f"{wall:.3f} s, {wall * 1e3 / SCAN_HOPS:.4f} ms a hop | card: "
          f"{card}", flush=True)
    print(f"phase3j scan layers (synchronous, median ms a hop over 50 "
          f"hops): {layers}", flush=True)

    wide = {}
    wide_launches = 0
    for res in (1000.0, 305.0):
        sc = Scanner(source(WIDE_FS, WIDE_EMITTERS), 430e6, 450e6,
                     strategy=SweepStrategy.PROGRESSIVE, resolution_hz=res,
                     device="cuda")
        est = sc._est
        x = sc.capture(435e6)
        xp = torch.from_numpy(est.prepare(x)).cuda()
        got = fft.psd_kernel(xp, est.consts, est.params)
        want = fft.psd_kernel_reference(xp, est.consts, est.params)
        torch.cuda.synchronize()
        err = psd_err(got, want)
        check(err <= 1.0 and bool(torch.isfinite(got).all()), (res, err))
        fft.psd_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        psd = sc.sweep(WIDE_HOPS)
        torch.cuda.synchronize()
        hop_ms = (time.perf_counter() - t0) * 1e3 / WIDE_HOPS
        wide_launches += fft.psd_kernel.launches
        freqs = sc.view.frequencies()
        floor = float(np.median(psd))
        over = {}
        for f in WIDE_EMITTERS:
            i = int(np.argmin(np.abs(freqs - f)))
            over[f / 1e6] = round(float(psd[max(0, i - 8):i + 8].max())
                                  / floor, 1)
        check(fft.psd_kernel.launches == WIDE_HOPS
              and sc.view.coverage() > 0.99
              and all(v > 50 for v in over.values()),
              (res, fft.psd_kernel.launches, sc.view.coverage(), over))
        a, b = est.cfg.a, est.cfg.b
        form = ", two passes" if fft.psd_two_pass(a, b) else ""
        wide[sc.fft_size] = (f"A {a}, B {b}{form}: kernel vs plain "
                             f"{err:.3g} of its tolerance; {WIDE_HOPS} hops "
                             f"{hop_ms:.3f} ms a hop; emitters over the "
                             f"median {over}")
    print(f"phase3j wide sweep (430-450 MHz at 20 Msps, 4 frames a hop): "
          f"{wide} | card: {card}", flush=True)
    return {"psd_scan": scan_launches, "psd_wide": wide_launches}


def phase3j_tasks(torch, card: str) -> dict:
    """(c) ``CarrierDetector`` and ``DopplerCalculator`` on the card on
    a seeded tone capture with a known offset: each on the PSD kernel
    (one launch), each within one bin of the offset, the detector within
    a bin of its plain version on the CPU.  (d) ``cli doppler`` on the ISS
    set from its epoch over 90 minutes: elevation, azimuth, range and
    Doppler physical; its wall."""
    import contextlib
    import io
    import os
    import re
    import tempfile

    from sigdigger_tpu_torch import cli
    from sigdigger_tpu_torch.kernels import fft
    from sigdigger_tpu_torch.orbit import parse_tle
    from sigdigger_tpu_torch.tasks import CarrierDetector, DopplerCalculator

    rng = np.random.default_rng(SEED + 40)

    def capture(n, f_norm):
        k = np.arange(n)
        return (np.exp(2j * np.pi * f_norm * k) + 0.05 * (
            rng.standard_normal(n) + 1j * rng.standard_normal(n))
                ).astype(np.complex64)

    fs, f0, n = 1_024_000.0, 123_456.7, 1 << 16
    x = capture(n, f0 / fs)
    fft.psd_kernel.launches = 0
    t0 = time.perf_counter()
    got = CarrierDetector(x, fs, device="cuda").run()
    carrier_s = time.perf_counter() - t0
    carrier_launches = fft.psd_kernel.launches
    plain = CarrierDetector(x, fs, estimator="pallas", device="cpu").run()
    bin_hz = fs / 16384
    check(got.done and carrier_launches == 1
          and abs(got.result - f0) <= bin_hz
          and abs(got.result - plain.result) <= bin_hz,
          (got.error, carrier_launches, got.result, plain.result))

    fs2, rf, shift, n2 = 50_000.0, 437e6, 2000.0, 8192
    lam = 299_792_458.0 / rf
    y = capture(n2, shift / fs2)
    fft.psd_kernel.launches = 0
    t0 = time.perf_counter()
    res = DopplerCalculator(y, fs2, rf, device="cuda").run()
    doppler_s = time.perf_counter() - t0
    doppler_launches = fft.psd_kernel.launches
    r = res.result
    v_peak = float(r.velocities[int(np.argmax(r.spectrum))])
    bin_v = fs2 / len(r.spectrum) * lam
    check(res.done and doppler_launches == 1
          and abs(v_peak + shift * lam) <= bin_v
          and abs(r.center_velocity + shift * lam) < 0.05 * shift * lam,
          (res.error, doppler_launches, v_peak, r.center_velocity))
    print(f"phase3j tasks on the card: CarrierDetector ({n} samples at "
          f"{fs / 1e6} Msps, tone at {f0} Hz): {got.result:.2f} Hz (plain "
          f"version {plain.result:.2f}, bin {bin_hz:.2f} Hz), psd_kernel "
          f"launches {carrier_launches}, {carrier_s * 1e3:.3f} ms; "
          f"DopplerCalculator ({n2} samples at {fs2 / 1e3} ksps, {shift} Hz "
          f"at {rf / 1e6} MHz): peak {v_peak:.2f} m/s, centroid "
          f"{r.center_velocity:.2f} m/s (want {-shift * lam:.2f}, bin "
          f"{bin_v:.2f}), psd_kernel launches {doppler_launches}, "
          f"{doppler_s * 1e3:.3f} ms | card: {card}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "iss.txt")
        with open(path, "w") as fh:
            fh.write(ISS_TLE)
        start = parse_tle(ISS_TLE)[0].epoch_unix
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["doppler", path, "--freq", str(TRACK_RF), "--lat",
                           str(TRACK_SITE[0]), "--lon", str(TRACK_SITE[1]),
                           "--alt", str(TRACK_SITE[2] * 1000.0), "--start",
                           str(start), "--duration", "5400", "--step", "30"])
        wall = time.perf_counter() - t0
    rows = [tuple(map(float, m)) for m in re.findall(
        r"dopp\s+([-+0-9.]+) Hz\s+el\s+([-+0-9.]+)°\s+az\s+([0-9.]+)°\s+"
        r"range\s+([0-9.]+) km", buf.getvalue())]
    d, el, az, rng_km = (np.array(c) for c in zip(*rows))
    check(rc == 0 and len(rows) == 180 and np.all(np.abs(el) <= 90.0)
          and np.all((az >= 0.0) & (az < 360.0))
          and np.all((rng_km > 300.0) & (rng_km < 14000.0))
          and np.all(np.abs(d) < 12_000.0), (rc, len(rows)))
    print(f"phase3j cli doppler (ISS, {TRACK_RF / 1e6} MHz, site "
          f"{TRACK_SITE}, 90 min in 30 s steps): {len(rows)} lines, "
          f"Doppler {d.min():+.1f}..{d.max():+.1f} Hz, elevation "
          f"{el.min():+.2f}..{el.max():+.2f} deg, range {rng_km.min():.1f}.."
          f"{rng_km.max():.1f} km; wall {wall * 1e3:.3f} ms (numpy)",
          flush=True)
    return {"psd_tasks": carrier_launches + doppler_launches}


def pass_time(pred) -> float:
    """The time near epoch, the bird over the horizon, at which its
    Doppler moves fastest (near closest approach): there a pass retunes
    the tracked channels most."""
    t0 = pred.tle.epoch_unix
    best, best_rate = t0, -1.0
    for dt in np.arange(0.0, 86400.0, 10.0):
        info = pred.predict(t0 + dt, TRACK_RF)
        if info.elevation_deg > 2.0:
            rate = abs(pred.predict(t0 + dt + 1.0, TRACK_RF).doppler_hz
                       - info.doppler_hz)
            if rate > best_rate:
                best_rate, best = rate, t0 + dt
    check(best_rate * TRACK_LAPSE > 10.0, best_rate)
    return best


def fm_offset_hz(blocks, tone: float, rate: float) -> list:
    """The carrier's offset from the channel's centre in each block of
    an FM inspector's audio (deviation 50 kHz, a tone at ``tone``): the
    least-squares DC over the tone's amplitude, times the deviation."""
    out, k = [], 0
    for a in blocks:
        t = (k + np.arange(len(a))) / rate
        k += len(a)
        m = np.stack([np.ones_like(t), np.sin(2 * np.pi * tone * t),
                      np.cos(2 * np.pi * tone * t)], axis=1)
        c = np.linalg.lstsq(m, a.astype(np.float64), rcond=None)[0]
        out.append(float(c[0] / np.hypot(c[1], c[2]) * 50e3))
    return out


def phase3j_tracked_session(torch, card: str) -> dict:
    """(e) phase 3f's bench session on a source centred on 437.5 MHz with
    64 of its FM audio inspectors under Doppler correction by the ISS
    predictor: SESSION_BLOCKS timed blocks after SESSION_WARM.  Stream
    time is anchored where the pass's Doppler moves fastest, and each
    block adds TRACK_LAPSE seconds of pass to it, so the Doppler moves
    some 50 to 100 Hz a block and every tracked channel is retuned every
    block (the engine skips moves under 1 Hz).  The four FM-tone slots
    are among the tracked ones and their carriers carry the same Doppler
    in the source, block by block.  Checks: 64 retunes a block; each
    corrected channel's centre (the audio and the raw bank's) within 2 Hz
    of its offset plus the predicted Doppler at the rx_time the engine
    used; the Doppler over 100 Hz somewhere; the demodulated audio of
    each FM-tone slot centred within 50 Hz of its carrier in every
    drained block after the first two, while the carrier moves over
    500 Hz (a retune the kernel never saw leaves the whole move in the
    audio's DC); ORBIT_REPORTs; ``audio_kernel`` once a block and the
    bench mix's checks.  The session's Msps beside phase 3f's."""
    from sigdigger_tpu_torch import MessageKind
    from sigdigger_tpu_torch.orbit import OrbitPredictor, parse_tle

    drain_errors()
    pred = OrbitPredictor(parse_tle(ISS_TLE)[0], *TRACK_SITE)
    wall0 = pass_time(pred)
    n_blocks = SESSION_WARM + SESSION_BLOCKS
    step_s = TRACK_LAPSE + BLOCK_OUT * 64 / FS
    # block j runs under the correction made at its start, j·step_s on
    fm_lo = {s: -48e6 + s * 115e3 for s in FM_SLOTS}
    fm_dopp = {s: np.array([pred.predict(wall0 + j * step_s,
                                         TRACK_RF + lo).doppler_hz
                            for j in range(n_blocks)])
               for s, lo in fm_lo.items()}
    blocks = session_blocks(n_blocks, SEED + 18, fm_dopp)
    an, hs, open_s = bench_session(blocks, freq=TRACK_RF)
    an._wall0 = wall0
    an.orbit_report_interval = 0.01
    tracked = [hs[i] for i in TRACK_SLOTS]
    check(len(tracked) == 64)
    for h in tracked:
        an.set_inspector_doppler_correction(h, pred)
    ks = [an._kslots[h] for h in tracked]
    bucket = ks[0].bucket
    check(all(k.bucket is bucket for k in ks))
    idx = np.array([k.idx for k in ks])
    offs = np.array([k.offset for k in ks])
    los = np.array([an._inspectors[h].lo for h in tracked])
    # each block's correction: the pass advanced by TRACK_LAPSE, its
    # rx_time, its time and its retunes
    orbit_ms, rx, retunes = [], [], [0]
    apply, retune = an._apply_orbit_corrections, an._retune_channel

    def lapsed_apply():
        an._wall0 += TRACK_LAPSE
        rx.append(an._rx_time())
        t = time.perf_counter()
        apply()
        orbit_ms.append((time.perf_counter() - t) * 1e3)

    def counted_retune(slot, f0):
        retunes[0] += 1
        retune(slot, f0)

    an._apply_orbit_corrections = lapsed_apply
    an._retune_channel = counted_retune
    msgs = []
    for _ in range(SESSION_WARM):
        an.step()
        msgs += an.poll()
    kernels = session_kernels()
    for k in kernels.values():
        k.launches = 0
    retunes[0] = 0
    del rx[:], orbit_ms[:]
    f0s = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SESSION_BLOCKS):
        an.step()
        msgs += an.poll()
        f0s.append((bucket.audio._f0[idx].copy(),
                    bucket.raw._f0[idx] - offs))
    an._drain_q.join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    msgs += an.poll()
    launches = {name: k.launches for name, k in kernels.items()}
    dopp = np.array([[pred.predict(t, TRACK_RF + lo).doppler_hz
                      for lo in los] for t in rx])
    err = max(float(np.abs(f - (los + dd)).max())
              for (fa, fr), dd in zip(f0s, dopp) for f in (fa, fr))
    check(np.allclose(rx, wall0 + step_s * np.arange(
        SESSION_WARM + 1, n_blocks + 1), rtol=0, atol=1e-5), rx)
    reports = [m for m in msgs if m.kind == MessageKind.INSPECTOR
               and m.inspector_kind.value == "orbit_report"]
    check(retunes[0] == 64 * SESSION_BLOCKS and err < 2.0
          and np.abs(dopp).max() > 100.0 and reports
          and launches["audio"] == SESSION_BLOCKS
          and all(an._inspectors[h].lo == lo for h, lo in zip(tracked, los)),
          (retunes[0], err, float(np.abs(dopp).max()), len(reports),
           launches))
    res = session_checks(an, hs, msgs, n_blocks)
    # the tracked FM carriers, centred in their channels by the kernel
    centred = {}
    for s, tone in FM_SLOTS.items():
        aud = [m.samples for m in msgs if m.kind == MessageKind.SAMPLES
               and m.handle == hs[s]]
        off = fm_offset_hz(aud, tone, an.audio_rate)[2:]
        moved = float(np.ptp(fm_dopp[s][:len(aud)]))
        centred[s] = (round(max(off, key=abs), 3), round(moved, 1))
        check(max(abs(o) for o in off) < 50.0 and moved > 500.0,
              (s, off, moved))
    msps = BLOCK_OUT * 64 * SESSION_BLOCKS / wall / 1e6
    base = SESSION_MSPS.get("phase3f")
    print(session_line("phase3j Doppler-tracked bench session (437.5 MHz, "
                       "64 FM inspectors tracking the ISS)", open_s,
                       launches, wall, SESSION_BLOCKS, res, card),
          flush=True)
    print(f"phase3j tracking ({TRACK_LAPSE} s of pass a block): Doppler "
          f"{dopp.min():+.1f}..{dopp.max():+.1f} Hz over the timed blocks, "
          f"{retunes[0]} retunes in {SESSION_BLOCKS} blocks (64 a block), "
          f"the channels' centres within {err:.4f} Hz of offset + "
          f"predicted Doppler (< 2); the FM-tone slots' carriers in their "
          f"demodulated audio (worst offset Hz, < 50; the carrier's move "
          f"Hz, > 500) {centred}; {len(reports)} ORBIT_REPORTs; session "
          f"{msps:.2f} Msps against phase 3f's {base:.2f} Msps in this "
          f"process (ratio {msps / base:.4f}); the corrections (64 "
          f"predictions, retunes and reports) "
          f"{float(np.median(orbit_ms)):.4f} ms a block (median) | card: "
          f"{card}", flush=True)
    return {"audio_tracked": launches["audio"]}


# the end-to-end phases of one tree, run in a child process by --pairs:
# the phase functions of the tree's own chip_smoke.py
_E2E_CHILD = """
import sys
sys.path.insert(0, {tree!r})
import torch
import chip_smoke as cs
from sigdigger_tpu_torch.kernels import _build, fft
from sigdigger_tpu_torch.kernels import channelizer2 as ch2
_build.build_all()
card = cs.card_line()
cs.phase3_end_to_end(ch2, torch, card)
cs.phase3b_digital(torch, card)
cs.phase3c_every_geometry(ch2, fft, torch, card)
cs.phase3f_bench_session(torch, card)
cs.phase3g_tv(torch, card)
"""

# (metric, the line it is read from) of the end-to-end phases
E2E_METRICS = [
    ("fm block ms", r"^phase3 e2e: .*block wall ([0-9.]+) ms"),
    ("psk block ms", r"^phase3b psk e2e: .*block wall ([0-9.]+) ms"),
    ("fm-live block ms",
     r"^phase3c fm unsnapped e2e: .*block wall ([0-9.]+) ms"),
    ("session block ms", r"^phase3f bench session.*block wall ([0-9.]+) ms"),
    ("tv fields/s", r"^phase3g cli tv \(AM.* ([0-9.]+) fields/s"),
]

# the phase 2 timings of the PSD kernels, kernel2 (whose fused PSD runs
# the same stages), the drain packer, the line resampler, the v1
# channelizer and the CMA bank, run in a child process by --kernel-pairs
_KERNEL_CHILD = """
import sys
sys.path.insert(0, {tree!r})
import torch
import chip_smoke as cs
from sigdigger_tpu_torch.kernels import _build, fft
from sigdigger_tpu_torch.kernels import channelizer2 as ch2
_build.build_all()
cs.phase2_kernel_vs_plain(ch2, torch)
cs.phase2_psd(fft, torch)
_, uploads = cs.phase2_kernel2_cossin(ch2, torch)
cs.phase2_psd_xw(fft, torch, uploads)
from sigdigger_tpu_torch.kernels import drainpack, tvline
cs.phase2_pack(drainpack, torch)
cs.phase2_tv(tvline, torch)
from sigdigger_tpu_torch.kernels import channelizer, equalizer
cs.phase2_kernel1(channelizer, torch)
cs.phase2_cma(equalizer, torch)
"""

_K2, _PSD, _XW = (r"^phase2 timing: kernel2 ", r"^phase2 psd timing: ",
                  r"^phase2 psd_xw timing \(N 4096, ")
_PACK, _PACK_G, _TV = (r"^phase2 pack timing \(bench layout\): ",
                       r"^phase2 pack timing \(grouped layout\): ",
                       r"^phase2 tv_kernel \(W 512, ")
_V1, _CMA = r"^phase2 kernel1 timing: ", r"^phase2 cma_kernel \(C 1024"
# "tv ms" and "tv device ms" read each tree's first tv line, its main
# path's form: the framed [L, W] windows before the stream form, the
# stream form after it; "tv framed ..." read the framed form on both
# sides: the parent's tv_kernel line, this tree's second line
_TVF = r"^phase2 tv(?:_kernel \(W 512, px 384; 3 x| framed form)"
# a "PSD device ms" metric reads the line's traced stages, the sum of
# psd_frames and psd_sum (the parent's second stage; the FFT stages have
# none); any other "device ms" metric the sum of its traced stages
KERNEL_METRICS = [
    ("kernel2 ms", _K2 + r"([0-9.]+) ms"),
    ("kernel2 PSD device ms", _K2 + r".*?stages (\{[^}]*\})"),
    ("psd ms", _PSD + r"kernel ([0-9.]+) ms"),
    ("psd PSD device ms", _PSD + r".*?stages (\{[^}]*\})"),
    ("psd torch.fft.fft ms", _PSD + r".*?FFT only\) ([0-9.]+) ms"),
    ("psd composed ms", _PSD + r".*?frame sum\) ([0-9.]+) ms"),
    ("psd_xw ms", _XW + r".*?kernel ([0-9.]+) ms"),
    ("psd_xw ema ms", _XW + r".*?ema kernel ([0-9.]+) ms"),
    ("psd_xw PSD device ms", _XW + r".*?stages (\{[^}]*\})"),
    ("psd_xw torch.fft.fft ms", _XW + r".*?FFT only\) ([0-9.]+) ms"),
    ("psd_xw composed ms", _XW + r".*?frame sum\) ([0-9.]+) ms"),
    ("pack ms", _PACK + r"kernel ([0-9.]+) ms"),
    ("pack device ms", _PACK + r".*?trace (\{[^}]*\})"),
    ("pack grouped device ms", _PACK_G + r".*?trace (\{[^}]*\})"),
    ("tv ms", _TV + r".*?64 lines: kernel ([0-9.]+) ms"),
    ("tv device ms", _TV + r".*?trace (\{[^}]*\})"),
    ("tv framed ms", _TVF + r".*?64 lines: kernel ([0-9.]+) ms"),
    ("tv framed device ms", _TVF + r".*?trace (\{[^}]*\})"),
    ("kernel1 ms", _V1 + r"kernel ([0-9.]+) ms"),
    ("kernel1 device ms", _V1 + r".*?stages (\{[^}]*\})"),
    ("cma ms", _CMA + r".*?kernel ([0-9.]+) ms"),
    ("cma device ms", _CMA + r".*?trace (\{[^}]*\})"),
]


# phase 3k(a): the live session around phase 3f's engine.  Slot 831 of
# the mix is the session's own audio inspector, tuned to slot 40's FM-tone
# carrier so its WAV holds a tone; slot 1 opens through the web view and
# the four FM-tone slots through the wire client, each at its place in
# the mix's opening order, between runs of in-process opens
LIVE_OWN_SLOT = 831
LIVE_OWN_CARRIER = 40
LIVE_WEB_SLOT = 1
LIVE_USER, LIVE_PASSWORD = "op", "live-pw"
LIVE_FREQ = 145.8e6          # the REPL's retune
LIVE_AUDIO_RATE = FS / 64 / AUDIO_DECIM
LIVE_OWN_FC, LIVE_OWN_BW = -48e6 + LIVE_OWN_CARRIER * 115e3, 200e3


class HostClock:
    """Host seconds spent in wrapped callables, summed per name over
    every call from any thread (no synchronise: the live consumers are
    host work beside the session's pipeline, which a synchronise would
    stall)."""

    def __init__(self) -> None:
        self.s: dict = {}
        self.calls: dict = {}

    def wrap(self, name: str, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.s[name] = self.s.get(name, 0.0) \
                    + time.perf_counter() - t0
                self.calls[name] = self.calls.get(name, 0) + 1
        return timed

    def per_block_ms(self, blocks: int) -> dict:
        return {k: round(v / blocks * 1e3, 4) for k, v in self.s.items()}


def tone_peak_hz(a: np.ndarray, rate: float, pad: int = 1) -> tuple:
    """The strongest frequency of ``a`` past DC (Hann window, the FFT
    zero-padded ``pad`` times) and the window's own bin, rate/len(a)."""
    a = np.asarray(a, np.float64).ravel()
    spec = np.abs(np.fft.rfft((a - a.mean()) * np.hanning(len(a)),
                              n=pad * len(a)))
    step = rate / (pad * len(a))
    return (int(np.argmax(spec[2 * pad:])) + 2 * pad) * step, rate / len(a)


def http_get(base: str, path: str) -> tuple:
    """(body, milliseconds) of one GET."""
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(base + path, timeout=30) as r:
        body = r.read()
    return body, (time.perf_counter() - t0) * 1e3


def http_post(base: str, path: str, obj: dict) -> dict:
    import urllib.request

    req = urllib.request.Request(base + path, method="POST",
                                 data=json.dumps(obj).encode())
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


# the remote client of phase 3k(a), in a process of its own as a remote
# SigDigger is: the port's SuscanWireClient, driven by JSON lines on
# stdin ("open": one inspector, answered with the handle its OPEN ack
# carries; "collect": every message until 2 s pass without one, answered
# with the count, each PSD's peak bin and the SAMPLES of its inspectors)
_WIRE_CHILD = r"""
import base64, json, sys, time
sys.path.insert(0, {root!r})
from sigdigger_tpu_torch.io.suscan_wire import SuscanWireClient
from sigdigger_tpu_torch.types import Channel

cl = SuscanWireClient("127.0.0.1", int(sys.argv[1]), user=sys.argv[2],
                      password=sys.argv[3])
mine, got = set(), dict(n=0, psd_peaks=[], samples={{}})


def take(m):
    got["n"] += 1
    if m.kind.name == "PSD":
        got["psd_peaks"].append(int(m.data.argmax()))
    elif m.kind.name == "SAMPLES" and m.handle in mine:
        a = m.samples
        got["samples"].setdefault(str(m.handle), []).append(
            [str(a.dtype), base64.b64encode(a.tobytes()).decode()])


print(json.dumps({{"ready": True}}), flush=True)
for line in sys.stdin:
    cmd = json.loads(line)
    if cmd["op"] == "open":
        cl.open_inspector(cmd["kind"], Channel(fc=cmd["fc"], bw=cmd["bw"]),
                          request_id=cmd["rid"], config=cmd["cfg"])
        h, deadline = None, time.time() + 60.0
        while h is None and time.time() < deadline:
            m = cl.read(timeout=0.5)
            if m is None:
                continue
            take(m)
            if (m.kind.name == "INSPECTOR" and m.inspector_kind.name == "OPEN"
                    and m.request_id == cmd["rid"]):
                h = m.handle
                mine.add(h)
        print(json.dumps({{"handle": h}}), flush=True)
    else:
        deadline = time.time() + 120.0
        while time.time() < deadline:
            m = cl.read(timeout=2.0)
            if m is None:
                break
            take(m)
        cl.close()
        print(json.dumps(got), flush=True)
        break
"""


class WireChild:
    """The remote client process of phase 3k(a)."""

    def __init__(self, port: int) -> None:
        import os

        root = os.path.dirname(os.path.abspath(__file__))
        self.p = subprocess.Popen(
            [sys.executable, "-c", _WIRE_CHILD.format(root=root), str(port),
             LIVE_USER, LIVE_PASSWORD], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True, cwd=root)
        check(self.ask(None) == {"ready": True})

    def ask(self, cmd) -> dict:
        if cmd is not None:
            self.p.stdin.write(json.dumps(cmd) + "\n")
            self.p.stdin.flush()
        line = self.p.stdout.readline()
        check(line, "the wire client process ended")
        return json.loads(line)

    def close(self) -> None:
        if self.p.poll() is None:
            self.p.kill()
        self.p.wait(timeout=30)


def live_session_run(torch, device: str, cap: str, tmp: str,
                     instrument: bool) -> dict:
    """One run of phase 3k(a)'s session over the capture ``cap``: built
    with every consumer, the bench mix opened in its order (the session's
    own audio slot at start, the web slot by POST, the four FM-tone slots
    by the wire client, the rest in-process under ``bulk_config``) while
    a gate holds the analyzer's first step, the REPL's retune, then the
    capture to its end.  A hook on the pump counts each inspector's
    SAMPLES and keeps the PSDs and the wire slots' SAMPLES (no copies).
    With ``instrument`` the consumers are wrapped in a HostClock.
    Returns what the checks and the prints read."""
    import socket
    import threading

    from sigdigger_tpu_torch.app import LiveSession, build_profile
    from sigdigger_tpu_torch.io import suscan_wire
    from sigdigger_tpu_torch.io.wav import read_wav
    from sigdigger_tpu_torch.types import AnalyzerParams, Channel

    gate, steps = threading.Event(), []
    counts: dict = {}
    psds: list = []
    kept: dict = {}
    clock = HostClock()

    class GatedSession(LiveSession):
        """Holds the analyzer's steps (outside the engine lock) until
        the mix is open, stamps each step's start, and counts at the
        pump."""

        def _make_analyzer(self):
            an = super()._make_analyzer()
            step = an.step

            def gated():
                gate.wait()
                steps.append(time.perf_counter())
                return step()

            an.step = gated
            return an

        def _handle(self, msg):
            if msg.kind.name == "SAMPLES":
                counts[msg.handle] = counts.get(msg.handle, 0) + 1
                if msg.handle in kept:
                    kept[msg.handle].append(msg.samples)
            elif msg.kind.name == "PSD":
                psds.append(msg)
            return super()._handle(msg)

    params = AnalyzerParams()
    params.window_size = 4096
    sess = GatedSession(
        build_profile(cap, throttle=False), params=params,
        engine="kernel", block_size=BLOCK_OUT * 64,
        engine_kw=dict(BENCH_OPTS), wire_port=0, user=LIVE_USER,
        password=LIVE_PASSWORD, control_port=0, http_port=0,
        record_path=f"{tmp}/rec.cf32", waterfall_png=f"{tmp}/wf.png",
        waterfall_interval=0.0,
        audio={"fc": LIVE_OWN_FC, "demod": 2, "rate": LIVE_AUDIO_RATE,
               "bw": LIVE_OWN_BW, "wav": f"{tmp}/own.wav",
               "backend": "null"},
        device=device)
    sess.start()
    an = sess.analyzer
    check(an.device.type == device and an._in_i16 == an._drain_bf16
          == (device == "cuda") and an._psd_bucket is an._buckets[64])
    wire = sess.wire_server
    wire_tap = sess._taps[0]
    saved = (suscan_wire.encode_message, suscan_wire.write_pdu)
    if instrument:
        # the recorder tee (on the analyzer's thread, under the engine
        # lock); the pump's handling of each message and its parts (the
        # waterfall's row and PNG, the audio sinks, the web view's feed);
        # the wire tap's puts beside it; the wire's encode, framing and
        # sends
        an._bb_filters[0] = clock.wrap("recorder", an._bb_filters[0])
        sess._handle = clock.wrap("pump", sess._handle)
        wf = sess.waterfall
        wf.feed = clock.wrap("pump_waterfall", wf.feed)
        wf.save_png = clock.wrap("pump_png", wf.save_png)
        sess.wav_saver.play = clock.wrap("pump_audio", sess.wav_saver.play)
        sess.playback.write = clock.wrap("pump_audio", sess.playback.write)
        sess.web_server.feed = clock.wrap("web_feed", sess.web_server.feed)
        wire_tap.put = clock.wrap("pump_tap", wire_tap.put)
        wire._send = clock.wrap("wire_send", wire._send)
        suscan_wire.encode_message = clock.wrap("wire_encode", saved[0])
        suscan_wire.write_pdu = clock.wrap("wire_frame", saved[1])
    child = None
    try:
        child = WireChild(wire.address[1])
        mix = bench_mix(an)
        wire_slots = sorted(FM_SLOTS)
        base = f"http://127.0.0.1:{sess.web_server.address[1]}"
        hs = {LIVE_OWN_SLOT: sess.audio_handle}
        run: list = []

        def bulk():
            with an.bulk_config():
                for i in run:
                    kind, fc, bw, cfg = mix[i]
                    hs[i] = an.open_inspector(kind, Channel(fc=fc, bw=bw),
                                              request_id=i + 1, config=cfg)
            run.clear()

        t0 = time.perf_counter()
        for i, (kind, fc, bw, cfg) in enumerate(mix):
            if i == LIVE_WEB_SLOT:
                bulk()
                hs[i] = http_post(
                    base, "/control/inspector/open",
                    {"class": kind, "fc": fc, "bw": bw,
                     "config": cfg})["handle"]
            elif i in FM_SLOTS:
                bulk()
                hs[i] = child.ask({"op": "open", "kind": kind, "fc": fc,
                                   "bw": bw, "cfg": cfg, "rid": i + 1})[
                                       "handle"]
                check(hs[i] is not None, ("no OPEN ack over the wire", i))
                kept[hs[i]] = []
            elif i != LIVE_OWN_SLOT:
                run.append(i)
        bulk()
        open_s = time.perf_counter() - t0
        check(len(hs) == len(mix) == len(an._inspectors) == N_CHANNELS,
              (len(hs), len(an._inspectors)))
        check(len(an._buckets[64].cmap) == N_CHANNELS)
        # the REPL retunes the source
        with socket.create_connection(
                ("127.0.0.1", sess.control_server.address[1]),
                timeout=30) as s:
            f = s.makefile("rw", newline="\n")
            f.write(f"set frequency {LIVE_FREQ}\n")
            f.flush()
            check(f.readline().strip() == "OK")
        check(an.profile.freq == LIVE_FREQ, an.profile.freq)

        kernels = session_kernels()
        for k in kernels.values():
            k.launches = 0
        drain_errors()
        gate.set()
        sess.run(duration=600.0)
        check(sess.eos.is_set())
        an._thread.join(timeout=120.0)
        check(not an._thread.is_alive())
        t_end = time.perf_counter()
        if device == "cuda":
            torch.cuda.synchronize()
        launches = {name: k.launches for name, k in kernels.items()}
        blocks = an._blocks
        # the web view, while the session still stands
        body, psd_ms = http_get(base, "/psd.json")
        png, png_ms = http_get(base, "/waterfall.png")
        _, page_ms = http_get(base, "/")
        state, state_ms = http_get(base, "/control/state")
        check(len(json.loads(state)["inspectors"]) == N_CHANNELS)
        remote = child.ask({"op": "collect"})
    finally:
        suscan_wire.encode_message, suscan_wire.write_pdu = saved
        if child is not None:
            child.close()
        sess.halt()
    own_wav, own_rate = read_wav(f"{tmp}/own.wav")
    return dict(
        hs=hs, wire_slots=wire_slots, open_s=open_s, launches=launches,
        blocks=blocks, steps=steps, t_end=t_end, counts=counts, psds=psds,
        kept=kept, web=json.loads(body), png=png, remote=remote,
        dropped=wire_tap.dropped, own_wav=own_wav, own_rate=own_rate,
        rec=np.fromfile(f"{tmp}/rec.cf32", np.complex64),
        wf_png=open(f"{tmp}/wf.png", "rb").read(8), clock=clock,
        web_ms=dict(psd=psd_ms, png=png_ms, page=page_ms, state=state_ms))


def live_session_checks(r: dict, x: np.ndarray, device: str) -> dict:
    """Phase 3k(a)'s checks on one run; returns the wire's summary."""
    import base64

    block = BLOCK_OUT * 64
    blocks, hs = r["blocks"], r["hs"]
    errors = drain_errors()
    check(not errors, errors[:3])
    check(blocks == len(x) // block + 1, blocks)
    # every kernel of phase 3f once a block
    per_block = {"audio": 1, "raw": 1, "recovery": 1, "psd_xw_ema": 1,
                 "squeeze": 1, "pack": 1, "compact": 1, "psd": 0}
    if device == "cuda":
        check(all(r["launches"][k] == n * blocks
                  for k, n in per_block.items()), r["launches"])
    # the pump saw every inspector's SAMPLES every block
    check(set(r["counts"]) == set(hs.values())
          and set(r["counts"].values()) == {blocks},
          sorted(set(r["counts"].values())))
    psds = r["psds"]
    check(psds and all(m.frequency == LIVE_FREQ for m in psds))
    # the wire: every PSD on the carrier; each wire inspector's SAMPLES
    # equal, bit for bit, to the pump's of some block, and each of those
    # past the first two blocks and short of the EOS read's on its tone
    f_car = 34e6 + CARRIER_POWER_SLOT * 100e3
    freqs = np.linspace(-FS / 2, FS / 2, 4096, endpoint=False)
    remote = r["remote"]
    check(remote["psd_peaks"], ("no PSD over the wire", remote["n"],
                                r["dropped"]))
    for k in remote["psd_peaks"]:
        check(abs(freqs[k] - f_car) <= 2 * FS / 4096, (freqs[k], f_car))
    arrived = {}
    for i in r["wire_slots"]:
        pumped = r["kept"][hs[i]]
        got = [np.frombuffer(base64.b64decode(b), dtype=np.dtype(dt))
               for dt, b in remote["samples"].get(str(hs[i]), [])]
        at = []
        for a in got:
            j = [j for j, p in enumerate(pumped)
                 if p.shape == a.shape and np.array_equal(p, a)]
            check(j, (i, "a wire message the pump did not hand over"))
            at.append(j[0])
        arrived[i] = (got, at)
    seen = {i: sorted(at) for i, (_, at) in arrived.items()}
    why = (f"wire: {remote['n']} messages received, {r['dropped']} dropped "
           f"by its tap; the wire slots' blocks {seen}")
    tones = {}
    for i, (got, at) in arrived.items():
        mid = [a for a, j in zip(got, at) if 2 <= j < blocks - 1]
        check(mid, (i, "no SAMPLES past the warm-up over the wire", why))
        pk = [tone_peak_hz(a, LIVE_AUDIO_RATE, pad=16)[0] for a in mid]
        res = LIVE_AUDIO_RATE / len(mid[0])
        check(all(abs(p - FM_SLOTS[i]) <= 2 * res for p in pk),
              (i, FM_SLOTS[i], pk))
        tones[FM_SLOTS[i]] = (len(got), round(float(np.median(pk)), 1))
    # /psd.json is the last PSD row; /waterfall.png is a PNG
    web = r["web"]
    last_db = 10.0 * np.log10(np.asarray(psds[-1].data, np.float64) + 1e-30)
    check(web["rows"] == len(psds) and np.allclose(
        web["psd_db"], np.round(last_db, 2), atol=0.0051),
        (web["rows"], len(psds)))
    check(r["png"].startswith(b"\x89PNG")
          and r["wf_png"].startswith(b"\x89PNG"))
    # the recording: 8 bytes a sample read, the capture, then zeros
    rec = r["rec"]
    check(len(rec) == blocks * block, (len(rec), blocks * block))
    check(rec[:len(x)].tobytes() == x.tobytes() and not rec[len(x):].any())
    # the session's own WAV holds slot 40's tone (past its first 2 blocks,
    # short of the EOS read's)
    per_blk = BLOCK_OUT // AUDIO_DECIM
    own_wav, own_rate = r["own_wav"], r["own_rate"]
    check(len(own_wav) == blocks * per_blk, (len(own_wav), blocks))
    pk, res = tone_peak_hz(own_wav[2 * per_blk:-per_blk, 0], own_rate)
    check(own_rate == int(LIVE_AUDIO_RATE)
          and abs(pk - FM_SLOTS[LIVE_OWN_CARRIER]) <= 2 * res, (pk, res))
    return dict(tones=tones, wav_hz=round(pk, 1),
                sent=remote["n"], psds=len(remote["psd_peaks"]))


def phase3k_live_session(torch, card: str, device: str = "cuda") -> dict:
    """(a) ``app.LiveSession`` with phase 3f's engine options on a capture
    of SESSION_WARM + SESSION_BLOCKS session blocks (throttle off), every
    consumer on: the wire server (user and password) with a remote client
    in its own process, the REPL, the web view, the raw-IQ recorder, the
    waterfall PNG and an FM audio inspector to a WAV with the null
    backend (``live_session_run``).  Two runs: the first as a user runs
    it, with only a counting hook on the pump, gives the session's Msps;
    the second wraps each consumer in a HostClock for its host
    milliseconds a block.  Each run is held to ``live_session_checks``:
    every kernel once a block (as phase 3f), no drain error, every
    inspector's SAMPLES at the pump every block, the wire's PSD on the
    carrier, the wire inspectors' audio on their tones, the retune at
    the engine, ``/psd.json`` = the last PSD row and ``/waterfall.png`` a
    PNG, the recording = the capture byte for byte (then the zeros of the
    read that met its end), the WAV's tone.  Prints the wire tap's drops.
    Returns the launches of the first run."""
    import tempfile

    n_file = SESSION_WARM + SESSION_BLOCKS
    x = np.concatenate(session_blocks(n_file, SEED + 18))
    out = {}
    for instrument in (False, True):
        drain_errors()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_live_") as tmp:
            cap = f"{tmp}/live_{int(FS)}sps.cf32"
            x.tofile(cap)
            r = live_session_run(torch, device, cap, tmp, instrument)
        out[instrument] = (r, live_session_checks(r, x, device))
    (r, w), (ri, wi) = out[False], out[True]
    blocks = r["blocks"]
    timed = blocks - SESSION_WARM
    wall = r["t_end"] - r["steps"][SESSION_WARM]
    msps = BLOCK_OUT * 64 * timed / wall / 1e6
    walli = ri["t_end"] - ri["steps"][SESSION_WARM]
    ref = SESSION_MSPS.get("phase3f")
    per = ri["clock"].per_block_ms(ri["blocks"])
    per["wire"] = round(sum(per.get(k, 0.0) for k in
                            ("wire_encode", "wire_frame", "wire_send")), 4)
    n_bulk = N_CHANNELS - 2 - len(r["wire_slots"])
    print(f"phase3k live session (phase 3f's engine, every consumer, the "
          f"remote client in its own process; {N_CHANNELS} inspectors: "
          f"{n_bulk} in-process, 1 web, {len(r['wire_slots'])} wire at "
          f"their places in the mix, the session's own audio; opened in "
          f"{r['open_s']:.3f} s): {blocks} blocks ({SESSION_WARM} warm-up), "
          f"launches {r['launches']}, block wall {wall / timed * 1e3:.3f} ms, "
          f"{msps:.2f} Msps against phase 3f's "
          f"{ref if ref is None else round(ref, 2)} in this process "
          f"(instrumented run {BLOCK_OUT * 64 * timed / walli / 1e6:.2f}); "
          f"{sum(r['counts'].values())} SAMPLES at the pump ({blocks} a "
          f"inspector), no drain error; wire (every message to every "
          f"connection): {w['sent']} messages received, {r['dropped']} "
          f"dropped by its tap (instrumented run: {wi['sent']}, "
          f"{ri['dropped']}), {w['psds']} PSDs on the carrier, the wire "
          f"inspectors' (messages, median peak Hz) {w['tones']}; REPL "
          f"retune at the engine; /psd.json = the last of {len(r['psds'])} "
          f"PSD rows; recording {len(r['rec']) * 8} bytes = the capture + "
          f"the EOS read's zeros; WAV tone {w['wav_hz']} Hz | card: {card}",
          flush=True)
    print(f"phase3k consumers (instrumented run, host wall ms a block over "
          f"{ri['blocks']} blocks, waits for the interpreter lock included; "
          f"pump = the session's _handle, which holds pump_waterfall, "
          f"pump_png, pump_audio and web_feed; pump_tap the wire tap's puts "
          f"beside it; wire = encode + frame + send, the sends one a run of "
          f"PDUs; calls): {per} {ri['clock'].calls}; web GET ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in r["web_ms"].items())
          + f" | card: {card}", flush=True)
    return {"live_" + k: v for k, v in r["launches"].items()}


# phase 3k(b): `cli live` and `cli remote` on a capture an RTL-class
# receiver would write: an FM carrier with a tone, and noise
LIVE_CLI_FS = 1_024_000
LIVE_CLI_FC = 100e3
LIVE_CLI_TONE = 700.0
LIVE_CLI_SECONDS = 7
LIVE_CLI_MIN_AUDIO_S = 1.0   # of the 3 s remote run and the 6 s live one


def phase3k_cli(torch, card: str, device: str = "cuda") -> dict:
    """(b) ``cli.main(["live", <capture>, "--port", "0", "--control-port",
    "0", "--http", "0", "--audio", <fc>, "--audio-wav", ..., "--record",
    ..., "--duration", "6"])`` in a thread, at its defaults otherwise
    (``--device cuda``, the kernel engine, the file replayed at its
    rate), then ``cli.main(["remote", "127.0.0.1", <port>, "--audio",
    <fc>, "-o", <wav>, "--duration", "3"])`` against it.  Checks: both
    exit 0; ``remote`` counts more than one PSD, each peak inside the FM
    swing, and its WAV holds the tone; ``live`` reports its message
    count, its WAV holds the tone and its recording is the capture's
    prefix.  Returns the session kernels' launches over the run."""
    import contextlib
    import io
    import tempfile
    import threading

    from sigdigger_tpu_torch import cli
    from sigdigger_tpu_torch.io.wav import read_wav

    fs, fc, tone = LIVE_CLI_FS, LIVE_CLI_FC, LIVE_CLI_TONE
    n = fs * LIVE_CLI_SECONDS
    rng = np.random.default_rng(SEED + 30)
    t = np.arange(n) / fs
    x = (0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         + 0.5 * np.exp(1j * (2 * np.pi * fc * t + 2 * np.pi * 5e3 * np.cumsum(
             np.sin(2 * np.pi * tone * t)) / fs))).astype(np.complex64)
    # the user's command line: --device only off the card
    device_args = () if device == "cuda" else ("--device", device)
    kernels = session_kernels()
    for k in kernels.values():
        k.launches = 0
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_live_") as tmp:
        cap = f"{tmp}/live_{fs}sps.cf32"
        x.tofile(cap)
        err, rout = io.StringIO(), io.StringIO()

        def live():
            out["rc"] = cli.main([
                "live", cap, "--port", "0", "--control-port", "0",
                "--http", "0", "--audio", str(fc), "--audio-wav",
                f"{tmp}/live.wav", "--record", f"{tmp}/rec.cf32",
                "--duration", "6", *device_args])

        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            th = threading.Thread(target=live, daemon=True, name="cli-live")
            th.start()
            port = None
            deadline = time.time() + 120.0
            while port is None and th.is_alive() and time.time() < deadline:
                time.sleep(0.05)
                for line in err.getvalue().splitlines():
                    if line.startswith("live:") and "wire=" in line:
                        port = line.split("wire=")[1].split()[0].rstrip("]")
            check(port is not None, err.getvalue()[-2000:])
            with contextlib.redirect_stdout(rout):
                rc = cli.main(["remote", "127.0.0.1", port, "--audio",
                               str(fc), "-o", f"{tmp}/remote.wav",
                               "--duration", "3"])
            th.join(timeout=120.0)
        wall = time.perf_counter() - t0
        check(not th.is_alive() and out.get("rc") == 0 and rc == 0,
              (out, rc, err.getvalue()[-2000:]))
        if device == "cuda":
            torch.cuda.synchronize()
        launches = {name: k.launches for name, k in kernels.items()}
        rec = np.fromfile(f"{tmp}/rec.cf32", np.complex64)
        wavs = {w: read_wav(f"{tmp}/{w}.wav") for w in ("live", "remote")}
    log = err.getvalue()
    halted = [ln for ln in log.splitlines() if ln.startswith("halted after")]
    check(len(halted) == 1, log[-2000:])
    n_msgs = int(halted[0].split()[2])
    summary = [ln for ln in log.splitlines() if "PSD messages," in ln]
    check(len(summary) == 1, log[-2000:])
    n_psd, n_samples = int(summary[0].split()[0]), int(summary[0].split()[3])
    peaks = [float(ln.split("peak ")[1].split()[0]) * 1e6
             for ln in rout.getvalue().splitlines() if ln.startswith("psd ")]
    check(n_psd > 1 and len(peaks) == n_psd and n_samples > 0 and n_msgs > 0,
          (n_psd, len(peaks), n_samples, n_msgs))
    # each PSD's peak inside the carrier's ±5 kHz swing (plus two bins)
    check(all(abs(p - fc) <= 5e3 + 2 * fs / 4096 for p in peaks), peaks)
    tones = {}
    for w, (a, rate) in wavs.items():
        check(rate == 44100 and len(a) > LIVE_CLI_MIN_AUDIO_S * rate,
              (w, rate, len(a)))
        a = a[rate // 10:, 0]
        if w == "live":
            pk, res = tone_peak_hz(a, rate)
        else:
            # the server sends every inspector's samples to every client
            # and `remote` writes all it receives (as the reference's
            # does): live's own inspector's chunks and remote's, each on
            # the tone, alternate in its WAV with a phase step at each
            # seam, so the tone is read on segments of 2048 samples
            # (shorter than a chunk), their spectra averaged
            seg = 2048
            segs = a[:len(a) // seg * seg].reshape(-1, seg).astype(
                np.float64)
            segs = (segs - segs.mean(1, keepdims=True)) * np.hanning(seg)
            spec = (np.abs(np.fft.rfft(segs, 8 * seg, axis=1)) ** 2).mean(0)
            pk = (int(np.argmax(spec[16:])) + 16) * rate / (8 * seg)
            res = rate / seg
        check(abs(pk - tone) <= 2 * res, (w, pk, tone, res))
        tones[w] = round(pk, 1)
    check(len(rec) > 0 and rec.tobytes() == x[:len(rec)].tobytes(),
          len(rec))
    check(device != "cuda" or (launches["audio"] > 0
                               and launches["psd"] > 0), launches)
    print(f"phase3k cli live + remote ({fs / 1e6:.3f} Msps capture of "
          f"{LIVE_CLI_SECONDS} s, FM carrier at {fc / 1e3:.0f} kHz with a "
          f"{tone:.0f} Hz tone; live --duration 6 at its defaults, remote "
          f"--duration 3): both exit 0; live halted after {n_msgs} "
          f"messages, recorded {len(rec)} samples = the capture's prefix; "
          f"remote: {n_psd} PSDs, peaks {min(peaks) / 1e3:.2f}.."
          f"{max(peaks) / 1e3:.2f} kHz, {n_samples} audio samples; WAV tones "
          f"{tones} Hz; launches {launches}; {wall:.2f} s | card: {card}",
          flush=True)
    return {"cli_live_" + k: v for k, v in launches.items()}


# phase 3k(c): pipeline.py at benchmarks.py:61-79's geometry
PIPE_GEOM = dict(sample_rate=8_192_000.0, fft_size=2048, n_channels=256,
                 n_sub=64)
PIPE_BLOCK = 1 << 17
PIPE_PSK_BLOCK = 1 << 13
PIPE_REPS = 10


def pipe_input(n: int, seed: int) -> np.ndarray:
    """benchmarks.py's unit noise plus an FM carrier (1 kHz tone, 5 kHz
    deviation) on every 32nd channel's centre."""
    rng = np.random.default_rng(seed)
    fs = PIPE_GEOM["sample_rate"]
    t = np.arange(n) / fs
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    for f0 in np.linspace(-3.5e6, 3.5e6, 256)[::32]:
        x += 2.0 * np.exp(1j * (2 * np.pi * f0 * t + 2 * np.pi * 5e3
                                * np.cumsum(np.sin(2 * np.pi * 1e3 * t))
                                / fs))
    return x.astype(np.complex64)


def phase3k_pipeline(torch, card: str, device: str = "cuda") -> dict:
    """(c) ``pipeline_step`` on ``device`` against the same function on
    the CPU over 2 chained blocks of 2^17 samples, raw, fm and am: the
    PSD within TOL_PSD_BIN of its largest bin, raw iq and AM audio
    within TOL_REL of their scale (cuFFT and the CPU's FFT round in
    another order).  FM is held through its discriminator: the product
    y·conj(y_prev) of raw's channel samples (the FM path's, the same
    stages) on every element of every channel within 2·TOL_REL of the
    largest |y|^2 (the rounding of y, which it doubles), and the audio on
    every element within TOL_AUDIO plus the FIR's |taps| over what that
    rounding lets each discriminator sample move: arcsin of the
    product's relative error (twice the error measured, π where it is
    not smaller than the product), and one branch flip of the atan2 (2)
    where the CPU's product lies within that error of the negative real
    axis (a near-zero product in the noise-only channels, or a
    channel's start-up out of the zero tail); then each one's Msps over
    PIPE_REPS blocks, host input included.
    psk runs the per-sample loops (one step a channel sample, ~60 small
    launches a step): one block of 2^13 samples, its time."""
    from sigdigger_tpu_torch import pipeline as pl

    f0s = np.linspace(-3.5e6, 3.5e6, 256)
    bws = np.full(256, 40e3)
    x = pipe_input(3 * PIPE_BLOCK, SEED + 31)
    blocks = [x[i * PIPE_BLOCK:(i + 1) * PIPE_BLOCK] for i in range(3)]
    out, errs = {}, {}

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    iq, fm_room = {}, {}
    for demod in ("raw", "fm", "am"):
        cfg = pl.PipelineConfig(demod=demod, **PIPE_GEOM)
        step = pl.jit_pipeline(cfg)
        runs = {}
        for dev in (device, "cpu"):
            consts = pl.make_constants(cfg, f0s, bws, device=dev)
            state = pl.init_state(cfg, device=dev)
            outs = []
            for b in blocks[:2]:
                state, o = step(consts, state, b)
                outs.append({k: v.cpu().numpy() for k, v in o.items()})
            runs[dev] = (consts, state, outs)
        worst = {}
        for got, want in zip(runs[device][2], runs["cpu"][2]):
            e = float(np.abs(got["psd"] - want["psd"]).max()
                      / np.abs(want["psd"]).max())
            check(e <= TOL_PSD_BIN, (demod, "psd", e))
            worst["psd"] = max(worst.get("psd", 0.0), e)
            key = "iq" if demod == "raw" else "audio"
            check(np.all(np.isfinite(got[key])), demod)
            if demod != "fm":
                d = np.abs(got[key] - want[key])
                e = float(d.max() / np.abs(want[key]).max())
                check(e <= TOL_REL, (demod, key, e))
                worst[key] = max(worst.get(key, 0.0), e)
        if demod == "raw":
            iq = {dev: np.concatenate([o["iq"] for o in runs[dev][2]], 1)
                  for dev in (device, "cpu")}
            prod = {dev: y * np.conj(np.concatenate(
                [np.zeros_like(y[:, :1]), y[:, :-1]], 1))
                for dev, y in iq.items()}
            dp = np.abs(prod[device] - prod["cpu"])
            scale = float(np.abs(iq["cpu"]).max()) ** 2
            e = float(dp.max() / scale)
            check(e <= 2 * TOL_REL, ("fm", "discriminator product", e))
            worst["product"] = e
            mag = np.abs(prod["cpu"])
            r = np.where(mag > 0, 2 * dp / np.where(mag > 0, mag, 1), 2.0)
            turn = np.where(r < 1, np.arcsin(np.minimum(r, 1)), np.pi)
            flip = (prod["cpu"].real < 0) & (np.abs(prod["cpu"].imag)
                                             <= 2 * dp)
            fm_room["move"] = np.minimum(turn / np.pi + 2 * flip, 2.0)
            fm_room["flips"] = int(flip.sum())
        if demod == "fm":
            got = np.concatenate([o["audio"] for o in runs[device][2]], 1)
            want = np.concatenate([o["audio"] for o in runs["cpu"][2]], 1)
            taps = np.abs(runs["cpu"][0]["audio_taps"].cpu().numpy())
            room = TOL_AUDIO + np.stack(
                [np.convolve(m, taps)[:m.size] for m in fm_room["move"]])
            d = np.abs(got - want)
            over = d > room
            check(not over.any(), ("fm", "audio", int(over.sum()),
                                   float((d - room).max())))
            worst["audio_over_tol"] = float(np.mean(d > TOL_AUDIO))
            worst["flips"] = fm_room["flips"]
            worst["audio_room_used"] = float((d / room).max())
        errs[demod] = {k: float(f"{v:.3g}") for k, v in worst.items()}
        consts, state, _ = runs[device]
        for _ in range(2):
            state, o = step(consts, state, blocks[2])
        sync()
        t0 = time.perf_counter()
        for _ in range(PIPE_REPS):
            state, o = step(consts, state, blocks[2])
        sync()
        wall = time.perf_counter() - t0
        out[demod] = round(PIPE_BLOCK * PIPE_REPS / wall / 1e6, 3)
    cfg = pl.PipelineConfig(demod="psk", **PIPE_GEOM)
    consts = pl.make_constants(cfg, f0s, bws, device=device)
    state = pl.init_state(cfg, device=device)
    step = pl.jit_pipeline(cfg)
    sync()
    t0 = time.perf_counter()
    state, o = step(consts, state, x[:PIPE_PSK_BLOCK])
    sync()
    psk_s = time.perf_counter() - t0
    m = PIPE_PSK_BLOCK // cfg.decimation
    check(o["symbols"].shape == (256, m) and o["strobes"].shape == (256, m)
          and bool(torch.isfinite(o["symbols"]).all()))
    print(f"phase3k pipeline.py (benchmarks.py:61-79: 8.192 Msps, FFT 2048, "
          f"256 channels, n_sub 64, block 2^17, host input included): Msps "
          f"{out}; against the CPU (2 chained blocks; worst PSD and iq/AM "
          f"error of the largest, FM: the discriminator product's of the "
          f"largest |y|^2, the audio's share over TOL_AUDIO, the possible "
          f"branch flips and the largest share of its room used) {errs}; psk (the "
          f"per-sample loops) one block of 2^13 samples ({m} channel samples) "
          f"in {psk_s:.3f} s, {psk_s / m * 1e6:.1f} µs a channel sample "
          f"| card: {card}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 3l: the multi-device path on one card (parallel/)
# ---------------------------------------------------------------------------

MESH_BLOCKS = 3                 # timed blocks of each meshed session
MESH_REC_ROWS = 512             # rows of the recovery plain-version check
MESH_PIPE_BLOCK = 1 << 15       # sharded pipeline block (psk: 2^13)


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mesh_layouts(dev) -> dict:
    """The meshes of phase 3l, every cell on ``dev``: one device (the
    reference configuration of a meshed session), a ("ch",) mesh of 2
    and a ("time", "ch") mesh of 2 x 2."""
    from sigdigger_tpu_torch.parallel.banks import make_ch_mesh
    from sigdigger_tpu_torch.parallel.timebanks import make_time_ch_mesh

    return {"one": make_ch_mesh(1, [dev]), "ch2": make_ch_mesh(2, [dev] * 2),
            "t2c2": make_time_ch_mesh(2, 2, [dev] * 4)}


def mesh_session(blocks, mesh):
    """bench.py:255-259's session and 1024-inspector mix on ``mesh``,
    drained synchronously (depth 1, no drain thread), a PSD message every
    block.  Returns (analyzer, handles)."""
    from sigdigger_tpu_torch import KernelAnalyzer
    from sigdigger_tpu_torch.types import AnalyzerParams, Channel

    params = AnalyzerParams()
    params.window_size = 4096
    params.psd_update_interval = 0.0          # a PSD message every block
    opts = dict(BENCH_OPTS, pipeline_depth=1, drain_thread=False)
    an = KernelAnalyzer(source=ring_source(blocks), params=params,
                        block_size=BLOCK_OUT * 64, mesh=mesh, **opts)
    b = an._buckets[64]
    # the reference's meshed configuration: power-EMA AGC, no squeeze,
    # compactor, packer or shared-upload PSD, the PSD's frames sharded
    check(an.device == mesh.home and not b.audio.cfg.hang_agc
          and b.squeeze is None and b.comp_digital is None
          and an._psd_bucket is None and an._spectrum.mesh is mesh,
          mesh)
    an.poll()
    with an.bulk_config():
        hs = open_bench_mix(an, Channel)
    check(len(an.poll()) >= 1024)
    return an, hs


class Keeper:
    """A kernel wrapper's stand-in that keeps its last launch at each
    input shape (pass B of the exact audio); its ``launches`` count is
    the wrapper's own (the wrapper adds to it through its module name,
    which names the stand-in)."""

    def __init__(self, name: str, fn, kept: dict) -> None:
        self.name, self.fn, self.kept = name, fn, kept

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.launches = n

    def __call__(self, *a):
        out = self.fn(*a)
        self.kept[(self.name, tuple(a[0].shape))] = (a, out)
        return out


class ShardCalls:
    """Stands in for the kernel wrappers on their modules while a meshed
    block runs, and keeps the last launch of each at each local shape
    (its arguments and outputs) for the plain-version checks."""

    def __init__(self, mods: dict) -> None:
        self.mods = mods
        self.kept: dict = {}

    def __enter__(self):
        self.real = {name: getattr(mod, name)
                     for name, mod in self.mods.items()}
        for name, mod in self.mods.items():
            setattr(mod, name, Keeper(name, self.real[name], self.kept))
        return self

    def __exit__(self, *exc):
        for name, mod in self.mods.items():
            setattr(mod, name, self.real[name])


def mesh_run(name, mesh, blocks, torch) -> dict:
    """One meshed session: a warm-up block, then MESH_BLOCKS with the
    counts of kernels 4-7 set to 0 just before and read just after, each
    block's layers on ``utils/profiling.StageTimer`` (the spectrum, each
    bank, the drain, the step); the last block's shard launches kept;
    on the time mesh the recovery hand-off's inputs and outputs too."""
    from sigdigger_tpu_torch import MessageKind
    from sigdigger_tpu_torch.kernels import audio, fft, rawbank, recovery
    from sigdigger_tpu_torch.utils.profiling import StageTimer

    an, hs = mesh_session(blocks, mesh)
    b = an._buckets[64]
    timer = StageTimer(mesh.home)
    an._spectrum.feed = timer.wrap("spectrum", an._spectrum.feed)
    hand = []
    if an._tmesh:
        feed_planes = b.t_rec.feed_planes

        def handoff(y_re, y_im, fetch=True):
            st0 = torch.as_tensor(b.rec.state).to(y_re.device).clone()
            out = feed_planes(y_re, y_im, fetch)
            hand[:] = [(y_re, y_im, st0, out, b.rec.state)]
            return out

        b.t_audio.feed = timer.wrap("audio", b.t_audio.feed)
        b.t_raw.feed = timer.wrap("raw", b.t_raw.feed)
        b.t_rec.feed_planes = timer.wrap("recovery", handoff)
    else:
        b.audio.feed_frames = timer.wrap("audio", b.audio.feed_frames)
        b.raw.feed_frames = timer.wrap("raw", b.raw.feed_frames)
        b.rec.feed_planes = timer.wrap("recovery", b.rec.feed_planes)
    an._drain_bucket = timer.wrap("drain", an._drain_bucket)
    step = timer.wrap("step", an.step)
    check(step())
    an.poll()
    kernels = {"psd": fft.psd_kernel, "raw": rawbank.raw_kernel,
               "recovery": recovery.recovery_kernel,
               "audio": audio.audio_kernel}
    for k in kernels.values():
        k.launches = 0
    msgs = []
    sync(mesh.home)
    t0 = time.perf_counter()
    for i in range(MESH_BLOCKS):
        if i == MESH_BLOCKS - 1:
            with ShardCalls({"psd_kernel": fft, "raw_kernel": rawbank,
                             "recovery_kernel": recovery,
                             "audio_kernel": audio}) as calls:
                check(step())
        else:
            check(step())
        msgs += an.poll()
    sync(mesh.home)
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in kernels.items()}
    check(not drain_errors())
    by_h: dict = {h: [] for h in hs}
    psds = []
    for m in msgs:
        if m.kind == MessageKind.SAMPLES:
            by_h[m.handle].append((np.asarray(m.samples),
                                   m.extras.get("strobes")))
        elif m.kind == MessageKind.PSD:
            psds.append(np.asarray(m.data))
    check(all(len(v) == MESH_BLOCKS for v in by_h.values()),
          sorted({len(v) for v in by_h.values()}))
    layers = {k: round(float(np.median(timer.ms(k)[-MESH_BLOCKS:])), 4)
              for k in ("spectrum", "audio", "raw", "recovery", "drain",
                        "step")}
    kinds = [an._inspectors[h].class_name for h in hs]
    return dict(name=name, hs=hs, kinds=kinds, by_h=by_h, psds=psds,
                launches=launches, wall=wall, layers=layers,
                kept=calls.kept, hand=hand[0] if hand else None,
                rec=(b.rec.consts, b.rec.params))


def mesh_compare(got: dict, want: dict) -> dict:
    """A meshed session's payloads against the one-device mesh's: audio
    (the share of all its elements beyond TOL_AUDIO_BANK, at most
    TOL_AUDIO_FRAC: on a noise-only channel the discriminator's atan2 may
    take its other branch where a halo row's phase rounds apart), PSD (TOL_PSD_BIN of the largest bin), block power
    (TOL_RAW of itself), and every digital inspector's strobes and
    symbols EQUAL up to its first moved strobe."""
    import torch

    worst = {"psd": 0.0, "power": 0.0, "moved": 0}
    audio = ([], [])
    for h, kind in zip(got["hs"], got["kinds"]):
        a = np.concatenate([s for s, _ in got["by_h"][h]])
        w = np.concatenate([s for s, _ in want["by_h"][h]])
        check(a.shape == w.shape, (kind, a.shape, w.shape))
        if kind == "audio":
            audio[0].append(a)
            audio[1].append(w)
        elif kind == "power":
            e = float(np.max(np.abs(a - w) / np.maximum(np.abs(w), 1e-30)))
            worst["power"] = max(worst["power"], e)
        else:
            sa = np.concatenate([st for _, st in got["by_h"][h]])
            sw = np.concatenate([st for _, st in want["by_h"][h]])
            moved = np.flatnonzero(sa != sw)
            n = int(moved[0]) if len(moved) else len(sa)
            worst["moved"] += int(len(moved) > 0)
            check(n > 0 and np.array_equal(a[:n], w[:n]),
                  (kind, n, float(np.abs(a[:n] - w[:n]).max())))
    # over every audio element of the session, as phase 2 counts a plane
    worst["audio_frac"], worst["audio_max"] = beyond(
        *(torch.from_numpy(np.stack(v)) for v in audio), TOL_AUDIO_BANK)
    check(len(got["psds"]) == len(want["psds"]) >= 1)
    for p, q in zip(got["psds"], want["psds"]):
        worst["psd"] = max(worst["psd"],
                           float(np.abs(p - q).max() / np.abs(q).max()))
    check(worst["audio_frac"] <= TOL_AUDIO_FRAC and worst["psd"]
          <= TOL_PSD_BIN and worst["power"] <= TOL_RAW, (got["name"], worst))
    return {k: float(f"{v:.3g}") for k, v in worst.items()}


def mesh_plain_checks(run: dict, torch) -> dict:
    """Each shard launch kept from the last block against its plain
    version on the same inputs at its local shape: psd_kernel (TOL_PSD_BIN
    of the largest bin), raw_kernel (TOL_RAW of the largest plane value
    and of each power), audio_kernel (the share beyond TOL_AUDIO_BANK,
    audio and carries, at most TOL_AUDIO_FRAC), recovery_kernel on the
    first MESH_REC_ROWS rows, bit-equal (a comparison launch, after the
    counts were read).  Returns {kernel: (local shape, error)}."""
    from sigdigger_tpu_torch.kernels import audio, fft, rawbank, recovery

    out = {}
    for (name, shape), (a, got) in run["kept"].items():
        if name == "psd_kernel":
            want = fft.psd_kernel_reference(*a)
            e = float((got - want).abs().max() / want.abs().max())
            check(e <= TOL_PSD_BIN, (name, shape, e))
            shape = tuple(a[0].shape)
        elif name == "raw_kernel":
            want = rawbank.raw_kernel_reference(*a[:7])
            top = max(float(want[0].abs().max()), float(want[1].abs().max()))
            e = max(float((g - w).abs().max()) / top
                    for g, w in zip(got[:2], want[:2]))
            e = max(e, float(((got[2] - want[2]).abs() / want[2]).max()))
            check(e <= TOL_RAW, (name, shape, e))
            shape = (*a[0].shape, a[2].shape[1])
        elif name == "audio_kernel":
            want = audio.audio_kernel_reference(*a)
            e = max(beyond(g, w, TOL_AUDIO_BANK)[0]
                    for g, w in zip(got, want))
            check(e <= TOL_AUDIO_FRAC, (name, shape, e))
            p = a[6]
            shape = (a[0].shape[0], a[2]["h_re"].shape[1], f"m_tile {p.mt}",
                     f"seed_tile {p.seed_tile}", f"hang {p.hang}")
        else:
            y_re, y_im, state, params, mf, p = a
            r = MESH_REC_ROWS
            args = (y_re[:r].contiguous(), y_im[:r].contiguous(), state,
                    params, mf, p)
            ok = recovery.recovery_kernel(*args)
            op = recovery.recovery_kernel_reference(*args)
            check(all(torch.equal(g, w) for g, w in zip(ok, op)),
                  (name, shape))
            e = 0.0
            shape = (r, y_re.shape[1])
        out[name] = (shape, float(f"{e:.3g}"))
    check(set(out) == {"psd_kernel", "raw_kernel", "audio_kernel",
                       "recovery_kernel"}, sorted(out))
    return out


def phase3l_mesh(torch, card: str, device: str = "cuda") -> dict:
    """(a) The meshed ``KernelAnalyzer`` at the bench width: the bench
    mix on a one-device mesh, a ("ch",) mesh of 2 and a ("time", "ch")
    mesh of 2 x 2, every cell on one card (shards on one device run one
    after another: not a scale-out figure).  Each meshed session against
    the one-device one (``mesh_compare``), its kernels 4-7 launched
    blocks x shards times (x 2 for the exact audio passes), each held
    against its plain version at its local shapes
    (``mesh_plain_checks``), the time mesh's recovery hand-off bit-equal
    to one unsharded launch on the same planes and state.  (b)
    ``shard_pipeline`` on the 2 x 2 mesh at benchmarks.py:61-79's
    geometry against ``jit_pipeline``.  (c) two processes on the card
    (gloo), each its channel half of a hybrid mesh.  Returns the
    launches of the ("ch",) session."""
    from sigdigger_tpu_torch.kernels import recovery

    dev = torch.device(device, 0) if device == "cuda" else \
        torch.device(device)
    blocks = session_blocks(1 + MESH_BLOCKS, SEED + 40)
    meshes = mesh_layouts(dev)
    runs = {}
    for name, mesh in meshes.items():
        runs[name] = mesh_run(name, mesh, blocks, torch)
    shards = {"one": (1, 1, 1, 1), "ch2": (2, 2, 2, 2),
              "t2c2": (2, 4, 4, 8)}
    for name, (n_psd, n_raw, n_rec, n_audio) in shards.items():
        want = {"psd": n_psd, "raw": n_raw, "recovery": n_rec,
                "audio": n_audio}
        got = runs[name]["launches"]
        # (a CPU rehearsal runs the plain versions, which count nothing)
        check(dev.type != "cuda" or all(
            got[k] == MESH_BLOCKS * n for k, n in want.items()),
            (name, got, want))
    msps = {k: round(BLOCK_OUT * 64 * MESH_BLOCKS / r["wall"] / 1e6, 3)
            for k, r in runs.items()}
    errs = {k: mesh_compare(runs[k], runs["one"]) for k in ("ch2", "t2c2")}
    plain = {k: mesh_plain_checks(runs[k], torch) for k in ("ch2", "t2c2")}
    # the hand-off's last block against one unsharded launch on the
    # same planes and state (a comparison launch)
    y_re, y_im, st0, (sr, si, sb), st1 = runs["t2c2"]["hand"]
    consts, p = runs["t2c2"]["rec"]
    ok = recovery.recovery_kernel(y_re, y_im, st0, consts["params"],
                                  consts["mf"], p)
    check(all(torch.equal(g, w) for g, w in zip(ok, (sr, si, sb, st1))),
          "time-sharded recovery hand-off")
    print(f"phase3l meshed KernelAnalyzer (bench.py:255-259's mix, 1024 "
          f"slots, block 8192*64, decimation 64; every shard on one card: "
          f"shards run one after another, Msps is not a scale-out figure): "
          f"Msps {msps}; launches over {MESH_BLOCKS} blocks "
          f"{ {k: r['launches'] for k, r in runs.items()} } (blocks x shards, "
          f"x 2 for the exact audio passes); against the one-device mesh "
          f"(audio share beyond {TOL_AUDIO_BANK} and max abs, PSD of the "
          f"largest bin, power of itself, digital lanes with a moved "
          f"strobe; symbols equal before it) {errs}; time-sharded recovery "
          f"bit-equal to one unsharded launch | card: {card}", flush=True)
    print(f"phase3l shard launches against their plain versions at their "
          f"local shapes (shape, error): {plain} | card: {card}",
          flush=True)
    print(f"phase3l layers (utils/profiling.StageTimer, each stage from a "
          f"synchronize; median ms a block over the {MESH_BLOCKS} timed): "
          f"{ {k: r['layers'] for k, r in runs.items()} } | card: {card}",
          flush=True)
    phase3l_pipeline(torch, card, dev)
    phase3l_two_process(card, device)
    return {"mesh_" + k: v for k, v in runs["ch2"]["launches"].items()}


def pipe_close(demod: str, got: dict, want: dict, rows=slice(None)) -> float:
    """A sharded pipeline step's outputs (``got``, channel ``rows`` of
    the whole) against the unsharded step's on the same card: the PSD
    within TOL_PSD_BIN of its largest bin; raw and AM within TOL_REL of
    their scale; FM within TOL_REL on the carrier channels (every 32nd)
    and at most TOL_AUDIO_FRAC of all elements beyond TOL_AUDIO_BANK (the
    time shards' channel samples round apart by ~1e-7, and the
    discriminator's atan2 may pick the other branch on a noise-only
    channel); psk: at most 0.5% of strobes moved, and the symbols where
    both strobe within TOL_SYM times max(1, |symbol|) on 99.5% (the
    oracle tests/test_pipeline.py's bounds).  Returns the worst error."""
    import torch

    e = float((got["psd"] - want["psd"]).abs().max()
              / want["psd"].abs().max())
    check(e <= TOL_PSD_BIN, (demod, "psd", e))
    if demod == "psk":
        sa, sb = want["strobes"][rows], got["strobes"]
        check(float((sa == sb).float().mean()) > 0.995, demod)
        both = sa & sb
        ya = want["symbols"][rows][both]
        d = (got["symbols"][both] - ya).abs()
        check(float((d < TOL_SYM * torch.clamp(ya.abs(), min=1.0)).float()
                    .mean()) > 0.995, (demod, float(d.max())))
        return float(d.max())
    k = "iq" if demod == "raw" else "audio"
    a, w = got[k], want[k][rows]
    scale = float(want[k].abs().max())
    if demod == "fm":
        frac, _ = beyond(a, w, TOL_AUDIO_BANK)
        check(frac <= TOL_AUDIO_FRAC, (demod, frac))
        lo = rows.start or 0
        car = [c - lo for c in range(0, 256, 32) if c - lo in
               range(a.shape[0])]
        e = float((a[car] - w[car]).abs().max()) / scale
    else:
        e = float((a - w).abs().max()) / scale
    check(e <= TOL_REL, (demod, k, e))
    return e


def phase3l_pipeline(torch, card: str, dev) -> None:
    """``shard_pipeline`` on a 2 x 2 mesh over ``dev`` at
    benchmarks.py:61-79's geometry against ``jit_pipeline`` on ``dev``,
    2 chained blocks of MESH_PIPE_BLOCK, fm, am and raw; psk
    (``handoff="exact"``) on one block of PIPE_PSK_BLOCK; each held by
    ``pipe_close``."""
    from sigdigger_tpu_torch import pipeline as pl
    from sigdigger_tpu_torch.parallel.sharding import make_mesh, shard_pipeline
    from sigdigger_tpu_torch.utils.profiling import StageTimer

    f0s = np.linspace(-3.5e6, 3.5e6, 256)
    bws = np.full(256, 40e3)
    x = pipe_input(2 * MESH_PIPE_BLOCK, SEED + 41)
    mesh = make_mesh(2, 2, [dev] * 4)
    timer = StageTimer(dev)
    errs = {}
    for demod in ("fm", "am", "raw", "psk"):
        cfg = pl.PipelineConfig(demod=demod, **PIPE_GEOM)
        consts = pl.make_constants(cfg, f0s, bws, device=dev)
        n = PIPE_PSK_BLOCK if demod == "psk" else MESH_PIPE_BLOCK
        nb = 1 if demod == "psk" else 2
        one = pl.jit_pipeline(cfg)
        sh = timer.wrap(demod, shard_pipeline(cfg, mesh, handoff="exact")(
            consts, pl.init_state(cfg, device=dev)))
        s1 = s2 = None
        worst = 0.0
        for b in range(nb):
            blk = x[b * n:(b + 1) * n]
            s1, o1 = one(consts, s1 or pl.init_state(cfg, device=dev), blk)
            s2, o2 = sh(consts, s2 or pl.init_state(cfg, device=dev), blk)
            worst = max(worst, pipe_close(demod, o2, o1))
        errs[demod] = float(f"{worst:.3g}")
    ms = {k: round(float(np.median(timer.ms(k))), 3) for k in errs}
    print(f"phase3l shard_pipeline (benchmarks.py:61-79: 8.192 Msps, FFT "
          f"2048, 256 channels, n_sub 64; a 2 x 2 mesh on one card, "
          f"handoff exact) against jit_pipeline on the card, 2 chained "
          f"blocks of {MESH_PIPE_BLOCK} (psk: one of {PIPE_PSK_BLOCK}): "
          f"worst error (fm carriers/am/raw of the largest, psk symbols "
          f"abs where both strobe) {errs}; ms a sharded step {ms} | card: "
          f"{card}",
          flush=True)


def phase3l_two_process(card: str, device: str) -> None:
    """Two processes on the card join a gloo group
    (``parallel.distributed``), each drives its channel half of a hybrid
    ("time", "ch") mesh (time 2 on its own cells) with the sharded
    pipeline at benchmarks.py:61-79's geometry, and rank 0 holds its
    audio and the PSD against the single-process step (``pipe_close``).
    Each child has a 240 s timeout."""
    import os
    import socket
    import subprocess
    import tempfile

    worker = f'''
import sys, numpy as np, torch
pid, port = int(sys.argv[1]), sys.argv[2]
from sigdigger_tpu_torch.parallel import distributed
from sigdigger_tpu_torch.parallel.sharding import shard_pipeline
from sigdigger_tpu_torch import pipeline as pl
import chip_smoke as cs
distributed.initialize(f"localhost:{{port}}", num_processes=2,
                       process_id=pid, backend="gloo")
dev = torch.device({device!r}, 0) if {device!r} == "cuda" else \\
    torch.device({device!r})
cfg = pl.PipelineConfig(demod="fm", **cs.PIPE_GEOM)
consts = pl.make_constants(cfg, np.linspace(-3.5e6, 3.5e6, 256),
                           np.full(256, 40e3), device=dev)
x = cs.pipe_input({MESH_PIPE_BLOCK}, cs.SEED + 42)
mesh = distributed.make_hybrid_mesh(n_time=2, devices=[dev] * 2)
assert mesh.shape == {{"time": 2, "ch": 2}}, mesh.shape
step = shard_pipeline(cfg, mesh)(consts, pl.init_state(cfg, device=dev))
state, out = step(consts, pl.init_state(cfg, device=dev),
                  distributed.host_array(mesh, None, x))
mine = distributed.local_outputs(out["audio"])
assert [i[0] for i, _ in mine] == [slice(128 * pid, 128 * pid + 128)]
if pid == 0:
    _, ref = pl.jit_pipeline(cfg)(consts, pl.init_state(cfg, device=dev), x)
    (idx, data), = mine
    got = {{"audio": torch.from_numpy(data).to(dev), "psd": out["psd"]}}
    e = cs.pipe_close("fm", got, ref, rows=idx[0])
    print(f"ERR fm carriers {{e:.3g}} of the largest", flush=True)
torch.distributed.barrier()
distributed.shutdown()
print(f"OK {{pid}}", flush=True)
'''
    with tempfile.TemporaryDirectory() as tmp:
        script = os.path.join(tmp, "worker.py")
        with open(script, "w") as fh:
            fh.write(worker)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=root + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, script, str(i), str(port)], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=240)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
    for i, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0 and f"OK {i}" in out, (i, out[-2000:]))
    err = [ln for ln in outs[0].splitlines() if ln.startswith("ERR")]
    print(f"phase3l two processes (gloo, each its channel half of a 2 x 2 "
          f"hybrid mesh on the card, fm at benchmarks.py:61-79's geometry, "
          f"one block of {MESH_PIPE_BLOCK}): both exit 0; rank 0 against "
          f"the single-process step: {err[0][4:]}; {wall:.2f} s with the "
          f"processes' start | card: {card}", flush=True)


def metric_value(name: str, text: str) -> float:
    """A metric's number from its line; NaN for a trace that held no
    device time ("not measured")."""
    if "device" not in name:
        return float(text)
    import ast

    stages = ast.literal_eval(text)
    if "PSD device" in name:
        stages = {k: stages.get(k, 0.0) for k in ("psd_frames", "psd_sum")}
    if not all(isinstance(v, float) for v in stages.values()):
        return float("nan")
    return round(sum(stages.values()), 4)


def tree_pairs(parent: str, pairs: int, child: str, metrics: list) -> int:
    """The phases in ``child`` of the tree at ``parent`` and of this one
    in turns, ``pairs`` times, the order alternating (parent first in
    even pairs), each run a fresh process on the same card; prints
    every run's ``metrics``, then each metric's medians and how many
    pairs the change won."""
    import os
    import re

    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"parent": os.path.abspath(parent), "change": here}
    runs = {"parent": [], "change": []}
    for i in range(pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            out = subprocess.run(
                [sys.executable, "-c", child.format(tree=trees[side])],
                cwd=trees[side], capture_output=True, text=True, timeout=900)
            check(out.returncode == 0, (side, out.stderr[-3000:]))
            got = {}
            for name, pattern in metrics:
                m = re.search(pattern, out.stdout, re.M)
                got[name] = (float("nan") if m is None
                             else metric_value(name, m.group(1)))
            runs[side].append(got)
            print(f"pair {i} {side}: {json.dumps(got)}", flush=True)
            for line in out.stdout.splitlines():
                if line.startswith("phase2") and (
                        "timing" in line or line.startswith(
                            ("phase2 tv", "phase2 cma"))):
                    print(f"  {side}: {line}", flush=True)
    failed = []
    for name, _ in metrics:
        p = [r[name] for r in runs["parent"]]
        c = [r[name] for r in runs["change"]]
        # a run whose trace held no device time (three traces in a row:
        # profile_stages) counts in no median and no pair; a side may
        # lose one such run, not more
        n_p, n_c = int(np.isfinite(p).sum()), int(np.isfinite(c).sum())
        if min(n_p, n_c) < pairs - 1:
            failed.append(name)
        better = (lambda a, b: a > b) if "/s" in name else (
            lambda a, b: a < b)
        wins = sum(better(cv, pv) for cv, pv in zip(c, p))
        print(f"pairs {name}: parent median {np.nanmedian(p):.4f} "
              f"of {n_p} runs (runs {p}), change median "
              f"{np.nanmedian(c):.4f} of {n_c} runs (runs {c}), change "
              f"better in {wins} of {pairs} pairs", flush=True)
    check(not failed, ("unmeasured in more than one run of a side", failed))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    modes = {"--pairs": (_E2E_CHILD, E2E_METRICS),
             "--kernel-pairs": (_KERNEL_CHILD, KERNEL_METRICS)}
    if sys.argv[1:2] and sys.argv[1] in modes:
        print(card_line(), flush=True)
        return tree_pairs(sys.argv[2], int(sys.argv[3]),
                          *modes[sys.argv[1]])
    from sigdigger_tpu_torch.kernels import _build, audio, compact
    from sigdigger_tpu_torch.kernels import channelizer as ch1
    from sigdigger_tpu_torch.kernels import channelizer2 as ch2
    from sigdigger_tpu_torch.kernels import (
        drainpack,
        equalizer,
        fft,
        rawbank,
        recovery,
        symsqueeze,
        tvline,
    )

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    secs = _build.build_all(force=True)
    print(f"phase1 build: {time.perf_counter() - t0:.2f} s "
          f"({ {k: round(v, 2) for k, v in secs.items()} })", flush=True)
    for name in secs:
        with open(f"{_build.BUILD_DIR}/{name}.log") as fh:
            for line in fh:
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")
    t0 = time.perf_counter()
    tc_srcs = {"rawbank.cu": "raw_rot_tc",
               "channelizer2.cu": "chan_rot_disc_tc",
               "channelizer.cu": "chan_rot_disc_tc"}
    hg = sass_hgmma(tc_srcs)
    print(f"phase1 HGMMA instructions per tensor-core stage "
          f"({time.perf_counter() - t0:.2f} s): {hg}", flush=True)
    check({k.split(":")[0] for k in hg} == set(tc_srcs)
          and all(v > 0 for v in hg.values()), hg)

    t0 = time.perf_counter()
    p2 = {"kernel2": phase2_kernel_vs_plain(ch2, torch),
          "psd": phase2_psd(fft, torch),
          "raw": phase2_raw(rawbank, torch),
          "recovery": phase2_recovery(recovery, torch)}
    phase2_psd_sizes(fft, torch)
    p2["kernel2_cossin"], uploads = phase2_kernel2_cossin(ch2, torch)
    p2["psd_xw"], p2["psd_xw_ema"] = phase2_psd_xw(fft, torch, uploads)
    p2["kernel1"] = phase2_kernel1(ch1, torch)
    del uploads
    p2["audio"] = phase2_audio(audio, torch)
    p2["compact"] = phase2_compact(compact, torch)
    p2["squeeze"] = phase2_squeeze(symsqueeze, torch)
    p2["pack"] = phase2_pack(drainpack, torch)
    p2["tv"] = phase2_tv(tvline, torch)
    p2["cma"] = phase2_cma(equalizer, torch)
    print(f"phase2: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    launches = {"kernel2": phase3_end_to_end(ch2, torch, card)}
    print(f"phase3: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    launches.update(phase3b_digital(torch, card))
    print(f"phase3b: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    launches.update(phase3c_every_geometry(ch2, fft, torch, card))
    print(f"phase3c: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    launches.update(phase3d_ema_and_v1(ch1, ch2, fft, torch))
    print(f"phase3d: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    launches.update(phase3e_session(torch, card))
    print(f"phase3e: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    launches.update(phase3f_bench_session(torch, card))
    print(f"phase3f: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    launches.update(phase3g_tv(torch, card))
    print(f"phase3g: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    launches.update(phase3h_cma(torch))
    print(f"phase3h: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    launches.update(phase3i_cli(torch, card))
    print(f"phase3i: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    launches.update(phase3j_scan(torch, card))
    launches.update(phase3j_tasks(torch, card))
    launches.update(phase3j_tracked_session(torch, card))
    print(f"phase3j: {time.perf_counter() - t0:.2f} s (launches of the "
          f"spectrum users: psd_kernel scan {launches['psd_scan']}, wide "
          f"{launches['psd_wide']}, tasks {launches['psd_tasks']}; "
          f"audio_kernel tracked {launches['audio_tracked']})", flush=True)
    t0 = time.perf_counter()
    launches.update(phase3k_live_session(torch, card))
    launches.update(phase3k_cli(torch, card))
    phase3k_pipeline(torch, card)
    print(f"phase3k: {time.perf_counter() - t0:.2f} s (launches of the live "
          f"session: { {k[5:]: v for k, v in launches.items() if k.startswith('live_')} }; "
          f"of cli live: { {k[9:]: v for k, v in launches.items() if k.startswith('cli_live_') and v} })",
          flush=True)
    t0 = time.perf_counter()
    launches.update(phase3l_mesh(torch, card))
    print(f"phase3l: {time.perf_counter() - t0:.2f} s", flush=True)

    # each kernel form: (name, key, source, TPU kernel); the FM forms'
    # library yardstick (the channelize matmul alone) computes part of
    # the function only, so their library_ms is null
    rows = [
        ("kernel2", "kernel2", "channelizer2.cu",
         "kernels/channelizer2.py:126"),
        ("kernel2_unfused_cossin", "kernel2_cossin", "channelizer2.cu",
         "kernels/channelizer2.py:126"),
        ("psd_xw_kernel", "psd_xw", "psd_xw.cu", "kernels/fft.py:283"),
        ("psd_xw_ema_kernel", "psd_xw_ema", "psd_xw.cu",
         "kernels/fft.py:264"),
        ("psd_kernel", "psd", "psd.cu", "kernels/fft.py:65"),
        ("raw_kernel", "raw", "rawbank.cu", "kernels/rawbank.py:61"),
        ("recovery_kernel", "recovery", "recovery.cu",
         "kernels/recovery.py:90"),
        ("kernel1", "kernel1", "channelizer.cu",
         "kernels/channelizer.py:124"),
        ("audio_kernel", "audio", "audio.cu", "kernels/audio.py:193"),
        ("compact_kernel", "compact", "compact.cu", "kernels/compact.py:64"),
        ("squeeze_kernel", "squeeze", "symsqueeze.cu",
         "kernels/symsqueeze.py:71"),
        ("pack_kernel", "pack", "drainpack.cu", "kernels/drainpack.py:188"),
        ("tv_kernel", "tv", "tvline.cu", "kernels/tvline.py:54"),
        ("cma_kernel", "cma", "cma.cu", "kernels/equalizer.py:42"),
    ]
    no_library = ("kernel2", "kernel2_cossin", "raw", "recovery", "kernel1",
                  "audio", "cma")
    check(all(launches[key] > 0 for _, key, _, _ in rows), launches)

    # every TPU kernel with its bound at the inputs phase 2 timed
    ported = {tpu: key for _, key, _, tpu in rows if key != "kernel2_cossin"}
    check(all(s == "ported" for _, s in TPU_KERNELS))
    listing = []
    for r, s in TPU_KERNELS:
        key = ported[r.split(" ")[0]]
        listing.append({"replaces": f"sigdigger_tpu/{r}", "status": s,
                        "bound_ms": p2[key]["bound_ms"],
                        "bound_by": p2[key]["bound_by"]})
    print(json.dumps({"tpu_kernels": listing}))
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"sigdigger_tpu_torch/kernels/csrc/{src}",
        "replaces": f"sigdigger_tpu/{tpu}",
        "launches": launches[key],
        "max_abs_err": p2[key]["max_abs_err"],
        "ms": p2[key]["ms"],
        "plain_ms": p2[key]["plain_ms"],
        "bound_ms": p2[key]["bound_ms"],
        "bound_by": p2[key]["bound_by"],
        "library_ms": None if key in no_library else p2[key]["library_ms"],
    } for name, key, src, tpu in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
