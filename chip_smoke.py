"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --band-times [TREE]   # the band, wavefront and WTW kernels' times alone (A/B)
    python3 chip_smoke.py --serving-hops [TREE] # phases 10 (b) and 12 (b) unsharded, timed alone (A/B)

Phases, each raising on failure (the process then exits non-zero):

1. device — the card's name, then ``nvidia-smi``'s name and power limit;
2. build — ``nvcc`` builds every kernel of the port from ``csrc/``; each
   instantiation of the one-warp K-insert kernel with its registers, stack
   and spills from ptxas (a spill over 16 bytes fails), and the K-insert
   launch's kernel at each band checked below (one warp with its rows in
   rings or read from device memory, or the block kernel), with the blocks
   an SM holds; the wavefront kernels' registers, stack and spills (any
   spill fails) and the DP strips an SM holds; the WTW kernel's registers,
   stack and spills (any stack or spill fails) and its launch at each
   window checked below (warps, threads, shared bytes, blocks an SM);
3. kernel against plain, on the card — the K-insert kernel and its plain
   PyTorch version (on host copies, as in every comparison of phases 3 and
   7-10 but phase 10 (d)'s) run the same streams launch by launch (4 engine
   variants × bands c ∈ {10, 50, 200} × k_block ∈ {1, 8, 32}, with a stop
   past the end of the reference, and a live-capacity freeze at k_block
   32; then otw and livenote_v2_diff at the launch's route edges c ∈ {31,
   32, 63, 64, 228, 229, 237, 238, 255, 256}); status, scalars, path,
   window and live history must be EQUAL (the two share their operation order and
   round every step, so the tolerance is zero);
4. main path — the synthetic ``sonata_allegro`` piece (recording _00, 4.8
   minutes, is the reference; _01, 4.4 minutes, is the live performance)
   through ``ScoreFollower(fused=True, device="cuda")`` in 2048-sample
   buffers with the live apps' band ``{"c": 50, "max_run_count": 3}``, for
   the "otw" and "livenote_v2" engines.  The kernel's launch counter must
   equal the engine's dispatches, and the path must equal the plain
   version's on the same chroma columns.  Prints the path length, the
   PathScorer percentages, the wall-clock real-time factor, and at
   k_block ∈ {1, 8, 32} the kernel's per-launch device time (profiler)
   beside the back-to-back kernel and plain-version times (CUDA events).
5. wavefront kernels against plain, on the card — the DP and backtrack
   kernels and their plain versions on the same card-resident costs: both
   step specs, float32 and float64, shapes (1, 1) … (40, 65), the DP's
   lane, strip and chunk edges M ∈ {1, 31, 32, 33, 64, 65} × N ∈ {1, 7,
   31, 32, 33, 100}, the thin (1, 3,118), (3,118, 1) and (2,873, 40), a
   cost with infinite cells, an all-ones tie case, and the main path's
   (2,873, 3,118) and its transpose; then (40,000, 4), more strips than
   the card holds at once (float32, DTW).  ``acc``, ``back``, ``points``
   and ``length`` must be EQUAL (each cell is the same multiply, add and
   strict compare, so the tolerance is zero);
6. offline DTW main path — the three pairs of the rendered
   ``sonata_allegro`` piece (_00 3,118 frames, _01 2,874, _02 3,252) one by one
   through ``align_pair(engine="dtw", device="cuda")`` (chroma on the card,
   ``dtw_device``, both kernels, ``PathScorer``), each with one launch of
   each kernel and a path equal to the plain versions' on the same
   card-computed cost; then the whole sweep through
   ``CorpusRunner(root, "dtw", device="cuda").evaluate()`` with the
   launch counters read around it; one traced pair (device busy share,
   top device and host calls); then ``DTW(live, ref, max_dense_bytes=1)``
   on _01/_00, which forces the banded route, in float32 and float64;
   then each kernel's time at (2,874, 3,118): profiler device time per
   launch, CUDA events back to back, the plain version, and the bound.
7. set_live kernel against plain, on the card — the whole-pair kernel on
   card-resident pairs and its plain version on host copies of them: 4 engine variants ×
   bands c ∈ {10, 31, 32, 50, 63, 64, 200} (both sides of the warp's lane
   edges, where a lane's band registers go from 1 to 2 and 2 to 4) × {live
   runs out, stop past the reference's end with live ≈ 2.6× the reference,
   the 2N live-capacity halt}; a ragged batch of 4 == each pair alone ==
   plain; a shared reference × 3.  Path, plen, t, j and stopped must be
   EQUAL.  So too the kernels for any feature width (F = 7, and F = 12 rows
   not on a 16-byte boundary) at c ∈ {50, 238}, for otw and
   livenote_v2_diff.
8. fused corpus sweep main path — the full-scale synthetic corpus
   (``eval/synthetic.FULL_PIECES``: 8 pieces, 21 recordings, 18 pairs) through
   ``CorpusRunner(root, engine, band, mode="fused", device="cuda")`` for the
   four online engines, each sweep one batched launch (B = 18); every
   pair's path equal to solo ``align_pair(mode="fused")`` (all 18 for
   livenote_v2_diff, the sonata_allegro pairs for the others, one launch
   each); the kernel equal to the plain version on sonata_allegro _01/_00
   for each engine and over the whole otw sweep; one pair above 12,000
   combined frames (recordings of several pieces back to back) in one
   launch, equal to plain; the kernel's time at B = 1 and B = 18 (profiler, CUDA
   events, plain, bound) and one traced sweep.
9. the long-reference (delta) mode of the K-insert kernel and the follower on
   a concert-length reference —
   (a) the delta mode against its plain version on the card, launch by
   launch, over phase 3's grid (status, delta rows, window, live history and
   scalars EQUAL; a whole-path kernel run alongside has the same state and
   status after every launch and the same points), and so both modes at the
   wide bands c ∈ {237, 238, 400} too (238 and 400 keep their window in
   global memory) and, for otw and livenote_v2_diff, at the route edges of
   phase 3, with features of width 7 and width-12 rows 4 bytes off a
   16-byte boundary at c ∈ {50, 233, 238} and streams fed 3 launches past their
   stop and past their live capacity; kernels #2 and #3 (solo and a batch of 3) at the
   same bands and at c ∈ {511, 512} (otw; 16 and 32 band registers a
   lane), and the two kernels' times across that edge (set_live's µs per
   band update also at c ∈ {50, 511, 512});
   (b) the eight ``_00`` recordings of ``FULL_PIECES`` back to back as the
   reference (~39 minutes, ~25,000 frames; beat CSVs joined) and their
   ``_01`` recordings, in the same order, as the live performance, through
   ``ScoreFollower(ref, engine, PARAMS, fused=True, device="cuda")`` in
   2048-sample buffers for "otw" and "livenote_v2", over the live
   recording's first ``CONCERT_FOLLOW_HOPS`` hops: the engine must choose
   the long-reference layout by itself, its path must equal a
   ``long_ref=False`` engine's on the same columns, point for point, and
   begin with the plain version's in the long layout (a CPU engine) over
   the first 3,000 hops (``PLAIN_CONCERT_HOPS``); prints
   the real-time factor, the launches read from the counters, the pending
   delta entries a path read drains (one device-to-host copy each) and their
   bytes, and the device bytes per stream in each layout;
   (c) the delta mode's time at k_block 8 on that reference (profiler, CUDA
   events, plain, and the bound of this run's launches), the kernel's and
   the plain version's delta rows and states EQUAL after those launches.
10. multi-stream serving: the K-insert kernel over a grid of B streams
   (kernels #5 and #6) —
   (a) the batched kernel against the batched plain version, launch by
   launch, over 4 variants × c ∈ {10, 50, 200, 238} × k_block ∈ {1, 8} ×
   both modes, each a ragged batch of 3 references of different lengths
   with per-stream counts 0..k_block, and so at phase 3's route edges (otw,
   livenote_v2_diff, k_block 8); a ragged B = 5 in which one stream
   stops past its reference's end and one reaches the live-capacity freeze;
   a shared reference × 3.  Every stream's window, live rows, scalars,
   status, path buffers or delta rows EQUAL the plain version's and the
   solo kernel's on that stream alone;
   (b) ``FusedMultiStreamFollower`` with B = 256 streams on the shared
   ``sonata_allegro`` ``_00`` reference, even streams on ``_01`` and odd on
   ``_02`` (chroma on the card), stream i joining at hop i, in both layouts:
   the layouts' paths equal, the even streams' paths all equal and the odd
   streams' all equal, streams 0, 1, 254, 255 equal to a solo card engine,
   stream 0 to the plain version; the wall, per-stream and aggregate RTF,
   dispatches, launches read from the counters, device bytes per stream,
   the final drain, and a traced slice;
   (c) the same at B = 256 on the concert reference (24,456 frames), the
   windowed layout, the first 4,000 hops: streams 0 and 255 equal to a solo
   long-layout engine;
   (d) both modes' times at B ∈ {1, 4, 256, 1024} (profiler, CUDA events,
   bound), the plain version at B = 4 from the same state, whose rows and
   states must equal the kernel's.

11. streaming WTW for one stream (kernel #9, the fused K-column WTW
   insert) —
   (a) the kernel against its plain version on host copies, launch by
   launch, at (w, hop_frames) in {(20, 10), (100, 50), (128, 64),
   (20, 30)} (the harness's window, the live app's, the widest the kernel
   takes, a hop past the window) and at the kernel's warp edges (w in {1,
   31, 32, 33, 64, 65}, a hop below the window and one at or above it) x
   k_block in {1, 8, 32} x a fresh stream
   running to its margin stop, a mid-stream margin stop and a capacity
   stop, every third block ragged, two frozen launches after each stop:
   delta rows, scalars and live history EQUAL;
   (b) ``WTWFollower(ref, live, <live-app params>, engine="wtw_fused",
   device="cuda")`` on ``sonata_allegro`` _01 against _00 (w = 100, hop 50)
   in 2048-sample buffers as fast as the host allows: the path equal to
   the port's host ``WTW`` on the card (kernels #7 and #8 a window) fed
   8-column-aligned chunks, and beginning with the CPU plain engine's on
   the card's columns over the first 1,000 hops (a cut); the other
   payloads over those hops (int16 spans: the same path; host chroma: the
   points that move; "auto": the mode it resolves to); wall, real-time
   factor, host time a hop, launches, windows, the kernel's time on the
   main path's first 64 launches (profiler, CUDA events, plain, bound) and
   a traced slice;
   (c) the piece's three pairs through ``align_pair(engine="wtw",
   mode="fused", device="cuda")`` at the harness's widths (w = 20): wall
   and ``PathScorer`` buckets a pair, paths equal to ``mode="oracle"``.

12. multi-stream WTW serving: kernel #9's CUDA kernel over a grid of B
   streams (kernel #10) —
   (a) the batched kernel against its plain version (host copies) and the
   solo kernel #9 on each stream alone, launch by launch, over phase 11's
   (w, hop_frames) x k_block in {1, 8, 32} and its warp edges at k_block
   8, x {a ragged B = 3 of references
   of different lengths, a B = 5 with a margin and a capacity stop, a
   shared reference x 3}, per-stream counts 0..k_block, two frozen
   launches after the last stop: rows, scalars and live histories EQUAL;
   the blocks an SM holds (the occupancy calculator);
   (b) ``FusedMultiStreamWTW`` with B = 64 streams on the shared
   ``sonata_allegro`` ``_00`` reference at the live app's w = 100, hop 50,
   k_block 8, float32 spans, even streams on ``_01`` and odd on ``_02``,
   one 2048-sample buffer per stream a hop, stream i joining at hop i: the
   even streams' paths all equal and the odd streams' all equal, streams
   0, 1, 62, 63 equal to a solo ``FusedWTW`` on the card, stream 0
   beginning with the CPU plain engine's path over the first 1,000 hops;
   the frontend's columns equal to each stream's tiles alone at B = 1, 18
   and 64, with one batched product a stage timed beside it; wall, RTF,
   host time a hop, dispatches, launches read from the counters, device
   bytes per stream, the final drain, a traced slice; then k_block 32 with
   host chroma (``bench.py:787``): RTF and the points that move;
   (c) ``CorpusRunner(root, "wtw", mode="fused", device="cuda")`` over the
   full-scale corpus's 18 pairs (mixed references, w = 20): every pair's
   path equal to solo ``align_pair(engine="wtw", mode="fused")``; the
   sweep's wall against the solo runs', launches, buckets;
   (d) the kernel's time at w = 100 and B in {1, 64, 256}, and at w = 128,
   B = 256 (the blocks an SM decide the waves): profiler device time a launch (window and
   append-only launches apart), CUDA events, the bound; the plain version
   at B = 4 from the same state, rows and states equal to the kernel's.

13. the online engines on tensors (no hand-written kernel: ~800 small
   PyTorch launches a hop; the K-insert and set_live kernels' counters must
   stay 0 while they run), on phase 4's pair with its band, cut in depth to
   fit 90 s (``ONLINE_*``) —
   (a) ``OnlineTimeWarping(device="cuda")`` fed the first 400 of phase 4's
   columns through ``eval/corpus._streaming_path``: its path equals
   ``FusedStreamingEngine``'s (kernel #1) on those columns, point for
   point, and over the first 150 hops its path, live buffer and
   accumulator bits equal the same engine's on the CPU; the same for
   ``LiveNoteV2(chroma_diff=True)``, whose path comes from the default
   ``align_pair(ref, live, device="cuda")`` (livenote_v2_diff, the insert
   mode) on ``_00`` against ``_01`` cut to its first 400 hops;
   (b) ``ScoreFollower(engine="otw", fused=False)`` in the sync,
   ``use_blocks`` and ``pipelined`` modes fed the first 200 hops'
   2048-sample buffers: each path equals (a)'s on those hops; wall, RTF,
   host time a hop, and (at the phase's end) ``cudaLaunchKernel`` calls a
   hop from a profiler trace;
   (c) ``OnlineTimeWarping.set_live`` on the first 480 frames of both
   recordings: its path equals ``pallas_set_live``'s (kernel #2);
   (d) ``MultiStreamFollower`` over the 18 pairs of phase 8's corpus
   (B = 18, each stream on its own reference zero-padded to the longest),
   one column a stream a hop for 200 hops: the shortest and the longest
   reference's streams equal their solo engines; device bytes and the
   wall a hop.

14. the device-resident WTW engine (``AsyncWTW``, ``MultiStreamWTW``) and
   kernels #7 and #8 over a batch of windows (one launch of each, the
   batch on the grid) —
   (a) the batched DP and backtrack at (B, w) in ((1, 20), (18, 100),
   (64, 200), (18, 128)) float32, (18, 100) float64 and a batch at w = 200
   of more strips than the card holds at once (a window of ties and one
   with infinite cells in each): acc, back, points and length EQUAL B solo
   launches and the plain versions; one batched launch's device time
   (profiler) and CUDA-event time beside B solo launches';
   (b) ``WTWFollower(engine="wtw_async")`` at the live app's w = 100, hop
   50, k_block 8 on phase 4's pair, fed 2048-sample buffers, its insert
   loop under ``torch.cuda.set_sync_debug_mode("error")`` (a host read of
   a device value fails the phase): the path equals
   ``WTWFollower(engine="wtw_fused")``'s (kernel #9) and the host
   ``WTW``'s on the card; RTF, wall and host time a hop, windows, the
   batched launches (counters), and from a traced slice
   ``cudaLaunchKernel`` a hop, the kernels' device ms a window and the
   idle share;
   (c) ``AsyncWTW`` at w = 200, hop 100 (above the fused kernel): the path
   equals the host ``WTW``'s; a float64 ``AsyncWTW`` on the card equals its
   CPU run over the first ``ASYNC_F64_HOPS`` hops (host chroma columns,
   the card's reference rows);
   (d) ``align_pair(engine="wtw", mode="insert")`` at w = 20 on the piece's
   three pairs == ``mode="oracle"`` == ``mode="fused"``;
   (e) ``CorpusRunner(engine="wtw", mode="fused")`` at w = 200 over the
   full-scale corpus's 18 pairs, one ``MultiStreamWTW`` (B = 18, each
   stream on its own reference): each stream equals its solo ``AsyncWTW``;
   at w = 20 ``MultiStreamWTW`` equals ``FusedMultiStreamWTW`` stream by
   stream; ms and ``cudaLaunchKernel`` a dispatch, device bytes a stream.
   (d) and (e) run each recording's first ``ASYNC_CUT_HOPS`` hops (a cut
   in depth, to fit the phase's 60 s).

15. the live app, checkpoint and resume, and corpus alignment (no new
   kernel; kernels #1 and #3-#9 reached through new entry points) —
   (a) ``python -m real_time_audio_sync_tpu_torch.streaming --engine otw``
   as a process on ``sonata_allegro`` _00 against _01 cut to its first
   ``APP_HOPS`` hops (the tensor engine, no hand-written kernel): its field
   log equals an in-process ``follow_live(device="cuda")``'s; then
   ``follow_live(engine="wtw")`` (the host ``WTW``, w = 100), with kernels
   #7 and #8 launched once a window;
   (b) every checkpoint pair of ``utils/checkpoint`` on the card: half a
   run, save, load into a fresh CUDA engine, the rest — ``FusedStreamingEngine``
   in both layouts (#1, #4), ``FusedMultiStreamFollower`` with 4 streams in
   both (#5, #6), ``FusedWTW`` (#9), ``AsyncWTW`` and ``MultiStreamWTW``
   (#7/#8 over a batch), the host ``WTW`` (#7/#8) and ``OnlineTimeWarping``:
   each equals its uninterrupted run at tolerance 0, and its kernel's
   counter advances after the load; a card checkpoint resumes in a
   ``device="cpu"`` engine to the card's path;
   (c) ``parallel.batched_set_live`` over the 18 sweep pairs' chroma: one
   launch of kernel #3, paths equal to ``pallas_batched_set_live``'s; its
   dense route on 3 cut pairs: float32 equal to the kernel's paths, float64
   on the card equal to float64 on the CPU.

16. ``mesh=`` on the one card (kernels #3, #5, #6, #7/#8 over a batch and
   #10 launched once a shard; a mesh of the card n times stands in for n
   devices, so no run here covers more than one card), cut in depth to fit
   60 s (``MESH_*``, each cut printed) —
   (a) phase 10 (b)'s cell, ``FusedMultiStreamFollower`` at B = 256, in
   both layouts, unsharded, on ``corpus_mesh()`` and on 4 shards: every
   stream's path and the stop masks equal the unsharded run's, #5/#6
   launch shards × dispatches times; wall, and wall and host CPU a hop;
   (b) ``FusedMultiStreamWTW`` at B = 64, w = 100 on 4 shards (#10 shards
   × dispatches), ``MultiStreamWTW`` at w = 200 over the 18 sweep pairs on
   2 shards (#7/#8 once a shard's slot with a due window) and
   ``MultiStreamFollower`` at B = 8 on 2 shards (no band kernel): each
   equal to its unsharded run;
   (c) ``batched_set_live`` over the 18 sweep pairs on 2 and 3 shards: one
   launch of #3 a shard, paths equal the unsharded call's, the mean equal
   to the float32 sum × float32(1/18), printed as a hex float;
   (d) ``sharded_chroma_frames`` on ``_00``'s frames (cut to a multiple of
   4) on 4 shards, float32 and float64: equal to its shards'
   ``chroma_frames``, within the CPU test's tolerance of one call on every
   frame (max |diff| printed);
   (e) a 4-shard ``FusedMultiStreamFollower`` (B = 8) saved halfway and
   loaded into an unsharded one resumes to the uninterrupted path, both
   layouts.

17. the live-follower examples (``real_time_audio_sync_tpu_torch/examples``;
   kernels #1, #4 and #7/#8 solo and batched, reached from the scripts
   users start with) —
   (a) ``live_demo.main`` in process on phase 4's pair at full length,
   three ways: ``--fused`` (#1), ``--fused --tile 2`` (a 6,236-frame
   reference, the long layout, #4) and ``--engine wtw_async`` (w = 20,
   #7/#8 over a batch); (b) the non-fused engines ``otw``, ``livenote``,
   ``livenote_v2`` (no hand-written kernel) and ``wtw`` (the host WTW,
   #7/#8 solo) on the short synthetic ``steady`` pair: each field log
   equals the path of the follower the demo builds, made directly on the
   card and fed the same buffers (for ``--fused``, phase 4's otw
   follower); wall, ms a hop, the demo's dispatch p50/p99 and each
   kernel's launches from the counters;
   (c) ``python -m real_time_audio_sync_tpu_torch.examples.live_demo
   --fused --out-dir DIR`` on ``steady`` as a process, started beside (a)
   (field log == the direct follower's, ``click_track.wav`` over 10 KB),
   then with ``--realtime`` after (d), alone on the card (its drift and
   staleness lines);
   (d) ``heatmap_overlay.wav_costs`` (the script's alignment) on the card
   equals ``overlay_costs`` on the CPU on the same chroma (accumulated cost
   and paths, tolerance 0); ``heatmap_overlay.main`` with (c)'s field log
   writes a PNG over 10 KB where matplotlib is installed, and elsewhere
   stops with ``ModuleNotFoundError`` before aligning;
   (e) ``python -m real_time_audio_sync_tpu_torch.examples.mic_smoke`` as
   a process (started beside (a)): no audio backend, so exit 2 and
   ``SKIP`` on stderr.

The builds run in parallel (one ``nvcc`` per source).  Then each phase's
seconds, one JSON line of per-kernel results, and last ``{"ok": true,
"device": {...}}``.  ``--band-times [TREE]`` only times the two band
kernels, the two wavefront kernels (the DP also over a batch of windows)
and the WTW kernel (:func:`band_times`), for an A/B of two trees in one
call; ``--serving-hops [TREE]`` only times the unsharded serving cells of
phases 10 (b) and 12 (b) (:func:`serving_hops`), for the same.
Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

PARAMS = {"c": 50, "max_run_count": 3}  # livenote_live.py:94
VARIANTS = ("otw", "livenote", "livenote_v2", "livenote_v2_diff")
BANDS = (10, 50, 200)
K_BLOCKS = (1, 8, 32)
CSRC = "real_time_audio_sync_tpu_torch/csrc"
# kernel name -> (library, source, TPU kernel it replaces)
KERNELS = {
    "otw_insert_block": ("otw_insert", f"{CSRC}/otw_insert.cu", "real_time_audio_sync_tpu/ops/pallas_otw.py:803"),
    "wavefront_dp": ("wavefront", f"{CSRC}/wavefront.cu", "real_time_audio_sync_tpu/ops/pallas_wavefront.py:111"),
    "wavefront_backtrack": ("wavefront", f"{CSRC}/wavefront.cu", "real_time_audio_sync_tpu/ops/pallas_wavefront.py:181"),
    # kernels #2 (solo, B = 1) and #3 (batched) are one CUDA kernel
    "otw_set_live": ("otw_set_live", f"{CSRC}/otw_set_live.cu", "real_time_audio_sync_tpu/ops/pallas_otw.py:387"),
    "otw_batched_set_live": ("otw_set_live", f"{CSRC}/otw_set_live.cu",
                             "real_time_audio_sync_tpu/ops/pallas_otw.py:505"),
    # kernel #4 is the delta mode of kernel #1's CUDA kernel
    "otw_insert_block_long": ("otw_insert", f"{CSRC}/otw_insert.cu",
                              "real_time_audio_sync_tpu/ops/pallas_otw.py:959"),
    # kernels #5 and #6 are that kernel over a grid of B streams, in each mode
    "otw_multi_insert_block_long": ("otw_insert", f"{CSRC}/otw_insert.cu",
                                    "real_time_audio_sync_tpu/ops/pallas_otw.py:1002"),
    "otw_multi_insert_block": ("otw_insert", f"{CSRC}/otw_insert.cu",
                               "real_time_audio_sync_tpu/ops/pallas_otw.py:1080"),
    # kernel #9: K hop columns of streaming WTW
    "wtw_insert_block": ("wtw_insert", f"{CSRC}/wtw_insert.cu",
                         "real_time_audio_sync_tpu/ops/pallas_wtw.py:360"),
    # kernel #10: kernel #9's CUDA kernel over a grid of B streams
    "wtw_multi_insert_block": ("wtw_insert", f"{CSRC}/wtw_insert.cu",
                               "real_time_audio_sync_tpu/ops/pallas_wtw.py:408"),
    # kernels #7 and #8 over a batch of windows, one launch each (AsyncWTW, MultiStreamWTW)
    "wavefront_dp_batched": ("wavefront", f"{CSRC}/wavefront.cu",
                             "real_time_audio_sync_tpu/ops/pallas_wavefront.py:111"),
    "wavefront_backtrack_batched": ("wavefront", f"{CSRC}/wavefront.cu",
                                    "real_time_audio_sync_tpu/ops/pallas_wavefront.py:181"),
}
# the card's published peaks (H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
WAVEFRONT_SHAPES = ((1, 1), (1, 7), (7, 1), (5, 7), (33, 20), (40, 65))
# the DP kernel's edges: rows on both sides of a lane's and a strip's (32
# and 64 rows), columns on both sides of a chunk (32); thin shapes of the
# main path's lengths; and a shape of more strips than an H100 holds at once
WAVEFRONT_EDGE_M = (1, 31, 32, 33, 64, 65)
WAVEFRONT_EDGE_N = (1, 7, 31, 32, 33, 100)
WAVEFRONT_THIN = ((1, 3118), (3118, 1), (2873, 40))
WAVEFRONT_MANY_STRIPS = (40000, 4)
# --band-times: the wavefront kernels' shapes (the main pair, the live
# app's WTW window, the harness's), float32; the DP's also in float64
WAVEFRONT_TIMED = ((2874, 3118), (100, 100), (20, 20))
SWEEP_BAND = {"search_band_width": 50, "max_run_count": 3}  # tests.py:140
SET_LIVE_SCENARIOS = ("runs_out", "stop", "capacity")
# combined frames at which the JAX package sends a pair to its streaming
# engine instead of its set_live kernel (pallas_otw.py:422); phase 8 runs a
# pair above it through the port's set_live kernel
LONG_PAIR_FRAMES = 12000
# bands on both sides of the H100's shared-memory limit for the (c+1)² window
# (c = 238 is the first that does not fit), and one far above it
WIDE_BANDS = (237, 238, 400)
# phase 7's set_live bands: phase 3's and both sides of the lane edges of the
# warp kernel's band registers (32 and 64 positions)
SET_LIVE_BANDS = (10, 31, 32, 50, 63, 64, 200)
# phase 7's bands for the any-width set_live kernels: a window in shared
# memory and one in a global workspace
SET_LIVE_ANY_WIDTH_BANDS = (50, 238)
# phase 9's widest set_live bands (16 and 32 band registers a lane), and the
# bands at which it times set_live per band update
SET_LIVE_WIDEST = (511, 512)
SET_LIVE_TIMED_BANDS = (50, 200) + WIDE_BANDS + SET_LIVE_WIDEST
# the K-insert kernel's route edges, each band on both sides: the one-warp
# kernel's lane edges (1, 2, 4 band registers a lane), the home of its rows
# beside a shared window on an H100 (228: the rings; 229: device memory),
# the window's route (237: shared; 238: a global workspace, the rings
# again), and its edge with the block kernel above 8 band registers a lane
# (255: one warp; 256: the block kernel)
INSERT_EDGE_BANDS = (31, 32, 63, 64, 228, 229, 237, 238, 255, 256)
# the bands of the K-insert cases with features of width 7 (the block
# kernel) and with width-12 rows 4 bytes past a 16-byte boundary (the rings
# take them; where the rows would be read from device memory, the block
# kernel): a shared window with the rows in rings (50) and without (233),
# and a global one (238)
INSERT_ANY_WIDTH_BANDS = (50, 233, 238)
# launches fed to a stream after it stops or reaches its live capacity
AFTER_LAUNCHES = 3
# --band-times: the K-insert kernel's bands and k_blocks (0: a launch with no
# insert, the fixed part), the reference of the delta mode's time (the
# concert's length) and the grid's batches
BAND_TIMED = (10, 50, 200, 229, 237, 238, 255, 256, 400)
BAND_TIMED_K = (0, 1, 8, 32)
CONCERT_FRAMES = 24456
BAND_TIMED_BATCHES = (256, 1024)
# buffers of the concert follower traced by the profiler (a slice: a trace of
# every hop holds ~10^6 events)
TRACE_BUFFERS = 3000
# hops of the concert's live recording (of 23,339) that phase 9 (b)'s
# followers take: a cut in depth that bounds the script's time (~25 s a
# follower uncut); the reference stays whole, so the layout is the long one
CONCERT_FOLLOW_HOPS = 6000
# phase 10: the batched kernel's comparison bands (238: the global window),
# the streams served (bench.py:924-997 sizes serving at 256 to 1,024), the
# hops of the concert run (a cut that bounds the phase's time), the hops of
# its traced slice, the batches timed, and the plain version's batch and
# launches
MULTI_BANDS = (10, 50, 200, 238)
# hops of the concert that phase 9 (b) runs through the plain version on the
# CPU (a cut that bounds the script's time; the card runs CONCERT_FOLLOW_HOPS)
PLAIN_CONCERT_HOPS = 3000
SERVING_STREAMS = 256
CONCERT_HOPS = 4000
TRACE_HOPS = 600
MULTI_TIMING_BATCHES = (1, 4, 256, 1024)
MULTI_PLAIN_BATCH = 4
PLAIN_REPS = 4
# phase 11: the (w, hop_frames) of the comparisons — the harness's window
# (eval/corpus.DEFAULT_WTW_PARAMS), the live app's (WTWFollower's default),
# the widest the kernel takes, and a hop past the window — and their
# streams; the live app's parameters; the hops of the main path that the
# CPU plain engine runs (a cut that bounds the phase's time; the card runs
# all of them); the launches timed; the buffers of the traced slice
WTW_SHAPES = ((20, 10), (100, 50), (128, 64), (20, 30))
# phases 11 (a) and 12 (a) also run the kernel's warp edges (1 to 3 warps
# of 32 DP rows, and the one-frame window), each with a hop below the
# window and one at or above it (w = 1: both above)
WTW_EDGE_SHAPES = ((1, 1), (1, 3), (31, 15), (31, 31), (32, 16), (32, 40), (33, 16), (33, 33), (64, 32),
                   (64, 70), (65, 32), (65, 65))
# phase 11 (a)'s streams that stress the cost's division (wtw_stream), at
# one, two and four warps
WTW_COST_SHAPES = ((20, 10), (33, 16), (100, 50))
WTW_COST_SCENARIOS = ("zeros", "tiny", "small", "ties")
# launches of more columns than the kernel stages at once (32, COLS_STAGE in
# csrc/wtw_insert.cu): two and three stages, whose windows read rows that an
# earlier stage of the same launch appended; phase 11 (a) runs them at these
# (w, hop), phase 12 (a) at the first
WTW_WIDE_K_BLOCKS = (41, 65)
WTW_WIDE_SHAPES = ((100, 50), (20, 10))
WTW_SCENARIOS = ("run", "margin", "capacity")
LIVE_APP_WTW = {"fft_len": 4096, "hop_size": 2048, "dtw_win_size": 4096 * 50, "dtw_hop_size": 2048 * 50}
WTW_PLAIN_HOPS = 1000
WTW_TIMED_LAUNCHES = 64
WTW_TRACE_BUFFERS = 800
# phase 12: the streams served (bench.py:764 sizes WTW serving at 64), the
# k_block of the host-chroma run (bench.py:787), the hops of the traced
# slice, the batches at which the frontend is checked and timed (18: the
# sweep's pairs), the (w, hop_frames, B) timed (B = 256 at w = 128: the
# widest window at serving scale), and the plain version's batch
WTW_SERVING_STREAMS = 64
WTW_CHROMA_K_BLOCK = 32
WTW_SERVING_TRACE_HOPS = 96
WTW_FRONTEND_BATCHES = (1, 18, WTW_SERVING_STREAMS)
WTW_MULTI_TIMING = ((100, 50, 1), (100, 50, WTW_SERVING_STREAMS), (100, 50, 256), (128, 64, 256))
# --band-times: the WTW kernel's (w, hop_frames) alone (#9) and its grid's
# (w, hop_frames, B) (#10)
WTW_TIMED = ((20, 10), (100, 50), (128, 64))
WTW_MULTI_TIMED = ((100, 50, WTW_SERVING_STREAMS), (100, 50, 256), (128, 64, 256))
WTW_MULTI_PLAIN_BATCH = 4
# phase 13, cut in depth to fit its 90 s (the tensor engine's hop is ~800
# launches): the pair's first hops that (a) runs (and the live recording's,
# cut, that the default align_pair runs), the hops over which (a) holds the
# card's state bits against the CPU engine's, the hops (b) feeds each
# follower mode, the warm-up and traced hops of (b)'s profiler prefix, the
# frames of both recordings (c)'s set_live aligns, and (d)'s hops
ONLINE_HOPS = 400
ONLINE_CPU_HOPS = 150
ONLINE_MODE_HOPS = 200
ONLINE_TRACE_WARMUP, ONLINE_TRACE_HOPS = 2, 4
ONLINE_SET_LIVE_FRAMES = 480
ONLINE_MULTI_HOPS = 200
# phase 14: the batched wavefront kernels' (B, w) in float32 (a window of
# the harness, the live app's at the sweep's 18 streams, a wide window at
# serving batch, the fused kernel's widest at 18) and in float64; the
# AsyncWTW cells above the fused kernel (w = 200, hop 100); the hops of the
# float64 card-against-CPU prefix (a cut); the follower's warm-up and
# traced hops; the chunk rounds of the sweep engine's traced slice
ASYNC_BATCHES = ((1, 20), (18, 100), (64, 200), (18, 128))
ASYNC_BATCH_F64 = (18, 100)
ASYNC_WIDE = {"fft_len": 4096, "hop_size": 2048, "dtw_win_size": 4096 * 100, "dtw_hop_size": 2048 * 100}
ASYNC_F64_HOPS = 400
ASYNC_TRACE_WARMUP, ASYNC_TRACE_BUFFERS = 16, 800
ASYNC_SWEEP_TRACE_CHUNKS = 400
# phase 14 (d) and (e), cut in depth to fit the phase's 60 s: the hops of
# each recording the pairs and the sweep run (uncut, (d) and (e) took 18.4
# s and 30.6 s of a 95 s phase; at 1,000 hops the phase took 58.5 s)
ASYNC_CUT_HOPS = 800
# phase 16: mesh= on one card, cut in depth to fit 60 s: (a)'s hops at
# B = 256 (stream i joins at hop i), (b)'s hops of the WTW servers, the
# tensor engine's streams and hops, (e)'s streams and hops
MESH_SERVING_HOPS = 1000
MESH_WTW_HOPS = 400
MESH_ONLINE_STREAMS, MESH_ONLINE_HOPS = 8, 100
MESH_RESUME_STREAMS, MESH_RESUME_HOPS = 8, 600
# --serving-hops: untimed hops of each cell before its timed runs, and
# the timed runs of each cell (a fresh server each)
SERVING_HOPS_WARMUP, SERVING_HOPS_REPEATS = 40, 3
# --band-times: the batched DP's (B, w), float32
WAVEFRONT_BATCH_TIMED = ((18, 100), (64, 200))
# phase 15: the app's live recording cut to its first APP_HOPS hops (the
# tensor engine takes ~15 ms a hop on the card, PERF.md §6); each checkpoint
# case's run of 2·RESUME_HALF hops (columns), RESUME_ONLINE_HOPS for the
# tensor engine, RESUME_STREAMS streams a batched engine; the card-to-CPU
# resume's RESUME_CPU_TAIL columns on the plain version; the dense route's
# DENSE_PAIRS sweep pairs cut to DENSE_FRAMES (reference, live) frames
APP_HOPS = 200
RESUME_HALF = 300
RESUME_ONLINE_HOPS = 120
RESUME_STREAMS = 4
RESUME_CPU_COLS = 400
RESUME_CPU_TAIL = 96
DENSE_PAIRS = 3
DENSE_FRAMES = (300, 360)
# phase 17: the synthetic case (eval/synthetic, 139 hops) of the non-fused
# engines, the processes and the heatmap (the tensor engines take ~15 ms a
# hop, too slow for phase 4's pair), and the kernels the examples reach
EXAMPLES_CASE = "steady"
EXAMPLES_STEADY_ENGINES = ("otw", "livenote", "livenote_v2", "wtw")
EXAMPLES_KERNELS = ("otw_insert_block", "otw_insert_block_long", "wavefront_dp", "wavefront_backtrack",
                    "wavefront_dp_batched", "wavefront_backtrack_batched")


def log(msg: str) -> None:
    print(msg, flush=True)


def unit_cols(x):
    import numpy as np

    return (x / np.linalg.norm(x, axis=0, keepdims=True)).astype(np.float32)


def stream(rng, variant: str, n: int, scenario: str):
    """(ref (12, n), live (12, L)) features for one comparison stream.

    ``"stop"``: a tempo-warped rendition of the reference followed by
    unrelated columns, so the path runs past the reference's end.
    ``"capacity"``: live stuck on the first reference frame for more than
    the 2n live capacity, so t runs out of room before j reaches the end."""
    import numpy as np

    if scenario == "stop":
        ref = unit_cols(rng.random((12, n)) + 0.05)
        pos = np.cumsum(rng.uniform(0.5, 1.5, n))
        pos = pos / pos[-1] * (n - 1)
        live = unit_cols(ref[:, np.round(pos).astype(int)] + 0.01 * rng.random((12, n)))
        live = np.concatenate([live, unit_cols(rng.random((12, 10)) + 0.05)], axis=1)
    else:
        ref = unit_cols(rng.random((12, n)) ** 4 + 0.01)
        live = unit_cols(ref[:, :1] + 0.01 * rng.random((12, 2 * n + 10)))
    if variant == "livenote_v2_diff":  # Euclidean cost on chroma-diff features
        ref = np.clip(np.diff(ref, axis=1), 0, np.inf).astype(np.float32)
        live = np.clip(np.diff(live, axis=1), 0, np.inf).astype(np.float32)
    return ref, live


def clone_state(state, device=None):
    """A copy of an engine state, on ``device`` (default: where it is)."""
    import dataclasses

    return dataclasses.replace(state, **{f.name: getattr(state, f.name).to(device, copy=True)
                                         for f in dataclasses.fields(state)
                                         if getattr(state, f.name) is not None})


def compare_states(a, b, what: str) -> float:
    """Raise unless the two states (on any devices) are equal; returns the
    window's largest absolute difference over finite cells (0.0 when
    equal)."""
    import torch

    for name in ("status", "scalars", "path_x", "path_y", "live", "window"):
        x, y = getattr(a, name), getattr(b, name)
        if x is None and y is None:  # delta mode: no whole-path buffers
            continue
        x, y = x.cpu(), y.cpu()
        if not torch.equal(x, y):
            diff = (x.double() - y.double()).abs()
            raise AssertionError(f"{what}: kernel and plain disagree on {name} "
                                 f"(max |diff| {diff[torch.isfinite(diff)].max().item() if torch.isfinite(diff).any() else 'inf'})")
    wa, wb = a.window.cpu(), b.window.cpu()
    fin = torch.isfinite(wa) & torch.isfinite(wb)
    return float((wa[fin] - wb[fin]).abs().max()) if fin.any() else 0.0


def run_whole_stream(ref, live, cfg, k_block: int, device, what: str):
    """One stream through the kernel in whole-path mode and its plain version
    on host copies, launch by launch (status, scalars, path, window and live
    history EQUAL).  Returns (the window's largest |diff|, launches, the
    final scalars)."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.ops import otw_insert

    n = ref.shape[1]
    cap = 2 * n
    kern = otw_insert.new_state(torch.from_numpy(ref).to(device), cfg, cap)
    plain = clone_state(kern, "cpu")
    rows = torch.from_numpy(np.ascontiguousarray(live.T)).to(device)
    worst, n_launches = 0.0, 0
    for s in range(0, rows.shape[0], k_block):
        block = rows[s : s + k_block]
        lens = (cap, n, block.shape[0])
        otw_insert.insert_block(kern, block, lens, cfg, k_block)
        otw_insert.insert_block_reference(plain, block.cpu(), lens, cfg, k_block)
        torch.cuda.synchronize()
        worst = max(worst, compare_states(kern, plain, f"{what} @col {s}"))
        n_launches += 1
    return worst, n_launches, kern.scalars.cpu()


def phase_kernel_vs_plain(device) -> float:
    import numpy as np

    from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES, OnlineConfig
    from real_time_audio_sync_tpu_torch.ops import otw_insert

    worst = 0.0
    n_launches = 0
    t0 = time.perf_counter()
    for vi, variant in enumerate(VARIANTS):
        for c in BANDS:
            for k_block in K_BLOCKS:
                scenarios = ("stop", "capacity") if k_block == 32 else ("stop",)
                for scenario in scenarios:
                    rng = np.random.default_rng(1000 * vi + 10 * c + k_block)
                    mrc = 5 if scenario == "capacity" else 3
                    cfg = OnlineConfig(c=c, max_run_count=mrc, **ENGINE_OVERRIDES[variant])
                    # capacity: long enough that j stays short of the end
                    # while t runs through the startup band and past 2n
                    n_ref = 3 * c + 30 if scenario == "capacity" else c + 30
                    ref, live = stream(rng, variant, n_ref, scenario)
                    cap = 2 * ref.shape[1]
                    err, n, sc = run_whole_stream(ref, live, cfg, k_block, device,
                                                  f"{variant} c={c} k={k_block} {scenario}")
                    worst, n_launches = max(worst, err), n_launches + n
                    if scenario == "stop" and sc[otw_insert.S_STOPPED] != 1:
                        raise AssertionError(f"{variant} c={c} k={k_block}: stream did not stop")
                    if scenario == "capacity" and not (sc[otw_insert.S_T] >= cap and sc[otw_insert.S_STOPPED] == 0):
                        raise AssertionError(f"{variant} c={c}: capacity freeze not reached ({sc.tolist()})")
    log(f"phase 3: kernel == plain on the card over {len(VARIANTS)} variants x bands {BANDS} x "
        f"k_block {K_BLOCKS} (+ capacity freeze at k_block 32): {n_launches} launches compared, "
        f"window max |diff| {worst}, {time.perf_counter() - t0:.1f} s")

    # the route edges of the launch (the one-warp kernel's lane edges, the
    # edges of its rows' and window's homes, and its edge with the block
    # kernel), for the dot and the Euclidean cost
    t1 = time.perf_counter()
    n_launches = 0
    for vi, variant in enumerate(("otw", "livenote_v2_diff")):
        for c in INSERT_EDGE_BANDS:
            rng = np.random.default_rng(3000 + 1000 * vi + c)
            ref, live = stream(rng, variant, c + 30, "stop")
            err, n, sc = run_whole_stream(ref, live, set_live_cfg(variant, c), 8, device, f"{variant} c={c} k=8 edge")
            worst, n_launches = max(worst, err), n_launches + n
            if sc[otw_insert.S_STOPPED] != 1:
                raise AssertionError(f"phase 3 [{variant} c={c}]: stream did not stop")
    log(f"phase 3: kernel == plain at the route edges {INSERT_EDGE_BANDS} (otw, livenote_v2_diff, k_block 8): "
        f"{n_launches} launches compared, {time.perf_counter() - t1:.1f} s")
    return worst


def render_piece(root: str):
    from real_time_audio_sync_tpu_torch.eval import synthetic

    synthetic.build_full_corpus(root, ["sonata_allegro"])
    d = os.path.join(root, "sonata_allegro")
    return os.path.join(d, "sonata_allegro_00.wav"), os.path.join(d, "sonata_allegro_01.wav")


def hop_columns(buffers, device):
    """The chroma columns the follower computes for these buffers: the same
    framing and the same per-call batches, on the same device."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.features.chroma import chroma_frames
    from real_time_audio_sync_tpu_torch.streaming.runtime import HopFramer

    framer, cols = HopFramer(), []
    for buf in buffers:
        windows = framer.push(buf)
        if windows:
            frames = torch.from_numpy(np.stack(windows)).to(device=device, dtype=torch.float32)
            cols.append(chroma_frames(frames))
    return torch.cat(cols, dim=1)


def time_launches(fn, state, rows, k: int, reps: int) -> float:
    """Mean ms per launch of ``fn`` over ``reps`` launches of k columns,
    after two warm-up launches, timed with CUDA events."""
    import torch

    for r in range(2):
        fn(state, rows[r * k : (r + 1) * k], k)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for r in range(2, 2 + reps):
        fn(state, rows[r * k : (r + 1) * k], k)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_launch_us(launch, reps: int, kernel: str):
    """The device µs of each launch of the CUDA kernel named ``kernel`` in
    a torch.profiler trace of ``launch(r)`` for r < ``reps``, in launch
    order.  The profiler sometimes drops some of a trace's device events:
    this traces again (up to three times) until a trace holds all of
    them, and returns the fullest trace's list."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for r in range(reps):
                launch(r)
            torch.cuda.synchronize()
        hits = [e for e in prof.events() if kernel in e.name and getattr(e, "device_type", None) == DeviceType.CUDA]
        if len(hits) > len(best):
            best = [e.time_range.elapsed_us() for e in sorted(hits, key=lambda e: e.time_range.start)]
        if len(best) == reps:
            break
    return best


def kernel_device_ms(launch, reps: int, kernel: str):
    """(mean device ms per launch of the CUDA kernel named ``kernel``,
    launches of it the trace holds) from :func:`kernel_launch_us`; the
    mean is None when the trace holds no device time of the kernel."""
    return device_ms(kernel_launch_us(launch, reps, kernel))


def device_ms(per_launch_us):
    """(mean ms, count) of per-launch device µs; (None, 0) for none."""
    if not per_launch_us:
        return None, 0
    return sum(per_launch_us) / 1e3 / len(per_launch_us), len(per_launch_us)


def trace_run(run, label: str) -> None:
    """One traced call of ``run``: device busy share of the wall, and the
    operations that take the device's and the host's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in avgs)
    log(f"{label}: traced wall {wall:.3f} s, device busy {dev_us / 1e6:.3f} s "
        f"({100 * dev_us / (wall * 1e6):.1f} %), idle {100 - 100 * dev_us / (wall * 1e6):.1f} %")
    for e in sorted(avgs, key=lambda e: e.self_device_time_total, reverse=True)[:6]:
        if e.self_device_time_total > 0:
            log(f"{label}: device {e.self_device_time_total / 1e3:9.1f} ms  x{e.count:6d}  {e.key[:90]}")
    for e in sorted(avgs, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        log(f"{label}: host   {e.self_cpu_time_total / 1e3:9.1f} ms  x{e.count:6d}  {e.key[:90]}")


def follow(follower, buffers) -> None:
    follower.start()
    for buf in buffers:
        follower.receive_audio(buf)
    follower.stop()


def phase_main_path(device, ref_wav: str, live_wav: str):
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.eval.scorer import PathScorer
    from real_time_audio_sync_tpu_torch.models.fused_streaming import FusedStreamingEngine
    from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES
    from real_time_audio_sync_tpu_torch.ops import otw_insert
    from real_time_audio_sync_tpu_torch.streaming.runtime import ScoreFollower
    from real_time_audio_sync_tpu_torch.utils.wavio import load_wav

    pcm, fs = load_wav(live_wav)
    buffers = [pcm[s : s + 2048] for s in range(0, len(pcm), 2048)]
    audio_s = len(pcm) / fs
    scorer = PathScorer.for_pair(ref_wav, live_wav)
    launches_total = 0
    timings, paths = {}, {}
    for engine in ("otw", "livenote_v2"):
        follower = ScoreFollower(ref_wav, engine, PARAMS, fused=True, device=device)
        eng = follower.engine
        torch.cuda.synchronize()
        otw_insert.launches = 0
        t0 = time.perf_counter()
        follow(follower, buffers)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = otw_insert.launches
        launches_total += launches
        if launches == 0 or launches != len(eng.dispatched_block_sizes):
            raise AssertionError(f"{engine}: {launches} kernel launches for "
                                 f"{len(eng.dispatched_block_sizes)} dispatches")
        path = np.asarray(follower.path)
        if path.ndim != 2 or path.shape[1] != 2 or len(path) == 0:
            raise AssertionError(f"{engine}: bad path shape {path.shape}")
        paths[engine] = [tuple(int(v) for v in p) for p in path]

        # the same stream through the plain version (CPU engine, same columns)
        cols = hop_columns(buffers, device)
        ref_cols = eng._state.ref[PARAMS["c"]:].T.cpu()
        plain = FusedStreamingEngine(ref_cols, PARAMS, ENGINE_OVERRIDES[engine], k_block=32, device="cpu")
        plain.insert_block_nowait(cols.cpu())
        plain.flush()
        if not np.array_equal(plain.path_array, path):
            raise AssertionError(f"{engine}: the kernel's path differs from the plain version's")

        score = scorer.score(follower.path)
        rtf = audio_s / wall
        log(f"phase 4 [{engine}]: {len(cols[0])} live frames ({audio_s:.1f} s audio) vs "
            f"{eng.n} ref frames; {launches} launches (mean {np.mean(eng.dispatched_block_sizes):.2f} "
            f"frames/launch); stopped={follower.stopped}; path {len(path)} points == plain")
        log(f"phase 4 [{engine}]: PathScorer count={score.count} pct_off_beats={score.pct_off_beats} "
            f"pct_off_secs={score.pct_off_secs}")
        log(f"phase 4 [{engine}]: wall {wall:.3f} s, real-time factor {rtf:.1f} "
            f"(per-frame feed, chroma + kernel + status polling)")

        if engine == "otw":
            # per-launch kernel vs plain time at the main path's shapes
            rows = cols.T.contiguous()
            cfg = eng.cfg
            base = otw_insert.new_state(eng._state.ref[PARAMS["c"]:].T.contiguous(), cfg, eng.cap)
            lens_of = lambda k: (eng.cap, eng.n, k)  # noqa: E731
            for k in K_BLOCKS:
                reps = {1: 256, 8: 64, 32: 16}[k]
                kern_ms = time_launches(
                    lambda st, r, kk: otw_insert.insert_block(st, r, lens_of(kk), cfg, kk),
                    clone_state(base), rows, k, reps)
                plain_ms = time_launches(
                    lambda st, r, kk: otw_insert.insert_block_reference(st, r, lens_of(kk), cfg, kk),
                    clone_state(base), rows, k, reps)
                st = clone_state(base)
                dev_ms, traced = kernel_device_ms(
                    lambda r, st=st, k=k: otw_insert.insert_block(st, rows[r * k : (r + 1) * k], lens_of(k), cfg, k),
                    reps, "otw_insert_kernel")
                timings[k] = (kern_ms, dev_ms, plain_ms)
                log(f"phase 4 [otw]: k_block={k}: kernel {kern_ms:.4f} ms/launch (events, back to back), "
                    f"device time {'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} "
                    f"(profiler, {traced} of {reps} launches traced); "
                    f"plain {plain_ms:.4f} ms/launch ({reps} launches each, c={PARAMS['c']}, N={eng.n})")
            fresh = ScoreFollower(ref_wav, engine, PARAMS, fused=True, device=device)
            trace_run(lambda: follow(fresh, buffers), "phase 4 [trace]")
    return launches_total, timings, paths


def max_abs_diff(x, y) -> float:
    """Largest |x - y| over the cells, 0.0 where both hold the same infinity."""
    import torch

    if x.numel() == 0:
        return 0.0
    return float(torch.nan_to_num((x.double() - y.double()).abs(), nan=0.0).max())


def compare_wavefront(cost, spec, what: str):
    """Kernel against plain on one card-resident cost: raises unless acc,
    back, points and length are equal; returns (acc max |diff|, points max
    |diff|, the plain path origin → end)."""
    import torch

    from real_time_audio_sync_tpu_torch.ops import wavefront

    acc_k, back_k = wavefront.wavefront_dp(cost, spec)
    acc_p, back_p = wavefront.wavefront_dp_reference(cost, spec)
    pts_k, len_k = wavefront.backtrack(back_k, spec)
    pts_p, len_p = wavefront.backtrack_reference(back_k, spec)
    torch.cuda.synchronize()
    for name, x, y in (("acc", acc_k, acc_p), ("back", back_k, back_p), ("points", pts_k, pts_p),
                       ("length", len_k, len_p)):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: kernel and plain disagree on {name} (max |diff| {max_abs_diff(x, y)})")
    return max_abs_diff(acc_k, acc_p), max_abs_diff(pts_k, pts_p), pts_p[: int(len_p)].flip(0).cpu().numpy()


def phase_wavefront_vs_plain(device):
    """Phase 5: random, tied and partly infinite costs at small, edge and
    thin shapes and at the main path's size, both ways round; then one DP
    of more strips than the card holds at once."""
    import torch

    from real_time_audio_sync_tpu_torch.ops import wavefront

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(5)
    n_cases, worst_acc, worst_pts = 0, 0.0, 0.0
    big = ((2873, 3118), (3118, 2873))
    edges = tuple((m, n) for m in WAVEFRONT_EDGE_M for n in WAVEFRONT_EDGE_N)
    shapes = WAVEFRONT_SHAPES + edges + WAVEFRONT_THIN + big
    for spec_name, spec in (("dtw", wavefront.DTW_SPEC), ("wtw", wavefront.WTW_SPEC)):
        for dtype in (torch.float32, torch.float64):
            cases = [(shape, torch.rand(shape, generator=gen, device=device, dtype=dtype)) for shape in shapes]
            cases.append(((12, 9), torch.ones((12, 9), device=device, dtype=dtype)))  # ties everywhere
            inf_cost = torch.rand((333, 517), generator=gen, device=device, dtype=dtype)
            inf_cost[torch.rand((333, 517), generator=gen, device=device) < 0.1] = float("inf")
            inf_cost[0, ::3] = float("inf")  # row 0 too: steps off the matrix, clamped
            cases.append(((333, 517), inf_cost))
            for shape, cost in cases:
                what = f"{spec_name} {str(dtype)[6:]} {shape}"
                d_acc, d_pts, path = compare_wavefront(cost, spec, what)
                worst_acc, worst_pts = max(worst_acc, d_acc), max(worst_pts, d_pts)
                n_cases += 1
                if shape in big:
                    log(f"phase 5: {what}: kernel == plain (acc, back, points; path length {len(path)} of "
                        f"{shape[0] + shape[1] - 1} slots)")
    log(f"phase 5: wavefront kernels == plain on the card in all {n_cases} cases (2 specs x float32/float64 x "
        f"{len(shapes) + 2} shapes: {len(WAVEFRONT_SHAPES)} small, {len(edges)} lane/strip/chunk edges, thin "
        f"{WAVEFRONT_THIN}, the main pair both ways, ties, infinite cells), acc max |diff| {worst_acc}, points "
        f"max |diff| {worst_pts}, {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    strips, resident = wavefront_strips(WAVEFRONT_MANY_STRIPS[0], False, device)
    if strips <= resident:
        raise AssertionError(f"phase 5: {WAVEFRONT_MANY_STRIPS} is {strips} strips, not more than the "
                             f"{resident} the card holds at once")
    cost = torch.rand(WAVEFRONT_MANY_STRIPS, generator=gen, device=device)
    d_acc, d_pts, path = compare_wavefront(cost, wavefront.DTW_SPEC, f"dtw float32 {WAVEFRONT_MANY_STRIPS}")
    log(f"phase 5: dtw float32 {WAVEFRONT_MANY_STRIPS}: {strips} strips, {resident} resident at once: kernel == "
        f"plain (acc, back, points; path length {len(path)}), {time.perf_counter() - t1:.1f} s (the plain "
        f"version's {sum(WAVEFRONT_MANY_STRIPS) - 1} diagonals most of it)")


def wavefront_strips(m: int, is_double: bool, device):
    """(strips of the DP kernel over m rows, strips the card holds at once)."""
    import ctypes

    import torch

    from real_time_audio_sync_tpu_torch.ops import _build

    lib = _build.load("wavefront").lib
    blocks = ctypes.c_int()
    err = lib.wavefront_dp_resident(int(is_double), ctypes.byref(blocks))
    if err != 0:
        raise AssertionError(f"wavefront_dp_resident failed: {lib.wavefront_error_string(err).decode()}")
    rows = lib.wavefront_dp_strip_rows()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return -(-m // rows), blocks.value * sms


def wtw_report(text: str, device) -> None:
    """Phase 2: each instantiation of the WTW kernel (one a candidate
    order) with its registers, stack and spills (ptxas; any stack or spill
    fails: the scalars, the lane's row and the group's costs must stay in
    registers), and the launch's geometry at the windows the checks run."""
    import torch

    from real_time_audio_sync_tpu_torch.ops import wtw_insert

    seen = 0
    for name, (regs, stack, spill_st, spill_ld) in sorted(ptxas_report(text).items()):
        if "wtw_insert_kernel" not in name:
            continue
        log(f"phase 2: {name}: {regs} registers, {stack} B stack, {spill_st} B spill stores, {spill_ld} B spill loads")
        if stack is None or stack or spill_st or spill_ld:
            raise AssertionError(f"phase 2: {name}: {stack} B stack, {spill_st} B spill stores, {spill_ld} B spill loads")
        seen += 1
    if seen != 6:
        raise AssertionError(f"phase 2: ptxas reported {seen} WTW kernels, not one a candidate order")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for w in sorted({w for w, _ in WTW_SHAPES + WTW_EDGE_SHAPES}):
        warps, threads, smem, blocks = wtw_insert.plan(w)
        log(f"phase 2: WTW at w={w}: {warps} warp(s) of one DP row a lane, {threads} threads a block, {smem} B of dynamic shared "
            f"memory, {blocks} blocks an SM ({blocks * sms} streams in one wave on {sms} SMs)")


def wavefront_report(text: str, device) -> None:
    """Phase 2: the wavefront kernels' registers, stack and spills (ptxas;
    any spill fails) and the DP strips the card holds at once."""
    seen = 0
    for name, (regs, stack, spill_st, spill_ld) in sorted(ptxas_report(text).items()):
        if "wavefront_dp_kernel" not in name and "wavefront_backtrack_kernel" not in name:
            continue
        log(f"phase 2: {name}: {regs} registers, {stack} B stack, {spill_st} B spill stores, {spill_ld} B spill loads")
        if spill_st is None or spill_st or spill_ld:
            raise AssertionError(f"phase 2: {name} spills ({spill_st} B stores, {spill_ld} B loads)")
        seen += 1
    if seen < 3:
        raise AssertionError(f"phase 2: ptxas reported {seen} wavefront kernels")
    import torch

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for is_double in (False, True):
        _, resident = wavefront_strips(1, is_double, device)
        log(f"phase 2: wavefront DP, {'float64' if is_double else 'float32'}: {resident // sms} strips an SM, "
            f"{resident} resident at once on {sms} SMs")


def time_calls(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls back to back, after
    ``warmup`` calls, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_dtw_main_path(device, root: str):
    """Phase 6; returns {kernel name: (launches, max_abs_err, ms, event_ms,
    plain_ms, bound_ms, bound_by)} for the two wavefront kernels, the
    errors from kernel against plain on each pair's card-computed cost."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.eval import corpus
    from real_time_audio_sync_tpu_torch.models import dtw
    from real_time_audio_sync_tpu_torch.ops import wavefront

    features = {}
    worst = {"wavefront_dp": 0.0, "wavefront_backtrack": 0.0}
    for ref_wav, live_wav in corpus.corpus_pairs(root):
        corpus._FEAT_CACHE.clear()  # each pair's wall time includes its two chroma extractions
        torch.cuda.synchronize()
        wavefront.dp_launches = wavefront.backtrack_launches = 0
        t0 = time.perf_counter()
        result = corpus.align_pair(ref_wav, live_wav, "dtw", device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (wavefront.dp_launches, wavefront.backtrack_launches)
        if launches != (1, 1):
            raise AssertionError(f"{os.path.basename(live_wav)}: launches (dp, backtrack) = {launches}, want (1, 1)")
        ref_seq = corpus._cached_chroma(ref_wav, np.float32, device)
        live_seq = corpus._cached_chroma(live_wav, np.float32, device)
        features[os.path.basename(ref_wav), os.path.basename(live_wav)] = (live_seq, ref_seq, result.path)
        what = f"{os.path.basename(live_wav)} vs {os.path.basename(ref_wav)}"
        cost = dtw._cosine_cost(live_seq, ref_seq)
        d_acc, d_pts, plain_path = compare_wavefront(cost, wavefront.DTW_SPEC, f"phase 6 [{what}]")
        worst["wavefront_dp"] = max(worst["wavefront_dp"], d_acc)
        worst["wavefront_backtrack"] = max(worst["wavefront_backtrack"], d_pts)
        if not np.array_equal(plain_path, result.path):
            raise AssertionError(f"{what}: the main path's path differs from the plain versions'")
        s = result.score
        log(f"phase 6 [{what}]: {tuple(cost.shape)} cells, acc, back, points and length == plain "
            f"(acc max |diff| {d_acc}), path {len(result.path)} points == plain, launches (dp, backtrack) "
            f"{launches}; PathScorer count={s.count} pct_off_beats={s.pct_off_beats} "
            f"pct_off_secs={s.pct_off_secs}; wall {wall:.3f} s (chroma of both + DTW + scoring)")

    # the main path: the whole sweep, counters set to 0 just before it
    corpus._FEAT_CACHE.clear()
    torch.cuda.synchronize()
    wavefront.dp_launches = wavefront.backtrack_launches = 0
    t0 = time.perf_counter()
    report = corpus.CorpusRunner(root, "dtw", device=device).evaluate(verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"wavefront_dp": wavefront.dp_launches, "wavefront_backtrack": wavefront.backtrack_launches}
    n = len(report.results)
    if n != 3 or report.skipped or set(launches.values()) != {n}:
        raise AssertionError(f"CorpusRunner: {n} pairs, {len(report.skipped)} skipped, launches {launches}")
    for r in report.results:
        want = features[os.path.basename(r.ref_wav), os.path.basename(r.live_wav)][2]
        if not np.array_equal(r.path, want):
            raise AssertionError(f"CorpusRunner: {os.path.basename(r.live_wav)} path differs from align_pair's")
    log(f"phase 6 [CorpusRunner]: {n} pairs, launches {launches}, mean error (% points >3 s off) "
        f"{report.mean_error}, wall {wall:.3f} s")
    ref_wav, live_wav = corpus.corpus_pairs(root)[0]
    corpus._FEAT_CACHE.clear()
    trace_run(lambda: corpus.align_pair(ref_wav, live_wav, "dtw", device=device), "phase 6 [trace]")

    # the banded route on the card, forced
    live_seq, ref_seq, dense_path = features["sonata_allegro_00.wav", "sonata_allegro_01.wav"]
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cost_none, _, banded_path = dtw.DTW(live_seq, ref_seq, max_dense_bytes=1, device=device)
    wall = time.perf_counter() - t0
    if cost_none is not None:
        raise AssertionError("DTW(max_dense_bytes=1) did not take the banded route")
    same = banded_path.shape == dense_path.shape and np.array_equal(banded_path, dense_path)
    only_one = len(set(map(tuple, banded_path)) ^ set(map(tuple, dense_path)))
    log(f"phase 6 [banded]: DTW(live _01, ref _00, max_dense_bytes=1): banded path {len(banded_path)} points, "
        f"equal to the dense path ({len(dense_path)}): {same} ({only_one} points in one path only); "
        f"wall {wall:.3f} s")
    # the same pair in float64, where float32 near-ties no longer decide
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, _, banded64 = dtw.DTW(live_seq, ref_seq, dtype=np.float64, max_dense_bytes=1, device=device)
    _, _, dense64 = dtw.DTW(live_seq, ref_seq, dtype=np.float64, device=device)
    log(f"phase 6 [banded]: the same in float64: banded path equal to the dense path: "
        f"{banded64.shape == dense64.shape and np.array_equal(banded64, dense64)}")

    # each kernel's time at the main path's shape
    cost = dtw._cosine_cost(live_seq, ref_seq).contiguous()
    m, n = cost.shape
    _, back = wavefront.wavefront_dp(cost, wavefront.DTW_SPEC)
    path_len = int(wavefront.backtrack(back, wavefront.DTW_SPEC)[1])
    reps = 20
    out = {}
    strips, resident = wavefront_strips(m, False, device)
    log(f"phase 6 [wavefront_dp] at ({m}, {n}): {strips} strips ({resident} resident at once)")
    for name, kernel, launch, plain, plain_reps, bytes_, ops in (
        ("wavefront_dp", "wavefront_dp_kernel",
         lambda: wavefront.wavefront_dp(cost, wavefront.DTW_SPEC),
         lambda: wavefront.wavefront_dp_reference(cost, wavefront.DTW_SPEC), 2,
         m * n * (4 + 4 + 1), m * n * 8),  # cost in, acc and back out; 3 mul + 3 add + 2 compares a cell
        ("wavefront_backtrack", "wavefront_backtrack_kernel",
         lambda: wavefront.backtrack(back, wavefront.DTW_SPEC),
         lambda: wavefront.backtrack_reference(back, wavefront.DTW_SPEC), 5,
         path_len + (m + n - 1) * 8 + 4, path_len * 4),  # the codes on the path in, points and length out
    ):
        event_ms = time_calls(launch, reps)
        dev_ms, traced = kernel_device_ms(lambda r: launch(), reps, kernel)
        plain_ms = time_calls(plain, plain_reps, warmup=1)
        t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
        bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        out[name] = (launches[name], worst[name], dev_ms, event_ms, plain_ms, bound_ms, bound_by)
        log(f"phase 6 [{name}] at ({m}, {n}), float32: device time "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} (profiler, {traced} of {reps} launches "
            f"traced), {event_ms:.4f} ms back to back (CUDA events, {reps} launches), plain {plain_ms:.2f} ms "
            f"({plain_reps} calls); bound {bound_ms:.6f} ms by {bound_by} ({bytes_} B, {ops} ops)")
    return out


def set_live_pair(rng, variant: str, c: int, scenario: str):
    """(ref (12, n), live (12, L)) for one set_live comparison.

    ``"runs_out"``: a tempo-warped rendition of the first 80 % of the
    reference, so live ends before j reaches the end.  ``"stop"``: a
    rendition of the whole reference (1.25× its length) followed by
    unrelated columns, ≈ 2.6× the reference in all, so j passes the end
    first.  ``"capacity"``: live stuck on the first reference frame for more
    than the 2n live capacity (as phase 3)."""
    import numpy as np

    if scenario == "capacity":
        return stream(rng, variant, 3 * c + 30, "capacity")
    n = c + 30
    ref = unit_cols(rng.random((12, n)) + 0.05)
    span, stretch = (0.8, 1.0) if scenario == "runs_out" else (1.0, 1.25)
    n_live = int(n * span * stretch)
    pos = np.cumsum(rng.uniform(0.5, 1.5, n_live))
    pos = pos / pos[-1] * (span * n - 1)
    live = unit_cols(ref[:, np.round(pos).astype(int)] + 0.01 * rng.random((12, n_live)))
    if scenario == "stop":
        live = np.concatenate([live, unit_cols(rng.random((12, int(1.35 * n))) + 0.05)], axis=1)
    if variant == "livenote_v2_diff":  # Euclidean cost on chroma-diff features
        ref = np.clip(np.diff(ref, axis=1), 0, np.inf).astype(np.float32)
        live = np.clip(np.diff(live, axis=1), 0, np.inf).astype(np.float32)
    return ref, live


def set_live_cfg(variant: str, c: int, mrc: int = 3):
    from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES, OnlineConfig

    return OnlineConfig(c=c, max_run_count=mrc, **ENGINE_OVERRIDES[variant])


def compare_set_live(refs, lives, cfg, what: str):
    """The kernel on one packed batch of card-resident pairs and the plain
    version on host copies of them: raises unless path, plen, t, j and
    stopped are equal; returns (the kernel's out rows, the plain version's
    seconds, the largest absolute difference, 0 when equal)."""
    from real_time_audio_sync_tpu_torch.ops import otw_set_live

    return compare_packed(otw_set_live.pack(refs, lives, cfg.c), cfg, what)


def compare_packed(packed, cfg, what: str):
    """:func:`compare_set_live` on a batch already packed on the card."""
    import torch

    from real_time_audio_sync_tpu_torch.ops import otw_set_live

    kern = [x.cpu() for x in otw_set_live.batched_set_live(*packed, cfg)]
    packed = [x.cpu() for x in packed]
    t0 = time.perf_counter()
    plain = otw_set_live.batched_set_live_reference(*packed, cfg)
    plain_s = time.perf_counter() - t0
    for name, x, y in zip(("path_x", "path_y", "out"), kern, plain):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: kernel and plain disagree on {name} (max |diff| {max_abs_diff(x, y)})")
    return kern[2].cpu().tolist(), plain_s, max(max_abs_diff(x, y) for x, y in zip(kern, plain))


def misaligned(x):
    """A contiguous copy of card tensor ``x`` whose base lies 4 bytes past
    the allocation's start, so not on a 16-byte boundary."""
    import torch

    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def same_result(a, b) -> bool:
    import numpy as np

    return a[0].shape == b[0].shape and np.array_equal(a[0], b[0]) and tuple(a[1:]) == tuple(b[1:])


def phase_set_live_vs_plain(device) -> None:
    """Phase 7: the set_live kernel against its plain version on the card."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES
    from real_time_audio_sync_tpu_torch.ops import otw_set_live

    t0 = time.perf_counter()
    cases = 0
    for vi, variant in enumerate(VARIANTS):
        for c in SET_LIVE_BANDS:
            for si, scenario in enumerate(SET_LIVE_SCENARIOS):
                rng = np.random.default_rng(7000 + 100 * vi + 10 * c + si)
                ref, live = set_live_pair(rng, variant, c, scenario)
                cfg = set_live_cfg(variant, c, 5 if scenario == "capacity" else 3)
                what = f"{variant} c={c} {scenario}"
                ((plen, t, j, stopped, *_),), _, _ = compare_set_live(
                    [torch.from_numpy(ref).to(device)], [torch.from_numpy(live).to(device)], cfg, f"phase 7 [{what}]")
                n, n_live = ref.shape[1], live.shape[1]
                want = {"runs_out": t == n_live and not stopped, "stop": stopped == 1 and j == n and t < n_live,
                        "capacity": t == 2 * n and not stopped and j < n}[scenario]
                if not want:
                    raise AssertionError(f"phase 7 [{what}]: outcome (plen {plen}, t {t}, j {j}, stopped {stopped}) "
                                         f"is not '{scenario}' for n {n}, live {n_live}")
                cases += 1
    log(f"phase 7: set_live kernel == plain on the card in all {cases} cases ({len(VARIANTS)} variants x bands "
        f"{SET_LIVE_BANDS} x {SET_LIVE_SCENARIOS}; path, plen, t, j, stopped equal), {time.perf_counter() - t0:.1f} s")

    # the any-width kernels, which read the rows from device memory: feature
    # width 7, and width-12 rows whose base is not 16-byte aligned, with the
    # window in shared memory (c = 50) and in a global workspace (c = 238)
    t1 = time.perf_counter()
    cases = 0
    for vi, variant in enumerate(("otw", "livenote_v2_diff")):
        for c in SET_LIVE_ANY_WIDTH_BANDS:
            rng = np.random.default_rng(7300 + 10 * vi + c)
            ref, live = set_live_pair(rng, variant, c, "stop")
            cfg = set_live_cfg(variant, c)
            compare_set_live([torch.from_numpy(ref[:7].copy()).to(device)],
                             [torch.from_numpy(live[:7].copy()).to(device)], cfg, f"phase 7 [{variant} c={c} F=7]")
            packed = otw_set_live.pack([torch.from_numpy(ref).to(device)], [torch.from_numpy(live).to(device)], c)
            shifted = [misaligned(x) for x in packed[:2]] + [packed[2]]
            if any(x.data_ptr() % 16 == 0 for x in shifted[:2]):
                raise AssertionError("phase 7: the shifted rows are 16-byte aligned")
            compare_packed(shifted, cfg, f"phase 7 [{variant} c={c} rows not 16-byte aligned]")
            cases += 2
    log(f"phase 7: any-width set_live kernels == plain in all {cases} cases (otw, livenote_v2_diff x bands "
        f"{SET_LIVE_ANY_WIDTH_BANDS} x {{F = 7, F = 12 at a base 4 bytes past 16-byte alignment}}), "
        f"{time.perf_counter() - t1:.1f} s")

    params = {"c": 50, "max_run_count": 3}
    for vi, variant in enumerate(VARIANTS):
        rng = np.random.default_rng(7500 + vi)
        pairs = [set_live_pair(rng, variant, 50, SET_LIVE_SCENARIOS[i % 3]) for i in range(4)]
        refs = [torch.from_numpy(r).to(device) for r, _ in pairs]
        lives = [torch.from_numpy(l).to(device) for _, l in pairs]
        compare_set_live(refs, lives, set_live_cfg(variant, 50), f"phase 7 [{variant} batch of 4]")
        over = ENGINE_OVERRIDES[variant]
        batched = otw_set_live.pallas_batched_set_live(refs, lives, params, **over, device=device)
        for i, (r, l) in enumerate(zip(refs, lives)):
            solo = otw_set_live.pallas_set_live(r, l, params, **over, device=device)
            if not same_result(batched[i], solo):
                raise AssertionError(f"phase 7 [{variant}]: pair {i} of the batch differs from the pair alone")
        shared = otw_set_live.pack(refs[:1] * 3, lives[:3], 50)[0]
        if shared.shape[0] != 1:
            raise AssertionError("phase 7: a shared reference was packed more than once")
        compare_set_live(refs[:1] * 3, lives[:3], set_live_cfg(variant, 50), f"phase 7 [{variant} shared ref x 3]")
        for i, res in enumerate(otw_set_live.pallas_batched_set_live(refs[:1] * 3, lives[:3], params, **over,
                                                                     device=device)):
            if not same_result(res, otw_set_live.pallas_set_live(refs[0], lives[i], params, **over, device=device)):
                raise AssertionError(f"phase 7 [{variant}]: shared-reference pair {i} differs from the pair alone")
    log(f"phase 7: per variant, a ragged batch of 4 == kernel pair by pair == plain; shared reference x 3 "
        f"(one copy) == plain == alone; {time.perf_counter() - t0:.1f} s in all")


def set_live_bound(outs, c: int, f: int, euclidean: bool, rows: int):
    """(bound ms, "bytes" or "operations", bytes, ops) of one launch whose
    pairs ended at ``outs`` (plen, t, j, ...): the bytes are the ``rows``
    feature rows read once, the path points and scalars written once; the
    operations are, for each band update this run made (t + j − 1 a pair),
    (c+1) cells of cost (2F+1), recurrence (5) and scan (3 a stage), and two
    (c+1)-wide argmins for each committed point."""
    import math

    stages = math.ceil(math.log2(c + 1))
    per_cell = (3 * f + 1 if euclidean else 2 * f + 1) + 5 + 3 * stages
    updates = sum(t + j - 1 for _, t, j, *_ in outs)
    points = sum(plen for plen, *_ in outs)
    bytes_ = rows * f * 4 + len(outs) * (2 * 4 + 8 * 4) + points * 8
    ops = updates * (c + 1) * per_cell + points * 2 * (c + 1)
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes", bytes_, ops) if t_bytes >= t_ops else (t_ops, "operations", bytes_, ops)


def phase_set_live_main_path(device, root: str):
    """Phase 8; returns {kernel name: (launches, max_abs_err, ms, event_ms,
    plain_ms, bound_ms, bound_by)} for kernels #2 (B = 1) and #3 (B = 18)."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.eval import corpus, synthetic
    from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES
    from real_time_audio_sync_tpu_torch.ops import otw_set_live

    t0 = time.perf_counter()
    synthetic.build_full_corpus(root)
    pairs = corpus.corpus_pairs(root)
    log(f"phase 8: full-scale corpus rendered: {len(synthetic.FULL_PIECES)} pieces, {len(pairs)} pairs, "
        f"{time.perf_counter() - t0:.1f} s")
    corpus._FEAT_CACHE.clear()
    c = SWEEP_BAND["search_band_width"]
    sweeps, sweep_launches, solo_launches = {}, 0, 0
    for engine in VARIANTS:
        torch.cuda.synchronize()
        otw_set_live.launches = 0
        t0 = time.perf_counter()
        report = corpus.CorpusRunner(root, engine, SWEEP_BAND, mode="fused", device=device).evaluate(verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = otw_set_live.launches
        sweep_launches += launches
        if launches != 1 or len(report.results) != len(pairs) or report.skipped:
            raise AssertionError(f"phase 8 [{engine}]: {launches} launches for {len(report.results)} pairs "
                                 f"({len(report.skipped)} skipped)")
        for r in report.results:
            if r.path.ndim != 2 or r.path.shape[1] != 2 or len(r.path) == 0 or tuple(r.path[0]) != (0, 0):
                raise AssertionError(f"phase 8 [{engine}]: bad path {r.path.shape} for {os.path.basename(r.live_wav)}")
        if not np.isfinite(report.mean_error):
            raise AssertionError(f"phase 8 [{engine}]: mean error {report.mean_error}")
        sweeps[engine] = report
        worst = max(report.results, key=lambda r: (r.score.pct_off_beats[3], r.score.pct_off_3s))
        log(f"phase 8 [{engine}]: CorpusRunner(mode='fused') over {len(report.results)} pairs in {launches} launch, "
            f"wall {wall:.3f} s (features of every recording when first needed, the launch, PathScorer); "
            f"mean error (% points >3 s off) {report.mean_error}; worst pair "
            f"{os.path.basename(worst.live_wav)} vs {os.path.basename(worst.ref_wav)}: {len(worst.path)} points, "
            f"pct_off_beats {worst.score.pct_off_beats}, pct_off_secs {worst.score.pct_off_secs}")

    # batched == solo: every pair of the default engine, the sonata_allegro pairs of the others
    for engine in VARIANTS:
        report = sweeps[engine]
        chosen = [r for r in report.results
                  if engine == "livenote_v2_diff" or os.path.basename(r.ref_wav).startswith("sonata_allegro")]
        for r in chosen:
            otw_set_live.launches = 0
            solo = corpus.align_pair(r.ref_wav, r.live_wav, engine, SWEEP_BAND, mode="fused", device=device)
            if otw_set_live.launches != 1:
                raise AssertionError(f"phase 8 [{engine}]: solo align_pair made {otw_set_live.launches} launches")
            solo_launches += otw_set_live.launches
            if not np.array_equal(solo.path, r.path):
                raise AssertionError(f"phase 8 [{engine}]: {os.path.basename(r.live_wav)} batched path != solo")
        log(f"phase 8 [{engine}]: batched == solo align_pair(mode='fused') on {len(chosen)} pairs, one launch each")

    # the kernel against the plain version on _01 / _00
    ref_wav = os.path.join(root, "sonata_allegro", "sonata_allegro_00.wav")
    live_wav = os.path.join(root, "sonata_allegro", "sonata_allegro_01.wav")
    plain_ms, worst = {}, 0.0
    for engine in VARIANTS:
        kind = "chroma_diff" if engine == "livenote_v2_diff" else "chroma"
        ref = corpus._cached_chroma(ref_wav, np.float32, device, kind)
        live = corpus._cached_chroma(live_wav, np.float32, device, kind)
        cfg = set_live_cfg(engine, c)
        ((plen, t, j, stopped, *_),), plain_s, err = compare_set_live([ref], [live], cfg,
                                                                      f"phase 8 [{engine} _01/_00]")
        plain_ms[engine] = plain_s * 1e3
        worst = max(worst, err)
        log(f"phase 8 [{engine}]: _01/_00 ({live.shape[1]} x {ref.shape[1]} frames): kernel == plain (path "
            f"{plen} points, t {t}, j {j}, stopped {stopped}; plain {plain_s:.2f} s)")

    # a pair above the JAX package's 12,000-frame long-pair threshold takes
    # the same one launch: one recording of each of the first pieces, played
    # back to back (a concert of several movements) against their references
    firsts = {}
    for r, l in pairs:
        firsts.setdefault(os.path.dirname(r), (r, l))
    long_ref, long_live = [], []
    for r, l in firsts.values():
        long_ref.append(corpus._cached_chroma(r, np.float32, device))
        long_live.append(corpus._cached_chroma(l, np.float32, device))
        if sum(x.shape[1] for x in long_ref + long_live) >= LONG_PAIR_FRAMES:
            break
    ref, live = torch.cat(long_ref, dim=1).contiguous(), torch.cat(long_live, dim=1).contiguous()
    if ref.shape[1] + live.shape[1] < LONG_PAIR_FRAMES:
        raise AssertionError(f"phase 8: the long pair has only {ref.shape[1] + live.shape[1]} frames")
    cfg = set_live_cfg("otw", c)
    ((plen, t, j, stopped, *_),), plain_s, err = compare_set_live([ref], [live], cfg, "phase 8 [otw long pair]")
    worst = max(worst, err)
    otw_set_live.launches = 0
    got = otw_set_live.pallas_set_live(ref, live, SWEEP_BAND, **ENGINE_OVERRIDES["otw"], device=device)
    if otw_set_live.launches != 1 or (len(got[0]), got[1], got[2], got[3]) != (plen, t, j, bool(stopped)):
        raise AssertionError(f"phase 8 [otw long pair]: {otw_set_live.launches} launches, result {got[1:]} "
                             f"({len(got[0])} points) against the packed kernel's {(plen, t, j, stopped)}")
    log(f"phase 8 [otw]: long pair of {len(long_ref)} pieces back to back ({live.shape[1]} x {ref.shape[1]} "
        f"frames, {ref.shape[1] + live.shape[1]} combined): one launch, kernel == plain (path {plen} points, "
        f"t {t}, j {j}, stopped {stopped}; plain {plain_s:.2f} s)")

    # times: kernel #2 at B = 1 on _01/_00, kernel #3 at B = 18 (the otw sweep), both otw
    cfg = set_live_cfg("otw", c)
    refs = [corpus._cached_chroma(r, np.float32, device) for r, _ in pairs]
    lives = [corpus._cached_chroma(l, np.float32, device) for _, l in pairs]
    _, sweep_plain_s, err = compare_set_live(refs, lives, cfg, "phase 8 [otw sweep, B = 18]")
    worst = max(worst, err)
    log(f"phase 8 [otw]: kernel == plain over the whole sweep (B = {len(pairs)}), plain {sweep_plain_s:.1f} s")
    out = {}
    for name, batch_refs, batch_lives, p_ms, n_launch in (
        ("otw_set_live", [corpus._cached_chroma(ref_wav, np.float32, device)],
         [corpus._cached_chroma(live_wav, np.float32, device)], plain_ms["otw"], solo_launches),
        ("otw_batched_set_live", refs, lives, sweep_plain_s * 1e3, sweep_launches),
    ):
        packed = otw_set_live.pack(batch_refs, batch_lives, c)
        reps = 20  # the profiler may miss the first few launches of a trace
        event_ms = time_calls(lambda: otw_set_live.batched_set_live(*packed, cfg), reps)
        dev_ms, traced = kernel_device_ms(lambda r: otw_set_live.batched_set_live(*packed, cfg), reps,
                                          "otw_set_live_kernel")
        outs = otw_set_live.batched_set_live(*packed, cfg)[2].cpu().tolist()
        rows = sum(x.shape[1] for x in batch_refs) + sum(x.shape[1] for x in batch_lives)
        bound_ms, bound_by, bytes_, ops = set_live_bound(outs, c, 12, False, rows)
        out[name] = (n_launch, worst, dev_ms, event_ms, p_ms, bound_ms, bound_by)
        log(f"phase 8 [{name}] B = {len(batch_lives)}, otw, c = {c}: device time "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} (profiler, {traced} of {reps} launches "
            f"traced), {event_ms:.4f} ms back to back (CUDA events), plain {p_ms:.1f} ms; bound {bound_ms:.6f} ms "
            f"by {bound_by} ({bytes_} B, {ops} ops; {sum(o[1] + o[2] - 1 for o in outs)} band updates, "
            f"{sum(o[0] for o in outs)} points)")
    corpus._FEAT_CACHE.clear()
    trace_run(lambda: corpus.CorpusRunner(root, "livenote_v2_diff", SWEEP_BAND, mode="fused",
                                          device=device).evaluate(verbose=False), "phase 8 [trace]")
    return out


def delta_row(cfg, k_block: int, device):
    import torch

    from real_time_audio_sync_tpu_torch.ops import otw_insert

    return torch.empty(otw_insert.delta_width(cfg, k_block), dtype=torch.int32, device=device)


def run_delta_stream(ref, live, cfg, k_block: int, device, what: str, misalign: bool = False):
    """One stream through the kernel in delta mode and its plain version,
    launch by launch (status, delta row, window, live history and scalars
    equal), beside the kernel in whole-path mode, whose state and status
    must equal the delta-mode kernel's after every launch and whose path
    must hold the rows' points — so both modes are held to the plain
    version.  ``misalign``: both kernels' reference and live rows start 4
    bytes past a 16-byte boundary.  Returns the window's largest |diff|
    (0.0) and the final scalars."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.ops import otw_insert

    n = ref.shape[1]
    cap = 2 * n
    ref_t = torch.from_numpy(ref).to(device)
    kern = otw_insert.new_state(ref_t, cfg, cap, whole_path=False)
    plain = clone_state(kern, "cpu")
    whole = otw_insert.new_state(ref_t, cfg, cap)
    if misalign:
        for st in (kern, whole):
            st.ref, st.live = misaligned(st.ref), misaligned(st.live)
            if st.ref.data_ptr() % 16 == 0 or st.live.data_ptr() % 16 == 0:
                raise AssertionError(f"{what}: the shifted rows are 16-byte aligned")
    rows = torch.from_numpy(np.ascontiguousarray(live.T)).to(device)
    points, worst = [], 0.0
    for s in range(0, rows.shape[0], k_block):
        block = rows[s : s + k_block]
        lens = (cap, n, block.shape[0])
        plen0 = int(plain.scalars[otw_insert.S_PLEN])
        row_k, row_p = delta_row(cfg, k_block, device), delta_row(cfg, k_block, "cpu")
        otw_insert.insert_block(kern, block, lens, cfg, k_block, delta=row_k)
        otw_insert.insert_block_reference(plain, block.cpu(), lens, cfg, k_block, delta=row_p)
        otw_insert.insert_block(whole, block, lens, cfg, k_block)
        torch.cuda.synchronize()
        if not torch.equal(row_k.cpu(), row_p):
            raise AssertionError(f"{what} @col {s}: kernel and plain disagree on the delta row "
                                 f"(max |diff| {max_abs_diff(row_k.cpu(), row_p)})")
        worst = max(worst, compare_states(kern, plain, f"{what} @col {s}"))
        if not torch.equal(row_k[: otw_insert.N_STATUS], whole.status):
            raise AssertionError(f"{what} @col {s}: delta and whole-path status differ")
        for name in ("window", "live", "scalars"):
            if not torch.equal(getattr(whole, name), getattr(kern, name)):
                raise AssertionError(f"{what} @col {s}: the two modes' {name} differ")
        got = int(row_k[1]) - plen0
        _, dx, dy = otw_insert.delta_views(row_k, cfg, k_block)
        points.append(torch.stack([dx[:got], dy[:got]], dim=1))
    plen = int(whole.scalars[otw_insert.S_PLEN])
    want = torch.stack([whole.path_x[:plen], whole.path_y[:plen]], dim=1)
    if not torch.equal(torch.cat(points), want):
        raise AssertionError(f"{what}: the delta rows' points differ from the whole-path kernel's path")
    return worst, kern.scalars.cpu()


def window_routes(bands, device) -> dict:
    """Where each band's window lives on this card, as both band libraries
    decide it (``otw_band_workspace_floats``); they must agree."""
    import torch

    from real_time_audio_sync_tpu_torch.ops import _build

    index = torch.device(device).index or 0
    routes = {}
    for c in bands:
        floats = {_build.load(lib).lib.otw_band_workspace_floats(c, index) for lib in ("otw_insert", "otw_set_live")}
        if len(floats) != 1 or floats - {0, (c + 1) ** 2}:
            raise AssertionError(f"band {c}: the band libraries ask for {floats} workspace floats")
        routes[c] = "shared" if floats == {0} else "global"
    return routes


def phase_delta_vs_plain(device) -> None:
    """Phase 9 (a): the delta mode over phase 3's grid, and both modes and
    the set_live kernel at the wide bands."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES, OnlineConfig
    from real_time_audio_sync_tpu_torch.ops import otw_insert

    t0 = time.perf_counter()
    worst, streams = 0.0, 0
    for vi, variant in enumerate(VARIANTS):
        for c in BANDS:
            for k_block in K_BLOCKS:
                for scenario in (("stop", "capacity") if k_block == 32 else ("stop",)):
                    rng = np.random.default_rng(9000 + 1000 * vi + 10 * c + k_block)
                    mrc = 5 if scenario == "capacity" else 3
                    cfg = OnlineConfig(c=c, max_run_count=mrc, **ENGINE_OVERRIDES[variant])
                    ref, live = stream(rng, variant, 3 * c + 30 if scenario == "capacity" else c + 30, scenario)
                    worst = max(worst, run_delta_stream(ref, live, cfg, k_block, device,
                                                        f"phase 9 [{variant} c={c} k={k_block} {scenario}]")[0])
                    streams += 1
    log(f"phase 9: delta-mode kernel == plain on the card over {len(VARIANTS)} variants x bands {BANDS} x "
        f"k_block {K_BLOCKS} (+ capacity freeze at k_block 32): {streams} streams, window max |diff| {worst}, "
        f"every delta row equal, the whole-path kernel's path == the rows' points, {time.perf_counter() - t0:.1f} s")

    t1 = time.perf_counter()
    for vi, variant in enumerate(VARIANTS):
        for c in WIDE_BANDS:
            rng = np.random.default_rng(9500 + 10 * vi + c)
            cfg = OnlineConfig(c=c, max_run_count=3, **ENGINE_OVERRIDES[variant])
            ref, live = stream(rng, variant, c + 30, "stop")
            worst = max(worst, run_delta_stream(ref, live, cfg, 8, device, f"phase 9 [{variant} c={c} wide]")[0])
    routes = window_routes(SET_LIVE_TIMED_BANDS + INSERT_EDGE_BANDS, device)
    if routes[238] != "global" or routes[400] != "global":
        raise AssertionError(f"phase 9: the wide bands did not take the global window: {routes}")
    log(f"phase 9: wide bands {WIDE_BANDS} (windows, as the band library chose them: {routes}): "
        f"K-insert kernel == plain in both modes for {len(VARIANTS)} variants, k_block 8, "
        f"{time.perf_counter() - t1:.1f} s")

    phase_delta_edges(device)

    t1 = time.perf_counter()
    cases = 0
    for vi, variant in enumerate(("otw", "livenote_v2_diff")):
        for c in WIDE_BANDS + (SET_LIVE_WIDEST if variant == "otw" else ()):
            rng = np.random.default_rng(9700 + 10 * vi + c)
            ref, live = set_live_pair(rng, variant, c, "stop")
            compare_set_live([torch.from_numpy(ref).to(device)], [torch.from_numpy(live).to(device)],
                             set_live_cfg(variant, c), f"phase 9 [set_live {variant} c={c}]")
            cases += 1
    rng = np.random.default_rng(9800)
    pairs = [set_live_pair(rng, "otw", WIDE_BANDS[-1], SET_LIVE_SCENARIOS[i]) for i in range(3)]
    compare_set_live([torch.from_numpy(r).to(device) for r, _ in pairs], [torch.from_numpy(l).to(device) for _, l in pairs],
                     set_live_cfg("otw", WIDE_BANDS[-1]), f"phase 9 [batched set_live c={WIDE_BANDS[-1]} B=3]")
    log(f"phase 9: set_live kernel == plain at the wide bands: {cases} solo pairs (otw, livenote_v2_diff x "
        f"{WIDE_BANDS}; otw x {SET_LIVE_WIDEST}) and a ragged batch of 3 at c={WIDE_BANDS[-1]}, "
        f"{time.perf_counter() - t1:.1f} s")

    # what the global-memory window costs: kernels #1 and #2 across the edge,
    # and set_live's time per band update from the main path's band to the
    # widest band registers
    for c in SET_LIVE_TIMED_BANDS:
        rng = np.random.default_rng(9900 + c)
        cfg = OnlineConfig(c=c, max_run_count=3, **ENGINE_OVERRIDES["otw"])
        ref, live = stream(rng, "otw", c + 30, "stop")
        n = ref.shape[1]
        insert = ""
        if c in (BANDS[-1],) + WIDE_BANDS:
            rows = torch.from_numpy(np.ascontiguousarray(live.T)).to(device)
            k, reps = 8, 16
            state = otw_insert.new_state(torch.from_numpy(ref).to(device), cfg, 2 * n)
            ins_ms = time_launches(lambda st, r, kk: otw_insert.insert_block(st, r, (2 * n, n, kk), cfg, kk),
                                   state, rows, k, reps)
            insert = f"K-insert kernel {ins_ms:.4f} ms/launch at k_block {k} (CUDA events, {reps} launches, n={n}); "
        log(f"phase 9 [c={c}, window in {routes[c]} memory]: {insert}{set_live_timing(rng, cfg, device)}")


def phase_delta_edges(device) -> None:
    """Phase 9 (a): the K-insert kernel's route edges in both modes;
    features of width 7 (the block kernel) and width-12 rows 4 bytes past a
    16-byte boundary; streams fed more launches after they stop and after
    they reach their live capacity."""
    import numpy as np

    from real_time_audio_sync_tpu_torch.ops import otw_insert

    t1 = time.perf_counter()
    worst = 0.0
    cases = 0
    for vi, variant in enumerate(("otw", "livenote_v2_diff")):
        for c in INSERT_EDGE_BANDS:
            rng = np.random.default_rng(9200 + 1000 * vi + c)
            ref, live = stream(rng, variant, c + 30, "stop")
            worst = max(worst, run_delta_stream(ref, live, set_live_cfg(variant, c), 8, device,
                                                f"phase 9 [{variant} c={c} edge]")[0])
            cases += 1
        for c in INSERT_ANY_WIDTH_BANDS:
            rng = np.random.default_rng(9300 + 1000 * vi + c)
            ref, live = stream(rng, variant, c + 30, "stop")
            cfg = set_live_cfg(variant, c)
            run_delta_stream(np.ascontiguousarray(ref[:7]), np.ascontiguousarray(live[:7]), cfg, 8, device,
                             f"phase 9 [{variant} c={c} F=7]")
            run_delta_stream(ref, live, cfg, 8, device, f"phase 9 [{variant} c={c} rows not 16-byte aligned]",
                             misalign=True)
            # past the stop and past the live capacity: more launches, frozen
            extra = unit_cols(rng.random((12, 8 * AFTER_LAUNCHES)) + 0.05)
            _, sc = run_delta_stream(ref, np.concatenate([live, extra], axis=1), cfg, 8, device,
                                     f"phase 9 [{variant} c={c} after the stop]")
            if sc[otw_insert.S_STOPPED] != 1:
                raise AssertionError(f"phase 9 [{variant} c={c}]: the stream did not stop")
            ref, live = stream(rng, variant, 3 * c + 30, "capacity")
            live = np.concatenate([live, live[:, -1:].repeat(8 * AFTER_LAUNCHES, axis=1)], axis=1)
            _, sc = run_delta_stream(ref, live, set_live_cfg(variant, c, 5), 8, device,
                                     f"phase 9 [{variant} c={c} after the live capacity]")
            if not (sc[otw_insert.S_T] >= 2 * ref.shape[1] + 8 * AFTER_LAUNCHES and sc[otw_insert.S_STOPPED] == 0):
                raise AssertionError(f"phase 9 [{variant} c={c}]: the capacity freeze was not passed ({sc.tolist()})")
            cases += 4
    log(f"phase 9: K-insert kernel == plain in both modes in {cases} cases (otw, livenote_v2_diff x route edges "
        f"{INSERT_EDGE_BANDS}; x bands {INSERT_ANY_WIDTH_BANDS} x {{F = 7, F = 12 rows 4 bytes past 16-byte "
        f"alignment, {AFTER_LAUNCHES} launches past the stop, {AFTER_LAUNCHES} past the live capacity}}), "
        f"window max |diff| {worst}, {time.perf_counter() - t1:.1f} s")


def set_live_timing(rng, cfg, device) -> str:
    """The set_live kernel's time on one otw "stop" pair at band ``cfg.c``
    drawn from ``rng``: ms a pair and µs a band update (CUDA events)."""
    import torch

    from real_time_audio_sync_tpu_torch.ops import otw_set_live

    c = cfg.c
    ref, live = set_live_pair(rng, "otw", c, "stop")
    packed = otw_set_live.pack([torch.from_numpy(ref).to(device)], [torch.from_numpy(live).to(device)], c)
    ms = time_calls(lambda: otw_set_live.batched_set_live(*packed, cfg), 5)
    plen, t, j = otw_set_live.batched_set_live(*packed, cfg)[2][0, :3].tolist()
    return (f"set_live kernel {ms:.4f} ms/pair (CUDA events, 5 calls; {t} x {j} frames, {t + j - 1} band updates, "
            f"{plen} points, {ms * 1e3 / max(t + j - 1, 1):.3f} us/update)")


def warped_pair(rng, n_ref: int, n_live: int):
    """(ref (12, n_ref), live (12, n_live)): unit chroma-like columns and a
    tempo-warped rendition of the reference's first ~90 %, so a stream
    fed all of it never stops."""
    import numpy as np

    ref = unit_cols(rng.random((12, n_ref)) + 0.05)
    pos = np.cumsum(rng.uniform(0.5, 1.5, n_live))
    pos = pos / pos[-1] * (0.9 * n_ref - 1)
    return ref, unit_cols(ref[:, np.round(pos).astype(int)] + 0.01 * rng.random((12, n_live)))


def queued_ms(launch, reps: int, prepare=None) -> float:
    """ms a launch of ``launch(r)`` for r < ``reps``, from CUDA events
    around the run, queued on the stream behind a sleeping kernel, so that
    the host's launch rate (tens of µs a call of the wrapper) does not
    enter: the device starts the run only once the host has queued all of
    it (checked: the start event has not completed when the host is done;
    else again with a longer sleep, after ``prepare()`` again where given:
    the launches' inputs made anew, outside the timed run)."""
    import torch

    cycles = 20_000_000  # ~10 ms at the H100's 1.98 GHz
    for _ in range(4):
        if prepare is not None:
            prepare()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for r in range(reps):
            launch(r)
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise AssertionError("the host did not queue the timed run before the device reached it")


def insert_times(device) -> dict:
    """The K-insert kernel's ms a launch for :func:`band_times`
    (:func:`queued_ms`, after two launches of warm-up): a solo stream at
    each band of BAND_TIMED, past its startup band, at each k_block of
    BAND_TIMED_K (0: a launch with no insert); then the delta mode at k_block 8, c = 50, on a CONCERT_FRAMES reference, and
    the grid at c = 50, k_block 8, both modes, B in BAND_TIMED_BATCHES
    streams on one 3,118-frame reference fed the same columns."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES, OnlineConfig
    from real_time_audio_sync_tpu_torch.ops import otw_insert

    def timed(launch, reps):
        launch(0)
        launch(1)
        return queued_ms(lambda r: launch(r + 2), reps)

    out = {}
    n_ref = 3118  # sonata_allegro_00's frames
    for c in BAND_TIMED:
        cfg = OnlineConfig(c=c, max_run_count=3, **ENGINE_OVERRIDES["otw"])
        ref, live = warped_pair(np.random.default_rng(15000 + c), n_ref, n_ref)
        rows = torch.from_numpy(np.ascontiguousarray(live.T)).to(device)
        base = otw_insert.new_state(torch.from_numpy(ref).to(device), cfg, 2 * n_ref)
        warm = 2 * c + 32  # past the startup band t < c
        for s in range(0, warm, 32):
            otw_insert.insert_block(base, rows[s : s + 32], (2 * n_ref, n_ref, 32), cfg, 32)
        for k in BAND_TIMED_K:
            reps = {0: 64, 1: 128, 8: 64, 32: 16}[k]
            st, kb, tail = clone_state(base), k if k else 8, rows[warm:]
            ms = timed(lambda r: otw_insert.insert_block(st, tail[r * k : (r + 1) * k] if k else tail[:kb],
                                                         (2 * n_ref, n_ref, k), cfg, kb), reps)
            out[f"c={c} k={k}"] = ms
            log(f"[insert c={c} k_block={k}]: {ms:.4f} ms/launch ({reps} launches queued, N={n_ref})")

    c, k, reps = PARAMS["c"], 8, 64
    cfg = OnlineConfig(c=c, max_run_count=3, **ENGINE_OVERRIDES["otw"])
    ref, live = warped_pair(np.random.default_rng(15500), CONCERT_FRAMES, 2 * c + (reps + 2) * k)
    rows = torch.from_numpy(np.ascontiguousarray(live.T)).to(device)
    cap = 2 * CONCERT_FRAMES
    st = otw_insert.new_state(torch.from_numpy(ref).to(device), cfg, cap, whole_path=False)
    n_warm = 2 * c // k
    delta = torch.empty((n_warm + reps + 2, otw_insert.delta_width(cfg, k)), dtype=torch.int32, device=device)
    for r in range(n_warm):
        otw_insert.insert_block(st, rows[r * k : (r + 1) * k], (cap, CONCERT_FRAMES, k), cfg, k, delta=delta[r])
    ms = timed(lambda r: otw_insert.insert_block(st, rows[(n_warm + r) * k : (n_warm + r + 1) * k],
                                                 (cap, CONCERT_FRAMES, k), cfg, k, delta=delta[n_warm + r]), reps)
    out[f"delta c={c} k={k}"] = ms
    log(f"[insert delta c={c} k_block={k}]: {ms:.4f} ms/launch ({reps} launches queued, N={CONCERT_FRAMES})")

    ref, live = warped_pair(np.random.default_rng(15600), n_ref, (reps + 2) * k)
    rows = torch.from_numpy(np.ascontiguousarray(live.T)).to(device)
    ref_d = torch.from_numpy(ref).to(device)
    for b in BAND_TIMED_BATCHES:
        cols = [rows[r * k : (r + 1) * k].expand(b, k, rows.shape[1]).contiguous() for r in range(reps + 2)]
        ks = torch.full((b,), k, dtype=torch.int32, device=device)
        for whole in (True, False):
            st = otw_insert.new_multi_state([ref_d] * b, cfg, whole_path=whole)
            rows_d = None if whole else torch.empty((reps + 2, b, otw_insert.delta_width(cfg, k)),
                                                    dtype=torch.int32, device=device)
            ms = timed(lambda r: otw_insert.multi_insert_block(st, cols[r], ks, cfg, k,
                                                               None if whole else rows_d[r]), reps)
            mode = "whole" if whole else "delta"
            out[f"grid {mode} B={b}"] = ms
            log(f"[insert grid {mode} c={c} k_block={k} B={b}]: {ms:.4f} ms/launch ({reps} launches queued)")
    return out


def wavefront_times(device) -> dict:
    """The wavefront kernels' ms a launch for :func:`band_times`
    (:func:`queued_ms` over 20 launches after two of warm-up, each
    launch's wrapper included: the DP's zeroed workspace, the backtrack's
    outputs): the DP and the backtrack at each shape of WAVEFRONT_TIMED in
    float32, on a uniform random cost, and the DP at the first in float64;
    then, where the package's wrappers take a batch, the DP over a batch
    of windows at each (B, w) of WAVEFRONT_BATCH_TIMED (WTW's spec)."""
    import torch

    from real_time_audio_sync_tpu_torch.ops import wavefront

    def timed(launch, reps=20):
        launch()
        launch()
        return queued_ms(lambda r: launch(), reps)

    gen = torch.Generator(device=device).manual_seed(16)
    out = {}
    for shape in WAVEFRONT_TIMED:
        for dtype in (torch.float32, torch.float64) if shape == WAVEFRONT_TIMED[0] else (torch.float32,):
            cost = torch.rand(shape, generator=gen, device=device, dtype=dtype)
            name = f"dp {shape[0]}x{shape[1]} {str(dtype)[6:]}"
            out[name] = timed(lambda: wavefront.wavefront_dp(cost, wavefront.DTW_SPEC))
            log(f"[wavefront {name}]: {out[name]:.4f} ms/launch (20 launches queued)")
            if dtype == torch.float32:
                _, back = wavefront.wavefront_dp(cost, wavefront.DTW_SPEC)
                length = int(wavefront.backtrack(back, wavefront.DTW_SPEC)[1])
                name = f"backtrack {shape[0]}x{shape[1]}"
                out[name] = timed(lambda: wavefront.backtrack(back, wavefront.DTW_SPEC))
                log(f"[wavefront {name}]: {out[name]:.4f} ms/launch (20 launches queued; path {length} points)")
    if hasattr(wavefront, "dp_batched_launches"):  # a package whose wrappers take a batch of windows
        for b, w in WAVEFRONT_BATCH_TIMED:
            cost = torch.rand((b, w, w), generator=gen, device=device)
            name = f"dp batch {b}x{w}x{w} float32"
            out[name] = timed(lambda: wavefront.wavefront_dp(cost, wavefront.WTW_SPEC))
            log(f"[wavefront {name}]: {out[name]:.4f} ms/launch (20 launches queued, the batch in one launch)")
    return out


def wtw_times(device) -> dict:
    """The WTW kernel's ms a launch for :func:`band_times`, through the
    wrappers alone (``new_state``, ``wtw_insert_block``,
    ``new_multi_state``, ``multi_wtw_insert_block``, ``delta_width``): #9
    at each (w, hop) of WTW_TIMED and #10 at each (w, hop, B) of
    WTW_MULTI_TIMED, k_block 8, every stream on a fresh state on a
    3,118-frame reference fed a warped rendition of it.  For each, the
    main path's mix: its first WTW_TIMED_LAUNCHES launches in order; then
    the launches of that mix that ran a window and those that only
    appended, each from a copy of its own state before it (four times
    over, at most WTW_TIMED_LAUNCHES launches).  Every run
    :func:`queued_ms`, its states copied before it."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.ops import wtw_insert

    k, reps, n_ref = 8, WTW_TIMED_LAUNCHES, 3118
    ref, live = warped_pair(np.random.default_rng(17000), n_ref, reps * k)
    ref_d = torch.from_numpy(ref).to(device)
    rows_d = torch.from_numpy(np.ascontiguousarray(live.T)).to(device)
    out = {}
    for w, hop, b in [(w, hop, None) for w, hop in WTW_TIMED] + list(WTW_MULTI_TIMED):
        width = wtw_insert.delta_width(w, hop, k)
        if b is None:
            blocks = [rows_d[r * k : (r + 1) * k] for r in range(reps)]
            fresh = lambda: wtw_insert.new_state(ref_d, 2 * n_ref)  # noqa: E731
            rows = torch.empty((reps, width), dtype=torch.int32, device=device)

            def launch(st, r):
                wtw_insert.wtw_insert_block(st, blocks[r], (n_ref, 2 * n_ref, k), w, hop, k, rows[r])
        else:
            blocks = [rows_d[r * k : (r + 1) * k].expand(b, k, 12).contiguous() for r in range(reps)]
            lens = torch.tensor([[n_ref, 2 * n_ref, k]] * b, dtype=torch.int32, device=device)
            fresh = lambda: wtw_insert.new_multi_state([ref_d] * b, [2 * n_ref] * b)  # noqa: E731
            rows = torch.empty((reps, b, width), dtype=torch.int32, device=device)

            def launch(st, r):
                wtw_insert.multi_wtw_insert_block(st, blocks[r], lens, w, hop, k, rows[r])
        before, st = [], fresh()  # each launch's state before it
        for r in range(reps):
            before.append(clone_state(st))
            launch(st, r)
        plens = [0] + rows.reshape(reps, -1)[:, 1].tolist()
        ran = [r for r in range(reps) if plens[r + 1] > plens[r]]
        kinds = {"mix": None, "window": ran, "append-only": [r for r in range(reps) if r not in ran]}
        name = f"w={w} hop={hop}" + ("" if b is None else f" B={b}")
        for kind, which in kinds.items():
            states = []
            if which is None:
                def prepare():
                    states[:] = [clone_state(before[0])]
                run = lambda r: launch(states[0], r)  # noqa: E731
                n = reps
            else:
                order = (which * 4)[:reps]

                def prepare():
                    states[:] = [clone_state(before[r]) for r in order]
                run = lambda r: launch(states[r], order[r])  # noqa: E731
                n = len(order)
            if n == 0:
                continue
            out[f"{name} {kind}"] = queued_ms(run, n, prepare)
            log(f"[wtw {name} k_block={k} {kind}]: {out[f'{name} {kind}']:.4f} ms/launch ({n} launches queued; "
                f"{len(ran)} of the mix's {reps} ran a window)")
    return out


def band_times(tree) -> int:
    """``--band-times [TREE]``: the band, wavefront and WTW kernels' times
    alone, with the port imported from the checkout at ``TREE`` (another
    commit unpacked there, built there) or from this one, for an A/B of two
    trees on one card: set_live's ms a pair and µs a band update at every
    band of ``SET_LIVE_TIMED_BANDS`` (phase 9's pairs), the K-insert
    kernel's times of :func:`insert_times`, the wavefront kernels' of
    :func:`wavefront_times` and the WTW kernel's of :func:`wtw_times`.  Prints the card, the package's path, a line
    a case and last one JSON object of every number; exits 0."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if tree is not None:
        sys.path.insert(0, os.path.abspath(tree))
    import real_time_audio_sync_tpu_torch
    from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES, OnlineConfig

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    package = os.path.dirname(real_time_audio_sync_tpu_torch.__file__)
    log(f"band, wavefront and WTW kernel times of {package}")
    set_live_us = {}
    for c in SET_LIVE_TIMED_BANDS:
        rng = np.random.default_rng(9900 + c)
        stream(rng, "otw", c + 30, "stop")  # phase 9 draws its K-insert stream first
        cfg = OnlineConfig(c=c, max_run_count=3, **ENGINE_OVERRIDES["otw"])
        line = set_live_timing(rng, cfg, device)
        set_live_us[c] = float(line.rsplit(", ", 1)[1].split(" ")[0])
        log(f"[set_live c={c}]: {line}")
    insert = insert_times(device)
    wave = wavefront_times(device)
    wtw = wtw_times(device)
    print(json.dumps({"card": card, "package": package, "set_live_us_per_update": set_live_us,
                      "insert_ms": insert, "wavefront_ms": wave, "wtw_ms": wtw}), flush=True)
    return 0


def serving_hops(tree) -> int:
    """``--serving-hops [TREE]``: the unsharded serving cells of phases
    10 (b) (``FusedMultiStreamFollower``, B = 256, both layouts) and 12 (b)
    (``FusedMultiStreamWTW``, B = 64, w = 100) alone, every hop of them,
    with the port imported from the checkout at ``TREE`` or from this one,
    for an A/B of the host's dispatch path of two trees on one card.  Each
    cell runs once untimed for ``SERVING_HOPS_WARMUP`` hops (the kernels'
    build), then ``SERVING_HOPS_REPEATS`` times timed on a fresh server:
    wall and host CPU µs a hop, launches (counters), and a digest of every
    stream's path (equal digests, equal paths).  Prints the card and the package's path, a line a cell, and
    last one JSON object of every number; exits 0."""
    import hashlib

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if tree is not None:
        sys.path.insert(0, os.path.abspath(tree))
    import real_time_audio_sync_tpu_torch
    from real_time_audio_sync_tpu_torch.features.chroma import wav_to_chroma
    from real_time_audio_sync_tpu_torch.ops import otw_insert, wtw_insert
    from real_time_audio_sync_tpu_torch.parallel import FusedMultiStreamFollower, FusedMultiStreamWTW
    from real_time_audio_sync_tpu_torch.utils.wavio import load_wav

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    package = os.path.dirname(real_time_audio_sync_tpu_torch.__file__)
    log(card)
    log(f"serving hop times of {package}")

    def digest(paths) -> str:
        h = hashlib.sha256()
        for p in paths:
            h.update(np.ascontiguousarray(np.asarray(p, np.int64)).tobytes() + b"|")
        return h.hexdigest()[:16]

    def timed_runs(make, run, hops: int, read_launches) -> dict:
        """``SERVING_HOPS_REPEATS`` timed runs, each on a fresh server with
        its launch counters at 0: every run's wall and host CPU µs a hop
        and launches (adaptive coalescing lets the dispatches vary with
        the timing), the least of the times, and the path digest (raises
        unless every run gives the same)."""
        from real_time_audio_sync_tpu_torch.ops import otw_insert, wtw_insert

        walls, hosts, launches, digests = [], [], [], set()
        for _ in range(SERVING_HOPS_REPEATS):
            server = make()
            otw_insert.multi_launches = otw_insert.multi_delta_launches = wtw_insert.multi_launches = 0
            _, wall, host = mesh_timed(lambda: run(server))
            walls.append(wall / hops * 1e6)
            hosts.append(host / hops * 1e6)
            launches.append(read_launches())
            digests.add(digest(server.paths()))
        if len(digests) != 1:
            raise AssertionError(f"--serving-hops: the runs' paths differ: {digests}")
        row = {"hops": hops, "wall_us_a_hop": walls, "host_us_a_hop": hosts, "min_wall_us_a_hop": min(walls),
               "min_host_us_a_hop": min(hosts), "launches": launches, "paths": digests.pop()}
        row["summary"] = (f"wall us a hop {', '.join(f'{w:.1f}' for w in walls)} (least {min(walls):.1f}), host CPU "
                          f"us a hop {', '.join(f'{h:.1f}' for h in hosts)} (least {min(hosts):.1f}), "
                          f"launches {', '.join(map(str, launches))}, paths {row['paths']}")
        return row

    from real_time_audio_sync_tpu_torch.models.wtw import WTWLongReferenceWarning

    warnings.simplefilter("ignore", WTWLongReferenceWarning)  # the live app's widths on a long reference, as main's
    out = {"card": card, "package": package}
    with tempfile.TemporaryDirectory() as root:
        render_piece(root)
        d = os.path.join(root, "sonata_allegro")
        ref_wav = os.path.join(d, "sonata_allegro_00.wav")
        pcms = [load_wav(os.path.join(d, f"sonata_allegro_0{i}.wav"))[0] for i in (1, 2)]
        ref = wav_to_chroma(ref_wav, np.float32, device=device)
        cols = [hop_columns([pcm[s : s + 2048] for s in range(0, len(pcm), 2048)], device) for pcm in pcms]
        lens = np.asarray([x.shape[1] for x in cols])
        lives = np.zeros((2, lens.max(), 12), np.float32)
        for i, x in enumerate(cols):
            lives[i, : lens[i]] = x.T.cpu().numpy()
        b = SERVING_STREAMS
        perf = np.arange(b) % 2  # phase 10 (b): even streams follow _01, odd streams _02
        hops = b - 1 + int(lens.max())
        for long_ref in (True, False):
            label = "windowed" if long_ref else "whole buffer"
            make = lambda: FusedMultiStreamFollower(ref, PARAMS, n_streams=b, k_block=8, long_ref=long_ref,  # noqa: E731
                                                    device=device)
            serve(make(), lives, lens, perf, SERVING_HOPS_WARMUP)
            row = timed_runs(make, lambda fms: serve(fms, lives, lens, perf, hops), hops,
                             lambda: otw_insert.multi_delta_launches if long_ref else otw_insert.multi_launches)
            out[f"follower_{'windowed' if long_ref else 'whole'}"] = row
            log(f"phase 10 (b) [{label}, unsharded, {card}]: B = {b}, {hops} hops, {row['summary']}")
        buffers = [[pcm[s : s + 2048] for s in range(0, len(pcm), 2048)] for pcm in pcms]
        b = WTW_SERVING_STREAMS
        perf = np.arange(b) % 2  # phase 12 (b)
        hops = b - 1 + max(len(x) for x in buffers)
        make = lambda: FusedMultiStreamWTW([ref_wav] * b, LIVE_APP_WTW, k_block=8, transfer_dtype="float32",  # noqa: E731
                                           device=device)
        serve_wtw(make(), buffers, perf, SERVING_HOPS_WARMUP)
        row = timed_runs(make, lambda ms: serve_wtw(ms, buffers, perf, hops), hops, lambda: wtw_insert.multi_launches)
        out["wtw"] = row
        log(f"phase 12 (b) [unsharded, {card}]: B = {b}, {hops} hops, {row['summary']}")
    print(json.dumps(out), flush=True)
    return 0


def render_concert(root: str):
    """The eight ``_00`` recordings back to back (reference) and their
    ``_01`` recordings in the same order (live), with their beat CSVs
    joined (times offset by the audio before them, beats renumbered), in
    ``root/concert``.  Needs the full corpus rendered in ``root``."""
    import csv

    import numpy as np

    from real_time_audio_sync_tpu_torch.config import FS
    from real_time_audio_sync_tpu_torch.eval import synthetic
    from real_time_audio_sync_tpu_torch.utils.wavio import load_wav, write_wav

    d = os.path.join(root, "concert")
    os.makedirs(d, exist_ok=True)
    out = []
    for take in ("00", "01"):
        pcm, rows, t_off, b_off = [], [], 0.0, 0
        for piece in synthetic.FULL_PIECES:
            base = os.path.join(root, piece, f"{piece}_{take}")
            x, fs = load_wav(base + ".wav")
            if fs != FS:
                raise AssertionError(f"{base}.wav: {fs} Hz")
            with open(base + ".csv", newline="") as f:
                beats = [(float(r[0]), int(r[1])) for r in csv.reader(f) if r]
            rows += [(t + t_off, b + b_off) for t, b in beats]
            pcm.append(x)
            t_off += len(x) / fs
            b_off += beats[-1][1]
        path = os.path.join(d, f"concert_{take}")
        write_wav(path + ".wav", np.concatenate(pcm))
        with open(path + ".csv", "w", newline="") as f:
            csv.writer(f).writerows([(f"{t:.6f}", b) for t, b in rows])
        out.append(path + ".wav")
    return out


def stream_device_bytes(eng) -> dict:
    """Device bytes one stream's state holds, by layout: the window, the
    reference and live rows and the scalars, plus the whole-path buffers of
    the standard layout (the delta layout's pending rows are counted apart)."""
    st = eng._state
    common = sum(x.numel() * x.element_size() for x in (st.window, st.ref, st.live, st.scalars, st.status))
    path = 2 * (eng.cap + eng.n + 16) * 4
    return {"delta": common, "standard": common + path}


def insert_bound(c: int, f: int, euclidean: bool, k: int, d_pad: int, launches: int, dt: int, dj: int,
                 points: int):
    """(bound ms, "bytes" or "operations", bytes, ops) of one delta-mode
    launch, averaged over ``launches`` launches that advanced t by ``dt``, j
    by ``dj`` and committed ``points`` points: bytes are the window read and
    written, the k columns read, their live rows written, the c+1+k live and
    c+1+dj/launches reference rows the band reads, the scalars read and
    written and the delta row written; operations are (c+1) cells of cost,
    recurrence and scan per band update (dt + dj in all) and two (c+1)-wide
    argmins per point."""
    import math

    stages = math.ceil(math.log2(c + 1))
    per_cell = (3 * f + 1 if euclidean else 2 * f + 1) + 5 + 3 * stages
    bytes_ = (2 * (c + 1) ** 2 * 4 + 2 * k * f * 4 + (c + 1 + k) * f * 4 + (c + 1 + dj / launches) * f * 4
              + 2 * 16 * 4 + (8 + 2 * d_pad) * 4)
    ops = ((dt + dj) * (c + 1) * per_cell + points * 2 * (c + 1)) / launches
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes", bytes_, ops) if t_bytes >= t_ops else (t_ops, "operations", bytes_, ops)


def phase_concert(device, root: str):
    """Phase 9 (b) and (c); returns (launches read, max |diff| against the
    plain version, device ms, event ms, plain ms, bound ms, bound by) for
    kernel #4's row, the concert's (reference, live) wavs and the live
    chroma columns on the card."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.eval import synthetic
    from real_time_audio_sync_tpu_torch.eval.scorer import PathScorer
    from real_time_audio_sync_tpu_torch.models import fused_streaming
    from real_time_audio_sync_tpu_torch.models.fused_streaming import FusedStreamingEngine
    from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES
    from real_time_audio_sync_tpu_torch.ops import otw_insert
    from real_time_audio_sync_tpu_torch.streaming.runtime import ScoreFollower
    from real_time_audio_sync_tpu_torch.utils.wavio import load_wav

    t0 = time.perf_counter()
    ref_wav, live_wav = render_concert(root)
    pcm, fs = load_wav(live_wav)
    buffers = [pcm[s : s + 2048] for s in range(0, len(pcm), 2048)]
    all_hops = len(buffers) - 1
    buffers = buffers[: CONCERT_FOLLOW_HOPS + 1]
    audio_s = sum(len(b) for b in buffers) / fs
    cols = hop_columns(buffers, device)
    scorer = PathScorer.for_pair(ref_wav, live_wav)
    log(f"phase 9 [concert]: reference and live joined from the {len(synthetic.FULL_PIECES)} pieces "
        f"({len(pcm) / fs / 60:.1f} min of live audio, {all_hops} hops; the followers take the first "
        f"{cols.shape[1]} hops, {audio_s / 60:.1f} min, a cut in depth), {time.perf_counter() - t0:.1f} s")
    launches_read = 0
    for engine in ("otw", "livenote_v2"):
        follower = ScoreFollower(ref_wav, engine, PARAMS, fused=True, device=device)
        eng = follower.engine
        if not eng.long_ref or eng.n < fused_streaming._LONG_REF_THRESHOLD:
            raise AssertionError(f"{engine}: {eng.n} reference frames, long_ref={eng.long_ref}")
        torch.cuda.synchronize()
        otw_insert.launches = otw_insert.delta_launches = 0
        t1 = time.perf_counter()
        follow(follower, buffers)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        delta, whole = otw_insert.delta_launches, otw_insert.launches
        launches_read += delta
        if delta == 0 or whole != 0 or delta != len(eng.dispatched_block_sizes):
            raise AssertionError(f"{engine}: {delta} delta and {whole} whole-path launches for "
                                 f"{len(eng.dispatched_block_sizes)} dispatches")
        entries = len(eng._deltas)
        pending = sum(x.numel() * x.element_size() for e in eng._deltas
                      for x in (e if isinstance(e, tuple) else (e,)))
        t1 = time.perf_counter()
        path = np.asarray(follower.path)
        drain_s = time.perf_counter() - t1
        if path.ndim != 2 or path.shape[1] != 2 or len(path) == 0 or eng._deltas:
            raise AssertionError(f"{engine}: bad path {path.shape} or undrained rows")
        std = FusedStreamingEngine(eng._state.ref[PARAMS["c"]:].T, PARAMS, ENGINE_OVERRIDES[engine], k_block=32,
                                   device=device, long_ref=False)
        std.insert_block_nowait(cols)
        std.flush()
        if not np.array_equal(std.path_array, path):
            raise AssertionError(f"{engine}: the long-reference path differs from the standard layout's")
        # the first PLAIN_CONCERT_HOPS columns through the plain version in
        # the long layout (CPU engine): its path is the card path's prefix
        # (points are only ever appended); the cut bounds the phase's time
        t1 = time.perf_counter()
        plain = FusedStreamingEngine(eng._state.ref[PARAMS["c"]:].T.cpu(), PARAMS, ENGINE_OVERRIDES[engine],
                                     k_block=32, device="cpu", long_ref=True)
        plain.insert_block_nowait(cols[:, :PLAIN_CONCERT_HOPS].cpu())
        plain.flush()
        plain_path = plain.path_array
        if len(plain_path) == 0 or not np.array_equal(plain_path, path[: len(plain_path)]):
            raise AssertionError(f"{engine}: the kernel's long-reference path differs from the plain version's")
        plain_s = time.perf_counter() - t1
        score = scorer.score(follower.path)
        size = stream_device_bytes(eng)
        log(f"phase 9 [concert {engine}]: {cols.shape[1]} hops vs {eng.n} ref frames, long_ref chosen by the engine; "
            f"{delta} delta launches read from the counter (mean {np.mean(eng.dispatched_block_sizes):.2f} "
            f"frames/launch), 0 whole-path; path {len(path)} points == standard layout (k_block 32) == plain "
            f"version in the long layout over the first {PLAIN_CONCERT_HOPS} hops ({len(plain_path)} points; CPU, "
            f"{plain_s:.1f} s), last point "
            f"{tuple(int(v) for v in path[-1])}; stopped={follower.stopped}")
        log(f"phase 9 [concert {engine}]: wall {wall:.3f} s, real-time factor {audio_s / wall:.1f}; the path read "
            f"drained {entries} pending entries (one device-to-host copy each, {pending} B in all, "
            f"{pending / max(entries, 1):.0f} B per copy) in {drain_s:.3f} s; device bytes per stream: "
            f"{size['delta']} (delta layout) vs {size['standard']} (standard layout)")
        log(f"phase 9 [concert {engine}]: PathScorer count={score.count} pct_off_beats={score.pct_off_beats} "
            f"pct_off_secs={score.pct_off_secs}")
        if engine == "otw":
            # the same follower in the standard layout (threshold raised for
            # this one construction): what the delta layout costs per hop
            saved = fused_streaming._LONG_REF_THRESHOLD
            fused_streaming._LONG_REF_THRESHOLD = eng.n + 1
            try:
                standard = ScoreFollower(ref_wav, engine, PARAMS, fused=True, device=device)
            finally:
                fused_streaming._LONG_REF_THRESHOLD = saved
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            follow(standard, buffers)
            torch.cuda.synchronize()
            std_wall = time.perf_counter() - t1
            if standard.engine.long_ref or not np.array_equal(np.asarray(standard.path), path):
                raise AssertionError(f"{engine}: the standard-layout follower's path differs from the long one's")
            log(f"phase 9 [concert {engine}]: the same follower in the standard layout: wall {std_wall:.3f} s, "
                f"real-time factor {audio_s / std_wall:.1f}, path == the long layout's")
            # where the time goes in the long layout: a traced slice of the concert
            fresh = ScoreFollower(ref_wav, engine, PARAMS, fused=True, device=device)
            trace_run(lambda: follow(fresh, buffers[:TRACE_BUFFERS]), f"phase 9 [trace, first {TRACE_BUFFERS} buffers]")

    # (c) the delta mode's time at k_block 8 on the concert reference
    k = 8
    reps = min(64, cols.shape[1] // k - 2)
    cfg = eng.cfg
    rows = cols.T.contiguous()
    base = otw_insert.new_state(eng._state.ref[PARAMS["c"]:].T.contiguous(), cfg, eng.cap, whole_path=False)
    width = otw_insert.delta_width(cfg, k)
    lens = (eng.cap, eng.n, k)

    def timed(fn, state, out):
        for r in range(2):
            fn(state, rows[r * k : (r + 1) * k], lens, cfg, k, delta=out[r])
        sc0 = state.scalars.tolist()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for r in range(2, 2 + reps):
            fn(state, rows[r * k : (r + 1) * k], lens, cfg, k, delta=out[r])
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, sc0, state.scalars.tolist()

    # the kernel and the plain version from the same state on the same
    # columns, each into rows of its own: rows and states must be equal
    kern_st, plain_st = clone_state(base), clone_state(base)
    out = torch.empty((reps + 2, width), dtype=torch.int32, device=device)
    plain_out = torch.empty((reps + 2, width), dtype=torch.int32, device=device)
    event_ms, sc0, sc1 = timed(otw_insert.insert_block, kern_st, out)
    plain_ms, _, _ = timed(otw_insert.insert_block_reference, plain_st, plain_out)
    if not torch.equal(out, plain_out):
        raise AssertionError(f"phase 9 [otw_insert_block_long]: kernel and plain disagree on the delta rows "
                             f"(max |diff| {max_abs_diff(out, plain_out)})")
    err = compare_states(kern_st, plain_st, "phase 9 [otw_insert_block_long]")
    st = clone_state(base)
    dev_ms, traced = kernel_device_ms(
        lambda r: otw_insert.insert_block(st, rows[r * k : (r + 1) * k], lens, cfg, k, delta=out[r]), reps,
        "otw_insert_kernel")
    dt, dj, points = (sc1[s] - sc0[s] for s in (otw_insert.S_T, otw_insert.S_J, otw_insert.S_PLEN))
    bound_ms, bound_by, bytes_, ops = insert_bound(cfg.c, 12, cfg.euclidean, k, otw_insert.delta_slots(cfg, k), reps,
                                                   dt, dj, points)
    log(f"phase 9 [otw_insert_block_long] k_block={k}, c={cfg.c}, N={eng.n} ({engine}): "
        f"device time {'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} (profiler, {traced} of {reps} "
        f"launches traced), {event_ms:.4f} ms back to back (CUDA events), plain {plain_ms:.4f} ms; bound "
        f"{bound_ms:.7f} ms by {bound_by} ({bytes_:.0f} B, {ops:.0f} ops a launch; {reps} launches: t +{dt}, "
        f"j +{dj}, {points} points); kernel == plain over these {reps + 2} launches (delta rows, window, live "
        f"history, scalars), window max |diff| {err}")
    log(f"phase 9: {time.perf_counter() - t0:.1f} s for (b) and (c)")
    return (launches_read, err, dev_ms, event_ms, plain_ms, bound_ms, bound_by), (ref_wav, live_wav), cols


# ---------------------------------------------------------------------------
# Phase 10: multi-stream serving (kernels #5 and #6, the K-insert kernel's grid)
# ---------------------------------------------------------------------------


def multi_ks(launch: int, ptr, lens, k_block: int):
    """Each stream's insert count in a launch: a cycle through 0 … k_block
    (0 every fifth launch of a stream, so the batch is always ragged),
    never past the stream's live columns."""
    import numpy as np

    return np.asarray([0 if (launch + i) % 5 == 4 else min(1 + (launch + i) % k_block, n - p)
                       for i, (p, n) in enumerate(zip(ptr, lens))], np.int32)


def run_multi_batch(refs, lives, cfg, k_block: int, whole_path: bool, device, what: str, shared: bool = False):
    """B streams through the batched kernel and the batched plain version
    (on host copies of the same inputs), launch by launch with ragged
    per-stream counts (0 included), beside the solo kernel (#1 or #4) on
    each stream alone: the batch's window, live rows,
    scalars, status, path buffers or delta rows EQUAL the plain version's,
    and each stream's equal the solo kernel's.  Returns (launches, final
    scalars (B, 16))."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.ops import otw_insert

    b, c = len(refs), cfg.c
    ref_d = [torch.from_numpy(r).to(device) for r in refs]
    kern = otw_insert.new_multi_state([ref_d[0]] * b if shared else ref_d, cfg, whole_path)
    plain = clone_state(kern, "cpu")
    solos = [otw_insert.new_state(r, cfg, 2 * r.shape[1], whole_path) for r in ref_d]
    width = otw_insert.delta_width(cfg, k_block)
    lens = [l.shape[1] for l in lives]
    ptr, launch = [0] * b, 0
    while any(p < n for p, n in zip(ptr, lens)):
        ks = multi_ks(launch, ptr, lens, k_block)
        cols = np.zeros((b, k_block, refs[0].shape[0]), np.float32)
        for i, (p, l) in enumerate(zip(ptr, lives)):
            cols[i, : ks[i]] = l[:, p : p + ks[i]].T
        cols_d, ks_d = torch.from_numpy(cols).to(device), torch.from_numpy(ks).to(device)
        rows_k = None if whole_path else torch.full((b, width), -7, dtype=torch.int32, device=device)
        rows_p = None if whole_path else torch.full((b, width), -5, dtype=torch.int32)
        otw_insert.multi_insert_block(kern, cols_d, ks_d, cfg, k_block, rows_k)
        otw_insert.multi_insert_block_reference(plain, torch.from_numpy(cols), torch.from_numpy(ks), cfg, k_block,
                                                rows_p)
        solo_rows = []
        for i, st in enumerate(solos):
            n = refs[i].shape[1]
            solo_rows.append(None if whole_path else torch.full((width,), -3, dtype=torch.int32, device=device))
            otw_insert.insert_block(st, cols_d[i, : ks[i]], (2 * n, n, int(ks[i])), cfg, k_block, solo_rows[i])
        torch.cuda.synchronize()
        at = f"{what} @launch {launch}"
        for name in ("window", "live", "scalars", "status", "path_x", "path_y"):
            x, y = getattr(kern, name), getattr(plain, name)
            if x is not None and not torch.equal(x.cpu(), y):
                raise AssertionError(f"{at}: batched kernel and plain disagree on {name} "
                                     f"(max |diff| {max_abs_diff(x.cpu(), y)})")
        if rows_k is not None and not torch.equal(rows_k.cpu(), rows_p):
            raise AssertionError(f"{at}: batched kernel and plain disagree on the delta rows")
        for i, st in enumerate(solos):
            view, rows = kern.stream(i), 2 * refs[i].shape[1] + c
            same = (torch.equal(view.window, st.window) and torch.equal(view.scalars, st.scalars)
                    and torch.equal(view.live[:rows], st.live))
            if whole_path:
                p_len = st.path_x.shape[0]
                same = same and torch.equal(view.status, st.status) and torch.equal(view.path_x[:p_len], st.path_x) \
                    and torch.equal(view.path_y[:p_len], st.path_y)
            else:
                same = same and torch.equal(rows_k[i], solo_rows[i])
            if not same:
                raise AssertionError(f"{at}: stream {i} of the batch differs from the solo kernel on it alone")
        ptr = [p + int(k) for p, k in zip(ptr, ks)]
        launch += 1
    return launch, kern.scalars.cpu()


def phase_multi_vs_plain(device) -> None:
    """Phase 10 (a)."""
    import numpy as np

    from real_time_audio_sync_tpu_torch.ops import otw_insert

    t0 = time.perf_counter()
    launches, cells = 0, 0
    for vi, variant in enumerate(VARIANTS):
        for c in MULTI_BANDS:
            for k_block in (1, 8):
                for whole_path in (True, False):
                    rng = np.random.default_rng(10000 + 1000 * vi + 10 * c + k_block)
                    cfg = set_live_cfg(variant, c)
                    # three references of different lengths; stream 1's live
                    # runs out early, streams 0 and 2 run past their ends
                    pairs = [stream(rng, variant, c + 20 + 10 * i, "stop") for i in range(3)]
                    refs = [r for r, _ in pairs]
                    lives = [l for _, l in pairs]
                    lives[1] = lives[1][:, : lives[1].shape[1] * 3 // 5]
                    n, sc = run_multi_batch(refs, lives, cfg, k_block, whole_path, device,
                                            f"phase 10 [{variant} c={c} k={k_block} {'whole' if whole_path else 'delta'}]")
                    if sc[0, otw_insert.S_STOPPED] != 1 or sc[2, otw_insert.S_STOPPED] != 1:
                        raise AssertionError(f"phase 10 [{variant} c={c}]: streams 0 and 2 did not stop")
                    launches += n
                    cells += 1
    log(f"phase 10: batched K-insert kernel == plain == the solo kernel stream by stream on the card over "
        f"{len(VARIANTS)} variants x bands {MULTI_BANDS} x k_block (1, 8) x both modes ({cells} ragged batches of "
        f"3 references of different lengths, per-stream counts 0..k_block): {launches} launches, "
        f"{time.perf_counter() - t0:.1f} s")

    t1 = time.perf_counter()
    launches, cells = 0, 0
    for vi, variant in enumerate(("otw", "livenote_v2_diff")):
        for c in INSERT_EDGE_BANDS:
            for whole_path in (True, False):
                rng = np.random.default_rng(11000 + 1000 * vi + c)
                pairs = [stream(rng, variant, c + 20 + 10 * i, "stop") for i in range(3)]
                refs, lives = [r for r, _ in pairs], [l for _, l in pairs]
                lives[1] = lives[1][:, : lives[1].shape[1] * 3 // 5]
                n, sc = run_multi_batch(refs, lives, set_live_cfg(variant, c), 8, whole_path, device,
                                        f"phase 10 [{variant} c={c} edge {'whole' if whole_path else 'delta'}]")
                if sc[0, otw_insert.S_STOPPED] != 1 or sc[2, otw_insert.S_STOPPED] != 1:
                    raise AssertionError(f"phase 10 [{variant} c={c} edge]: streams 0 and 2 did not stop")
                launches += n
                cells += 1
    log(f"phase 10: the same at the route edges {INSERT_EDGE_BANDS} (otw, livenote_v2_diff, k_block 8, both "
        f"modes; {cells} ragged batches): {launches} launches, {time.perf_counter() - t1:.1f} s")

    t1 = time.perf_counter()
    c = PARAMS["c"]
    for vi, variant in enumerate(("otw", "livenote_v2_diff")):
        for whole_path in (True, False):
            rng = np.random.default_rng(10500 + 10 * vi + whole_path)
            cfg = set_live_cfg(variant, c, 5)  # max_run_count 5 lets the stuck stream reach the freeze
            pairs = [stream(rng, variant, c + 15 + 20 * i, "stop") for i in range(5)]
            pairs[3] = stream(rng, variant, 3 * c + 30, "capacity")
            refs, lives = [r for r, _ in pairs], [l for _, l in pairs]
            lives[4] = lives[4][:, : lives[4].shape[1] // 2]  # runs out
            mode = "whole" if whole_path else "delta"
            _, sc = run_multi_batch(refs, lives, cfg, 8, whole_path, device, f"phase 10 [{variant} B=5 {mode}]")
            n3 = refs[3].shape[1]
            if sc[1, otw_insert.S_STOPPED] != 1 or not (sc[3, otw_insert.S_T] >= 2 * n3 and sc[3, otw_insert.S_STOPPED] == 0):
                raise AssertionError(f"phase 10 [{variant} B=5 {mode}]: stop or freeze not reached ({sc.tolist()})")
    for vi, variant in enumerate(VARIANTS):
        for whole_path in (True, False):
            rng = np.random.default_rng(10700 + 10 * vi + whole_path)
            ref, live = stream(rng, variant, c + 30, "stop")
            # the whole rendition, its first half, and the rendition from its fourth frame
            lives = [live, live[:, : live.shape[1] // 2], live[:, 3:]]
            run_multi_batch([ref] * 3, lives, set_live_cfg(variant, c), 8, whole_path, device,
                            f"phase 10 [{variant} shared x 3 {'whole' if whole_path else 'delta'}]", shared=True)
    log(f"phase 10: ragged B = 5 (one stream stops past its reference's end, one reaches the live-capacity freeze, "
        f"one runs out; otw, livenote_v2_diff) and a shared reference x 3 (4 variants), both modes: batched kernel "
        f"== plain == solo kernel, {time.perf_counter() - t1:.1f} s")


def multi_device_bytes(fms) -> int:
    """Device bytes of a follower's state per stream (the shared reference
    divided among the streams; pending delta rows counted apart)."""
    import dataclasses

    st = fms._state
    total = sum(x.numel() * x.element_size() for x in (getattr(st, f.name) for f in dataclasses.fields(st))
                if x is not None)
    return total // fms.b


def pending_deltas(fms) -> list:
    """A multi-stream server's pending delta entries, every shard's."""
    return [e for sh in fms._shards for e in sh.deltas]


def pending_delta_bytes(fms) -> int:
    return sum(x.numel() * x.element_size() for e in pending_deltas(fms)
               for x in (e if isinstance(e, tuple) else (e,)))


def serve(fms, lives, lens, perf, hops: int) -> None:
    """Feed ``fms`` for ``hops`` hops: stream i follows performance
    ``perf[i]`` (a row of the host array ``lives`` (P, T, F), ``lens[p]``
    columns long), joins at hop i through the ``active`` mask, and feeds
    one column a hop until its performance ends."""
    import numpy as np

    starts = np.arange(len(perf))
    for h in range(hops):
        pos = h - starts
        act = (pos >= 0) & (pos < lens[perf])
        fms.feed(lives[perf, np.clip(pos, 0, lives.shape[1] - 1)], act)
    fms.flush()


def serving_run(ref, lives, lens, perf, long_ref: bool, hops: int, device, label: str):
    """One main-path run of ``FusedMultiStreamFollower`` (B = len(perf),
    shared reference, stream i joins at hop i), with every launch counter
    set to 0 just before and read just after.  Returns (follower, paths,
    figures)."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.config import FRAME_PERIOD_SEC
    from real_time_audio_sync_tpu_torch.ops import otw_insert
    from real_time_audio_sync_tpu_torch.parallel import FusedMultiStreamFollower

    b = len(perf)
    fms = FusedMultiStreamFollower(ref, PARAMS, n_streams=b, k_block=8, long_ref=long_ref, device=device)
    starts = np.arange(b)
    torch.cuda.synchronize()
    otw_insert.launches = otw_insert.delta_launches = 0
    otw_insert.multi_launches = otw_insert.multi_delta_launches = 0
    t0 = time.perf_counter()
    serve(fms, lives, lens, perf, hops)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (otw_insert.launches, otw_insert.delta_launches, otw_insert.multi_launches,
              otw_insert.multi_delta_launches)
    want = (0, 0, 0, len(fms.dispatched_block_sizes)) if long_ref else (0, 0, len(fms.dispatched_block_sizes), 0)
    if counts != want or not fms.dispatched_block_sizes:
        raise AssertionError(f"{label}: launches (solo, solo delta, batched, batched delta) {counts}, want {want}")
    pending = pending_delta_bytes(fms) if long_ref else 0
    entries = len(pending_deltas(fms)) if long_ref else 0
    t1 = time.perf_counter()
    paths = fms.paths()
    drain_s = time.perf_counter() - t1
    frames = np.clip(hops - starts, 0, lens[perf]).astype(np.int64)
    sizes = np.asarray(fms.dispatched_block_sizes)
    audio = frames * FRAME_PERIOD_SEC
    log(f"{label}: B = {b}, {hops} hops, {int(frames.sum())} frames in all; wall {wall:.3f} s; RTF per stream "
        f"{np.mean(audio) / wall:.2f} (mean; min {audio.min() / wall:.2f}), aggregate {audio.sum() / wall:.1f}; "
        f"{wall * 1e6 / frames.sum():.3f} us per frame per stream; {len(sizes)} dispatches, block sizes "
        f"{dict(zip(*[a.tolist() for a in np.unique(sizes, return_counts=True)]))}; launches read from the "
        f"counters: {counts[3] if long_ref else counts[2]} ({'delta' if long_ref else 'whole-path'} grid), "
        f"0 solo; stopped {int(fms.stopped.sum())} of {b}")
    log(f"{label}: device bytes per stream {multi_device_bytes(fms)} (shared reference "
        f"{fms._state.ref.numel() * 4} B once); final paths() drained {entries} pending entries, {pending} B "
        f"({pending / b:.0f} B per stream), in {drain_s:.3f} s")
    return fms, paths, counts[3] if long_ref else counts[2]


def equal_paths(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b))


def solo_path(ref, cols, device, long_ref=None):
    from real_time_audio_sync_tpu_torch.models.fused_streaming import FusedStreamingEngine

    eng = FusedStreamingEngine(ref, PARAMS, k_block=32, long_ref=long_ref, device=device)
    eng.insert_block_nowait(cols)
    eng.flush()
    return eng.path_array, eng.long_ref


def multi_bound(c: int, f: int, euclidean: bool, k: int, d_pad: int, launches: int, dt: int, dj: int, points: int,
                b: int, delta: bool):
    """(bound ms, "bytes" or "operations", bytes, ops) of one batched launch
    of B identical streams, averaged over ``launches`` launches that
    advanced each stream's t by ``dt``, j by ``dj`` and committed ``points``
    points: per stream the window read and written, the k columns read and
    their live rows written, the c+1+k live rows the band reads, the
    scalars read and written, and the delta row (delta mode) or the status
    and points (whole path) written; the shared reference's c+1+dj/launches
    rows once; operations as :func:`insert_bound`, B times."""
    import math

    stages = math.ceil(math.log2(c + 1))
    per_cell = (3 * f + 1 if euclidean else 2 * f + 1) + 5 + 3 * stages
    out = (8 + 2 * d_pad) * 4 if delta else 8 * 4 + points * 8 / launches
    stream_bytes = 2 * (c + 1) ** 2 * 4 + 2 * k * f * 4 + (c + 1 + k) * f * 4 + 2 * 16 * 4 + out
    bytes_ = b * stream_bytes + (c + 1 + dj / launches) * f * 4
    ops = b * ((dt + dj) * (c + 1) * per_cell + points * 2 * (c + 1)) / launches
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes", bytes_, ops) if t_bytes >= t_ops else (t_ops, "operations", bytes_, ops)


def phase_multi_rows(device, ref, live):
    """Phase 10 (d): both modes at B in MULTI_TIMING_BATCHES on the
    sonata_allegro reference, k_block 8, c = 50, every stream on the same
    columns: profiler device time and back-to-back CUDA-event time per
    launch, the bound; at B = 4 also the plain version (on card tensors)
    from the same state on the same columns, whose rows and states must
    equal the kernel's.  Returns {mode: {B: (dev_ms, event_ms, bound_ms,
    bound_by)}, "plain": {mode: ms}, "err": max |diff|}."""
    import torch

    from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES, OnlineConfig
    from real_time_audio_sync_tpu_torch.ops import otw_insert

    cfg = OnlineConfig(c=PARAMS["c"], max_run_count=PARAMS["max_run_count"], **ENGINE_OVERRIDES["otw"])
    k, reps = 8, 64
    rows = live.T.contiguous()
    width = otw_insert.delta_width(cfg, k)
    out = {"delta": {}, "whole": {}, "plain": {}, "err": 0.0}
    for mode in ("delta", "whole"):
        whole = mode == "whole"
        for b in MULTI_TIMING_BATCHES:
            base = otw_insert.new_multi_state([ref] * b, cfg, whole_path=whole)
            cols = [rows[r * k : (r + 1) * k].expand(b, k, rows.shape[1]).contiguous() for r in range(reps + 2)]
            ks = torch.full((b,), k, dtype=torch.int32, device=device)
            delta = None if whole else torch.empty((reps + 2, b, width), dtype=torch.int32, device=device)

            def launch(st, r):
                otw_insert.multi_insert_block(st, cols[r], ks, cfg, k, None if delta is None else delta[r])

            st = clone_state(base)
            for r in range(2):
                launch(st, r)
            sc0 = st.scalars[0].tolist()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for r in range(2, 2 + reps):
                launch(st, r)
            end.record()
            torch.cuda.synchronize()
            event_ms = start.elapsed_time(end) / reps
            sc1 = st.scalars[0].tolist()
            traced_st = clone_state(base)
            dev_ms, traced = kernel_device_ms(lambda r: launch(traced_st, r), reps, "otw_insert_kernel")
            dt, dj, points = (sc1[s] - sc0[s] for s in (otw_insert.S_T, otw_insert.S_J, otw_insert.S_PLEN))
            bound_ms, bound_by, bytes_, ops = multi_bound(cfg.c, rows.shape[1], cfg.euclidean, k,
                                                          otw_insert.delta_slots(cfg, k), reps, dt, dj, points, b,
                                                          not whole)
            out[mode][b] = (dev_ms, event_ms, bound_ms, bound_by)
            extra = ""
            if b == MULTI_PLAIN_BATCH:
                # the plain version from the same state on the same columns
                kern, plain = clone_state(base), clone_state(base)
                plain_delta = None if whole else torch.empty_like(delta)
                for r in range(2):
                    launch(kern, r)
                    otw_insert.multi_insert_block_reference(plain, cols[r], ks, cfg, k,
                                                            None if whole else plain_delta[r])
                t0 = time.perf_counter()
                for r in range(2, 2 + PLAIN_REPS):
                    otw_insert.multi_insert_block_reference(plain, cols[r], ks, cfg, k,
                                                            None if whole else plain_delta[r])
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3 / PLAIN_REPS
                for r in range(2, 2 + PLAIN_REPS):
                    launch(kern, r)
                torch.cuda.synchronize()
                if not whole and not torch.equal(delta[: 2 + PLAIN_REPS], plain_delta[: 2 + PLAIN_REPS]):
                    raise AssertionError(f"phase 10 [{mode} B={b}]: kernel and plain disagree on the delta rows")
                for name in ("window", "live", "scalars", "status", "path_x", "path_y"):
                    x, y = getattr(kern, name), getattr(plain, name)
                    if x is not None and not torch.equal(x, y):
                        raise AssertionError(f"phase 10 [{mode} B={b}]: kernel and plain disagree on {name}")
                out["err"] = max(out["err"], max_abs_diff(kern.window, plain.window))
                out["plain"][mode] = plain_ms
                extra = f"; plain {plain_ms:.3f} ms a launch (card tensors, {PLAIN_REPS} launches), equal to the kernel"
            log(f"phase 10 [{'otw_multi_insert_block_long' if not whole else 'otw_multi_insert_block'}] B={b}, "
                f"k_block {k}, c={cfg.c}, N={ref.shape[1]}: device time "
                f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} (profiler, {traced} of {reps} launches "
                f"traced), {event_ms:.4f} ms back to back (CUDA events); bound {bound_ms:.7f} ms by {bound_by} "
                f"({bytes_:.0f} B, {ops:.0f} ops a launch; t +{dt}, j +{dj}, {points} points a stream over {reps} "
                f"launches){extra}")
    return out


def phase_serving(device, root: str, concert_wavs, concert_cols):
    """Phase 10 (b)–(d); returns the two kernels' rows for the kernels line."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.features.chroma import wav_to_chroma
    from real_time_audio_sync_tpu_torch.utils.wavio import load_wav

    t0 = time.perf_counter()
    d = os.path.join(root, "sonata_allegro")
    ref = wav_to_chroma(os.path.join(d, "sonata_allegro_00.wav"), np.float32, device=device)
    cols = []
    for take in ("01", "02"):
        pcm, _ = load_wav(os.path.join(d, f"sonata_allegro_{take}.wav"))
        cols.append(hop_columns([pcm[s : s + 2048] for s in range(0, len(pcm), 2048)], device))
    lens = np.asarray([x.shape[1] for x in cols])
    lives = np.zeros((2, lens.max(), 12), np.float32)
    for i, x in enumerate(cols):
        lives[i, : lens[i]] = x.T.cpu().numpy()
    b = SERVING_STREAMS
    perf = np.arange(b) % 2  # even streams follow _01, odd streams _02
    hops = b - 1 + int(lens.max())
    log(f"phase 10 (b): shared reference sonata_allegro_00 ({ref.shape[1]} frames), {b} streams, even on _01 "
        f"({lens[0]} hops), odd on _02 ({lens[1]} hops), stream i joins at hop i; chroma on the card")
    launches, runs = {}, {}
    for long_ref in (True, False):
        label = f"phase 10 (b) [{'windowed' if long_ref else 'whole buffer'}]"
        fms, paths, n = serving_run(ref, lives, lens, perf, long_ref, hops, device, label)
        launches["otw_multi_insert_block_long" if long_ref else "otw_multi_insert_block"] = n
        runs[long_ref] = paths
    paths = runs[True]
    if not equal_paths(paths, runs[False]):
        raise AssertionError("phase 10 (b): the two layouts' paths differ")
    for p in (0, 1):
        if not all(np.array_equal(paths[i], paths[p]) for i in range(p, b, 2)):
            raise AssertionError(f"phase 10 (b): the {'even' if p == 0 else 'odd'} streams' paths differ (feed skew)")
    for i in (0, 1, b - 2, b - 1):
        want, _ = solo_path(ref, cols[perf[i]], device)
        if not np.array_equal(paths[i], want):
            raise AssertionError(f"phase 10 (b): stream {i} differs from a solo card engine on the same columns")
    t1 = time.perf_counter()
    plain, _ = solo_path(ref.cpu(), cols[0].cpu(), "cpu")
    if not np.array_equal(paths[0], plain):
        raise AssertionError("phase 10 (b): stream 0 differs from the plain version (CPU engine)")
    log(f"phase 10 (b): both layouts' {b} paths equal; even streams' paths all equal ({len(paths[0])} points), odd "
        f"streams' all equal ({len(paths[1])}); streams 0, 1, {b - 2}, {b - 1} == a solo card engine; stream 0 == "
        f"the plain version (CPU engine, {time.perf_counter() - t1:.1f} s)")
    trace_run(lambda: serving_trace(ref, lives, lens, perf, device), f"phase 10 (b) [trace, first {TRACE_HOPS} hops]")

    # (c) the concert reference, windowed layout, the first CONCERT_HOPS hops
    t1 = time.perf_counter()
    cref = wav_to_chroma(concert_wavs[0], np.float32, device=device)
    clive = concert_cols.T.cpu().numpy()[None]
    clens = np.asarray([clive.shape[1]])
    cperf = np.zeros(b, np.int64)
    log(f"phase 10 (c): shared reference concert_00 ({cref.shape[1]} frames), {b} streams on concert_01 "
        f"({clens[0]} hops), stream i joins at hop i; the run is cut to its first {CONCERT_HOPS} hops to bound "
        f"the phase's time")
    fms, cpaths, n = serving_run(cref, clive, clens, cperf, True, CONCERT_HOPS, device, "phase 10 (c) [windowed]")
    launches["otw_multi_insert_block_long"] += n
    for i in (0, b - 1):
        want, solo_long = solo_path(cref, concert_cols[:, : CONCERT_HOPS - i], device)
        if not solo_long or not np.array_equal(cpaths[i], want):
            raise AssertionError(f"phase 10 (c): stream {i} differs from a solo long-layout engine "
                                 f"(long layout {solo_long})")
    log(f"phase 10 (c): streams 0 and {b - 1} == a solo long-layout card engine on the same columns "
        f"({len(cpaths[0])} and {len(cpaths[b - 1])} points), {time.perf_counter() - t1:.1f} s")
    del fms, cpaths

    timing = phase_multi_rows(device, ref, cols[0])
    log(f"phase 10: {time.perf_counter() - t0:.1f} s for (b), (c) and (d)")
    rows = {}
    for name, mode in (("otw_multi_insert_block_long", "delta"), ("otw_multi_insert_block", "whole")):
        dev_ms, event_ms, bound_ms, bound_by = timing[mode][SERVING_STREAMS]
        rows[name] = (launches[name], timing["err"], dev_ms, event_ms, timing["plain"][mode], bound_ms, bound_by)
    return rows


def serving_trace(ref, lives, lens, perf, device) -> None:
    from real_time_audio_sync_tpu_torch.parallel import FusedMultiStreamFollower

    fms = FusedMultiStreamFollower(ref, PARAMS, n_streams=len(perf), k_block=8, device=device)
    serve(fms, lives, lens, perf, TRACE_HOPS)


def wtw_stream(rng, w: int, hop: int, scenario: str, extra: int = 0):
    """(ref (m, 12), live rows, m, n_cap, start (cp, lp, rp)) of one phase 11
    (a) stream, its reference ``extra`` frames longer than the default.
    "run": a fresh stream that runs windows until the margin stop;
    "margin": mid-stream, the live capacity puts live_ptr at n_cap-1-w
    after the first window; "capacity": chroma_ptr one column short of
    n_cap, w+3 columns ahead of live_ptr, so the second column finds no
    room.  Four runs of "run" stress the cost's division: "zeros" has a
    live frame of zeros here and there (NaN costs, paths stopped at row 0),
    "tiny" live frames scaled by 1e-30, whose squares underflow to 0 (every
    live norm 0 but no dot: a zero divisor, every cost -inf), "small" live frames
    scaled by 2e-19 (finite, nonzero dots and divisors below 2^-60, outside
    the kernel's fast division's range: every cost from its exact double
    form), "ties" every frame the same (every cost equal)."""
    import numpy as np

    m = 3 * w + hop + 10 + extra
    if scenario in ("run", "zeros", "tiny", "small", "ties"):
        n_cap, cp0, lp0 = 2 * m, 0, 0
    elif scenario == "margin":
        n_cap, cp0, lp0 = w + 1 + hop, max(0, w - 2), 0
    else:
        n_cap = 2 * m
        cp0 = n_cap - 1
        lp0 = cp0 - (w + 3)
    ref = unit_cols(rng.random((12, m)) + 0.05).T
    path = np.clip(np.cumsum(rng.integers(0, 3, n_cap + 64)) // 2, 0, m - 1)
    live = unit_cols((ref[path] + 0.1 * rng.random((n_cap + 64, 12))).T).T
    if scenario == "zeros":
        live[rng.random(len(live)) < 0.15] = 0.0
    elif scenario == "tiny":
        live = (live * 1e-30).astype(np.float32)
    elif scenario == "small":
        live = (live * 2e-19).astype(np.float32)
    elif scenario == "ties":
        ref[:] = ref[0]
        live[:] = ref[0]
    return np.ascontiguousarray(ref), np.ascontiguousarray(live), m, n_cap, (cp0, lp0, 0)


def run_wtw_stream(rng, w: int, hop: int, k: int, scenario: str, device):
    """One stream through the WTW kernel (on the card) and its plain version
    (on host copies) launch by launch, every third block ragged, until two
    frozen launches after the stop; raises unless rows, scalars and live
    history are EQUAL after every launch.  Returns (launches, windows, max
    |diff| of the live rows)."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.ops import wtw_insert

    ref, live, m, n_cap, sc0 = wtw_stream(rng, w, hop, scenario)
    st = wtw_insert.new_state(torch.from_numpy(ref.T.copy()).to(device), n_cap)
    st.live[: sc0[0]] = torch.from_numpy(live[: sc0[0]]).to(device)
    st.scalars[:3] = torch.tensor(sc0, dtype=torch.int32)
    plain = clone_state(st, "cpu")
    width = wtw_insert.delta_width(w, hop, k)
    what = f"phase 11 [w={w} hop={hop} k_block={k} {scenario}]"
    launches, after_stop, worst = 0, 0, 0.0
    while after_stop < 2:
        if launches > 4 * n_cap:
            raise AssertionError(f"{what}: no stop after {launches} launches")
        pos = int(plain.scalars[wtw_insert.WS_CHROMA])
        n_valid = k if launches % 3 != 1 else max(1, k - 2)
        cols = np.zeros((k, 12), np.float32)
        take = live[pos : pos + k]
        cols[: len(take)] = take
        row = torch.empty(width, dtype=torch.int32, device=device)
        plain_row = torch.empty(width, dtype=torch.int32)
        wtw_insert.wtw_insert_block(st, torch.from_numpy(cols).to(device), (m, n_cap, n_valid), w, hop, k, row)
        wtw_insert.wtw_insert_block_reference(plain, torch.from_numpy(cols), (m, n_cap, n_valid), w, hop, k, plain_row)
        for name, x, y in (("row", row, plain_row), ("scalars", st.scalars, plain.scalars),
                           ("live", st.live, plain.live)):
            x = x.cpu()
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: kernel and plain disagree on {name} at launch {launches}")
        worst = max(worst, float((st.live.cpu() - plain.live).abs().max()))
        launches += 1
        after_stop += int(plain.scalars[wtw_insert.WS_FLAGS]) & 1
    return launches, int(plain.scalars[wtw_insert.WS_PLEN]), worst


def phase_wtw_vs_plain(device) -> float:
    """Phase 11 (a): the WTW kernel against its plain version; returns the
    largest |diff| (0.0 when equal)."""
    import numpy as np

    from real_time_audio_sync_tpu_torch.ops import wtw_insert

    t0 = time.perf_counter()
    log("phase 11 (a): shared memory a block: " + ", ".join(
        f"w={w}: {wtw_insert.plan(w)[2]} B" for w in sorted({w for w, _ in WTW_SHAPES})))
    worst, streams, launches, points = 0.0, 0, 0, 0
    for w, hop, ks in [(w, hop, K_BLOCKS) for w, hop in WTW_SHAPES + WTW_EDGE_SHAPES] + [
            (w, hop, WTW_WIDE_K_BLOCKS) for w, hop in WTW_WIDE_SHAPES]:
        for k in ks:
            for scenario in WTW_SCENARIOS:
                rng = np.random.default_rng(11000 + 100 * w + 10 * k + hop + len(scenario))
                n, p, err = run_wtw_stream(rng, w, hop, k, scenario, device)
                worst, streams, launches, points = max(worst, err), streams + 1, launches + n, points + p
    for w, hop in WTW_COST_SHAPES:
        for scenario in WTW_COST_SCENARIOS:
            rng = np.random.default_rng(11500 + w + hop + len(scenario))
            n, p, err = run_wtw_stream(rng, w, hop, 8, scenario, device)
            worst, streams, launches, points = max(worst, err), streams + 1, launches + n, points + p
    log(f"phase 11 (a): WTW kernel == plain (tolerance 0) over {streams} streams ((w, hop) in "
        f"{WTW_SHAPES + WTW_EDGE_SHAPES} x "
        f"k_block in {K_BLOCKS} x {WTW_SCENARIOS}, {WTW_WIDE_SHAPES} x k_block in {WTW_WIDE_K_BLOCKS} x "
        f"{WTW_SCENARIOS}, and {WTW_COST_SHAPES} x {WTW_COST_SCENARIOS} at k_block 8; "
        f"ragged blocks, 2 frozen launches after each stop), "
        f"{launches} launches, {points} committed points, max |diff| {worst}, {time.perf_counter() - t0:.1f} s")
    return worst


def wtw_columns(pcm, device):
    """The live chroma columns (12, T) the WTW engines extract from ``pcm``
    on ``device`` (each frame in a tile of the same shape)."""
    import torch

    from real_time_audio_sync_tpu_torch.features.chroma import chroma_frames_tiled, frame_span

    x = torch.from_numpy(pcm.astype("float32")).to(device)
    t = (len(pcm) - 4096) // 2048 + 1
    return chroma_frames_tiled(frame_span(x, t, 4096, 2048))


def plain_wtw_path(ref_wav: str, pcm, cols, ref_rows, hops: int):
    """The CPU plain engine's path (a ``FusedWTW`` on the CPU, the live
    app's parameters) over the first ``hops`` hops of ``pcm`` in
    2048-sample buffers, fed the card's chroma columns ``cols`` (12, T) and
    the card's reference rows ``ref_rows`` (m, 12)."""
    import torch

    from real_time_audio_sync_tpu_torch.models import FusedWTW

    class CardColumns(FusedWTW):
        """FusedWTW on the CPU that takes the card's chroma columns."""

        def _columns(self, n):
            self.buf.consume(n * self.hop_size)
            out = torch.zeros((self.k_block, 12))
            out[:n] = cols[:, self.fed : self.fed + n].T.cpu()
            self.fed += n
            return out

    plain = CardColumns(ref_wav, LIVE_APP_WTW, device="cpu")
    plain.fed = 0
    plain._state.ref.copy_(ref_rows.cpu())
    n_samples = (hops - 1) * 2048 + 4096
    for s in range(0, n_samples, 2048):
        plain.insert(pcm[s : min(s + 2048, n_samples)])
    plain.flush()
    return plain.path_array


def chroma_tile_cost(device, card: str, reps: int = 200) -> None:
    """CUDA-event ms of one chroma extraction of n frames on the card, alone
    (``chroma_frames``) and in tiles of CHROMA_TILE frames as the WTW
    engines extract them (``chroma_frames_tiled``): n = 1 is the host
    engine's hop, 8 and 32 a fused launch's columns at k_block 8 and 32."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.features.chroma import CHROMA_TILE, chroma_frames, chroma_frames_tiled

    frames = torch.from_numpy(np.random.default_rng(11).standard_normal((32, 4096), dtype=np.float32)).to(device)
    for n in (1, 8, 32):
        times = []
        for fn in (chroma_frames, chroma_frames_tiled):
            fn(frames[:n])
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn(frames[:n])
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / reps)
        log(f"phase 11 (b) [{card}]: chroma of {n} frame(s) on the card: {times[0]:.4f} ms alone, {times[1]:.4f} ms "
            f"in tiles of {CHROMA_TILE} (CUDA events, {reps} back to back)")


def wtw_bound(w: int, k: int, launches: int, windows: int, width: int):
    """(bound ms a launch, "bytes" or "operations") over ``launches``
    launches of k columns that ran ``windows`` windows: bytes are the
    columns read and their live rows written, each window's two w x 12
    windows read, the scalars read and written and the row written;
    operations are each window's w^2 cells of cost (12 multiplies, 12
    adds, a multiply, a divide, a subtract) and DP (3 multiplies, 3 adds,
    2 compares) and its 2w norms (24 operations each)."""
    bytes_ = launches * (2 * k * 48 + 2 * 16 * 4 + width * 4) + windows * 2 * w * 48
    ops = windows * (w * w * (27 + 8) + 2 * w * 24)
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3 / launches, ops / FP32_FLOPS * 1e3 / launches
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_wtw_main_path(device, root: str, card: str):
    """Phase 11 (b) and (c); returns the kernels-line row of
    wtw_insert_block (its max_abs_err filled in by the caller)."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.eval import corpus
    from real_time_audio_sync_tpu_torch.eval.scorer import PathScorer
    from real_time_audio_sync_tpu_torch.models import WTW, FusedWTW
    from real_time_audio_sync_tpu_torch.ops import wavefront, wtw_insert
    from real_time_audio_sync_tpu_torch.streaming.runtime import WTWFollower
    from real_time_audio_sync_tpu_torch.utils.wavio import load_wav

    log(card)
    d = os.path.join(root, "sonata_allegro")
    ref_wav, live_wav = (os.path.join(d, f"sonata_allegro_0{i}.wav") for i in (0, 1))
    pcm, fs = load_wav(live_wav)
    buffers = [pcm[s : s + 2048] for s in range(0, len(pcm), 2048)]
    audio_s = len(pcm) / fs
    hops = (len(pcm) - 4096) // 2048 + 1

    # (b) the live app's follower on the card, fed as fast as the host allows
    follower = WTWFollower(ref_wav, live_wav, LIVE_APP_WTW, engine="wtw_fused", device=device)
    eng = follower.dtw
    w, hop, k = eng._w, eng._hop_frames, eng.k_block
    torch.cuda.synchronize()
    wtw_insert.launches = 0
    t0 = time.perf_counter()
    follow(follower, buffers)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wtw_insert.launches
    path = np.asarray(follower.path)
    pointers = eng.pointers
    windows = pointers[1] // hop  # each window advances live_ptr by exactly hop_frames
    if launches == 0 or path.ndim != 2 or len(path) == 0 or not np.isfinite(path).all():
        raise AssertionError(f"phase 11 (b): {launches} launches, path of shape {path.shape}")

    # the port's host WTW on the card (kernels #7 and #8 a window), fed
    # 8-column-aligned chunks (tests/test_pallas_wtw.py:29-38) and the rest
    first, rest = 4096 + 7 * 2048, 8 * 2048
    cuts = list(range(first, len(pcm), rest))
    wavefront.dp_launches = 0
    host = WTW(ref_wav, LIVE_APP_WTW, device=device)
    for chunk in np.split(pcm, cuts):
        if host.insert(chunk) == "stop":
            break
    if host.path != [tuple(p) for p in path.tolist()] or pointers != (host.chroma_ptr, host.live_ptr, host.ref_ptr):
        raise AssertionError("phase 11 (b): the fused path differs from the host WTW engine's on the card")
    log(f"phase 11 (b): path == the host WTW engine on the card ({wavefront.dp_launches} DP launches, "
        f"{len(np.split(pcm, cuts))} aligned chunks)")

    # the live app's default engine, the host WTW (engine="wtw"), on the
    # card fed the same buffers: each hop extracts its one frame in a tile
    # of CHROMA_TILE frames, so its columns, and its path, are the fused one's
    host_follower = WTWFollower(ref_wav, live_wav, LIVE_APP_WTW, engine="wtw", device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    follow(host_follower, buffers)
    torch.cuda.synchronize()
    host_wall = time.perf_counter() - t0
    if not np.array_equal(np.asarray(host_follower.path).reshape(-1, 2), path):
        raise AssertionError("phase 11 (b): WTWFollower(engine='wtw') on the card differs from the fused follower")
    log(f"phase 11 (b) [{card}]: WTWFollower(engine='wtw') on the card, the same buffers: wall {host_wall:.3f} s, "
        f"real-time factor {audio_s / host_wall:.1f}, host {host_wall / hops * 1e6:.1f} us a hop, "
        f"path == the fused follower's")
    chroma_tile_cost(device, card)

    # the plain version: a CPU FusedWTW on the card's columns and reference, the first hops
    cols = wtw_columns(pcm, device)

    t1 = time.perf_counter()
    plain_path = plain_wtw_path(ref_wav, pcm, cols, eng._state.ref, WTW_PLAIN_HOPS)
    if len(plain_path) == 0 or not np.array_equal(plain_path, path[: len(plain_path)]):
        raise AssertionError("phase 11 (b): the card's path does not begin with the CPU plain engine's")
    log(f"phase 11 (b): the CPU plain engine over the first {WTW_PLAIN_HOPS} hops (a cut; the card ran "
        f"{hops}): {len(plain_path)} points == the card path's first, {time.perf_counter() - t1:.1f} s")

    # the other payloads on the card, over the same first hops: int16 spans
    # (exact on this PCM16 audio, so the same path), columns from the host
    # frontend (another FFT, so near-tie points may move), and "auto"
    n_samples = (WTW_PLAIN_HOPS - 1) * 2048 + 4096
    for mode in ("int16", "chroma", "auto"):
        other = FusedWTW(ref_wav, LIVE_APP_WTW, transfer_dtype=mode, device=device)
        for s in range(0, n_samples, 2048):
            other.insert(pcm[s : min(s + 2048, n_samples)])
        other.flush()
        got = other.path_array
        n = min(len(got), len(path))
        moved = int((got[:n] != path[:n]).any(axis=1).sum())
        if len(got) == 0 or (other.transfer_dtype in ("float32", "int16") and not np.array_equal(got, path[:len(got)])):
            raise AssertionError(f"phase 11 (b): transfer_dtype={mode!r} ({other.transfer_dtype}) changed the path")
        log(f"phase 11 (b): transfer_dtype={mode!r} (resolved: {other.transfer_dtype}) over the first "
            f"{WTW_PLAIN_HOPS} hops: {len(got)} points, {moved} of the first {n} differ from the float32 path")

    score = PathScorer.for_pair(ref_wav, live_wav).score(follower.path)
    log(f"phase 11 (b) [{card}]: WTWFollower(engine='wtw_fused', w={w}, hop={hop}, k_block={k}) on "
        f"sonata_allegro _01 ({hops} hops, {audio_s:.1f} s) vs _00 ({eng.M} frames): wall {wall:.3f} s, "
        f"real-time factor {audio_s / wall:.1f}, host {wall / hops * 1e6:.1f} us a hop, {launches} launches, "
        f"{windows} windows, {len(path)} points, stopped={follower.stopped}")
    log(f"phase 11 (b): PathScorer count={score.count} pct_off_beats={score.pct_off_beats} "
        f"pct_off_secs={score.pct_off_secs}")

    # the kernel's time at the main path's shapes: its first launches replayed
    reps = WTW_TIMED_LAUNCHES
    blocks = [cols[:, r * k : (r + 1) * k].T.contiguous() for r in range(reps)]
    width = wtw_insert.delta_width(w, hop, k)
    rows = torch.empty((reps, width), dtype=torch.int32, device=device)
    lens = (eng.M, eng.N, k)

    def fresh():
        return wtw_insert.new_state(eng.chroma_ref, eng.N)

    def replay(st, r):
        wtw_insert.wtw_insert_block(st, blocks[r], lens, w, hop, k, rows[r])

    warm = fresh()
    for r in range(reps):
        replay(warm, r)
    timed = fresh()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for r in range(reps):
        replay(timed, r)
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / reps
    traced = fresh()

    def traced_launch(r):
        nonlocal traced
        if r == 0:  # each trace replays the same launches from a fresh state
            traced = fresh()
        replay(traced, r)

    per_launch = kernel_launch_us(traced_launch, reps, "wtw_insert_kernel")
    dev_ms, n_traced = device_ms(per_launch)
    # launch by launch, from a complete trace: those that ran a window (the
    # row's plen moved) and those that only appended
    plens = [0] + rows[:, 1].tolist()
    window_ms = idle_ms = None
    if len(per_launch) == reps:
        ran = [plens[r + 1] > plens[r] for r in range(reps)]
        window_ms = sum(t for t, x in zip(per_launch, ran) if x) / 1e3 / max(1, sum(ran))
        idle_ms = sum(t for t, x in zip(per_launch, ran) if not x) / 1e3 / max(1, reps - sum(ran))
    if not torch.equal(timed.scalars, warm.scalars):
        raise AssertionError("phase 11 (b): replays of the same launches disagree")
    host_state = clone_state(fresh(), "cpu")
    host_blocks = [b.cpu() for b in blocks]
    host_row = torch.empty(width, dtype=torch.int32)
    t2 = time.perf_counter()
    for r in range(reps):
        wtw_insert.wtw_insert_block_reference(host_state, host_blocks[r], lens, w, hop, k, host_row)
    plain_ms = (time.perf_counter() - t2) * 1e3 / reps
    if not torch.equal(host_state.scalars, warm.scalars.cpu()):
        raise AssertionError("phase 11 (b): plain and kernel disagree over the timed launches")
    timed_windows = int(warm.scalars[wtw_insert.WS_LIVE]) // hop
    bound_ms, bound_by = wtw_bound(w, k, reps, timed_windows, width)
    log(f"phase 11 (b) [{card}]: launches that ran a window "
        f"{'not measured' if window_ms is None else f'{window_ms:.4f} ms'}, launches that only appended "
        f"{'not measured' if idle_ms is None else f'{idle_ms:.4f} ms'} (profiler, device time, launch by launch)")
    log(f"phase 11 (b) [{card}]: kernel {'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} device time "
        f"a launch (profiler, {n_traced} of {reps} launches traced), {event_ms:.4f} ms (CUDA events, back to "
        f"back); plain {plain_ms:.3f} ms a launch (host copies); {timed_windows} windows in those {reps} "
        f"launches; bound {bound_ms:.7f} ms a launch by {bound_by}; chain a window: at least {2 * w - 1} "
        f"dependent cells and up to {2 * w - 1} backtrack steps on one lane")
    fresh_follower = WTWFollower(ref_wav, live_wav, LIVE_APP_WTW, engine="wtw_fused", device=device)
    trace_run(lambda: follow(fresh_follower, buffers[:WTW_TRACE_BUFFERS]), "phase 11 (b) [trace]")

    # (c) the harness's widths: the piece's three pairs through align_pair
    log(card)
    pairs = [p for p in corpus.corpus_pairs(root) if os.path.dirname(p[0]) == d]
    for ref_p, live_p in pairs:
        wtw_insert.launches = 0
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        fused = corpus.align_pair(ref_p, live_p, "wtw", mode="fused", device=device)
        torch.cuda.synchronize()
        pair_wall = time.perf_counter() - t3
        n_fused = wtw_insert.launches
        oracle = corpus.align_pair(ref_p, live_p, "wtw", mode="oracle", device=device)
        if n_fused == 0 or not np.array_equal(fused.path, oracle.path):
            raise AssertionError(f"phase 11 (c): {os.path.basename(ref_p)} vs {os.path.basename(live_p)}: "
                                 f"fused ({n_fused} launches) and oracle paths differ")
        s = fused.score
        log(f"phase 11 (c) [{card}]: {os.path.basename(ref_p)} vs {os.path.basename(live_p)}: align_pair(wtw, "
            f"fused) wall {pair_wall:.3f} s, {n_fused} launches, {len(fused.path)} points == oracle; "
            f"pct_off_beats={s.pct_off_beats} pct_off_secs={s.pct_off_secs}")
    return (launches, None, dev_ms, event_ms, plain_ms, bound_ms, bound_by), {
        "windows": windows, "window_ms": window_ms, "append_only_ms": idle_ms}


def wtw_batch(rng, w: int, hop: int, case: str):
    """(streams, shared) of one phase 12 (a) batch, each stream
    :func:`wtw_stream`'s (ref, live, m, n_cap, start); a "run" stream's
    reference is a window shorter than phase 11's and the stream starts
    w-1 columns in, so that its first column makes a window due and it
    reaches its margin stop after a few windows (a cut that bounds the
    phase's time: the plain version's windows take most of it).
    "ragged": three streams on references of different lengths; "stops":
    five, stream 1 reaching its margin stop and stream 3 its capacity
    stop; "shared": three performances of one reference."""
    import numpy as np

    def stream(scenario, extra=0):
        if scenario != "run":
            return wtw_stream(rng, w, hop, scenario)
        return wtw_stream(rng, w, hop, "run", extra - w)[:4] + ((w - 1, 0, 0),)

    if case == "ragged":
        return [stream("run", 9 * i) for i in range(3)], False
    if case == "stops":
        return [stream(scenario, extra) for scenario, extra in
                (("run", 0), ("margin", 0), ("run", 11), ("capacity", 0), ("run", 5))], False
    ref, live, m, n_cap, start = stream("run")
    lives = [live]
    for _ in range(2):
        path = np.clip(np.cumsum(rng.integers(0, 3, n_cap + 64)) // 2, 0, m - 1)
        lives.append(np.ascontiguousarray(unit_cols((ref[path] + 0.1 * rng.random((n_cap + 64, 12))).T).T))
    return [(ref, lv, m, n_cap, start) for lv in lives], True


def run_wtw_batch(streams, shared: bool, w: int, hop: int, k: int, device, what: str):
    """One batch through kernel #10 (on the card), its plain version (on host
    copies) and kernel #9 on each stream alone (on the card), launch by
    launch with per-stream counts 0..k (k but on every third launch of a
    stream, where it is (3·launch + 5·b + 1) mod (k + 1)), until two launches after every
    stream has stopped; raises unless every stream's row, scalars and live
    history are EQUAL across the three.  Returns (launches, committed
    points, the plain state's scalars)."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.ops import wtw_insert

    b_n = len(streams)
    refs = [torch.from_numpy(s[0].T.copy()).to(device) for s in (streams[:1] if shared else streams)]
    kern = wtw_insert.new_multi_state(refs * b_n if shared else refs, [s[3] for s in streams])
    if kern.ref.shape[0] != (1 if shared else b_n):
        raise AssertionError(f"{what}: reference stack of {kern.ref.shape[0]}")
    for b, (_, live, _, _, start) in enumerate(streams):
        kern.live[b, : start[0]] = torch.from_numpy(live[: start[0]]).to(device)
        kern.scalars[b, :3] = torch.tensor(start, dtype=torch.int32)
    plain = clone_state(kern, "cpu")
    solos = [clone_state(kern.stream(b)) for b in range(b_n)]
    width = wtw_insert.delta_width(w, hop, k)
    lens = np.array([[s[2], s[3], 0] for s in streams], np.int32)
    launches, after = 0, 0
    while after < 2:
        if launches > 4 * max(s[3] for s in streams) + 8:
            raise AssertionError(f"{what}: no stop after {launches} launches")
        sc = plain.scalars.numpy()
        cols = np.zeros((b_n, k, 12), np.float32)
        for b, (_, live, _, _, _) in enumerate(streams):
            take = live[sc[b, wtw_insert.WS_CHROMA] :][:k]
            cols[b, : len(take)] = take
            lens[b, 2] = k if (launches + b) % 3 else (3 * launches + 5 * b + 1) % (k + 1)
        cols_d, lens_d = torch.from_numpy(cols).to(device), torch.from_numpy(lens.copy()).to(device)
        rows = torch.empty((b_n, width), dtype=torch.int32, device=device)
        solo_rows = torch.empty((b_n, width), dtype=torch.int32, device=device)
        plain_rows = torch.empty((b_n, width), dtype=torch.int32)
        wtw_insert.multi_wtw_insert_block(kern, cols_d, lens_d, w, hop, k, rows)
        for b in range(b_n):
            wtw_insert.wtw_insert_block(solos[b], cols_d[b], tuple(int(v) for v in lens[b]), w, hop, k, solo_rows[b])
        wtw_insert.multi_wtw_insert_block_reference(plain, torch.from_numpy(cols), torch.from_numpy(lens.copy()), w,
                                                    hop, k, plain_rows)
        torch.cuda.synchronize()
        for name, x, y in (("rows", rows, plain_rows), ("scalars", kern.scalars, plain.scalars),
                           ("live", kern.live, plain.live)):
            if not torch.equal(x.cpu(), y):
                raise AssertionError(f"{what}: kernel #10 and plain disagree on {name} at launch {launches}")
        for b in range(b_n):
            for name, x, y in (("row", solo_rows[b], plain_rows[b]), ("scalars", solos[b].scalars, plain.scalars[b]),
                               ("live", solos[b].live, plain.live[b])):
                if not torch.equal(x.cpu(), y):
                    raise AssertionError(f"{what}: stream {b} alone (kernel #9) disagrees on {name} at launch "
                                         f"{launches}")
        launches += 1
        after += bool((plain.scalars[:, wtw_insert.WS_FLAGS] & 1).all())
    return launches, int(plain.scalars[:, wtw_insert.WS_PLEN].sum()), plain.scalars


def phase_wtw_multi_vs_plain(device) -> float:
    """Phase 12 (a): kernel #10 against its plain version and against kernel
    #9 stream by stream; returns the largest |diff| (0.0 when equal)."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.ops import wtw_insert

    t0 = time.perf_counter()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plans = {w: wtw_insert.plan(w) for w in (20, 100, 128)}
    log("phase 12 (a): blocks an SM (the occupancy calculator): " + ", ".join(
        f"w={w}: {blocks} ({warps} warp(s), {threads} threads a block, {smem} B of shared memory), "
        f"{blocks * sms} blocks in one wave on {sms} SMs" for w, (warps, threads, smem, blocks) in plans.items()))
    batches, launches, points = 0, 0, 0
    # the warp edges at k_block 8 only: phase 11 (a) runs them at every
    # k_block, and a k_block-1 batch is the phase's slowest (a cut that
    # bounds the script's time); one shape at a k_block over three stages
    wide = WTW_WIDE_SHAPES[0] + (WTW_WIDE_K_BLOCKS[-1],)
    for w, hop, k in [(w, hop, k) for w, hop in WTW_SHAPES for k in K_BLOCKS] + [
            (w, hop, 8) for w, hop in WTW_EDGE_SHAPES] + [wide]:
        for case in ("ragged", "stops", "shared"):
            rng = np.random.default_rng(12000 + 100 * w + 10 * k + hop + len(case))
            streams, shared = wtw_batch(rng, w, hop, case)
            what = f"phase 12 (a) [w={w} hop={hop} k_block={k} {case}]"
            n, p, sc = run_wtw_batch(streams, shared, w, hop, k, device, what)
            if case == "stops" and not (sc[1, wtw_insert.WS_FLAGS] & 1
                                        and sc[3, wtw_insert.WS_CHROMA] == streams[3][3]):
                raise AssertionError(f"{what}: the margin or the capacity stop was not reached")
            batches, launches, points = batches + 1, launches + n, points + p
    log(f"phase 12 (a): kernel #10 == plain == kernel #9 stream by stream (tolerance 0: rows, scalars, live "
        f"history after every launch) over {batches} batches ((w, hop) in {WTW_SHAPES} x k_block in {K_BLOCKS} "
        f"and {WTW_EDGE_SHAPES} x k_block 8, and (w, hop, k_block) {wide}, x "
        f"a ragged B = 3 of references of different lengths, a B = 5 with a margin and a capacity stop, a shared "
        f"reference x 3; per-stream counts 0..k_block; 2 frozen launches after the last stop), {launches} "
        f"launches, {points} committed points, {time.perf_counter() - t0:.1f} s")
    return 0.0


def batched_tile_columns(spans, t: int):
    """The alternative to ``chroma_spans_tiled`` that phase 12 (b) times: every
    stream's tiles of CHROMA_TILE frames in ONE batched product a stage
    (``torch.bmm`` over B·t/8 tiles), (B, span) → (B, t, 12).  Its rows keep
    the per-stream tiles' bits only if the library runs each batch entry as
    the same 8-row product; phase 12 counts the streams where it does."""
    import torch

    from real_time_audio_sync_tpu_torch.features.chroma import CHROMA_TILE, frontend_constants

    b = spans.shape[0]
    win, dft_cos, dft_sin, fb_t = frontend_constants(4096, 22050, spans.dtype, device=spans.device)
    blocks = spans[:, : (t + 1) * 2048].reshape(b, t + 1, 2048)
    tiles = torch.cat([blocks[:, :-1], blocks[:, 1:]], dim=2).reshape(b * t // CHROMA_TILE, CHROMA_TILE, 4096)
    n = tiles.shape[0]
    wf = tiles * win
    re = torch.bmm(wf, dft_cos.expand(n, -1, -1))
    im = torch.bmm(wf, dft_sin.expand(n, -1, -1))
    raw = torch.bmm(re * re + im * im, fb_t.expand(n, -1, -1))
    norm = torch.sqrt(torch.sum(raw * raw, dim=2, keepdim=True))
    raw = raw / torch.where(norm < torch.finfo(raw.dtype).tiny, torch.ones_like(norm), norm)
    return raw.reshape(b, t, 12)


def frontend_forms(pcms, b: int, device, card: str, reps: int = 20) -> None:
    """Phase 12 (b)'s frontend at B streams: ``chroma_spans_tiled`` (the
    engine's) must give each stream's columns bit for bit as the solo
    engines' tiles do; the batched alternative is timed beside it and its
    equal streams counted (host wall with a synchronise, and CUDA events)."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.features.chroma import chroma_frames_tiled, chroma_spans_tiled, frame_span

    span = 7 * 2048 + 4096
    host = np.stack([pcms[i % 2][(i * 8 * 2048) % (len(pcms[i % 2]) - span):][:span] for i in range(b)])
    spans = torch.from_numpy(host.astype(np.float32)).to(device)
    got = chroma_spans_tiled(spans, 8)
    for i in range(b):
        if not torch.equal(got[i], chroma_frames_tiled(frame_span(spans[i], 8, 4096, 2048)).T):
            raise AssertionError(f"phase 12 (b): the frontend's columns of stream {i} of {b} differ from the "
                                 f"stream's tiles alone")
    equal = int(sum(torch.equal(x, y) for x, y in zip(batched_tile_columns(spans, 8), got)))
    times = []
    for fn in (lambda: chroma_spans_tiled(spans, 8), lambda: batched_tile_columns(spans, 8)):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(((time.perf_counter() - t0) * 1e3 / reps, start.elapsed_time(end) / reps))
    log(f"phase 12 (b) [{card}]: frontend of one dispatch at B = {b}, k_block 8: per-stream tiles (the engine's) "
        f"{times[0][0]:.3f} ms host wall, {times[0][1]:.3f} ms events, columns == each stream's tiles alone; one "
        f"batched product a stage {times[1][0]:.3f} ms wall, {times[1][1]:.3f} ms events, bit-equal on {equal} of "
        f"{b} streams ({reps} back to back each)")


def serve_wtw(ms, buffers, perf, hops: int) -> None:
    """Feed ``ms`` for ``hops`` hops: stream i follows performance
    ``perf[i]`` (``buffers[p]`` its 2048-sample buffers), joining at hop i,
    one buffer a hop until its performance ends; then flush."""
    for h in range(hops):
        ms.insert([buffers[p][h - i] if 0 <= h - i < len(buffers[p]) else None for i, p in enumerate(perf)])
    ms.flush()


def wtw_serving_run(ref_wav: str, buffers, perf, k_block: int, transfer: str, device, label: str):
    """One main-path run of ``FusedMultiStreamWTW`` (B = len(perf) on the
    shared reference ``ref_wav``, the live app's parameters), every WTW
    launch counter set to 0 just before and read just after; raises unless
    each dispatch was one launch of kernel #10 and none of kernel #9.
    Returns (engine, paths, launches, wall)."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.ops import wtw_insert
    from real_time_audio_sync_tpu_torch.parallel import FusedMultiStreamWTW

    b = len(perf)
    ms = FusedMultiStreamWTW([ref_wav] * b, LIVE_APP_WTW, k_block=k_block, transfer_dtype=transfer, device=device)
    sizes, dispatch = [], ms._dispatch

    def counted(ks):
        sizes.append(int(ks.max()))
        dispatch(ks)

    ms._dispatch = counted
    hops = b - 1 + max(len(x) for x in buffers)
    torch.cuda.synchronize()
    wtw_insert.launches = wtw_insert.multi_launches = 0
    t0 = time.perf_counter()
    serve_wtw(ms, buffers, perf, hops)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (wtw_insert.launches, wtw_insert.multi_launches)
    if counts != (0, len(sizes)) or not sizes:
        raise AssertionError(f"{label}: launches (kernel #9, kernel #10) {counts} for {len(sizes)} dispatches")
    pending, entries = pending_delta_bytes(ms), len(pending_deltas(ms))
    t1 = time.perf_counter()
    paths = ms.paths()
    drain_s = time.perf_counter() - t1
    audio = np.asarray([len(buffers[p]) * 2048 / 22050 for p in perf])
    st = ms._state
    dev_bytes = sum(x.numel() * x.element_size() for x in (st.ref, st.live, st.scalars)) // b
    log(f"{label}: B = {b}, k_block {k_block}, transfer_dtype={transfer!r}, {hops} hops; wall {wall:.3f} s; RTF per "
        f"stream {audio.mean() / wall:.2f} (mean; min {audio.min() / wall:.2f}), aggregate {audio.sum() / wall:.1f}; "
        f"host {wall / hops * 1e6:.1f} us a hop ({wall / hops / b * 1e6:.2f} us a stream-hop); {len(sizes)} "
        f"dispatches; launches read from the counters: {counts[1]} of kernel #10, {counts[0]} of kernel #9; "
        f"stopped {int(ms.stopped.sum())} of {b}")
    log(f"{label}: device bytes per stream {dev_bytes} (live history {st.live.shape[1]} x {st.live.shape[2]} float32, "
        f"the shared reference {st.ref.numel() * 4} B once); final paths() drained {entries} pending entries, "
        f"{pending} B ({pending / b:.0f} B per stream), in {drain_s:.3f} s")
    return ms, paths, counts[1], wall


def multi_wtw_bound(w: int, k: int, launches: int, windows: int, width: int, b: int):
    """(bound ms a launch, "bytes" or "operations") of B identical streams
    on one shared reference over ``launches`` launches that ran
    ``windows`` windows a stream: per stream what :func:`wtw_bound` counts
    but the reference window, plus its lens row; the reference window of
    each window step once (every stream reads the same rows)."""
    per_stream = launches * (2 * k * 48 + 2 * 16 * 4 + width * 4 + 12) + windows * w * 48
    bytes_ = b * per_stream + windows * w * 48
    ops = b * windows * (w * w * (27 + 8) + 2 * w * 24)
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3 / launches, ops / FP32_FLOPS * 1e3 / launches
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_wtw_multi_time(device, ref, cols, card: str):
    """Phase 12 (d): kernel #10 at (w, hop, B) in WTW_MULTI_TIMING, k_block 8,
    every stream on the main path's first launches' columns against the
    shared sonata_allegro reference: profiler device time a launch (window
    and append-only launches apart), CUDA events back to back, the bound,
    the waves; at B = 4 the plain version (host copies) from the same
    state, whose rows and states must equal the kernel's.  Returns
    {(w, hop, B): (dev_ms, event_ms, bound_ms, bound_by, window_ms,
    append_only_ms)} and the plain version's ms a launch."""
    import torch

    from real_time_audio_sync_tpu_torch.ops import _build, wtw_insert

    lib = _build.load("wtw_insert").lib
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    k, reps = 8, WTW_TIMED_LAUNCHES
    m = ref.shape[1]
    out = {}
    for w, hop, b in WTW_MULTI_TIMING + ((100, 50, WTW_MULTI_PLAIN_BATCH),):
        blocks = [cols[:, r * k : (r + 1) * k].T.expand(b, k, 12).contiguous() for r in range(reps)]
        lens = torch.tensor([[m, 2 * m, k]] * b, dtype=torch.int32, device=device)
        width = wtw_insert.delta_width(w, hop, k)
        rows = torch.empty((reps, b, width), dtype=torch.int32, device=device)

        def fresh():
            return wtw_insert.new_multi_state([ref] * b, [2 * m] * b)

        def launch(st, r):
            wtw_insert.multi_wtw_insert_block(st, blocks[r], lens, w, hop, k, rows[r])

        warm = fresh()
        for r in range(reps):
            launch(warm, r)
        if b == WTW_MULTI_PLAIN_BATCH:
            plain, plain_rows = clone_state(fresh(), "cpu"), torch.empty((reps, b, width), dtype=torch.int32)
            host_blocks, host_lens = [x.cpu() for x in blocks], lens.cpu()
            t0 = time.perf_counter()
            for r in range(reps):
                wtw_insert.multi_wtw_insert_block_reference(plain, host_blocks[r], host_lens, w, hop, k, plain_rows[r])
            plain_ms = (time.perf_counter() - t0) * 1e3 / reps
            torch.cuda.synchronize()
            for name, x, y in (("rows", rows, plain_rows), ("scalars", warm.scalars, plain.scalars),
                               ("live", warm.live, plain.live)):
                if not torch.equal(x.cpu(), y):
                    raise AssertionError(f"phase 12 (d) [B={b}]: kernel #10 and plain disagree on {name}")
            log(f"phase 12 (d) [{card}]: plain version at B = {b}, w = {w}: {plain_ms:.3f} ms a launch (host copies, "
                f"{reps} launches), rows and state == the kernel's")
            continue
        timed = fresh()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for r in range(reps):
            launch(timed, r)
        end.record()
        torch.cuda.synchronize()
        event_ms = start.elapsed_time(end) / reps
        if not torch.equal(timed.scalars, warm.scalars):
            raise AssertionError(f"phase 12 (d) [w={w} B={b}]: replays of the same launches disagree")
        traced = fresh()

        def traced_launch(r):
            nonlocal traced
            if r == 0:  # each trace replays the same launches from a fresh state
                traced = fresh()
            launch(traced, r)

        per_launch = kernel_launch_us(traced_launch, reps, "wtw_insert_kernel")
        dev_ms, n_traced = device_ms(per_launch)
        plens = [0] + rows[:, 0, 1].tolist()
        window_ms = idle_ms = None
        if len(per_launch) == reps:
            ran = [plens[r + 1] > plens[r] for r in range(reps)]
            window_ms = sum(t for t, x in zip(per_launch, ran) if x) / 1e3 / max(1, sum(ran))
            idle_ms = sum(t for t, x in zip(per_launch, ran) if not x) / 1e3 / max(1, reps - sum(ran))
        windows = int(warm.scalars[0, wtw_insert.WS_LIVE]) // hop
        bound_ms, bound_by = multi_wtw_bound(w, k, reps, windows, width, b)
        per_sm = lib.wtw_blocks_per_sm(w, 12)
        out[(w, hop, b)] = (dev_ms, event_ms, bound_ms, bound_by, window_ms, idle_ms)
        log(f"phase 12 (d) [{card}]: kernel #10, w = {w}, hop {hop}, k_block {k}, B = {b} "
            f"({-(-b // (per_sm * sms))} wave(s) of {per_sm * sms} blocks): "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} device time a launch (profiler, {n_traced} of "
            f"{reps} launches traced), {event_ms:.4f} ms (CUDA events, back to back); launches that ran a window "
            f"{'not measured' if window_ms is None else f'{window_ms:.4f} ms'}, that only appended "
            f"{'not measured' if idle_ms is None else f'{idle_ms:.4f} ms'}; {windows} windows a stream in {reps} "
            f"launches; bound {bound_ms:.7f} ms a launch by {bound_by}")
    return out, plain_ms


def phase_wtw_serving(device, root: str, card: str):
    """Phase 12 (b)–(d); returns the kernels-line row of
    wtw_multi_insert_block (its max_abs_err filled in by the caller) and
    its extra keys."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.eval import corpus, synthetic
    from real_time_audio_sync_tpu_torch.features.chroma import wav_to_chroma
    from real_time_audio_sync_tpu_torch.models import FusedWTW
    from real_time_audio_sync_tpu_torch.ops import wtw_insert
    from real_time_audio_sync_tpu_torch.parallel import FusedMultiStreamWTW
    from real_time_audio_sync_tpu_torch.utils.wavio import load_wav

    # (b) B listeners on one concert at the live app's widths
    t0 = time.perf_counter()
    d = os.path.join(root, "sonata_allegro")
    ref_wav = os.path.join(d, "sonata_allegro_00.wav")
    pcms = [load_wav(os.path.join(d, f"sonata_allegro_0{i}.wav"))[0] for i in (1, 2)]
    buffers = [[pcm[s : s + 2048] for s in range(0, len(pcm), 2048)] for pcm in pcms]
    b = WTW_SERVING_STREAMS
    perf = np.arange(b) % 2  # even streams follow _01, odd streams _02
    log(card)
    log(f"phase 12 (b): FusedMultiStreamWTW, shared reference sonata_allegro_00, {b} streams, even on _01 "
        f"({len(buffers[0])} buffers), odd on _02 ({len(buffers[1])}), stream i joins at hop i, w = 100, hop 50, "
        f"as fast as the host allows")
    ms, paths, launches, wall = wtw_serving_run(ref_wav, buffers, perf, 8, "float32", device, "phase 12 (b)")
    for p in (0, 1):
        if not paths[p] or not all(paths[i] == paths[p] for i in range(p, b, 2)):
            raise AssertionError(f"phase 12 (b): the {'even' if p == 0 else 'odd'} streams' paths differ")
    for i in (0, 1, b - 2, b - 1):
        solo = FusedWTW(ref_wav, LIVE_APP_WTW, device=device)
        for buf in buffers[perf[i]]:
            solo.insert(buf)
        solo.flush()
        if solo.path != paths[i] or solo.pointers != ms.pointers()[i]:
            raise AssertionError(f"phase 12 (b): stream {i} differs from a solo FusedWTW on the card fed the same")
    t1 = time.perf_counter()
    plain_path = plain_wtw_path(ref_wav, pcms[0], wtw_columns(pcms[0], device), ms._state.ref[0], WTW_PLAIN_HOPS)
    if len(plain_path) == 0 or not np.array_equal(plain_path, np.asarray(paths[0][: len(plain_path)])):
        raise AssertionError("phase 12 (b): stream 0's path does not begin with the CPU plain engine's")
    log(f"phase 12 (b): the even streams' paths all equal ({len(paths[0])} points), the odd streams' all equal "
        f"({len(paths[1])}); streams 0, 1, {b - 2}, {b - 1} == a solo FusedWTW on the card; stream 0 begins with "
        f"the CPU plain engine's {len(plain_path)} points over the first {WTW_PLAIN_HOPS} hops (a cut), "
        f"{time.perf_counter() - t1:.1f} s; {time.perf_counter() - t0:.1f} s into (b)")
    for n in WTW_FRONTEND_BATCHES:
        frontend_forms(pcms, n, device, card)
    log(f"phase 12 (b): {time.perf_counter() - t0:.1f} s into (b)")
    trace_ms = FusedMultiStreamWTW([ref_wav] * b, LIVE_APP_WTW, transfer_dtype="float32", device=device)
    trace_run(lambda: serve_wtw(trace_ms, buffers, perf, WTW_SERVING_TRACE_HOPS),
              f"phase 12 (b) [trace, first {WTW_SERVING_TRACE_HOPS} hops]")
    del trace_ms
    log(f"phase 12 (b): {time.perf_counter() - t0:.1f} s into (b)")
    kc = WTW_CHROMA_K_BLOCK
    ms32, paths32, _, _ = wtw_serving_run(ref_wav, buffers, perf, kc, "chroma", device, f"phase 12 (b) [k_block {kc}]")
    moved = [sum(x != y for x, y in zip(p, q)) + abs(len(p) - len(q)) for p, q in zip(paths32, paths)]
    log(f"phase 12 (b) [k_block {kc}, host chroma]: points that differ from the float32 path: stream 0 {moved[0]} of "
        f"{len(paths[0])}, stream 1 {moved[1]} of {len(paths[1])}, all streams {sum(moved)} of "
        f"{sum(len(p) for p in paths)} (host chroma moves points on held chords; not required equal)")
    del ms, ms32
    log(f"phase 12 (b): {time.perf_counter() - t0:.1f} s")

    # (c) the WTW corpus sweep: the full-scale corpus's 18 pairs as one run
    t2 = time.perf_counter()
    log(card)
    sweep_root = os.path.join(root, "wtw_sweep")  # the pieces alone, without the concert
    os.makedirs(sweep_root, exist_ok=True)
    for piece in synthetic.FULL_PIECES:
        os.symlink(os.path.join(root, piece), os.path.join(sweep_root, piece))
    corpus._FEAT_CACHE.clear()
    torch.cuda.synchronize()
    wtw_insert.launches = wtw_insert.multi_launches = 0
    t3 = time.perf_counter()
    report = corpus.CorpusRunner(sweep_root, "wtw", mode="fused", device=device).evaluate(verbose=False)
    torch.cuda.synchronize()
    sweep_wall = time.perf_counter() - t3
    sweep_launches = wtw_insert.multi_launches
    if wtw_insert.launches != 0 or sweep_launches == 0 or len(report.results) != len(corpus.corpus_pairs(sweep_root)):
        raise AssertionError(f"phase 12 (c): {len(report.results)} pairs, launches (kernel #9, kernel #10) "
                             f"({wtw_insert.launches}, {sweep_launches})")
    corpus._FEAT_CACHE.clear()
    solo_wall = 0.0
    for r in report.results:
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        solo = corpus.align_pair(r.ref_wav, r.live_wav, "wtw", mode="fused", device=device)
        torch.cuda.synchronize()
        solo_wall += time.perf_counter() - t4
        if len(r.path) == 0 or not np.array_equal(r.path, solo.path):
            raise AssertionError(f"phase 12 (c): {os.path.basename(r.live_wav)}: the sweep's path != solo align_pair")
    buckets = {t: float(np.mean([r.score.pct_off_beats[t] for r in report.results])) for t in (1, 3, 5, 10)}
    log(f"phase 12 (c) [{card}]: CorpusRunner(wtw, mode='fused') over {len(report.results)} pairs (w = 20, "
        f"B = {len(report.results)}, mixed references): wall {sweep_wall:.3f} s, {sweep_launches} launches of kernel "
        f"#10; the {len(report.results)} solo align_pair(wtw, fused) runs {solo_wall:.3f} s in all (memo cleared before "
        f"each); every "
        f"pair's path == solo; mean % of points > 1/3/5/10 beats off {buckets}, mean error (% > 3 s) "
        f"{report.mean_error:.3f}; {time.perf_counter() - t2:.1f} s")

    # (d) kernel #10's time
    ref = wav_to_chroma(ref_wav, np.float32, device=device)
    timing, plain_ms = phase_wtw_multi_time(device, ref, wtw_columns(pcms[0], device), card)
    dev_ms, event_ms, bound_ms, bound_by, window_ms, idle_ms = timing[(100, 50, WTW_SERVING_STREAMS)]
    row = (launches + sweep_launches, None, dev_ms, event_ms, plain_ms, bound_ms, bound_by)
    return row, {"batch": WTW_SERVING_STREAMS, "plain_batch": WTW_MULTI_PLAIN_BATCH, "window_ms": window_ms,
                 "append_only_ms": idle_ms, "serving_launches": launches, "sweep_launches": sweep_launches}


def no_kernel_launched(what: str, phase: str = "13") -> None:
    """The online tensor engines launch no hand-written kernel: raise unless
    the K-insert and set_live kernels' counters are still 0."""
    from real_time_audio_sync_tpu_torch.ops import otw_insert, otw_set_live

    counts = (otw_insert.launches, otw_insert.multi_launches, otw_set_live.launches)
    if any(counts):
        raise AssertionError(f"phase {phase} [{what}]: hand-written kernels launched {counts}")


def reset_kernel_counts() -> None:
    from real_time_audio_sync_tpu_torch.ops import otw_insert, otw_set_live

    otw_insert.launches = otw_insert.multi_launches = otw_set_live.launches = 0


def fused_path(ref, cols, band, variant: str, device):
    """Kernel #1's path on these columns (k_block 8), the comparison run."""
    from real_time_audio_sync_tpu_torch.models import FusedStreamingEngine
    from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES

    eng = FusedStreamingEngine(ref, band, ENGINE_OVERRIDES[variant], k_block=8, device=device)
    eng.insert_block_nowait(cols)
    eng.flush()
    return eng.path_array


def same_state_bits(card, cpu, what: str) -> None:
    """The card engine's path, live buffer and accumulator equal the CPU
    engine's bit for bit."""
    import numpy as np
    import torch

    if not np.array_equal(card.path_array, cpu.path_array):
        raise AssertionError(f"phase 13 [{what}]: the card's path differs from the CPU's")
    for name in ("live", "acc"):
        if not torch.equal(getattr(card.state, name).cpu(), getattr(cpu.state, name)):
            raise AssertionError(f"phase 13 [{what}]: the card's {name} bits differ from the CPU's")


def launches_a_hop(make_follower, buffers) -> float:
    """``cudaLaunchKernel`` calls a hop of a fresh follower over
    ``ONLINE_TRACE_HOPS`` buffers after a warm-up, from a profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    f = make_follower()
    f.start()
    for buf in buffers[:ONLINE_TRACE_WARMUP]:
        f.receive_audio(buf)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for buf in buffers[ONLINE_TRACE_WARMUP : ONLINE_TRACE_WARMUP + ONLINE_TRACE_HOPS]:
            f.receive_audio(buf)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel") / ONLINE_TRACE_HOPS


def cut_recording(wav: str, hops: int, out_dir: str) -> str:
    """The first ``hops`` hops of a recording (and its beat CSV up to
    there) as a recording of its own in ``out_dir``: a depth cut that the
    pair runners take like any pair."""
    from real_time_audio_sync_tpu_torch.utils.wavio import load_wav, write_wav

    pcm, fs = load_wav(wav)
    pcm = pcm[: (hops + 1) * 2048]
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, os.path.basename(wav)[:-4] + f"_first{hops}.wav")
    write_wav(out, pcm, fs)
    with open(wav[:-4] + ".csv") as src, open(out[:-4] + ".csv", "w") as dst:
        dst.writelines(line for line in src if line.strip() and float(line.split(",")[0]) < len(pcm) / fs)
    return out


def phase_online(device, root: str, card: str) -> None:
    """Phase 13 (module docstring).  Each part runs a prefix of the pair
    (``ONLINE_*`` hops): the tensor engine issues ~800 small launches a
    hop, 12-15 ms of host a hop on the H100 machine (PR 18)."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.eval import corpus, synthetic
    from real_time_audio_sync_tpu_torch.models import LiveNoteV2, OnlineTimeWarping
    from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES
    from real_time_audio_sync_tpu_torch.ops import otw_set_live
    from real_time_audio_sync_tpu_torch.parallel import MultiStreamFollower
    from real_time_audio_sync_tpu_torch.streaming.runtime import ScoreFollower
    from real_time_audio_sync_tpu_torch.utils.wavio import load_wav

    t_phase = time.perf_counter()
    part_s = {}

    def part_done(name, since):
        part_s[name] = time.perf_counter() - since
        return time.perf_counter()

    ref_wav, live_wav = render_piece(root)
    pcm, fs = load_wav(live_wav)
    buffers = [pcm[s : s + 2048] for s in range(0, len(pcm), 2048)]
    cols = hop_columns(buffers, device)  # the follower's columns, on the card
    ref = corpus._cached_chroma(ref_wav, np.float32, device)
    hops = ONLINE_HOPS

    t_part = part_done("setup", t_phase)

    # (a) OnlineTimeWarping through _streaming_path == kernel #1; its first
    # hops' state == the CPU engine's, bit for bit
    cpu = OnlineTimeWarping(ref.cpu(), PARAMS, device="cpu")
    t0 = time.perf_counter()
    corpus._streaming_path(cpu, cols[:, :ONLINE_CPU_HOPS].cpu())
    cpu_s = time.perf_counter() - t0
    reset_kernel_counts()
    eng = OnlineTimeWarping(ref, PARAMS, device=device)
    t0 = time.perf_counter()
    corpus._streaming_path(eng, cols[:, :ONLINE_CPU_HOPS])
    wall = time.perf_counter() - t0
    same_state_bits(eng, cpu, "a: otw")
    del cpu
    t0 = time.perf_counter()
    otw_path = np.asarray(corpus._streaming_path(eng, cols[:, ONLINE_CPU_HOPS:hops]))
    torch.cuda.synchronize()
    wall += time.perf_counter() - t0
    no_kernel_launched("a: otw")
    if len(otw_path) == 0 or not np.array_equal(otw_path, fused_path(ref, cols[:, :hops], PARAMS, "otw", device)):
        raise AssertionError(f"phase 13 [a: otw]: path ({otw_path.shape}) differs from kernel #1's")
    log(f"phase 13 (a) [otw]: the first {hops} of {cols.shape[1]} hops through _streaming_path in {wall:.3f} s "
        f"({1e3 * wall / hops:.2f} ms a hop; the CPU engine {1e3 * cpu_s / ONLINE_CPU_HOPS:.2f} ms); path "
        f"{len(otw_path)} points == FusedStreamingEngine (kernel #1) on those columns; first {ONLINE_CPU_HOPS} "
        f"hops: path, live and acc bits == the CPU engine's; no hand-written kernel launched")

    t_part = part_done("a otw", t_part)
    live_cut = cut_recording(live_wav, ONLINE_HOPS, os.path.join(root, "online_cut"))
    reset_kernel_counts()
    t0 = time.perf_counter()
    default = corpus.align_pair(ref_wav, live_cut, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    no_kernel_launched("a: align_pair default")
    ref_d = corpus._cached_chroma(ref_wav, np.float32, device, "chroma_diff")
    live_d = corpus._cached_chroma(live_cut, np.float32, device, "chroma_diff")
    if default.engine != "livenote_v2_diff" or len(default.path) == 0 or not np.array_equal(
            default.path, fused_path(ref_d, live_d, corpus.DEFAULT_PARAMS, "livenote_v2_diff", device)):
        raise AssertionError(f"phase 13 [a: {default.engine}]: the default align_pair's path differs from kernel #1's")
    card_d = LiveNoteV2(ref_d, corpus.DEFAULT_PARAMS, chroma_diff=True, device=device)
    cpu_d = LiveNoteV2(ref_d.cpu(), corpus.DEFAULT_PARAMS, chroma_diff=True, device="cpu")
    corpus._streaming_path(card_d, live_d[:, :ONLINE_CPU_HOPS])
    corpus._streaming_path(cpu_d, live_d[:, :ONLINE_CPU_HOPS].cpu())
    same_state_bits(card_d, cpu_d, "a: livenote_v2_diff")
    del card_d, cpu_d
    s = default.score
    log(f"phase 13 (a) [livenote_v2_diff]: align_pair(ref, live) (the default engine and insert mode) on _00 "
        f"against _01's first {ONLINE_HOPS} hops ({live_d.shape[1]} chroma-diff frames) in {wall:.3f} s; path "
        f"{len(default.path)} points == FusedStreamingEngine (kernel #1); first {ONLINE_CPU_HOPS} hops: path, "
        f"live and acc bits == the CPU engine's; PathScorer pct_off_beats {s.pct_off_beats}, pct_off_3s "
        f"{s.pct_off_3s}")

    t_part = part_done("a livenote_v2_diff", t_part)

    # (b) the follower's non-fused modes, each == (a)'s path on its hops
    fed = buffers[: ONLINE_MODE_HOPS + 1]  # the first buffer makes no hop
    audio_s = sum(len(b) for b in fed) / fs
    modes = (("sync", {}), ("use_blocks", {"use_blocks": True}), ("pipelined", {"pipelined": True}))
    for mode, kw in modes:
        follower = ScoreFollower(ref_wav, "otw", PARAMS, **kw, device=device)
        torch.cuda.synchronize()
        reset_kernel_counts()
        t0, c0 = time.perf_counter(), time.process_time()
        follow(follower, fed)
        torch.cuda.synchronize()
        wall, host_s = time.perf_counter() - t0, time.process_time() - c0
        no_kernel_launched(f"b: {mode}")
        path = np.asarray(follower.path)
        n_hops = follower.engine._frames_dispatched
        if n_hops != ONLINE_MODE_HOPS or len(path) == 0 or not np.array_equal(path, otw_path[: len(path)]):
            raise AssertionError(f"phase 13 [b: {mode}]: {n_hops} hops, path ({len(path)} points) differs from (a)'s")
        log(f"phase 13 (b) [{mode}]: the first {n_hops} hops ({audio_s:.1f} s audio) in {wall:.3f} s: RTF "
            f"{audio_s / wall:.1f}, wall {1e6 * wall / n_hops:.0f} us a hop, host CPU {1e6 * host_s / n_hops:.0f} us "
            f"a hop; path {len(path)} points == (a)'s")

    t_part = part_done("b", t_part)

    # (c) set_live on the pair's first seconds == kernel #2
    eng = OnlineTimeWarping(ref[:, :ONLINE_SET_LIVE_FRAMES], PARAMS, device=device)
    live_part = cols[:, :ONLINE_SET_LIVE_FRAMES]
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    eng.set_live(live_part)
    got = eng.path
    wall = time.perf_counter() - t0
    no_kernel_launched("c: set_live")
    want = otw_set_live.pallas_set_live(ref[:, :ONLINE_SET_LIVE_FRAMES], live_part, PARAMS, **ENGINE_OVERRIDES["otw"],
                                        device=device)[0]
    if len(got) == 0 or not np.array_equal(got, np.asarray(want)):
        raise AssertionError(f"phase 13 [c]: set_live's path ({len(got)} points) differs from kernel #2's")
    steps = 2 * ONLINE_SET_LIVE_FRAMES
    log(f"phase 13 (c): OnlineTimeWarping.set_live on the first {ONLINE_SET_LIVE_FRAMES} frames of both recordings "
        f"({steps} steps issued) in {wall:.3f} s ({1e3 * wall / steps:.2f} ms a step); path {len(got)} points == "
        f"pallas_set_live (kernel #2)")

    t_part = part_done("c", t_part)

    # (d) B = 18 streams on their own references, one column each a hop
    pairs = [p for p in corpus.corpus_pairs(root) if os.path.basename(os.path.dirname(p[0])) in synthetic.FULL_PIECES]
    refs = [corpus._cached_chroma(r, np.float32, device) for r, _ in pairs]
    lives = [corpus._cached_chroma(live, np.float32, device) for _, live in pairs]
    n_hops = ONLINE_MULTI_HOPS
    batch = torch.stack([x[:, :n_hops] for x in lives])
    torch.cuda.reset_peak_memory_stats()
    ms = MultiStreamFollower(refs, PARAMS, device=device)
    state_bytes = sum(x.numel() * x.element_size() for x in ms.states) + ms.refs.numel() * ms.refs.element_size()
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    for h in range(n_hops):
        ms.insert(batch[:, :, h])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    no_kernel_launched("d: MultiStreamFollower")
    paths = ms.paths()
    for k in (int(np.argmin(ms.ref_lens)), int(np.argmax(ms.ref_lens))):
        solo = OnlineTimeWarping(refs[k], PARAMS, device=device)
        if not np.array_equal(np.asarray(corpus._streaming_path(solo, batch[k])), paths[k]):
            raise AssertionError(f"phase 13 [d]: stream {k} ({ms.ref_lens[k]} ref frames) differs from its solo engine")
    log(f"phase 13 (d): MultiStreamFollower, B = {ms.b} (the sweep's pairs), references of {ms.ref_lens.min()}-"
        f"{ms.ref_lens.max()} frames (n_max {ms.refs.shape[2]}): {n_hops} hops in {wall:.3f} s "
        f"({1e3 * wall / n_hops:.2f} ms a hop, {1e3 * wall / n_hops / ms.b:.3f} ms a stream a hop); state on the card "
        f"{state_bytes / 2**30:.3f} GiB (peak allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB); the "
        f"shortest and the longest reference's streams == their solo engines")
    del ms, batch
    t_part = part_done("d", t_part)

    # launches a hop of each follower mode, from a trace of a prefix
    for mode, kw in modes:
        per_hop = launches_a_hop(lambda: ScoreFollower(ref_wav, "otw", PARAMS, **kw, device=device), buffers)
        log(f"phase 13 (b) [{mode}]: {per_hop:.1f} cudaLaunchKernel a hop (profiler, {ONLINE_TRACE_HOPS} hops "
            f"after {ONLINE_TRACE_WARMUP})")
    part_done("traces", t_part)
    log("phase 13: seconds a part: " + ", ".join(f"{k} {v:.1f}" for k, v in part_s.items()))
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s in all; {card}")



def batched_wavefront_bounds(b: int, w: int, itemsize: int, path_points: int):
    """(dp bound ms, by), (backtrack bound ms, by) of one batched launch over
    b (w, w) windows: the DP reads each cost once and writes acc and back
    (3 multiplies, 3 adds, 2 compares a cell); the backtrack reads the
    codes on the paths (``path_points`` of them in all) and writes the
    points and lengths (4 operations a step)."""
    out = []
    for bytes_, ops in ((b * w * w * (2 * itemsize + 1), b * w * w * 8),
                        (path_points + b * (2 * w - 1) * 8 + 4 * b, path_points * 4)):
        t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
        out.append((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))
    return out


def phase_async_batched(device, card: str):
    """Phase 14 (a): the DP and backtrack kernels over a batch of windows
    against B solo launches and the plain versions (tolerance 0), and the
    device time of one batched launch against B solo ones.  Returns the
    kernels-line numbers of both at (18, 100) float32 (launches filled in
    by the caller)."""
    import torch

    from real_time_audio_sync_tpu_torch.ops import wavefront as wf

    t0 = time.perf_counter()
    spec = wf.WTW_SPEC
    gen = torch.Generator(device=device).manual_seed(14)
    strips, resident = wavefront_strips(200, False, device)
    many = resident // strips + 8  # B x strips above what the card holds at once
    cases = [(b, w, torch.float32) for b, w in ASYNC_BATCHES] + [
        (*ASYNC_BATCH_F64, torch.float64), (many, 200, torch.float32)]
    worst = {"dp": 0.0, "bt": 0.0}
    rows = {}
    for b, w, dt in cases:
        what = f"phase 14 (a) B={b} w={w} {str(dt)[6:]}"
        cost = torch.rand((b, w, w), generator=gen, device=device, dtype=dt)
        cost[0] = 1.0  # a window of ties everywhere
        if b > 1:
            cost[1, 3:7, 2:9] = float("inf")  # and one with infinite cells
        acc, back = wf.wavefront_dp(cost, spec)
        pts, ln = wf.backtrack(back, spec)
        acc_p, back_p = wf.wavefront_dp_reference(cost, spec)
        pts_p, ln_p = wf.backtrack_reference(back, spec)
        singles = [cost[i].contiguous() for i in range(b)]
        solo = [wf.wavefront_dp(c, spec) for c in singles]
        solo_bt = [wf.backtrack(s[1], spec) for s in solo]
        torch.cuda.synchronize()
        for name, x, y in (("acc", acc, acc_p), ("back", back, back_p), ("points", pts, pts_p),
                           ("length", ln, ln_p)):
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: batched kernel and plain disagree on {name}")
        for i in range(b):
            if not (torch.equal(acc[i], solo[i][0]) and torch.equal(back[i], solo[i][1])
                    and torch.equal(pts[i], solo_bt[i][0]) and torch.equal(ln[i], solo_bt[i][1])):
                raise AssertionError(f"{what}: window {i} of the batch differs from its solo launch")
        worst["dp"] = max(worst["dp"], max_abs_diff(acc, acc_p))
        worst["bt"] = max(worst["bt"], max_abs_diff(pts, pts_p))
        # one batched launch against b solo launches: CUDA events (back to
        # back, wrappers included) and the profiler's device time
        ev_dp = time_calls(lambda: wf.wavefront_dp(cost, spec), 10)
        ev_dp_solo = time_calls(lambda: [wf.wavefront_dp(c, spec) for c in singles], 3, warmup=1)
        ev_bt = time_calls(lambda: wf.backtrack(back, spec), 10)
        ev_bt_solo = time_calls(lambda: [wf.backtrack(s[1], spec) for s in solo], 3, warmup=1)
        dev_dp, _ = kernel_device_ms(lambda r: wf.wavefront_dp(cost, spec), 5, "wavefront_dp_kernel")
        dev_bt, _ = kernel_device_ms(lambda r: wf.backtrack(back, spec), 5, "wavefront_backtrack_kernel")
        solo_dp_us = kernel_launch_us(lambda r: wf.wavefront_dp(singles[r], spec), b, "wavefront_dp_kernel")
        solo_bt_us = kernel_launch_us(lambda r: wf.backtrack(solo[r][1], spec), b, "wavefront_backtrack_kernel")
        fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"  # noqa: E731
        n_strips = b * -(-w // 64)
        log(f"{what}: batched == {b} solo launches == plain (acc, back, points, length); {n_strips} strips "
            f"({resident} resident at once); DP: one batched launch {fmt(dev_dp)} device (profiler), {ev_dp:.4f} ms "
            f"(events) against {b} solo launches {sum(solo_dp_us) / 1e3:.4f} ms device ({len(solo_dp_us)} traced), "
            f"{ev_dp_solo:.4f} ms (events); backtrack: {fmt(dev_bt)} / {ev_bt:.4f} ms against "
            f"{sum(solo_bt_us) / 1e3:.4f} / {ev_bt_solo:.4f} ms")
        if (b, w, dt) == (*ASYNC_BATCHES[1], torch.float32):
            plain_dp = time_calls(lambda: wf.wavefront_dp_reference(cost, spec), 2, warmup=1)
            plain_bt = time_calls(lambda: wf.backtrack_reference(back, spec), 2, warmup=1)
            (b_dp, by_dp), (b_bt, by_bt) = batched_wavefront_bounds(b, w, 4, int(ln.sum()))
            rows["wavefront_dp_batched"] = [None, 0.0, dev_dp, ev_dp, plain_dp, b_dp, by_dp,
                                            {"batch": b, "w": w, "solo_ms": sum(solo_dp_us) / 1e3,
                                             "solo_event_ms": ev_dp_solo}]
            rows["wavefront_backtrack_batched"] = [None, 0.0, dev_bt, ev_bt, plain_bt, b_bt, by_bt,
                                                   {"batch": b, "w": w, "solo_ms": sum(solo_bt_us) / 1e3,
                                                    "solo_event_ms": ev_bt_solo}]
            log(f"{what}: plain DP {plain_dp:.2f} ms, plain backtrack {plain_bt:.2f} ms (card tensors); bound DP "
                f"{b_dp:.7f} ms by {by_dp}, backtrack {b_bt:.7f} ms by {by_bt}")
    if many * strips <= resident:
        raise AssertionError(f"phase 14 (a): B={many} x {strips} strips is not more than the card holds")
    rows["wavefront_dp_batched"][1] = worst["dp"]
    rows["wavefront_backtrack_batched"][1] = worst["bt"]
    log(f"phase 14 (a) [{card}]: {len(cases)} batches equal; acc max |diff| {worst['dp']}, points max |diff| "
        f"{worst['bt']}; {time.perf_counter() - t0:.1f} s")
    return rows


def reset_batched_counts() -> None:
    from real_time_audio_sync_tpu_torch.ops import wavefront

    wavefront.dp_batched_launches = wavefront.backtrack_batched_launches = 0


def batched_counts(what: str, windows: int):
    """The batched wavefront kernels' counters, read after a main-path run:
    raises unless both launched, once each a window slot (at least one
    slot a window's stream, and never more slots than windows)."""
    from real_time_audio_sync_tpu_torch.ops import wavefront

    counts = (wavefront.dp_batched_launches, wavefront.backtrack_batched_launches)
    if counts[0] == 0 or counts[0] != counts[1] or windows <= 0:
        raise AssertionError(f"{what}: batched DP/backtrack launches {counts}, {windows} windows")
    return counts[0]


def async_trace(follower, buffers, label: str, hop: int):
    """A profiler trace of a warm follower over ``buffers``: cudaLaunchKernel
    a hop, the wavefront kernels' device ms a window, the device's idle
    share of the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    lp0 = follower.dtw.pointers[1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for buf in buffers:
            follower.receive_audio(buf)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    windows = (follower.dtw.pointers[1] - lp0) // hop
    avgs = prof.key_averages()
    for e in sorted(avgs, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        log(f"{label}: host {e.self_cpu_time_total / 1e3:8.1f} ms  x{e.count:6d}  {e.key[:80]}")
    calls = sum(e.count for e in avgs if e.key == "cudaLaunchKernel")
    dev = sum(e.self_device_time_total for e in avgs)
    dp = sum(e.self_device_time_total for e in avgs if "wavefront_dp_kernel" in e.key)
    bt = sum(e.self_device_time_total for e in avgs if "wavefront_backtrack_kernel" in e.key)
    per_win = (lambda us: f"{us / 1e3 / windows:.4f} ms" if windows else "not measured")  # noqa: E731
    log(f"{label}: {len(buffers)} hops traced, {windows} windows: {calls / len(buffers):.1f} cudaLaunchKernel a "
        f"hop; DP {per_win(dp)} and backtrack {per_win(bt)} device a window; device busy {dev / 1e6:.4f} s of "
        f"{wall:.3f} s, idle {100 - 100 * dev / (wall * 1e6):.1f} %")
    return {"launch_calls_a_hop": calls / len(buffers), "dp_ms_a_window": dp / 1e3 / windows if windows else None,
            "backtrack_ms_a_window": bt / 1e3 / windows if windows else None,
            "idle_pct": 100 - 100 * dev / (wall * 1e6)}


def phase_async_follower(device, root: str, card: str):
    """Phase 14 (b) and (c); returns the batched launches of their main
    paths and (b)'s figures."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.models import WTW, AsyncWTW
    from real_time_audio_sync_tpu_torch.streaming.runtime import WTWFollower
    from real_time_audio_sync_tpu_torch.utils.wavio import load_wav

    t0 = time.perf_counter()
    d = os.path.join(root, "sonata_allegro")
    ref_wav, live_wav = (os.path.join(d, f"sonata_allegro_0{i}.wav") for i in (0, 1))
    pcm, fs = load_wav(live_wav)
    buffers = [pcm[s : s + 2048] for s in range(0, len(pcm), 2048)]
    audio_s, hops = len(pcm) / fs, (len(pcm) - 4096) // 2048 + 1

    # (b) the live app's follower on AsyncWTW, the insert loop under the sync check
    follower = WTWFollower(ref_wav, live_wav, LIVE_APP_WTW, engine="wtw_async", device=device)
    eng = follower.dtw
    w, hop, k = eng._w, eng._hop_frames, eng.k_block
    follower.start()
    torch.cuda.synchronize()
    reset_batched_counts()
    t1 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")  # a host read of a device value in the loop raises
    try:
        for buf in buffers:
            follower.receive_audio(buf)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    loop_s = time.perf_counter() - t1
    follower.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    windows = eng.pointers[1] // hop  # each window advances live_ptr by exactly hop_frames
    follow_launches = batched_counts("phase 14 (b)", windows)
    path = [tuple(p) for p in follower.path]
    fused = WTWFollower(ref_wav, live_wav, LIVE_APP_WTW, engine="wtw_fused", device=device)
    follow(fused, buffers)
    host = WTW(ref_wav, LIVE_APP_WTW, device=device)
    for buf in buffers:
        if host.insert(buf) == "stop":
            break
    if not path or path != [tuple(p) for p in fused.path] or path != host.path:
        raise AssertionError("phase 14 (b): the AsyncWTW follower's path differs from the fused follower's or "
                             "the host WTW engine's")
    if eng.pointers != fused.dtw.pointers:
        raise AssertionError("phase 14 (b): AsyncWTW's pointers differ from FusedWTW's")
    log(f"phase 14 (b) [{card}]: WTWFollower(engine='wtw_async', w={w}, hop={hop}, k_block={k}) on sonata_allegro "
        f"_01 ({hops} hops, {audio_s:.1f} s) vs _00 ({eng.M} frames): wall {wall:.3f} s, real-time factor "
        f"{audio_s / wall:.1f}, host {loop_s / hops * 1e6:.1f} us a hop (the insert loop, no synchronization: "
        f"sync debug mode 'error'), {windows} windows, {follow_launches} batched DP and backtrack launches, "
        f"{len(path)} points == WTWFollower(engine='wtw_fused') (kernel #9) == the host WTW engine on the card")
    traced = WTWFollower(ref_wav, live_wav, LIVE_APP_WTW, engine="wtw_async", device=device)
    traced.start()
    for buf in buffers[:ASYNC_TRACE_WARMUP]:
        traced.receive_audio(buf)
    torch.cuda.synchronize()
    figures = async_trace(traced, buffers[ASYNC_TRACE_WARMUP : ASYNC_TRACE_WARMUP + ASYNC_TRACE_BUFFERS],
                          f"phase 14 (b) [trace, {card}]", hop)
    traced.stop()
    figures.update(rtf=audio_s / wall, host_us_a_hop=loop_s / hops * 1e6, windows=windows)
    log(f"phase 14 (b): {time.perf_counter() - t0:.1f} s")

    # (c) above the fused kernel: w = 200, hop 100
    t2 = time.perf_counter()
    wide = AsyncWTW(ref_wav, ASYNC_WIDE, device=device)
    reset_batched_counts()
    t3 = time.perf_counter()
    for buf in buffers:
        wide.insert(buf)
    wide.flush()
    wide_wall = time.perf_counter() - t3
    wide_windows = wide.pointers[1] // wide._hop_frames
    wide_launches = batched_counts("phase 14 (c)", wide_windows)
    host = WTW(ref_wav, ASYNC_WIDE, device=device)
    for buf in buffers:
        if host.insert(buf) == "stop":
            break
    if not host.path or wide.path != host.path or wide.pointers[1:] != (host.live_ptr, host.ref_ptr):
        raise AssertionError("phase 14 (c): AsyncWTW at w = 200 differs from the host WTW engine on the card")
    log(f"phase 14 (c) [{card}]: AsyncWTW(w={wide._w}, hop={wide._hop_frames}) fed the same buffers: wall "
        f"{wide_wall:.3f} s, real-time factor {audio_s / wide_wall:.1f}, {wide_windows} windows, {wide_launches} "
        f"batched launches, {len(host.path)} points == the host WTW engine on the card")
    # float64 on the card against the CPU on a prefix: the host frontend's
    # columns (the same bits on both) and the card's reference rows
    kw = {"dtype": np.float64, "transfer_dtype": "chroma"}
    card64 = AsyncWTW(ref_wav, ASYNC_WIDE, device=device, **kw)
    cpu64 = AsyncWTW(ref_wav, ASYNC_WIDE, device="cpu", **kw)
    cpu64._stepper.ref.copy_(card64._stepper.ref.cpu())
    for e in (card64, cpu64):
        for buf in buffers[:ASYNC_F64_HOPS]:
            e.insert(buf)
        e.flush()
    cp = card64.pointers[0]
    if (not card64.path or card64.path != cpu64.path or card64.pointers != cpu64.pointers
            or not np.array_equal(card64.chroma_live[:, :cp], cpu64.chroma_live[:, :cp])):
        raise AssertionError("phase 14 (c): float64 AsyncWTW on the card differs from its CPU run")
    log(f"phase 14 (c): float64 AsyncWTW on the card == the CPU run over the first {ASYNC_F64_HOPS} hops (a cut): "
        f"{len(cpu64.path)} points, pointers {cpu64.pointers}, live chroma up to chroma_ptr; "
        f"{time.perf_counter() - t2:.1f} s")
    return follow_launches + wide_launches, figures


def phase_async_corpus(device, root: str, card: str):
    """Phase 14 (d) and (e); returns the batched launches of their main
    paths and (e)'s figures."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.eval import corpus, synthetic
    from real_time_audio_sync_tpu_torch.parallel import FusedMultiStreamWTW, MultiStreamWTW, wtw_serving

    # (d) the harness's insert mode at w = 20 on the piece's three pairs, each
    # recording cut to its first ASYNC_CUT_HOPS hops
    t0 = time.perf_counter()
    d = os.path.join(root, "sonata_allegro")
    cut_root = os.path.join(root, "async_cut")
    for name in sorted(f for f in os.listdir(d) if f.endswith(".wav")):
        cut_recording(os.path.join(d, name), ASYNC_CUT_HOPS, os.path.join(cut_root, "sonata_allegro"))
    launches = 0
    for ref_p, live_p in corpus.corpus_pairs(cut_root):
        reset_batched_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = corpus.align_pair(ref_p, live_p, "wtw", mode="insert", device=device)
        torch.cuda.synchronize()
        pair_wall = time.perf_counter() - t1
        n = batched_counts("phase 14 (d)", len(got.path))
        launches += n
        for mode in ("oracle", "fused"):
            if not np.array_equal(got.path, corpus.align_pair(ref_p, live_p, "wtw", mode=mode, device=device).path):
                raise AssertionError(f"phase 14 (d): {os.path.basename(live_p)}: insert mode != mode={mode!r}")
        log(f"phase 14 (d) [{card}]: {os.path.basename(ref_p)} vs {os.path.basename(live_p)}: align_pair(wtw, "
            f"insert) wall {pair_wall:.3f} s, {n} batched launches, {len(got.path)} points == oracle == fused")
    log(f"phase 14 (d): {time.perf_counter() - t0:.1f} s")

    # (e) the 18-pair sweep at w = 200: one MultiStreamWTW; every recording
    # of the full-scale corpus cut to its first ASYNC_CUT_HOPS hops
    t2 = time.perf_counter()
    sweep_root = os.path.join(root, "wtw_sweep_cut")
    for piece in synthetic.FULL_PIECES:
        src = os.path.join(root, piece)
        for name in sorted(os.listdir(src)):
            if name.endswith(".wav"):
                cut_recording(os.path.join(src, name), ASYNC_CUT_HOPS, os.path.join(sweep_root, piece))
    pairs = corpus.corpus_pairs(sweep_root)
    dispatches = []
    original = wtw_serving.MultiStreamWTW._dispatch

    def counting(self, ks):
        dispatches.append(int((ks > 0).sum()))
        return original(self, ks)

    corpus._FEAT_CACHE.clear()
    wtw_serving.MultiStreamWTW._dispatch = counting
    try:
        torch.cuda.synchronize()
        reset_batched_counts()
        t3 = time.perf_counter()
        report = corpus.CorpusRunner(sweep_root, "wtw", ASYNC_WIDE, mode="fused", device=device).evaluate(
            verbose=False)
        torch.cuda.synchronize()
        sweep_wall = time.perf_counter() - t3
    finally:
        wtw_serving.MultiStreamWTW._dispatch = original
    n = batched_counts("phase 14 (e)", len(dispatches))
    launches += n
    if len(report.results) != len(pairs) or not dispatches:
        raise AssertionError(f"phase 14 (e): {len(report.results)} pairs, {len(dispatches)} dispatches")
    for r in report.results:
        solo = corpus.align_pair(r.ref_wav, r.live_wav, "wtw", ASYNC_WIDE, mode="fused", device=device)
        if len(r.path) == 0 or not np.array_equal(r.path, solo.path):
            raise AssertionError(f"phase 14 (e): {os.path.basename(r.live_wav)}: the sweep's path != solo AsyncWTW")
    log(f"phase 14 (e) [{card}]: CorpusRunner(wtw, mode='fused', w=200, hop=100) over {len(pairs)} pairs (each "
        f"recording's first {ASYNC_CUT_HOPS} hops, a cut): one "
        f"MultiStreamWTW (B = {len(pairs)}), wall {sweep_wall:.3f} s, {len(dispatches)} dispatches, "
        f"{sweep_wall / len(dispatches) * 1e3:.3f} ms a dispatch, {n} batched DP and backtrack launches (a window "
        f"slot each); every stream == its solo AsyncWTW (align_pair); {time.perf_counter() - t2:.1f} s")

    # the same streams at w = 20 against FusedMultiStreamWTW (kernel #10),
    # fed the harness's chunks directly
    chunks = [np.array_split(corpus._cached("audio", live, np.float64, device), 4096) for _, live in pairs]
    refs = [ref for ref, _ in pairs]
    engines = (MultiStreamWTW(refs, corpus.DEFAULT_WTW_PARAMS, transfer_dtype="float32", device=device),
               FusedMultiStreamWTW(refs, corpus.DEFAULT_WTW_PARAMS, transfer_dtype="float32", device=device))
    walls = []
    for ms in engines:
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for t in range(max(len(c) for c in chunks)):
            ms.insert([c[t] if t < len(c) else None for c in chunks])
        ms.flush()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t4)
    if engines[0].paths() != engines[1].paths() or engines[0].pointers() != engines[1].pointers():
        raise AssertionError("phase 14 (e): MultiStreamWTW at w = 20 differs from FusedMultiStreamWTW")
    bytes_a_stream = engines[0]._stepper.device_bytes() / len(pairs)
    # cudaLaunchKernel a dispatch over a traced slice of a fresh engine
    from torch.profiler import ProfilerActivity, profile

    ms = MultiStreamWTW(refs, ASYNC_WIDE, transfer_dtype="float32", device=device)
    count = []
    ms._dispatch = lambda ks, _d=ms._dispatch: count.append(1) or _d(ks)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(ASYNC_SWEEP_TRACE_CHUNKS):
            ms.insert([c[t] if t < len(c) else None for c in chunks])
        torch.cuda.synchronize()
    calls = sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel")
    log(f"phase 14 (e) [{card}]: at w = 20, B = {len(pairs)}: MultiStreamWTW == FusedMultiStreamWTW stream by "
        f"stream (paths, pointers), walls {walls[0]:.3f} s and {walls[1]:.3f} s; {bytes_a_stream / 2**20:.3f} MiB "
        f"of device state a stream (the references once); at w = 200, {calls / max(1, len(count)):.0f} "
        f"cudaLaunchKernel a dispatch ({len(count)} dispatches traced)")
    return launches, {"sweep_ms_a_dispatch": sweep_wall / len(dispatches) * 1e3, "sweep_dispatches": len(dispatches),
                      "bytes_a_stream": bytes_a_stream}


def field_log_path(log_dir: str):
    """The path of the one field log in ``log_dir``."""
    from real_time_audio_sync_tpu_torch.eval.logs import parse_field_log

    (name,) = [n for n in os.listdir(log_dir) if n.endswith(".txt")]
    return parse_field_log(os.path.join(log_dir, name)).path


def phase_app(device, root: str, card: str) -> dict:
    """Phase 15 (a): the live app on the card, as a user runs it."""
    import torch

    from real_time_audio_sync_tpu_torch.ops import wavefront
    from real_time_audio_sync_tpu_torch.streaming.app import follow_live

    out = os.path.join(root, "phase15")
    ref_wav = os.path.join(root, "sonata_allegro", "sonata_allegro_00.wav")
    live_wav = cut_recording(os.path.join(root, "sonata_allegro", "sonata_allegro_01.wav"), APP_HOPS, out)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "real_time_audio_sync_tpu_torch.streaming", "--ref", ref_wav,
                           "--live", live_wav, "--engine", "otw", "--log-dir", os.path.join(out, "app")],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=600)
    app_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 15 (a): the app exited {proc.returncode}: {proc.stderr[-3000:]}")
    app_path = field_log_path(os.path.join(out, "app"))
    reset_kernel_counts()
    t0 = time.perf_counter()
    f = follow_live(ref_wav, live_wav, engine="otw", log_dir=os.path.join(out, "otw"), quiet=True, device=device)
    torch.cuda.synchronize()
    otw_s = time.perf_counter() - t0
    no_kernel_launched("a: follow_live otw", phase="15")
    if field_log_path(os.path.join(out, "otw")) != app_path or len(app_path) < APP_HOPS // 2:
        raise AssertionError(f"phase 15 (a): the app's field log ({len(app_path)} points) != follow_live's")
    log(f"phase 15 (a) [{card}]: python -m real_time_audio_sync_tpu_torch.streaming --engine otw on _01's first "
        f"{APP_HOPS} hops against _00: {app_s:.1f} s as a process (start-up included), field log of "
        f"{len(app_path)} points == follow_live(device='cuda')'s ({otw_s:.2f} s, "
        f"{otw_s / APP_HOPS * 1e3:.2f} ms a hop, no hand-written kernel launched); mic {f.meter.db:.1f} dB")
    wavefront.dp_launches = wavefront.backtrack_launches = 0
    t0 = time.perf_counter()
    f = follow_live(ref_wav, live_wav, engine="wtw", log_dir=os.path.join(out, "wtw"), quiet=True, device=device)
    torch.cuda.synchronize()
    wtw_s = time.perf_counter() - t0
    launches = (wavefront.dp_launches, wavefront.backtrack_launches)
    path = field_log_path(os.path.join(out, "wtw"))
    if launches[0] == 0 or launches[0] != launches[1] or path != [tuple(int(v) for v in p) for p in f.path] or not path:
        raise AssertionError(f"phase 15 (a): --engine wtw launched {launches}, field log of {len(path)} points")
    log(f"phase 15 (a) [{card}]: follow_live(engine='wtw', device='cuda') (the host WTW, w = 100): {wtw_s:.2f} s, "
        f"{launches[0]} DP and {launches[1]} backtrack launches (kernels #7 and #8, one a window), field log of "
        f"{len(path)} points")
    return {"app_s": app_s, "app_points": len(app_path), "wtw_windows": launches[0]}


def resume_case(name: str, make, feed, result, n: int, half: int, save, load, counter, out: str) -> int:
    """Half a run, save, load into a fresh engine, run the rest: raise unless
    the result equals the uninterrupted run's, and, where ``counter`` reads
    the engine's kernel counter, unless the kernel launched after the load.
    Returns the launches after the load."""
    import torch

    whole = make()
    feed(whole, 0, n)
    want = result(whole)
    first = make()
    feed(first, 0, half)
    ckpt = os.path.join(out, f"{name}.npz")
    save(first, ckpt)
    resumed = make()
    load(resumed, ckpt)
    before = counter() if counter else 0
    feed(resumed, half, n)
    got = result(resumed)
    torch.cuda.synchronize()
    launched = counter() - before if counter else 0
    if got != want:
        raise AssertionError(f"phase 15 (b) [{name}]: the resumed run differs from the uninterrupted one")
    if counter and launched <= 0:
        raise AssertionError(f"phase 15 (b) [{name}]: the kernel did not launch after the load")
    return launched


def phase_checkpoints(device, root: str, card: str) -> dict:
    """Phase 15 (b): every checkpoint pair on the card; returns each
    kernel's launches after the loads."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.features.chroma import wav_to_chroma
    from real_time_audio_sync_tpu_torch.models import AsyncWTW, FusedStreamingEngine, FusedWTW, OnlineTimeWarping
    from real_time_audio_sync_tpu_torch.models.wtw import WTW
    from real_time_audio_sync_tpu_torch.ops import otw_insert, wavefront, wtw_insert
    from real_time_audio_sync_tpu_torch.parallel import FusedMultiStreamFollower, MultiStreamWTW
    from real_time_audio_sync_tpu_torch.utils import checkpoint as ck
    from real_time_audio_sync_tpu_torch.utils.wavio import load_wav

    out = os.path.join(root, "phase15", "checkpoints")
    os.makedirs(out, exist_ok=True)
    piece = os.path.join(root, "sonata_allegro", "sonata_allegro_0")
    ref_wav = piece + "0.wav"
    ref = wav_to_chroma(ref_wav, device=device)
    lives = [wav_to_chroma(piece + f"{i}.wav", device=device)[:, : 2 * RESUME_HALF] for i in (1, 2)]
    host_lives = [x.T.cpu().numpy() for x in lives]
    pcms = [load_wav(piece + f"{i}.wav")[0] for i in (1, 2)]
    n = min(2 * RESUME_HALF, *(x.shape[1] for x in lives))
    bufs = [[p[h * 2048 : (h + 1) * 2048] for h in range(n)] for p in pcms]

    def fused(long_ref):
        def feed(e, lo, hi):
            for s in range(lo, hi, 8):
                e.insert_block_nowait(lives[0][:, s : min(s + 8, hi)])
        return (lambda: FusedStreamingEngine(ref, PARAMS, k_block=8, long_ref=long_ref, device=device), feed,
                lambda e: (e.flush(), e.path_array.tolist())[1])

    def multi(long_ref):
        def feed(f, lo, hi):
            for t in range(lo, hi):
                act = np.arange(RESUME_STREAMS) <= t  # stream i joins at hop i
                f.feed(np.stack([host_lives[i % 2][t - i if t >= i else 0] for i in range(RESUME_STREAMS)]), act)
        return (lambda: FusedMultiStreamFollower(ref, PARAMS, RESUME_STREAMS, k_block=8, long_ref=long_ref,
                                                 device=device), feed,
                lambda f: (f.flush(), [p.tolist() for p in f.paths()])[1])

    def solo_audio(e, lo, hi):
        for b in bufs[0][lo:hi]:
            e.insert(b)

    def wtw_result(e):
        if hasattr(e, "flush"):
            e.flush()
        ptrs = e.pointers if hasattr(e, "pointers") else (e.chroma_ptr, e.live_ptr, e.ref_ptr)
        return e.path, tuple(int(v) for v in ptrs)

    def multi_audio(m, lo, hi):
        for h in range(lo, hi):
            m.insert([bufs[i % 2][h] for i in range(RESUME_STREAMS)])

    def multi_wtw_result(m):
        m.flush()
        return [np.asarray(p).tolist() for p in m.paths()], m.pointers()

    def online_feed(e, lo, hi):
        for t in range(lo, hi):
            e.insert(lives[0][:, t])

    wtw_kw = {"transfer_dtype": "float32", "device": device}
    cases = {
        # name: (make, feed, result, steps, save, load, kernel, counter)
        "fused": (*fused(False), n, ck.save_fused_state, ck.load_fused_state, "otw_insert_block",
                  lambda: otw_insert.launches),
        "fused_long_ref": (*fused(True), n, ck.save_fused_state, ck.load_fused_state, "otw_insert_block_long",
                           lambda: otw_insert.delta_launches),
        "multi_windowed": (*multi(None), n, ck.save_multi_stream_state, ck.load_multi_stream_state,
                           "otw_multi_insert_block_long", lambda: otw_insert.multi_delta_launches),
        "multi_whole": (*multi(False), n, ck.save_multi_stream_state, ck.load_multi_stream_state,
                        "otw_multi_insert_block", lambda: otw_insert.multi_launches),
        "fused_wtw": (lambda: FusedWTW(ref_wav, LIVE_APP_WTW, k_block=8, **wtw_kw), solo_audio, wtw_result, n,
                      ck.save_fused_wtw_state, ck.load_fused_wtw_state, "wtw_insert_block",
                      lambda: wtw_insert.launches),
        "async_wtw": (lambda: AsyncWTW(ref_wav, LIVE_APP_WTW, k_block=8, **wtw_kw), solo_audio, wtw_result, n,
                      ck.save_async_wtw_state, ck.load_async_wtw_state, "wavefront_dp_batched",
                      lambda: wavefront.dp_batched_launches),
        "multi_wtw": (lambda: MultiStreamWTW([ref_wav] * RESUME_STREAMS, LIVE_APP_WTW, **wtw_kw), multi_audio,
                      multi_wtw_result, n,
                      ck.save_multi_wtw_state, ck.load_multi_wtw_state, "wavefront_backtrack_batched",
                      lambda: wavefront.backtrack_batched_launches),
        "wtw": (lambda: WTW(ref_wav, LIVE_APP_WTW, device=device), solo_audio, wtw_result, n, ck.save_wtw_state,
                ck.load_wtw_state, "wavefront_dp", lambda: wavefront.dp_launches),
        "otw": (lambda: OnlineTimeWarping(ref, PARAMS, device=device), online_feed,
                lambda e: e.path, RESUME_ONLINE_HOPS, ck.save_state, ck.load_state, None, None),
    }
    resumed = {}
    for name, (make, feed, result, steps, save, load, kernel, counter) in cases.items():
        t0 = time.perf_counter()
        half = steps // 2 // 8 * 8  # a whole number of 8-column launches before the save
        launched = resume_case(name, make, feed, result, steps, half, save, load, counter, out)
        if kernel:
            resumed[kernel] = resumed.get(kernel, 0) + launched
        log(f"phase 15 (b) [{card}]: {name}: saved after {half} of {steps} "
            f"steps, loaded into a fresh engine on the card, resumed == uninterrupted; {launched} launches of "
            f"{kernel or 'no hand-written kernel'} after the load; {time.perf_counter() - t0:.2f} s")
    # a checkpoint saved on the card resumes in a CPU engine (the plain version) to the same path
    ckpt = os.path.join(out, "fused_to_cpu.npz")
    whole = FusedStreamingEngine(ref, PARAMS, k_block=8, device=device)
    for s in range(0, RESUME_CPU_COLS, 8):
        whole.insert_block_nowait(lives[0][:, s : s + 8])
    whole.flush()
    card_eng = FusedStreamingEngine(ref, PARAMS, k_block=8, device=device)
    cut = RESUME_CPU_COLS - RESUME_CPU_TAIL
    card_eng.insert_block_nowait(lives[0][:, :cut])
    ck.save_fused_state(card_eng, ckpt)
    cpu = FusedStreamingEngine(ref.cpu(), PARAMS, k_block=8, device="cpu")
    ck.load_fused_state(cpu, ckpt)
    tail = lives[0][:, cut:RESUME_CPU_COLS].cpu()
    for s in range(0, tail.shape[1], 8):
        cpu.insert_block_nowait(tail[:, s : s + 8])
    cpu.flush()
    if not np.array_equal(cpu.path_array, whole.path_array):
        raise AssertionError("phase 15 (b): the card's checkpoint resumed on the CPU differs from the card's run")
    log(f"phase 15 (b) [{card}]: a FusedStreamingEngine checkpoint saved on the card after {cut} columns, resumed "
        f"in a device='cpu' engine (the plain version) for {RESUME_CPU_TAIL} more: path == the card's "
        f"({len(whole.path_array)} points)")
    return resumed


def phase_corpus_batch(device, root: str, card: str) -> int:
    """Phase 15 (c): ``parallel/corpus.batched_set_live`` over the 18-pair
    sweep's chroma (kernel #3, one launch), and its dense route; returns
    the kernel's launches."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.eval import corpus, synthetic
    from real_time_audio_sync_tpu_torch.ops import otw_set_live
    from real_time_audio_sync_tpu_torch.parallel import batched_set_live, pad_pairs

    # the sweep's 18 pairs (phase 9's concert recordings lie under root too)
    pairs = [p for p in corpus.corpus_pairs(root) if os.path.basename(os.path.dirname(p[0])) in synthetic.FULL_PIECES]
    refs = [corpus._cached_chroma(r, np.float32, device) for r, _ in pairs]
    lives = [corpus._cached_chroma(l, np.float32, device) for _, l in pairs]
    padded = pad_pairs([r.cpu().numpy() for r in refs], [l.cpu().numpy() for l in lives])
    torch.cuda.synchronize()
    otw_set_live.launches = 0
    t0 = time.perf_counter()
    paths, mean = batched_set_live(*padded, SWEEP_BAND, device=device)
    torch.cuda.synchronize()
    wall, launches = time.perf_counter() - t0, otw_set_live.launches
    want = otw_set_live.pallas_batched_set_live(refs, lives, SWEEP_BAND, device=device)
    if launches != 1 or len(paths) != len(pairs) or any(not np.array_equal(p, w[0]) for p, w in zip(paths, want)):
        raise AssertionError(f"phase 15 (c): batched_set_live made {launches} launches, paths != "
                             "pallas_batched_set_live's")
    if mean.device.type != torch.device(device).type or mean.dtype != torch.float32 or abs(float(mean) - np.mean([len(p) for p in paths])) > 1e-3:
        raise AssertionError(f"phase 15 (c): mean path length {mean}")
    log(f"phase 15 (c) [{card}]: batched_set_live over the {len(pairs)} sweep pairs (padded to "
        f"{padded[0].shape[2]} x {padded[1].shape[2]} frames): one launch of kernel #3, {wall:.3f} s with the "
        f"host copies, paths == pallas_batched_set_live's, mean path length {float(mean):.1f}")
    n, t = DENSE_FRAMES
    cut = pad_pairs([r[:, :n].cpu().numpy() for r in refs[:DENSE_PAIRS]],
                    [l[:, :t].cpu().numpy() for l in lives[:DENSE_PAIRS]])
    kernel, _ = batched_set_live(*cut, SWEEP_BAND, device=device)
    t0 = time.perf_counter()
    dense32, _ = batched_set_live(*cut, SWEEP_BAND, backend="dense", device=device)
    dense64, _ = batched_set_live(*cut, SWEEP_BAND, dtype=np.float64, device=device)
    dense_s = time.perf_counter() - t0
    cpu64, _ = batched_set_live(*cut, SWEEP_BAND, dtype=np.float64, device="cpu")
    same = [np.array_equal(a, b) for a, b in zip(dense32, kernel)]
    same64 = [np.array_equal(a, b) for a, b in zip(dense64, cpu64)]
    if not all(same) or not all(same64):
        raise AssertionError(f"phase 15 (c): dense float32 == kernel {same}, dense float64 card == CPU {same64}")
    agree = sum(np.array_equal(a, b) for a, b in zip(dense64, kernel))
    log(f"phase 15 (c) [{card}]: the dense route on {DENSE_PAIRS} pairs cut to {n} x {t} frames: float32 == the "
        f"kernel's paths, float64 on the card == float64 on the CPU, float64 == the float32 kernel on {agree} of "
        f"{DENSE_PAIRS} pairs; {dense_s:.2f} s for the two dense batches on the card")
    return launches


def mesh_of(device, n: int):
    """A mesh of the one card ``n`` times: n shards side by side on it
    (the port's stand-in for virtual devices; no run here covers more than
    one card)."""
    import numpy as np

    from real_time_audio_sync_tpu_torch.parallel.mesh import Mesh

    return Mesh(np.asarray([device] * n, dtype=object), ("data",))


def mesh_timed(run):
    """(result, wall seconds, host CPU seconds) of ``run()``, the card
    synchronized before and after."""
    import torch

    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), time.process_time()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, time.process_time() - c0


def mesh_serving(device, ref, lives, lens, perf, card: str) -> dict:
    """Phase 16 (a): ``FusedMultiStreamFollower`` at B = 256 unsharded, on
    ``corpus_mesh()`` and on 4 shards of the card, both layouts; returns
    the launches of #5 and #6 on the sharded runs."""
    import numpy as np

    from real_time_audio_sync_tpu_torch.ops import otw_insert
    from real_time_audio_sync_tpu_torch.parallel import FusedMultiStreamFollower, corpus_mesh

    b, hops = len(perf), MESH_SERVING_HOPS
    log(f"phase 16 (a) [{card}]: FusedMultiStreamFollower, B = {b} on the shared sonata_allegro_00, even streams "
        f"on _01, odd on _02, stream i joining at hop i; cut to the first {hops} hops of {b - 1 + int(lens.max())}")
    launches = {"otw_multi_insert_block_long": 0, "otw_multi_insert_block": 0}
    for long_ref in (True, False):
        name = "otw_multi_insert_block_long" if long_ref else "otw_multi_insert_block"
        runs = {}
        for label, mesh in (("unsharded", None), ("corpus_mesh()", corpus_mesh()), ("4 shards", mesh_of(device, 4)),
                            ("unsharded again", None)):  # the repeat: the spread of the unsharded wall
            fms = FusedMultiStreamFollower(ref, PARAMS, n_streams=b, k_block=8, long_ref=long_ref, mesh=mesh,
                                           device=device)
            otw_insert.launches = otw_insert.delta_launches = 0
            otw_insert.multi_launches = otw_insert.multi_delta_launches = 0
            _, wall, host = mesh_timed(lambda: serve(fms, lives, lens, perf, hops))
            counts = (otw_insert.launches, otw_insert.delta_launches, otw_insert.multi_launches,
                      otw_insert.multi_delta_launches)
            shards, dispatches = len(fms._shards), len(fms.dispatched_block_sizes)
            want = (0, 0, 0, shards * dispatches) if long_ref else (0, 0, shards * dispatches, 0)
            if counts != want or not dispatches:
                raise AssertionError(f"phase 16 (a) [{label}]: launches (solo, solo delta, batched, batched delta) "
                                     f"{counts}, want {want}")
            if mesh is not None:
                launches[name] += want[2] + want[3]
            runs[label] = (fms.paths(), fms.stopped.copy(), dispatches)
            log(f"phase 16 (a) [{'windowed' if long_ref else 'whole buffer'}, {label}]: {shards} shard(s), "
                f"{dispatches} dispatches, {want[2] + want[3]} launches of #{5 if long_ref else 6} read from the "
                f"counters (shards x dispatches); wall {wall:.3f} s, {wall / hops * 1e6:.1f} us a hop, host CPU "
                f"{host / hops * 1e6:.1f} us a hop")
        paths, stopped, dispatches = runs["unsharded"]
        for label in ("corpus_mesh()", "4 shards", "unsharded again"):
            got, got_stopped, got_dispatches = runs[label]
            if not equal_paths(got, paths) or not np.array_equal(got_stopped, stopped) or got_dispatches != dispatches:
                raise AssertionError(f"phase 16 (a) [{label}]: paths, stop masks or dispatches != unsharded")
        log(f"phase 16 (a) [{'windowed' if long_ref else 'whole buffer'}]: every stream's path == the unsharded "
            f"run's on both meshes ({sum(len(p) for p in paths)} points)")
    return launches


def mesh_wtw(device, root: str, card: str) -> dict:
    """Phase 16 (b): the WTW servers and ``MultiStreamFollower`` sharded on
    the card against their unsharded runs; returns the sharded launches of
    #10 and of #7/#8 over a batch."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.eval import corpus, synthetic
    from real_time_audio_sync_tpu_torch.ops import otw_insert, otw_set_live, wavefront, wtw_insert
    from real_time_audio_sync_tpu_torch.parallel import FusedMultiStreamWTW, MultiStreamFollower, MultiStreamWTW
    from real_time_audio_sync_tpu_torch.utils.wavio import load_wav

    launches = {}
    # FusedMultiStreamWTW, B = 64 at the live app's w = 100 (phase 12 (b)'s cell), 4 shards
    d = os.path.join(root, "sonata_allegro")
    ref_wav = os.path.join(d, "sonata_allegro_00.wav")
    pcms = [load_wav(os.path.join(d, f"sonata_allegro_0{i}.wav"))[0] for i in (1, 2)]
    buffers = [[pcm[s : s + 2048] for s in range(0, len(pcm), 2048)] for pcm in pcms]
    b, hops = WTW_SERVING_STREAMS, MESH_WTW_HOPS
    perf = np.arange(b) % 2
    runs = {}
    for label, mesh in (("unsharded", None), ("4 shards", mesh_of(device, 4)), ("unsharded again", None)):
        ms = FusedMultiStreamWTW([ref_wav] * b, LIVE_APP_WTW, k_block=8, transfer_dtype="float32", mesh=mesh,
                                 device=device)
        sizes, dispatch = [], ms._dispatch
        ms._dispatch = lambda ks, _d=dispatch: sizes.append(int(ks.max())) or _d(ks)
        wtw_insert.launches = wtw_insert.multi_launches = 0
        _, wall, host = mesh_timed(lambda: serve_wtw(ms, buffers, perf, hops))
        shards = len(ms._shards)
        if (wtw_insert.launches, wtw_insert.multi_launches) != (0, shards * len(sizes)) or not sizes:
            got = (wtw_insert.launches, wtw_insert.multi_launches)
            raise AssertionError(f"phase 16 (b) [{label}]: launches (#9, #10) {got}, want (0, {shards * len(sizes)})")
        if mesh is not None:
            launches["wtw_multi_insert_block"] = wtw_insert.multi_launches
        runs[label] = (ms.paths(), ms.pointers())
        log(f"phase 16 (b) [{card}] FusedMultiStreamWTW [{label}]: B = {b}, w = 100, the first {hops} hops (a cut), "
            f"{len(sizes)} dispatches, {wtw_insert.multi_launches} launches of #10 (shards x dispatches); wall "
            f"{wall:.3f} s, {wall / hops * 1e6:.1f} us a hop, host CPU {host / hops * 1e6:.1f} us a hop")
    if not runs["4 shards"] == runs["unsharded"] == runs["unsharded again"] or not any(runs["unsharded"][0]):
        raise AssertionError("phase 16 (b): FusedMultiStreamWTW on 4 shards != unsharded")

    # MultiStreamWTW at w = 200 over the 18 sweep pairs (phase 14 (e)'s cell), 2 shards
    pairs = [p for p in corpus.corpus_pairs(root) if os.path.basename(os.path.dirname(p[0])) in synthetic.FULL_PIECES]
    live_bufs = []
    for _, live in pairs:
        pcm = load_wav(live)[0]
        live_bufs.append([pcm[s : s + 2048] for s in range(0, min(len(pcm), hops * 2048), 2048)])
    runs = {}
    for label, mesh in (("unsharded", None), ("2 shards", mesh_of(device, 2)), ("unsharded again", None)):
        ms = MultiStreamWTW([r for r, _ in pairs], ASYNC_WIDE, transfer_dtype="float32", mesh=mesh, device=device)
        slots = []

        def tally(plan):
            def counted(ks):
                out = plan(ks)
                slots.append(sum(1 for c in out[4] if c))  # a slot with a due window: one launch each of #7, #8
                return out
            return counted

        for sh in ms._shards:
            sh.state.plan = tally(sh.state.plan)
        wavefront.dp_batched_launches = wavefront.backtrack_batched_launches = 0
        _, wall, host = mesh_timed(lambda: serve_wtw(ms, live_bufs, range(len(pairs)), hops))
        got = (wavefront.dp_batched_launches, wavefront.backtrack_batched_launches)
        if got != (sum(slots), sum(slots)) or not sum(slots):
            raise AssertionError(f"phase 16 (b) [{label}]: batched DP and backtrack launches {got}, want "
                                 f"{sum(slots)} each (the shards' slots with due windows)")
        if mesh is not None:
            launches["wavefront_dp_batched"] = launches["wavefront_backtrack_batched"] = sum(slots)
        runs[label] = (ms.paths(), ms.pointers())
        log(f"phase 16 (b) [{card}] MultiStreamWTW [{label}]: the {len(pairs)} sweep pairs at w = 200, each stream "
            f"i joining at hop i, the first {hops} hops (a cut), {sum(slots)} batched launches each of #7 and #8 "
            f"(a shard's slot with a due window each); wall {wall:.3f} s, host CPU {host / hops * 1e6:.1f} us a hop")
    if not runs["2 shards"] == runs["unsharded"] == runs["unsharded again"] or not any(runs["unsharded"][0]):
        raise AssertionError("phase 16 (b): MultiStreamWTW on 2 shards != unsharded")

    # MultiStreamFollower at B = 8 on sweep pairs, 2 shards (the tensor engine: no hand-written kernel)
    refs = [corpus._cached_chroma(r, np.float32, device) for r, _ in pairs[:MESH_ONLINE_STREAMS]]
    lives = [corpus._cached_chroma(l, np.float32, device) for _, l in pairs[:MESH_ONLINE_STREAMS]]
    cols = torch.stack([l[:, :MESH_ONLINE_HOPS] for l in lives]).permute(2, 0, 1).contiguous()  # (hops, B, 12)
    runs = {}
    for label, mesh in (("unsharded", None), ("2 shards", mesh_of(device, 2)), ("unsharded again", None)):
        ms = MultiStreamFollower(refs, PARAMS, mesh=mesh, device=device)
        otw_insert.launches = otw_insert.multi_launches = otw_set_live.launches = 0
        _, wall, host = mesh_timed(lambda: [ms.insert(c) for c in cols])
        if (otw_insert.launches, otw_insert.multi_launches, otw_set_live.launches) != (0, 0, 0):
            raise AssertionError(f"phase 16 (b) [{label}]: a band kernel launched under the tensor engine")
        runs[label] = (ms.paths(), ms.stopped, ms.pointers())
        log(f"phase 16 (b) [{card}] MultiStreamFollower [{label}]: B = {len(refs)}, {MESH_ONLINE_HOPS} hops (a cut), "
            f"wall {wall:.3f} s, {wall / MESH_ONLINE_HOPS * 1e3:.2f} ms a hop, host CPU "
            f"{host / MESH_ONLINE_HOPS * 1e3:.2f} ms a hop")
    p0, s0, q0 = runs["unsharded"]
    for label in ("2 shards", "unsharded again"):
        p1, s1, q1 = runs[label]
        if (not equal_paths(p0, p1) or not np.array_equal(s0, s1)
                or any(not np.array_equal(a, c) for a, c in zip(q0, q1))):
            raise AssertionError(f"phase 16 (b): MultiStreamFollower [{label}] != unsharded")
    log("phase 16 (b): every sharded run == its unsharded run, stream for stream (paths, pointers, stop masks)")
    return launches


def mesh_corpus_and_frontend(device, root: str, card: str) -> int:
    """Phase 16 (c) and (d); returns the sharded launches of #3."""
    import numpy as np
    import torch

    from real_time_audio_sync_tpu_torch.eval import corpus, synthetic
    from real_time_audio_sync_tpu_torch.features.chroma import chroma_frames, frame_span, num_frames
    from real_time_audio_sync_tpu_torch.ops import otw_set_live
    from real_time_audio_sync_tpu_torch.parallel import batched_set_live, pad_pairs, sharded_chroma_frames
    from real_time_audio_sync_tpu_torch.utils.wavio import load_wav

    pairs = [p for p in corpus.corpus_pairs(root) if os.path.basename(os.path.dirname(p[0])) in synthetic.FULL_PIECES]
    padded = pad_pairs([corpus._cached_chroma(r, np.float32, device).cpu().numpy() for r, _ in pairs],
                       [corpus._cached_chroma(l, np.float32, device).cpu().numpy() for _, l in pairs])
    want, _ = batched_set_live(*padded, SWEEP_BAND, device=device)
    launches = 0
    for n in (2, 3):
        otw_set_live.launches = 0
        (paths, mean), wall, _ = mesh_timed(lambda: batched_set_live(*padded, SWEEP_BAND, mesh=mesh_of(device, n),
                                                                      device=device))
        b = len(pairs)
        exact = np.float32(sum(len(p) for p in paths)) * (np.float32(1) / np.float32(b))
        if otw_set_live.launches != n or not equal_paths(paths, want):
            raise AssertionError(f"phase 16 (c): {otw_set_live.launches} launches of #3 on {n} shards, or paths != "
                                 "the unsharded call's")
        if mean.dtype != torch.float32 or mean.device != torch.device(device) or mean.item() != exact:
            raise AssertionError(f"phase 16 (c): mean {mean} != sum x float32(1/{b}) = {exact}")
        launches += n
        log(f"phase 16 (c) [{card}]: batched_set_live over the {b} sweep pairs on {n} shards: {n} launches of #3 "
            f"(one a shard), paths == unsharded, mean path length {float(mean).hex()} == sum x float32(1/{b}), "
            f"{wall:.3f} s with packing and copies")

    wav = torch.from_numpy(load_wav(os.path.join(root, "sonata_allegro", "sonata_allegro_00.wav"))[0])
    t = num_frames(wav.shape[0])
    cut = t - t % 4
    for dtype, np_dtype in ((torch.float32, np.float32), (torch.float64, np.float64)):
        x = torch.cat([torch.zeros(2048, dtype=dtype), wav.to(dtype)]).to(device)
        frames = frame_span(x, t, 4096, 2048)[:cut]
        got = sharded_chroma_frames(frames, mesh_of(device, 4), dtype=np_dtype)
        whole = chroma_frames(frames)
        quarters = torch.cat([chroma_frames(q) for q in frames.chunk(4)], dim=1)
        diff = (got - whole).abs().max().item()
        if got.shape != (12, cut) or got.device != torch.device(device) or not torch.equal(got, quarters):
            raise AssertionError(f"phase 16 (d): {dtype}: the sharded chromagram != its shards' chroma_frames")
        if dtype == torch.float64:
            torch.testing.assert_close(got, whole, rtol=1e-12, atol=1e-14)
        elif diff > 1e-5:
            raise AssertionError(f"phase 16 (d): float32 max |diff| {diff} > 1e-5")
        log(f"phase 16 (d) [{card}]: sharded_chroma_frames, {dtype}, {cut} of _00's {t} frames (a multiple of the 4 "
            f"shards) == its shards' chroma_frames; max |diff| against one chroma_frames call {diff:.3e}")
    return launches


def mesh_resume(device, root: str, card: str) -> None:
    """Phase 16 (e): a 4-shard ``FusedMultiStreamFollower`` saved halfway
    and loaded into an unsharded one resumes to the uninterrupted path."""
    import numpy as np

    from real_time_audio_sync_tpu_torch.features.chroma import wav_to_chroma
    from real_time_audio_sync_tpu_torch.parallel import FusedMultiStreamFollower
    from real_time_audio_sync_tpu_torch.utils import checkpoint
    from real_time_audio_sync_tpu_torch.utils.wavio import load_wav

    d = os.path.join(root, "sonata_allegro")
    ref = wav_to_chroma(os.path.join(d, "sonata_allegro_00.wav"), np.float32, device=device)
    cols = []
    for take in ("01", "02"):
        pcm, _ = load_wav(os.path.join(d, f"sonata_allegro_{take}.wav"))
        cols.append(hop_columns([pcm[s : s + 2048] for s in range(0, (MESH_RESUME_HOPS + 1) * 2048, 2048)], device))
    b, half = MESH_RESUME_STREAMS, MESH_RESUME_HOPS // 2
    lives = np.stack([c.T.cpu().numpy() for c in cols])
    perf = np.arange(b) % 2

    def feed(f, lo, hi):
        for h in range(lo, hi):
            f.feed(lives[perf, h])

    for long_ref in (True, False):
        def make(mesh=None):
            return FusedMultiStreamFollower(ref, PARAMS, n_streams=b, k_block=8, long_ref=long_ref, mesh=mesh,
                                            device=device)

        whole = make()
        feed(whole, 0, MESH_RESUME_HOPS)
        whole.flush()
        four = make(mesh_of(device, 4))
        feed(four, 0, half)
        ckpt = os.path.join(root, f"mesh_resume_{int(long_ref)}.npz")
        checkpoint.save_multi_stream_state(four, ckpt)
        resumed = make()
        checkpoint.load_multi_stream_state(resumed, ckpt)
        feed(resumed, half, MESH_RESUME_HOPS)
        resumed.flush()
        if not equal_paths(resumed.paths(), whole.paths()) or not any(len(p) for p in whole.paths()):
            raise AssertionError(f"phase 16 (e): long_ref={long_ref}: the 4-shard checkpoint resumed unsharded "
                                 "differs from the uninterrupted run")
        log(f"phase 16 (e) [{card}]: {'windowed' if long_ref else 'whole buffer'}: B = {b}, saved on 4 shards after "
            f"{half} of {MESH_RESUME_HOPS} hops, loaded unsharded: the resumed paths == the uninterrupted run's")


def phase_mesh(device, root: str, card: str) -> dict:
    """Phase 16: ``mesh=`` on the one card; returns each kernel's launches
    on the sharded runs."""
    import numpy as np

    from real_time_audio_sync_tpu_torch.features.chroma import wav_to_chroma
    from real_time_audio_sync_tpu_torch.utils.wavio import load_wav

    log(card)
    d = os.path.join(root, "sonata_allegro")
    ref = wav_to_chroma(os.path.join(d, "sonata_allegro_00.wav"), np.float32, device=device)
    cols = []
    for take in ("01", "02"):
        pcm, _ = load_wav(os.path.join(d, f"sonata_allegro_{take}.wav"))
        cols.append(hop_columns([pcm[s : s + 2048] for s in range(0, len(pcm), 2048)], device))
    lens = np.asarray([x.shape[1] for x in cols])
    lives = np.zeros((2, lens.max(), 12), np.float32)
    for i, x in enumerate(cols):
        lives[i, : lens[i]] = x.T.cpu().numpy()
    launches = mesh_serving(device, ref, lives, lens, np.arange(SERVING_STREAMS) % 2, card)
    launches.update(mesh_wtw(device, root, card))
    launches["otw_batched_set_live"] = mesh_corpus_and_frontend(device, root, card)
    mesh_resume(device, root, card)
    return launches


def example_counts() -> dict:
    """Every launch counter of the port's kernels, by kernel-line name (the
    examples may move only those of ``EXAMPLES_KERNELS``)."""
    from real_time_audio_sync_tpu_torch.ops import otw_insert, otw_set_live, wavefront, wtw_insert

    return {"otw_insert_block": otw_insert.launches, "otw_insert_block_long": otw_insert.delta_launches,
            "wavefront_dp": wavefront.dp_launches, "wavefront_backtrack": wavefront.backtrack_launches,
            "wavefront_dp_batched": wavefront.dp_batched_launches,
            "wavefront_backtrack_batched": wavefront.backtrack_batched_launches,
            "otw_multi_insert_block": otw_insert.multi_launches,
            "otw_multi_insert_block_long": otw_insert.multi_delta_launches,
            "otw_set_live": otw_set_live.launches, "wtw_insert_block": wtw_insert.launches,
            "wtw_multi_insert_block": wtw_insert.multi_launches}


def reset_example_counts() -> None:
    from real_time_audio_sync_tpu_torch.ops import otw_insert, otw_set_live, wavefront, wtw_insert

    otw_insert.launches = otw_insert.delta_launches = otw_insert.multi_launches = 0
    otw_insert.multi_delta_launches = otw_set_live.launches = 0
    wavefront.dp_launches = wavefront.backtrack_launches = 0
    wavefront.dp_batched_launches = wavefront.backtrack_batched_launches = 0
    wtw_insert.launches = wtw_insert.multi_launches = 0


def demo_direct_path(engine: str, fused: bool, ref_wav: str, live_wav: str, device):
    """The path of the follower ``live_demo`` builds, made directly and fed
    the demo's 2048-sample buffers."""
    from real_time_audio_sync_tpu_torch.examples.live_demo import WTW_PARAMS
    from real_time_audio_sync_tpu_torch.streaming import ScoreFollower, SimulatedMic, WTWFollower

    if engine in ("wtw", "wtw_async"):
        f = WTWFollower(ref_wav, live_wav, params=WTW_PARAMS, engine=engine, device=device)
    else:
        f = ScoreFollower(ref_wav, engine, {"c": 50, "max_run_count": 3}, pipelined=True, fused=fused, device=device)
    f.start()
    for buf in SimulatedMic(live_wav, buffer_size=2048):
        f.receive_audio(buf)
        if f.stopped:
            break
    f.stop()
    return [tuple(int(v) for v in p) for p in f.path]


def demo_lines(text: str) -> list:
    """The demo's summary lines (the display's lines left out)."""
    keep = ("followed ", "insert dispatch", "max drift", "score-position staleness")
    return [line for line in text.splitlines() if line.startswith(keep)]


def run_demo(flags, ref_wav: str, live_wav: str, out: str, device, card: str, label: str,
             expect: tuple, tile: int = 1, direct=None) -> dict:
    """Phase 17 (a)/(b): ``live_demo.main`` in process, the counters set to
    0 just before and read just after; its field log == the direct
    follower's (``direct``, when that run was already made); raises unless
    exactly the kernels of ``expect`` launched.  Returns the launches of the
    examples' kernels."""
    import contextlib
    import io

    import torch

    from real_time_audio_sync_tpu_torch.examples import live_demo

    engine = flags[flags.index("--engine") + 1] if "--engine" in flags else "otw"
    argv = ["--ref", ref_wav, "--live", live_wav, "--out-dir", out, "--device", str(device), *flags]
    text = io.StringIO()
    reset_example_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rc = live_demo.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = example_counts()
    launched = {name: n for name, n in counts.items() if n}
    pairs = (counts["wavefront_dp"] == counts["wavefront_backtrack"]
             and counts["wavefront_dp_batched"] == counts["wavefront_backtrack_batched"])  # a DP, a backtrack
    if rc != 0 or set(launched) != set(expect) or not pairs:
        raise AssertionError(f"phase 17 [{label}]: rc {rc}, launches {launched}, expected {expect}")
    lines = demo_lines(text.getvalue())
    hops = int(lines[0].split()[1])
    path = field_log_path(out)
    if direct is None and tile > 1:
        with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as tmp:
            direct = demo_direct_path(engine, "--fused" in flags, *live_demo.tile_recordings(ref_wav, live_wav, tile, tmp),
                                      device)
    elif direct is None:
        direct = demo_direct_path(engine, "--fused" in flags, ref_wav, live_wav, device)
    if path != direct or len(path) < hops // 2:
        raise AssertionError(f"phase 17 [{label}]: the field log ({len(path)} points) != the direct follower's "
                             f"({len(direct)} points)")
    log(f"phase 17 [{label}] [{card}]: live_demo.main({' '.join(flags)}) in process: rc 0, {hops} hops in "
        f"{wall:.2f} s ({wall / hops * 1e3:.3f} ms a hop, display included); field log of {len(path)} points == "
        f"the direct follower's on the card; launches {launched or 'none (no hand-written kernel)'}")
    for line in lines:
        log(f"phase 17 [{label}]:   {line}")
    return {name: counts[name] for name in EXAMPLES_KERNELS}


def run_script(module: str, args, timeout: int = 300):
    """``python -m module args`` from the checkout: (completed process, wall s)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=timeout)
    return proc, time.perf_counter() - t0


def phase_examples(device, root: str, card: str, fused_path) -> dict:
    """Phase 17: the three live-follower example scripts on the card;
    returns each example kernel's launches over (a) and (b).
    ``fused_path`` is phase 4's otw follower's path: the direct follower
    of the demo's ``--fused`` run on the same pair."""
    import numpy as np

    from real_time_audio_sync_tpu_torch.eval import synthetic
    from real_time_audio_sync_tpu_torch.examples import heatmap_overlay
    from real_time_audio_sync_tpu_torch.features.chroma import wav_to_chroma

    out = os.path.join(root, "phase17")
    synthetic.build_corpus(out, [EXAMPLES_CASE])
    sref, slive = (os.path.join(out, EXAMPLES_CASE, f"{EXAMPLES_CASE}_0{i}.wav") for i in (0, 1))
    ref_wav, live_wav = (os.path.join(root, "sonata_allegro", f"sonata_allegro_0{i}.wav") for i in (0, 1))
    demo = "real_time_audio_sync_tpu_torch.examples.live_demo"
    # (c)'s first process and (e) beside (a) and (b): both spend their time
    # starting up on the host; (e) never opens the card
    pool = concurrent.futures.ThreadPoolExecutor(2)
    d_c = os.path.join(out, "process")
    fast_run = pool.submit(run_script, demo, ["--ref", sref, "--live", slive, "--fused", "--out-dir", d_c])
    mic_run = pool.submit(run_script, "real_time_audio_sync_tpu_torch.examples.mic_smoke", ["--ref", sref])

    total = dict.fromkeys(EXAMPLES_KERNELS, 0)
    runs = [(("--fused",), ref_wav, live_wav, "a: fused", ("otw_insert_block",), 1, fused_path),
            (("--fused", "--tile", "2"), ref_wav, live_wav, "a: fused, tile 2", ("otw_insert_block_long",), 2, None),
            (("--engine", "wtw_async"), ref_wav, live_wav, "a: wtw_async",
             ("wavefront_dp_batched", "wavefront_backtrack_batched"), 1, None)]
    runs += [(("--engine", e), sref, slive, f"b: {e}", ("wavefront_dp", "wavefront_backtrack") if e == "wtw" else (),
              1, None) for e in EXAMPLES_STEADY_ENGINES]
    for i, (flags, r, l, label, expect, tile, direct) in enumerate(runs):
        got = run_demo(list(flags), r, l, os.path.join(out, f"demo{i}"), device, card, label, expect, tile, direct)
        for name in EXAMPLES_KERNELS:
            total[name] += got[name]

    # (c) as a process (run beside (a) and (b)), then paced at the audio
    # clock, alone but for (e)'s end
    direct = demo_direct_path("otw", True, sref, slive, device)

    def check_process(proc, wall, d, tag, note):
        if proc.returncode != 0:
            raise AssertionError(f"phase 17 (c) {tag}: live_demo exited {proc.returncode}: {proc.stderr[-3000:]}")
        click = os.path.getsize(os.path.join(d, "click_track.wav"))
        path = field_log_path(d)
        if path != direct or click <= 10_000:
            raise AssertionError(f"phase 17 (c) {tag}: field log of {len(path)} points (direct {len(direct)}), "
                                 f"click track {click} B")
        flags = "--realtime " if tag == "realtime" else ""
        log(f"phase 17 (c) [{card}]: python -m {demo} --fused {flags}--out-dir DIR on {EXAMPLES_CASE}: exit 0 in "
            f"{wall:.2f} s as a process ({note}; start-up and the kernel library's load included); field log of "
            f"{len(path)} points == the direct follower's; click_track.wav {click} B")
        for line in demo_lines(proc.stdout):
            log(f"phase 17 (c) {tag}:   {line}")

    check_process(*fast_run.result(), d_c, "as fast as it runs", "started beside (a)")
    log_c = os.path.join(d_c, next(n for n in os.listdir(d_c) if n.endswith(".txt")))

    # (d) the heatmap's alignment on the card == on the CPU on the same
    # chroma; the PNG where matplotlib is installed
    import importlib.util

    reset_example_counts()
    t0 = time.perf_counter()
    card_costs = heatmap_overlay.wav_costs(sref, slive, device)
    card_s = time.perf_counter() - t0
    launched = {name: n for name, n in example_counts().items() if n}
    ref_seq, live_seq = wav_to_chroma(sref, device=device), wav_to_chroma(slive, device=device)
    cpu_costs = heatmap_overlay.overlay_costs(ref_seq.cpu(), live_seq.cpu(), "cpu")
    if launched:
        raise AssertionError(f"phase 17 (d): launches {launched}")
    for name, (acc, path) in card_costs.items():
        if not (np.array_equal(acc, cpu_costs[name][0]) and np.array_equal(path, cpu_costs[name][1])):
            raise AssertionError(f"phase 17 (d) [{name}]: the card's set_live differs from the CPU's")
    log(f"phase 17 (d) [{card}]: heatmap_overlay.wav_costs on the card, {card_s:.2f} s: == overlay_costs on the "
        f"CPU on the same chroma: " + ", ".join(f"{name} acc {acc.shape} and {len(path)} points"
                                                for name, (acc, path) in card_costs.items())
        + "; no hand-written kernel launched")
    png = os.path.join(out, "overlay.png")
    argv = ["--ref", sref, "--live", slive, "--field-log", log_c, "--out", png]
    if importlib.util.find_spec("matplotlib") is None:
        t0 = time.perf_counter()
        try:
            heatmap_overlay.main(argv)
            raise AssertionError("phase 17 (d): heatmap_overlay.main ran without matplotlib")
        except ModuleNotFoundError as e:
            if e.name != "matplotlib":
                raise
        log(f"phase 17 (d): matplotlib is not installed on this machine, so heatmap_overlay.main draws nothing here: "
            f"it stops with ModuleNotFoundError('matplotlib') in {time.perf_counter() - t0:.3f} s, before the "
            f"alignment (the CPU tests draw the PNG)")
    else:
        t0 = time.perf_counter()
        rc = heatmap_overlay.main(argv)
        size = os.path.getsize(png)
        if rc != 0 or size <= 10_000:
            raise AssertionError(f"phase 17 (d): heatmap_overlay.main rc {rc}, {size} B")
        log(f"phase 17 (d): heatmap_overlay.main in process: rc 0 in {time.perf_counter() - t0:.2f} s, "
            f"{size} B PNG")

    d_rt = os.path.join(out, "realtime")
    check_process(*run_script(demo, ["--ref", sref, "--live", slive, "--fused", "--realtime", "--out-dir", d_rt]),
                  d_rt, "realtime", "alone on the card")

    proc, wall = mic_run.result()
    pool.shutdown()
    if proc.returncode != 2 or not proc.stderr.startswith("SKIP: "):
        raise AssertionError(f"phase 17 (e): mic_smoke exited {proc.returncode}: {proc.stderr[-2000:]}")
    log(f"phase 17 (e): python -m real_time_audio_sync_tpu_torch.examples.mic_smoke: exit 2 in {wall:.2f} s "
        f"as a process (started beside (a)): {proc.stderr.strip()}")
    log(f"phase 17: the examples' launches {total}")
    return total


def ptxas_report(text: str) -> dict:
    """{mangled kernel name: (registers, stack bytes, spill store bytes,
    spill load bytes)} from nvcc's ``--ptxas-options=-v`` output."""
    import re

    props, regs, fn = {}, {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line) or re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            props[fn] = tuple(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            regs[fn] = int(m.group(1))
    return {name: (regs.get(name), *props.get(name, (None, None, None))) for name in regs}


def warp_kernel_report(text: str) -> None:
    """Phase 2: each instantiation of the one-warp K-insert kernel with its
    registers, stack and spills (ptxas); raises if one spills more than 16
    bytes (its band registers would have gone to local memory)."""
    import re

    cost = {0: "dot", 1: "Euclidean"}
    seen = 0
    for name, (regs, stack, spill_st, spill_ld) in sorted(ptxas_report(text).items()):
        m = re.search(r"otw_insert_kernel_warpILi(\d+)ELb([01])ELi(\d)ELb([01])EE", name)
        if not m:
            continue
        p, shared, kind, ring = (int(x) for x in m.groups())
        log(f"phase 2: otw_insert_kernel_warp P={p}, window in {'shared' if shared else 'global'} memory, "
            f"rows in {'shared-memory rings' if ring else 'device memory'}, {cost[kind]}: {regs} registers, {stack} B stack, {spill_st} B spill stores, {spill_ld} B spill loads")
        if spill_st is None or spill_st > 16 or spill_ld > 16:
            raise AssertionError(f"phase 2: {name} spills ({spill_st} B stores, {spill_ld} B loads)")
        seen += 1
    if seen == 0:
        raise AssertionError("phase 2: ptxas reported no otw_insert_kernel_warp instantiation")


INSERT_ROUTES = {0: "block kernel", 1: "one-warp kernel", 2: "one-warp kernel, rows from device memory"}


def insert_plan(c: int, f: int = 12, euclidean: bool = False):
    """(route, threads a block, dynamic shared bytes, blocks an SM) of a
    K-insert launch at band c on this card (``otw_insert_plan``)."""
    import ctypes

    from real_time_audio_sync_tpu_torch.ops import _build

    out = (ctypes.c_int * 4)()
    err = _build.load("otw_insert").lib.otw_insert_plan(c, f, int(euclidean), out)
    if err != 0:
        raise AssertionError(f"otw_insert_plan(c={c}, f={f}) failed: error {err}")
    return tuple(out)


def insert_plans(device) -> None:
    """Phase 2: the K-insert launch's route at each band the checks run, with
    the blocks an SM holds (the occupancy calculator); raises unless the
    route edges lie where phases 3, 9 and 10 expect them."""
    import torch

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    routes = {}
    for c in sorted(set(BANDS + INSERT_EDGE_BANDS + WIDE_BANDS + BAND_TIMED)):
        route, threads, smem, blocks = insert_plan(c)
        routes[c] = route
        log(f"phase 2: K-insert at c={c}: {INSERT_ROUTES[route]}, {threads} threads a block, {smem} B of dynamic "
            f"shared memory, {blocks} blocks an SM ({blocks * sms} streams in one wave on {sms} SMs)")
    for c in INSERT_ANY_WIDTH_BANDS:
        if insert_plan(c, f=7)[0] != 0:
            raise AssertionError(f"phase 2: c={c}: F = 7 does not take the block kernel")
    want = {31: 1, 32: 1, 63: 1, 64: 1, 228: 1, 229: 2, 237: 2, 238: 1, 255: 1, 256: 0}
    if any(routes[c] != r for c, r in want.items()):
        raise AssertionError(f"phase 2: K-insert routes {routes}, the checks expect {want} at the edges")


def otw_insert_bound_ms(c: int = PARAMS["c"], k: int = 8, f: int = 12) -> float:
    """Bytes of one k_block-k launch at band c over the memory rate: the
    window in and out, the k columns in and live rows out, the k + c + 1
    reference rows the band crosses, k path points, scalars and status
    (its operations, ~k·loop_iters·(c+1)·40, take less time)."""
    window = 2 * (c + 1) ** 2 * 4
    rows = (2 * k + k + c + 1) * f * 4
    return (window + rows + k * 8 + 2 * 16 * 4 + 8 * 4) / HBM_BYTES_PER_S * 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from real_time_audio_sync_tpu_torch.ops import _build

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1: device {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)

    libs = sorted({lib for lib, _, _ in KERNELS.values()})
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source, all at once
        builds = dict(zip(libs, pool.map(_build.load, libs)))
    for lib, built in builds.items():
        log(f"phase 2: built {built.path.name} in {built.seconds:.1f} s")
        for line in built.log.splitlines():
            if ("ptxas info" in line and ("registers" in line or "Compiling" in line)) or "spill" in line:
                log(f"phase 2: {line.strip()}")
    warp_kernel_report(builds["otw_insert"].log)
    insert_plans(device)
    wavefront_report(builds["wavefront"].log, device)
    wtw_report(builds["wtw_insert"].log, device)
    phase_s = {"1-2": time.perf_counter() - t_start}  # seconds of each phase

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = phase_s.get(name, 0.0) + time.perf_counter() - t0
        return out

    worst = timed("3", phase_kernel_vs_plain, device)
    timed("5", phase_wavefront_vs_plain, device)
    timed("7", phase_set_live_vs_plain, device)

    with tempfile.TemporaryDirectory() as root:
        ref_wav, live_wav = timed("4", render_piece, root)
        launches, timings, main_paths = timed("4", phase_main_path, device, ref_wav, live_wav)
        wf = timed("6", phase_dtw_main_path, device, root)
        sl = timed("8", phase_set_live_main_path, device, root)
        timed("9", phase_delta_vs_plain, device)
        concert, concert_wavs, concert_cols = timed("9", phase_concert, device, root)
        log(f"phase 9: {phase_s['9']:.1f} s in all")
        timed("10", phase_multi_vs_plain, device)
        serving = timed("10", phase_serving, device, root, concert_wavs, concert_cols)
        log(f"phase 10: {phase_s['10']:.1f} s in all")
        log(card)
        wtw_err = timed("11", phase_wtw_vs_plain, device)
        with warnings.catch_warnings():
            # WTWLongReferenceWarning tells a user that WTW was validated on
            # excerpts of about 35 s; the live app's main path here runs on
            # a 4.8-minute reference on purpose, for the kernel's real sizes
            from real_time_audio_sync_tpu_torch.models.wtw import WTWLongReferenceWarning

            warnings.simplefilter("ignore", WTWLongReferenceWarning)
            wtw_row, wtw_extra = timed("11", phase_wtw_main_path, device, root, card)
            log(f"phase 11: {phase_s['11']:.1f} s in all")
            log(card)
            multi_wtw_err = timed("12", phase_wtw_multi_vs_plain, device)
            multi_wtw_row, multi_wtw_extra = timed("12", phase_wtw_serving, device, root, card)
        log(f"phase 12: {phase_s['12']:.1f} s in all")
        timed("13", phase_online, device, root, card)
        with warnings.catch_warnings():
            from real_time_audio_sync_tpu_torch.models.wtw import WTWLongReferenceWarning

            warnings.simplefilter("ignore", WTWLongReferenceWarning)
            log(card)
            batched = timed("14", phase_async_batched, device, card)
            follow_launches, async_extra = timed("14", phase_async_follower, device, root, card)
            corpus_launches, sweep_extra = timed("14", phase_async_corpus, device, root, card)
        log(f"phase 14: {phase_s['14']:.1f} s in all")
        with warnings.catch_warnings():
            from real_time_audio_sync_tpu_torch.models.wtw import WTWLongReferenceWarning

            warnings.simplefilter("ignore", WTWLongReferenceWarning)
            log(card)
            app_extra = timed("15", phase_app, device, root, card)
            resumed = timed("15", phase_checkpoints, device, root, card)
            batch_launches = timed("15", phase_corpus_batch, device, root, card)
        log(f"phase 15: {phase_s['15']:.1f} s in all")
        with warnings.catch_warnings():
            from real_time_audio_sync_tpu_torch.models.wtw import WTWLongReferenceWarning

            warnings.simplefilter("ignore", WTWLongReferenceWarning)
            mesh_launches = timed("16", phase_mesh, device, root, card)
        log(f"phase 16: {phase_s['16']:.1f} s in all")
        log(card)
        examples_launches = timed("17", phase_examples, device, root, card, main_paths["otw"])
        log(f"phase 17: {phase_s['17']:.1f} s in all")

    # "ms" is each kernel's device time per launch (profiler; the CUDA-event
    # time when the trace holds none); otw_insert_block's at k_block 8,
    # where the back-to-back event time is the host's launch rate
    kern_ms, dev_ms, plain_ms = timings[8]
    rows = {"otw_insert_block": (launches, worst, dev_ms, kern_ms, plain_ms, otw_insert_bound_ms(), "bytes")}
    rows.update(wf)
    rows.update(sl)
    rows["otw_insert_block_long"] = concert
    rows.update(serving)
    rows["wtw_insert_block"] = wtw_row[:1] + (wtw_err,) + wtw_row[2:]
    rows["wtw_multi_insert_block"] = multi_wtw_row[:1] + (multi_wtw_err,) + multi_wtw_row[2:]
    batched_extra = {}
    for name, (_, err, d_ms, e_ms, p_ms, b_ms, b_by, extra) in batched.items():
        rows[name] = (follow_launches + corpus_launches, err, d_ms, e_ms, p_ms, b_ms, b_by)
        batched_extra[name] = dict(extra, follower_launches=follow_launches, corpus_launches=corpus_launches,
                                   follower=async_extra, sweep=sweep_extra)
    kernels = []
    for name, (n_launch, err, d_ms, e_ms, p_ms, b_ms, b_by) in rows.items():
        _, source, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launch, "max_abs_err": err,
            "ms": e_ms if d_ms is None else d_ms,
            "ms_from": "cuda events" if d_ms is None else "profiler device time",
            "event_ms": e_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,  # no PyTorch call computes these recurrences
        })
        if name in serving:  # the grid: B streams a launch; the plain version timed at a small batch
            kernels[-1].update(batch=SERVING_STREAMS, plain_batch=MULTI_PLAIN_BATCH)
        if name == "wtw_insert_block":  # the main path's windows, and the device time of the two kinds of launch
            kernels[-1].update(wtw_extra)
        if name == "wtw_multi_insert_block":  # B streams a launch; the launches of (b) and (c); the two kinds
            kernels[-1].update(multi_wtw_extra)
        if name in batched_extra:  # phase 14: the batch timed, B solo launches beside it, the cells' figures
            kernels[-1].update(batched_extra[name])
        if name in resumed:  # phase 15 (b): the kernel's launches after the checkpoint loads
            kernels[-1]["resume_launches"] = resumed[name]
        if name == "otw_batched_set_live":  # phase 15 (c): parallel/corpus.batched_set_live over the sweep
            kernels[-1]["corpus_batch_launches"] = batch_launches
        if name == "wavefront_dp":  # phase 15 (a): the app's --engine wtw windows
            kernels[-1]["app"] = app_extra
        if name in mesh_launches:  # phase 16: the launches of the sharded runs (shards x dispatches)
            kernels[-1]["mesh_launches"] = mesh_launches[name]
        if name in examples_launches:  # phase 17 (a) and (b): the example scripts' launches
            kernels[-1]["examples_launches"] = examples_launches[name]
    order = sorted(phase_s, key=lambda name: int(name.split("-")[0]))
    log("seconds a phase: " + ", ".join(f"{name} {phase_s[name]:.1f}" for name in order))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--band-times"]:
        sys.exit(band_times(sys.argv[2] if len(sys.argv) > 2 else None))
    if sys.argv[1:2] == ["--serving-hops"]:
        sys.exit(serving_hops(sys.argv[2] if len(sys.argv) > 2 else None))
    sys.exit(main())
