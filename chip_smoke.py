"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each raising on failure (the process then exits non-zero):

1. device — the card's name, then ``nvidia-smi``'s name and power limit;
2. build — ``nvcc`` builds every kernel of the port from ``csrc/``;
3. kernel against plain, on the card — the K-insert kernel and its plain
   PyTorch version run the same streams launch by launch (4 engine
   variants × bands c ∈ {10, 50, 200} × k_block ∈ {1, 8, 32}, with a stop
   past the end of the reference, and a live-capacity freeze at k_block
   32); status, scalars, path, window and live history must be EQUAL (the
   two share their operation order and round every step, so the tolerance
   is zero);
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

Then one JSON line of per-kernel results, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

PARAMS = {"c": 50, "max_run_count": 3}  # livenote_live.py:94
VARIANTS = ("otw", "livenote", "livenote_v2", "livenote_v2_diff")
BANDS = (10, 50, 200)
K_BLOCKS = (1, 8, 32)
KERNEL_SOURCE = "real_time_audio_sync_tpu_torch/csrc/otw_insert.cu"
REPLACES = "real_time_audio_sync_tpu/ops/pallas_otw.py:803"


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


def clone_state(state):
    import dataclasses

    return dataclasses.replace(state, **{f.name: getattr(state, f.name).clone()
                                         for f in dataclasses.fields(state)})


def compare_states(a, b, what: str) -> float:
    """Raise unless the two states are equal; returns the window's largest
    absolute difference over finite cells (0.0 when equal)."""
    import torch

    for name in ("status", "scalars", "path_x", "path_y", "live", "window"):
        x, y = getattr(a, name), getattr(b, name)
        if not torch.equal(x, y):
            diff = (x.double() - y.double()).abs()
            raise AssertionError(f"{what}: kernel and plain disagree on {name} "
                                 f"(max |diff| {diff[torch.isfinite(diff)].max().item() if torch.isfinite(diff).any() else 'inf'})")
    fin = torch.isfinite(a.window) & torch.isfinite(b.window)
    return float((a.window[fin] - b.window[fin]).abs().max()) if fin.any() else 0.0


def phase_kernel_vs_plain(device) -> float:
    import numpy as np
    import torch

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
                    n = ref.shape[1]
                    cap = 2 * n
                    kern = otw_insert.new_state(torch.from_numpy(ref).to(device), cfg, cap)
                    plain = clone_state(kern)
                    rows = torch.from_numpy(np.ascontiguousarray(live.T)).to(device)
                    for s in range(0, rows.shape[0], k_block):
                        block = rows[s : s + k_block]
                        lens = (cap, n, block.shape[0])
                        otw_insert.insert_block(kern, block, lens, cfg, k_block)
                        otw_insert.insert_block_reference(plain, block, lens, cfg, k_block)
                        torch.cuda.synchronize()
                        worst = max(worst, compare_states(kern, plain, f"{variant} c={c} k={k_block} {scenario} @col {s}"))
                        n_launches += 1
                    sc = kern.scalars.cpu()
                    if scenario == "stop" and sc[otw_insert.S_STOPPED] != 1:
                        raise AssertionError(f"{variant} c={c} k={k_block}: stream did not stop")
                    if scenario == "capacity" and not (sc[otw_insert.S_T] >= cap and sc[otw_insert.S_STOPPED] == 0):
                        raise AssertionError(f"{variant} c={c}: capacity freeze not reached ({sc.tolist()})")
    log(f"phase 3: kernel == plain on the card over {len(VARIANTS)} variants x bands {BANDS} x "
        f"k_block {K_BLOCKS} (+ capacity freeze at k_block 32): {n_launches} launches compared, "
        f"window max |diff| {worst}, {time.perf_counter() - t0:.1f} s")
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


def kernel_device_ms(launch, state, rows, k: int, reps: int):
    """(mean device ms per kernel launch, kernel launches the trace holds)
    from a torch.profiler trace of ``reps`` launches of k columns; the mean
    is None when the trace holds no device time of the kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for r in range(reps):
            launch(state, rows[r * k : (r + 1) * k], k)
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if "otw_insert_kernel" in e.key and e.self_device_time_total > 0]
    traced = sum(e.count for e in hits)
    if traced == 0:
        return None, 0
    return sum(e.self_device_time_total for e in hits) / 1e3 / traced, traced


def trace_main_path(follower, buffers) -> None:
    """One traced run of the follower: device busy share of the wall, and
    the operations that take the device's and the host's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        follower.start()
        for buf in buffers:
            follower.receive_audio(buf)
        follower.stop()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in avgs)
    log(f"phase 4 [trace]: traced wall {wall:.3f} s, device busy {dev_us / 1e6:.3f} s "
        f"({100 * dev_us / (wall * 1e6):.1f} %), idle {100 - 100 * dev_us / (wall * 1e6):.1f} %")
    for e in sorted(avgs, key=lambda e: e.self_device_time_total, reverse=True)[:6]:
        if e.self_device_time_total > 0:
            log(f"phase 4 [trace]: device {e.self_device_time_total / 1e3:9.1f} ms  x{e.count:6d}  {e.key[:90]}")
    for e in sorted(avgs, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        log(f"phase 4 [trace]: host   {e.self_cpu_time_total / 1e3:9.1f} ms  x{e.count:6d}  {e.key[:90]}")


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
    timings = {}
    for engine in ("otw", "livenote_v2"):
        follower = ScoreFollower(ref_wav, engine, PARAMS, fused=True, device=device)
        eng = follower.engine
        torch.cuda.synchronize()
        otw_insert.launches = 0
        t0 = time.perf_counter()
        follower.start()
        for buf in buffers:
            follower.receive_audio(buf)
        follower.stop()
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
                dev_ms, traced = kernel_device_ms(
                    lambda st, r, kk: otw_insert.insert_block(st, r, lens_of(kk), cfg, kk),
                    clone_state(base), rows, k, reps)
                timings[k] = (kern_ms, dev_ms, plain_ms)
                log(f"phase 4 [otw]: k_block={k}: kernel {kern_ms:.4f} ms/launch (events, back to back), "
                    f"device time {'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} "
                    f"(profiler, {traced} of {reps} launches traced); "
                    f"plain {plain_ms:.4f} ms/launch ({reps} launches each, c={PARAMS['c']}, N={eng.n})")
            trace_main_path(ScoreFollower(ref_wav, engine, PARAMS, fused=True, device=device), buffers)
    return launches_total, timings


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

    built = _build.load("otw_insert")
    log(f"phase 2: built {built.path.name} in {built.seconds:.1f} s")
    for line in built.log.splitlines():
        if "ptxas info" in line and ("registers" in line or "Compiling" in line):
            log(f"phase 2: {line.strip()}")

    worst = phase_kernel_vs_plain(device)

    with tempfile.TemporaryDirectory() as root:
        ref_wav, live_wav = render_piece(root)
        launches, timings = phase_main_path(device, ref_wav, live_wav)

    # "ms" is the kernel's device time per launch (profiler) at k_block 8;
    # the back-to-back event time below k_block 32 is the host's launch rate
    kern_ms, dev_ms, plain_ms = timings[8]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "otw_insert_block", "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": worst,
        "ms": kern_ms if dev_ms is None else dev_ms,
        "ms_from": "cuda events" if dev_ms is None else "profiler device time",
        "event_ms": kern_ms, "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
