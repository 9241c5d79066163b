"""End-to-end live score-following demo: the livenote_live.py experience
(SURVEY.md §2 C11) as a terminal app on the PyTorch/CUDA port.

A simulated microphone streams the live recording through the pipelined
ScoreFollower (optionally the fused K-insert engine, kernel #1, or its
long-reference layout, kernel #4, on references of 6,000 frames or more);
the duplex audio output plays a click track at the reference's annotated
beats into a wav file (the speaker stand-in); the terminal shows the input
level meter, the beat/rehearsal-label readout and a positional cursor
across the score.  ``--engine wtw`` follows with the host WTW engine (its
windows through the wavefront kernels #7/#8), ``--engine wtw_async`` with
the device-resident one (the windows batched through the same kernels).

Usage::

    python -m real_time_audio_sync_tpu_torch.examples.live_demo [--ref REF.wav] [--live LIVE.wav]
        [--engine otw] [--fused] [--device cuda] [--out-dir DIR] [--quiet]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from real_time_audio_sync_tpu_torch.examples import require_device

# the JAX demo's pair, relative to a working directory holding the corpus's
# Songs/ tree
DEFAULT_REF = "Songs/chopin/chopin_rubinstein_20b.wav"
DEFAULT_LIVE = "Songs/chopin/chopin_rachmaninoff_20b.wav"

#: the WTW followers' windows: w = 20 frames, a hop of 10
WTW_PARAMS = {"fft_len": 4096, "hop_size": 2048, "dtw_win_size": 4096 * 10, "dtw_hop_size": 2048 * 10}


def tile_recordings(ref: str, live: str, n: int, out_dir: str):
    """Both recordings tiled ``n`` times into ``out_dir`` (a synthetic long
    rehearsal; no beat CSVs, so the run measures drift and staleness, not
    beat accuracy); returns the two new paths."""
    from real_time_audio_sync_tpu_torch.utils.wavio import load_wav, write_wav

    out = []
    for attr, path in (("ref", ref), ("live", live)):
        wav, fs = load_wav(path)
        tiled = os.path.join(out_dir, f"{attr}_x{n}.wav")
        write_wav(tiled, np.tile(wav, n), fs)
        out.append(tiled)
    return tuple(out)


def build_follower(args, device):
    """The follower ``args`` ask for and its reference length in frames."""
    if args.engine in ("wtw", "wtw_async"):
        # raw-audio windowed engine (wtw_live.py role); "wtw_async" runs the
        # device-resident stepper with status-vector positions
        from real_time_audio_sync_tpu_torch.streaming.runtime import WTWFollower

        follower = WTWFollower(args.ref, live_wav=args.live, params=WTW_PARAMS, log_dir=args.out_dir,
                               engine=args.engine, device=device)
        return follower, max(1, follower.dtw.M)
    from real_time_audio_sync_tpu_torch.streaming import ScoreFollower

    follower = ScoreFollower(
        args.ref,
        engine=args.engine,
        params={"c": 50, "max_run_count": 3},  # livenote_live.py:94
        log_dir=args.out_dir,
        pipelined=True,
        fused=args.fused,
        device=device,
    )
    # the tensor engines keep the reference as a (12, n) tensor
    return follower, max(1, follower.engine.n if args.fused else follower.engine.ref.shape[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ref", default=DEFAULT_REF)
    ap.add_argument("--live", default=DEFAULT_LIVE)
    ap.add_argument("--engine", default="otw",
                    choices=["otw", "livenote", "livenote_v2", "wtw", "wtw_async"])
    ap.add_argument("--fused", action="store_true", help="fused K-insert streaming engine")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    ap.add_argument("--out-dir", default=None, help="write field log + click wav here")
    ap.add_argument("--realtime", action="store_true", help="pace the mic at the audio clock")
    ap.add_argument("--tile", type=int, default=1,
                    help="tile ref+live audio N times (synthetic long rehearsal, "
                         "e.g. --tile 5 --realtime for a ~3-minute drift run)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    if args.tile <= 1:
        return follow(args, device)
    with tempfile.TemporaryDirectory(prefix="rtas_rehearsal_") as tmp:  # removed on return
        args.ref, args.live = tile_recordings(args.ref, args.live, args.tile, tmp)
        return follow(args, device)


def follow(args, device) -> int:
    import time as _time

    from real_time_audio_sync_tpu_torch.eval.ground_truth import GroundTruth
    from real_time_audio_sync_tpu_torch.streaming import SimulatedMic
    from real_time_audio_sync_tpu_torch.streaming.audio_io import ClickTrack, DuplexAudio, WavFileSink
    from real_time_audio_sync_tpu_torch.streaming.display import Cursor3D, MeterDisplay

    follower, n_ref_frames = build_follower(args, device)

    # duplex output: click track at the reference's annotated beats (a
    # tiled reference has no beat CSV, so no click track)
    duplex = None
    csv_path = args.ref[:-4] + ".csv"
    if args.out_dir and os.path.exists(csv_path):
        gt = GroundTruth.from_csv(csv_path)
        os.makedirs(args.out_dir, exist_ok=True)
        sink = WavFileSink(os.path.join(args.out_dir, "click_track.wav"))
        duplex = DuplexAudio(sink=sink)
        duplex.set_generator(ClickTrack(gt.times))

    meter = MeterDisplay()
    cursor = Cursor3D(area_size=(1.0, 1.0), area_pos=(0.0, 0.0), size_range=(0.0, 1.0))

    follower.start()
    hops = 0
    # drift instrumentation (livenote_live.py:203-206): wall-clock-expected
    # live frame vs the algorithm's current path head, plus the pipelined
    # engines' score-position staleness
    HOP_SEC = 2048 / 22050.0
    t_start = None
    drifts, ages = [], []
    eng = getattr(follower, "engine", None) or getattr(follower, "dtw", None)
    for buf in SimulatedMic(args.live, buffer_size=2048, realtime=args.realtime):
        if args.realtime and t_start is not None and hasattr(eng, "last_point_age_frames"):
            # staleness as a UI polling just before this hop sees it
            ages.append(eng.last_point_age_frames)
        if t_start is None:
            t_start = _time.perf_counter()
        events = follower.receive_audio(buf)
        if duplex is not None:
            duplex.on_update()
        hops += 1
        if args.realtime and events:
            expected = (_time.perf_counter() - t_start) / HOP_SEC
            drifts.append(expected - events[-1].live_frame)
        if events and not args.quiet and hops % 40 == 0:
            e = events[-1]
            meter.set(follower.meter.db)
            cursor.set_pos(np.array([e.ref_frame / n_ref_frames, 0.5, 0.5]))
            beat = f"beat {e.beat:7.2f}" if e.beat is not None else "beat    ?  "
            label = f" [{e.label}]" if e.label else ""
            print(f"{meter.render()}  frame {e.live_frame:4d}->{e.ref_frame:4d}  {beat}{label}")
            print(cursor.render(cols=64, rows=3))
        if follower.stopped:
            break
    log_path = follower.stop()
    while duplex is not None and duplex.generator is not None:
        duplex.on_update()
    if duplex is not None:
        duplex.close()

    path = follower.path
    print(f"followed {hops} buffers -> {len(path)} path points; "
          f"final position frame {path[-1][1] if path else 0}/{n_ref_frames}")
    if log_path:
        print(f"field log: {log_path}")
    summary = follower.latency.summary()
    if summary:
        print(f"insert dispatch p50 {summary['p50_ms']:.2f} ms, "
              f"p99 {summary.get('p99_ms', float('nan')):.2f} ms over {summary['count']} hops")
    if drifts:
        # expected-frame-vs-path-head drift (livenote_live.py:203-206): the
        # constant ~2-frame part is the analysis window + fresh-hop offset;
        # GROWTH over the run would mean the follower falls behind real time
        audio_min = hops * 2048 / 22050.0 / 60.0
        print(f"max drift {max(drifts):.1f} frames (mean {np.mean(drifts):.1f}) "
              f"over {audio_min:.1f} min at real-time pacing")
    if ages:
        a = np.asarray(ages, float)
        print(f"score-position staleness: p50 {np.percentile(a, 50):.0f} "
              f"p99 {np.percentile(a, 99):.0f} max {a.max():.0f} hops (target <=1)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
