"""Headless live app: the livenote_live.py / wtw_live.py experience without
Kivy — follow a (simulated or real) microphone against a reference
recording, print the on-screen state (beat, rehearsal label, input level),
and write the field-test log on stop (the JAX package's
``streaming/app.py``).

``--engine otw|livenote|livenote_v2`` runs ``ScoreFollower`` (the online
tensor engine on ``device``, one insert a hop, or a hop's columns in one
``insert_block`` with ``--blocks``); ``--engine wtw`` runs ``WTWFollower``
with the host ``WTW``, each window through the wavefront kernels on a
card.  ``--device`` (default ``cuda``) is the port's one flag of its own:
``--device cpu`` runs the plain versions.

    python -m real_time_audio_sync_tpu_torch.streaming --ref ref.wav --live live.wav --device cpu
"""

from __future__ import annotations

import sys
from typing import Optional

from real_time_audio_sync_tpu_torch.streaming.runtime import ScoreFollower, WTWFollower
from real_time_audio_sync_tpu_torch.streaming.sources import MicSource, SimulatedMic
from real_time_audio_sync_tpu_torch.streaming.writer import AudioWriter


def follow_live(
    ref_wav: str,
    live_wav: Optional[str] = None,
    engine: str = "otw",
    params: Optional[dict] = None,
    log_dir: Optional[str] = "tests_live",
    realtime: bool = False,
    capture_audio: bool = False,
    use_blocks: bool = False,
    quiet: bool = False,
    device="cuda",
):
    """Run the follower over a live source on ``device``; returns it after
    the stream ends.

    ``live_wav=None`` uses the real microphone (if a backend exists),
    otherwise the wav is streamed as a simulated mic.
    """
    if engine == "wtw":
        follower = WTWFollower(ref_wav, live_wav, params=params, log_dir=log_dir, device=device)
    else:
        follower = ScoreFollower(
            ref_wav, engine=engine, params=params, log_dir=log_dir, use_blocks=use_blocks, device=device
        )
    source = (
        SimulatedMic(live_wav, realtime=realtime) if live_wav else MicSource()
    )
    writer = AudioWriter("capture_") if capture_audio else None

    follower.start()
    if writer:
        writer.start()
    try:
        for buf in source:
            if writer:
                writer.add_audio(buf)
            for ev in follower.receive_audio(buf):
                if not quiet:
                    label = f" [{ev.label}]" if ev.label else ""
                    beat = f" beat {ev.beat:7.2f}" if ev.beat is not None else ""
                    sys.stdout.write(
                        f"\rlive {ev.live_frame:5d} → ref {ev.ref_frame:5d} "
                        f"({ev.time_sec:6.2f}s){beat}{label}  "
                        f"mic {follower.meter.db:6.1f} dB   "
                    )
                    sys.stdout.flush()
            if follower.stopped:
                break
    finally:
        log = follower.stop()
        if writer:
            writer.stop()
        if not quiet:
            print()
            stats = follower.latency.summary()
            if stats:
                print(
                    f"{stats['count']} updates: p50 {stats['p50_ms']:.2f} ms, "
                    f"p99 {stats['p99_ms']:.2f} ms, RTF {stats['rtf']:.0f}x"
                )
            if log:
                print(f"path log written to {log}")
    return follower


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="real_time_audio_sync_tpu_torch.streaming")
    ap.add_argument("--ref", required=True, help="reference recording (wav)")
    ap.add_argument("--live", help="live recording to simulate as mic input (omit for a real microphone)")
    ap.add_argument("--engine", default="otw", choices=["otw", "livenote", "livenote_v2", "wtw"])
    ap.add_argument("--realtime", action="store_true", help="pace the simulated mic at the audio clock")
    ap.add_argument("--blocks", action="store_true", help="insert per audio buffer (one dispatch per block) instead of per hop")
    ap.add_argument("--log-dir", default="tests_live")
    ap.add_argument("--capture", action="store_true", help="also record incoming audio to capture_N.wav")
    ap.add_argument("--device", default="cuda", help="torch device to follow on (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)

    follow_live(
        args.ref,
        args.live,
        engine=args.engine,
        log_dir=args.log_dir,
        realtime=args.realtime,
        capture_audio=args.capture,
        use_blocks=args.blocks,
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
