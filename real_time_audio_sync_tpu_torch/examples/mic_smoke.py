"""Hardware-microphone smoke test — run on a host with a real mic.

:class:`~real_time_audio_sync_tpu_torch.streaming.sources.MicSource` (the
ims/audio.py:64-103 role, field-validated in the reference) needs
``pyaudio`` or ``sounddevice``.  On a machine with a microphone and one of
them installed, this script is the 60-second validation:

    python -m real_time_audio_sync_tpu_torch.examples.mic_smoke --ref /path/to/reference.wav \
        [--seconds 30] [--device cuda]

It opens the mic, follows your performance against the reference recording
with the pipelined OTW follower on ``--device``, prints the score position
once per second, and on exit reports the input level statistics and insert
latency — if the meter moved and positions advanced while you played, the
mic path works.  Exit codes: 0 it worked, 1 the level never rose above the
noise floor, 2 no microphone backend on this host.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from real_time_audio_sync_tpu_torch.examples import require_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ref", required=True, help="reference recording (22.05 kHz wav)")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--buffer-size", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    from real_time_audio_sync_tpu_torch.streaming import ScoreFollower
    from real_time_audio_sync_tpu_torch.streaming.sources import MicSource

    try:
        mic = MicSource(buffer_size=args.buffer_size)
    except RuntimeError as e:
        print(f"SKIP: {e}", file=sys.stderr)
        return 2  # distinct exit code: no mic backend on this host

    follower = ScoreFollower(args.ref, engine="otw", pipelined=True, device=device)
    follower.start()
    t0 = time.monotonic()
    last_print = 0.0
    n_bufs = 0
    peak_db = -96.0
    for buf in mic:
        events = follower.receive_audio(np.asarray(buf, np.float32))
        n_bufs += 1
        peak_db = max(peak_db, follower.meter.db)
        now = time.monotonic() - t0
        if now - last_print >= 1.0:
            last_print = now
            e = events[-1] if events else None
            pos = f"frame {e.live_frame}->{e.ref_frame} ({e.time_sec:5.1f} s)" if e else "warming up"
            print(f"[{now:5.1f}s] level {follower.meter.db:6.1f} dB  {pos}", flush=True)
        if now >= args.seconds or follower.stopped:
            break
    follower.stop()
    s = follower.latency.summary()
    print(f"done: {n_bufs} buffers, peak level {peak_db:.1f} dB, "
          f"{len(follower.path)} path points"
          + (f", insert p50 {s['p50_ms']:.2f} ms" if s else ""))
    if peak_db <= -90:
        print("WARNING: input level never rose above the noise floor — "
              "check the microphone / input device selection "
              "(~/audio_config.cfg, streaming/audio_config.py)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
