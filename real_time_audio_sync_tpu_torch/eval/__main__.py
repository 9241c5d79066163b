"""CLI for the port's evaluation harness (the JAX package's
``eval/__main__.py``, with ``--device``).

Examples::

    # every engine on one pair, on the card (test_simple.py driver)
    python -m real_time_audio_sync_tpu_torch.eval --ref ref.wav --live live.wav

    # one engine
    python -m real_time_audio_sync_tpu_torch.eval --ref r.wav --live l.wav --engine otw

    # corpus sweep (test_all equivalent: livenote_v2_diff, streamed), on the CPU
    python -m real_time_audio_sync_tpu_torch.eval --corpus Songs/ --device cpu

    # an online engine over the whole corpus in one set_live launch
    python -m real_time_audio_sync_tpu_torch.eval --corpus Songs/ --engine livenote_v2_diff --mode fused

    # score a recorded field log against ground-truth CSVs
    python -m real_time_audio_sync_tpu_torch.eval --score-log tests/x.txt --ref-csv a.csv --live-csv b.csv

Every engine and mode of the JAX CLI runs: ``--engine dtw``, the online
engines otw, livenote, livenote_v2 and livenote_v2_diff in both modes, and
``--engine wtw`` with ``--mode insert``, ``fused`` or ``oracle``.  Without
``--engine``, ``--corpus`` sweeps livenote_v2_diff and ``--ref/--live``
runs every engine, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="real_time_audio_sync_tpu_torch.eval", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ref", help="reference recording (wav)")
    ap.add_argument("--live", help="live recording (wav)")
    ap.add_argument("--engine", default=None, help=(
        "dtw|otw|livenote|livenote_v2|livenote_v2_diff|wtw (default: all for --ref/--live, "
        "livenote_v2_diff for --corpus)"))
    ap.add_argument("--corpus", help="corpus directory (test_all sweep)")
    ap.add_argument("--field-log", help="recorded field log for the BSO cross-check during --corpus")
    ap.add_argument("--score-log", help="score a recorded field log instead of aligning")
    ap.add_argument("--ref-csv", help="ground-truth CSV for --score-log (reference side)")
    ap.add_argument("--live-csv", help="ground-truth CSV for --score-log (live side)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument("--mode", default="insert", choices=["insert", "fused", "oracle"],
                    help="insert: stream frame-by-frame (reference harness regime); "
                         "fused: whole alignment through the fused device backends "
                         "(set_live for the online engines; a corpus sweep batches ALL "
                         "pairs into one launch)")
    ap.add_argument("--device", default="cuda", help="torch device to align on (default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np

    dtype = np.dtype(args.dtype)

    if args.score_log:
        if not (args.ref_csv and args.live_csv):
            ap.error("--score-log requires --ref-csv and --live-csv")
        from real_time_audio_sync_tpu_torch.eval.ground_truth import GroundTruth
        from real_time_audio_sync_tpu_torch.eval.logs import path_from_field_log
        from real_time_audio_sync_tpu_torch.eval.scorer import PathScorer

        scorer = PathScorer(GroundTruth.from_csv(args.ref_csv), GroundTruth.from_csv(args.live_csv))
        s = scorer.score(path_from_field_log(args.score_log))
        for t in (1, 3, 5, 10):
            print(f"Percent incorrect (within {t} beat{'s' if t > 1 else ''}): {s.pct_off_beats[t]} %")
        for t in (1, 3, 5, 10):
            print(f"Percent incorrect (within {t} second{'s' if t > 1 else ''}): {s.pct_off_secs[t]} %")
        return 0

    if args.corpus:
        from real_time_audio_sync_tpu_torch.eval.corpus import CorpusRunner

        runner = CorpusRunner(args.corpus, args.engine or "livenote_v2_diff", dtype=dtype, mode=args.mode,
                              device=args.device)
        runner.evaluate(field_log=args.field_log)
        return 0

    if args.ref and args.live:
        from real_time_audio_sync_tpu_torch.eval.corpus import ENGINES, align_pair, run_simple

        if args.engine:
            result = align_pair(args.ref, args.live, args.engine, dtype=dtype, mode=args.mode, device=args.device)
            s = result.score
            for t in (1, 3, 5, 10):
                print(f"Percent incorrect (within {t} beat{'s' if t > 1 else ''}): {s.pct_off_beats[t]} %")
            print(f"Percent incorrect (within 3 seconds): {s.pct_off_3s} %")
        else:
            run_simple(args.ref, args.live, ENGINES, dtype=dtype, device=args.device)
        return 0

    ap.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
