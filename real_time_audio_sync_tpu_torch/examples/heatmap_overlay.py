"""Notebook-equivalent visualization (reference livenote_v2.ipynb /
field_testing.ipynb — SURVEY.md §2 C18): accumulated-cost heatmaps with the
committed path overlaid, LiveNote vs LiveNoteV2 comparison, and a recorded
field-test path replayed over the offline path.  Chroma and both engines'
``set_live`` run on ``--device``.

Usage::

    python -m real_time_audio_sync_tpu_torch.examples.heatmap_overlay --ref ref.wav --live live.wav \
        [--field-log tests/x.txt] [--out overlay.png] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np

from real_time_audio_sync_tpu_torch.examples import require_device

PARAMS = {"search_band_width": 50, "max_run_count": 3}


def overlay_costs(ref_seq, live_seq, device="cuda") -> dict:
    """LiveNote's and LiveNoteV2's ``set_live`` of the (12, T) chroma
    ``live_seq`` against ``ref_seq`` on ``device``: {name: (acc, path)},
    ``acc`` the accumulated cost's rows up to the live pointer (uncomputed
    cells hold the sentinel), ``path`` the committed (live, ref) points."""
    from real_time_audio_sync_tpu_torch.models import LiveNote, LiveNoteV2

    out = {}
    for name, cls in (("LiveNote", LiveNote), ("LiveNoteV2", LiveNoteV2)):
        engine = cls(ref_seq, PARAMS, device=device)
        engine.set_live(live_seq)
        out[name] = (engine.acc_cost[: engine.live_ptr + 1], engine.path_array)
    return out


def wav_costs(ref_wav: str, live_wav: str, device="cuda") -> dict:
    """:func:`overlay_costs` of the two recordings, chroma and alignment on
    ``device``: what the script draws."""
    from real_time_audio_sync_tpu_torch.features.chroma import wav_to_chroma

    return overlay_costs(wav_to_chroma(ref_wav, device=device), wav_to_chroma(live_wav, device=device), device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", required=True)
    ap.add_argument("--live", required=True)
    ap.add_argument("--field-log", help="recorded field-test path to overlay")
    ap.add_argument("--out", default="overlay.png")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    import matplotlib  # before the alignment: a machine without matplotlib fails at once

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    costs = wav_costs(args.ref, args.live, device)
    fig, axes = plt.subplots(1, len(costs), figsize=(14, 6), squeeze=False)
    for ax, (name, (acc, path)) in zip(axes[0], costs.items()):
        acc = acc.copy()
        acc[~np.isfinite(acc)] = np.nan
        acc[acc >= 1e9] = np.nan  # uncomputed band exterior
        ax.imshow(acc.T, origin="lower", aspect="auto", cmap="viridis")
        ax.plot(path[:, 0], path[:, 1], "r-", linewidth=1.0, label=f"{name} path")
        if args.field_log:
            from real_time_audio_sync_tpu_torch.eval.logs import path_from_field_log

            fp = np.asarray(path_from_field_log(args.field_log))
            ax.plot(fp[:, 0], fp[:, 1], "w--", linewidth=0.8, label="recorded field path")
        ax.set_xlabel("live frame")
        ax.set_ylabel("ref frame")
        ax.set_title(f"{name}: accumulated cost + committed path")
        ax.legend(loc="lower right")
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    plt.close(fig)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
