"""Beat ground truth: CSV loading and frame→beat interpolation.

The corpus ships one CSV per recording with rows ``time_sec,beat_number`` and
(for bso only) a third ``rehearsal_label`` column (SURVEY.md §2 C16).  Two
slightly different beat interpolators exist in the reference and both are
preserved here:

- :func:`get_beat` — the scorer's interpolator (tests.py:112-128,
  test_simple.py:75-91): walks annotation intervals in *time*, returns
  ``beat[i] - frac`` with ``frac`` the remaining fraction of the interval,
  and ``None`` past the last annotation.
- :func:`get_beat_wtw` — the WTW evaluator's interpolator (wtw.py:346-359):
  walks intervals in *samples*, returns ``beat[i] + p`` with ``p`` the
  elapsed fraction, ``0`` before the first annotation and ``beats[-1]`` past
  the end.
"""

from __future__ import annotations

import csv
import dataclasses
from typing import List, Optional, Sequence

from real_time_audio_sync_tpu_torch.config import FRAME_PERIOD_SEC


@dataclasses.dataclass
class GroundTruth:
    """Beat annotations of one recording."""

    times: List[float]
    beats: List[int]
    labels: Optional[List[str]] = None

    @staticmethod
    def from_csv(path: str) -> "GroundTruth":
        times: List[float] = []
        beats: List[int] = []
        labels: List[str] = []
        with open(path, newline="") as f:
            for row in csv.reader(f):
                if not row:
                    continue
                times.append(float(row[0]))
                beats.append(int(row[1]))
                if len(row) > 2:
                    labels.append(str(row[2]))
        return GroundTruth(times, beats, labels if labels else None)

    @staticmethod
    def for_recording(wav_path: str) -> "GroundTruth":
        """CSV sits next to the wav with the same stem (tests.py:40-45)."""
        return GroundTruth.from_csv(wav_path[:-4] + ".csv")


def get_beat(sample: float, gt_times: Sequence[float], gt_beats: Sequence[int]) -> Optional[float]:
    """Frame index → interpolated beat (tests.py:112-128 semantics).

    Returns ``None`` when the frame falls past the last annotation — and the
    caller-side truthiness check (``if l_beat and r_beat`` at tests.py:73)
    also drops points whose beat is exactly 0.0; that quirk lives in the
    scorer, not here.
    """
    time = sample * FRAME_PERIOD_SEC
    for i in range(len(gt_times)):
        if i == 0:
            if time <= gt_times[i]:
                if gt_times[i] != 0:
                    frac = float(gt_times[i] - time) / (gt_times[i] - 0)
                else:
                    frac = 0.0
                return gt_beats[i] - frac
        else:
            if gt_times[i - 1] <= time <= gt_times[i]:
                frac = float(gt_times[i] - time) / (gt_times[i] - gt_times[i - 1])
                return gt_beats[i] - frac
    return None


def get_beat_wtw(
    sample: float,
    gt_times: Sequence[float],
    gt_beats: Sequence[int],
    fs: int = 22050,
    hop_size: int = 2048,
) -> float:
    """Frame index → interpolated beat (wtw.py:346-359 semantics)."""
    ff = float(fs) / hop_size
    gsam = [x * ff for x in gt_times]
    for i in range(len(gsam) - 1):
        if sample < gsam[i]:
            return 0.0
        if gsam[i] <= sample < gsam[i + 1]:
            time = sample / ff
            p = (time - gt_times[i]) / (gt_times[i + 1] - gt_times[i])
            return gt_beats[i] + p
    return float(gt_beats[-1])


def get_beat_and_label(
    sample: float,
    gt: GroundTruth,
) -> tuple[Optional[float], Optional[str]]:
    """Beat + rehearsal label for the live display (livenote_live.py:211-227).

    Label indexing quirk preserved: inside interval ``i`` the reference
    returns ``labels[i-1]`` (the label *entered*), and ``labels[0]`` before
    the first annotation.
    """
    labels = gt.labels or []
    time = sample * FRAME_PERIOD_SEC
    for i in range(len(gt.times)):
        if i == 0:
            if time <= gt.times[i]:
                if gt.times[i] != 0:
                    frac = float(gt.times[i] - time) / (gt.times[i] - 0)
                else:
                    frac = 0.0
                return (gt.beats[i] - frac, labels[0] if labels else None)
        else:
            if gt.times[i - 1] <= time <= gt.times[i]:
                frac = float(gt.times[i] - time) / (gt.times[i] - gt.times[i - 1])
                return (gt.beats[i] - frac, labels[i - 1] if labels else None)
    return (None, None)
