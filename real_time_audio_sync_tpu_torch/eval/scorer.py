"""Alignment-path scorer against beat ground truth.

Single implementation of the evaluator the reference duplicates four times
(test_simple.py:41-91, tests.py:59-137, wtw.py:314-344, wtw_live.py:267-309).
For each path point ``(live_frame, ref_frame)`` both frames are converted to
interpolated beats and the absolute beat difference is bucketed at
>1/>3/>5/>10 beats; the richer tests.py variant additionally converts beat
error to seconds through the live timing map and buckets those.

Deliberately preserved quirks (each cited):
- points where either interpolated beat is ``None`` **or exactly 0.0** are
  skipped — the reference tests truthiness, not None-ness (tests.py:73).
- seconds conversion looks up **both** beats in the *live* timing map and
  indexes the annotation list by ``int(beat)`` as a positional index
  (tests.py:130-137).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from real_time_audio_sync_tpu_torch.eval.ground_truth import GroundTruth, get_beat


@dataclasses.dataclass
class ScoreResult:
    count: int
    squared_beat_error: float
    pct_off_beats: Dict[int, float]  # thresholds 1, 3, 5, 10
    pct_off_secs: Dict[int, float]  # thresholds 1, 3, 5, 10

    @property
    def pct_off_3s(self) -> float:
        """The reference's headline number (tests.py:109)."""
        return self.pct_off_secs[3]


class PathScorer:
    """Scores (live_frame, ref_frame) paths for one recording pair."""

    BEAT_THRESHOLDS = (1, 3, 5, 10)

    def __init__(self, ref_gt: GroundTruth, live_gt: GroundTruth):
        self.ref_gt = ref_gt
        self.live_gt = live_gt

    @staticmethod
    def for_pair(ref_wav: str, live_wav: str) -> "PathScorer":
        """CSVs located by wav stem (tests.py:40-45)."""
        return PathScorer(GroundTruth.for_recording(ref_wav), GroundTruth.for_recording(live_wav))

    # -- tests.py:130-137 ---------------------------------------------------
    def _beat_to_time(self, beat: float) -> float:
        times = self.live_gt.times
        time = times[int(beat)]
        if int(beat) + 1 < len(times):
            time += (beat % 1) * (times[int(beat) + 1] - times[int(beat)])
        return time

    def _secs_off(self, ref_beat: float, live_beat: float) -> Optional[float]:
        try:
            return abs(self._beat_to_time(ref_beat) - self._beat_to_time(live_beat))
        except IndexError:
            # Beat numbers can exceed the annotation count; the reference
            # would crash here (tests.py:131) but never does on its corpus —
            # treat such points as unscorable in seconds.
            return None

    def score(self, path: Sequence[Tuple[int, int]]) -> ScoreResult:
        sq_error = 0.0
        count = 0
        off_beats = {t: 0 for t in self.BEAT_THRESHOLDS}
        off_secs = {t: 0 for t in self.BEAT_THRESHOLDS}
        for l, r in path:
            l_beat = get_beat(l, self.live_gt.times, self.live_gt.beats)
            r_beat = get_beat(r, self.ref_gt.times, self.ref_gt.beats)
            if l_beat and r_beat:  # truthiness on purpose (tests.py:73)
                diff = abs(l_beat - r_beat)
                sq_error += diff ** 2
                for t in self.BEAT_THRESHOLDS:
                    if diff > t:
                        off_beats[t] += 1
                secs = self._secs_off(r_beat, l_beat)
                if secs is not None:
                    for t in self.BEAT_THRESHOLDS:
                        if secs > t:
                            off_secs[t] += 1
                count += 1
        if count == 0:
            raise ZeroDivisionError("no scorable path points")
        return ScoreResult(
            count=count,
            squared_beat_error=sq_error,
            pct_off_beats={t: 100.0 * off_beats[t] / count for t in self.BEAT_THRESHOLDS},
            pct_off_secs={t: 100.0 * off_secs[t] / count for t in self.BEAT_THRESHOLDS},
        )
