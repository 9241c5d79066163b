"""WTW offline evaluator — ``test_single_recording_WTW`` parity (reference
wtw.py:259-359; the JAX package's ``eval/wtw_offline.py``).

Differences from the shared PathScorer, all kept:

- the WTW beat interpolator (wtw.py:346-359: a sample-domain interval
  walk, ``beat[i] + elapsed_fraction``, 0 before the first annotation,
  ``beats[-1]`` past the end), :func:`..ground_truth.get_beat_wtw`;
- buckets at >1/>3/>10 beats only, and the squared beat error;
- ``ref_ground_truth``/``live_ground_truth`` are accepted but unused — the
  reference derives the CSV paths from the recordings' names
  (wtw.py:277-284);
- ``evaluate(buf_size)`` splits the live recording into ``buf_size``
  chunks with ``np.array_split`` (wtw.py:301): it counts chunks, not
  samples.

The engine is the host ``WTW`` on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from real_time_audio_sync_tpu_torch.eval.ground_truth import GroundTruth, get_beat_wtw


@dataclasses.dataclass
class WTWError:
    squared_beat_error: float
    pct_off_beats: Dict[int, float]
    count: int


class WTWOfflineEvaluator:
    def __init__(
        self,
        ref_recording: str,
        live_recording: str,
        ref_ground_truth=None,  # accepted but unused (reference parity)
        live_ground_truth=None,  # accepted but unused
        params: Optional[dict] = None,
        debug_params: Optional[dict] = None,
        dtype=np.float32,
        *,
        device="cuda",
    ):
        from real_time_audio_sync_tpu_torch.eval.corpus import DEFAULT_WTW_PARAMS
        from real_time_audio_sync_tpu_torch.models.wtw import WTW
        from real_time_audio_sync_tpu_torch.utils.wavio import load_wav

        self.dtw = WTW(ref_recording, params or DEFAULT_WTW_PARAMS, debug_params, dtype=dtype, device=device)
        self.live_recording, fs = load_wav(live_recording)
        assert fs == 22050

        self.ref_gt = GroundTruth.from_csv(ref_recording[:-4] + ".csv")
        self.live_gt = GroundTruth.from_csv(live_recording[:-4] + ".csv")
        self.sync_ests = None
        self.error: Optional[WTWError] = None

    def evaluate(self, buf_size: int = 4096) -> WTWError:
        """Emulate live streaming by splitting the recording into ``buf_size``
        chunks (wtw.py:298-307), then score the committed path."""
        for buf in np.array_split(self.live_recording, buf_size):
            if self.dtw.insert(buf) == "stop":
                break
        self.sync_ests = self.dtw.path
        self.error = self.get_error()
        return self.error

    def get_error(self) -> WTWError:
        """wtw.py:314-344 (the strict time-domain interpolator and the
        1/3/10 buckets)."""
        error = 0.0
        off = {1: 0, 3: 0, 10: 0}
        for l, r in self.sync_ests:
            l_beat = get_beat_wtw(l, self.live_gt.times, self.live_gt.beats)
            r_beat = get_beat_wtw(r, self.ref_gt.times, self.ref_gt.beats)
            diff = r_beat - l_beat
            error += diff ** 2
            for t in off:
                if abs(diff) > t:
                    off[t] += 1
        n = len(self.sync_ests)
        return WTWError(
            squared_beat_error=error,
            pct_off_beats={t: 100.0 * off[t] / n for t in off},
            count=n,
        )
