"""Shared core of the online score followers: direction encodings, the
per-engine config deltas, the static engine config, and lazy status
polling.

The three reference engines — OnlineTimeWarping (otw_eran.py), LiveNote
(livenote.py) and LiveNoteV2 (livenote_v2.py) — run one Dixon-2005
recurrence and differ only in documented details (SURVEY.md §7 hard
part 2):

============== ============ ============= =====================
engine         sentinel     run_count₀    path append guard
============== ============ ============= =====================
OTW            1e10         1             none
LiveNote       inf          0             none
LiveNoteV2     inf          0             monotone (x↑, y≥)
============== ============ ============= =====================

LiveNoteV2 additionally supports Euclidean cost on chroma-diff features
(livenote_v2.py:167-170).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

# direction / previous encodings
ROW, COL, BOTH = 0, 1, 2
PREV_NONE = -1

# Per-engine config deltas (SURVEY.md §7 hard part 2) — the single source
# used by the fused engine and the follower runtime.
ENGINE_OVERRIDES = {
    "otw": dict(sentinel=1e10, run_count_init=1, monotone_path=False, euclidean=False),
    "livenote": dict(sentinel=float("inf"), run_count_init=0, monotone_path=False, euclidean=False),
    "livenote_v2": dict(sentinel=float("inf"), run_count_init=0, monotone_path=True, euclidean=False),
    "livenote_v2_diff": dict(sentinel=float("inf"), run_count_init=0, monotone_path=True, euclidean=True),
}


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    """Static engine configuration."""

    c: int
    max_run_count: int
    sentinel: float  # uncomputed-cell value: 1e10 (OTW) or inf (LiveNote*)
    run_count_init: int  # 1 (OTW) or 0 (LiveNote*)
    monotone_path: bool  # LiveNoteV2 guard (livenote_v2.py:197-199)
    euclidean: bool  # LiveNoteV2 chroma-diff cost

    @property
    def loop_iters(self) -> int:
        # Consecutive Column directions are bounded by max_run_count before
        # the slope constraint forces a Row (otw_eran.py:168-170); +3 margin.
        # The status overflow flag reports any violation.
        return self.max_run_count + 3


class StatusPolling:
    """Lazy polling of the engine's int32 status vector
    ``[stopped | overflow<<1, path_len, last_x, last_y, ...]``.

    Every launch is followed by :meth:`_record_status`: on the card the
    status is copied into a fresh pinned host buffer with an asynchronous
    copy on the current stream, and a ``torch.cuda.Event`` is recorded
    behind it.  Completion is probed with ``event.query()`` (a local check,
    no synchronization), and reading a completed pinned buffer costs
    nothing, so harvests need no helper thread.  On the CPU the status is
    ready at once.

    Execution is in stream order, so a completed entry implies every
    earlier one completed; only the NEWEST completed status is kept (the
    vector is cumulative).  Harvests are rate-limited by
    ``poll_min_interval``, so ``last_point`` and "stop" lag by at most that
    interval plus the device backlog.

    Staleness accounting: each dispatch records the cumulative frame count;
    each harvest records how many frames were dispatched beyond the
    harvested status (``staleness_log``, in frames) — the score-position lag
    a UI built on ``last_point`` inherits."""

    #: default harvest interval: one feature hop (chroma.py:20-22)
    POLL_INTERVAL_HOP = 2048 / 22050.0

    #: message raised on the status overflow flag
    _overflow_msg = "column-phase loop bound violated"

    def _init_status_polling(self) -> None:
        self._outstanding = []  # [(frames_dispatched_after, host_status, event | None)]
        self._latest_done = None  # newest completed-but-unread entry
        self._frames_dispatched = 0
        self._stopped_cached = False
        self._last_point = None  # (path_len, x, y) from the last status read
        self._last_point_frames = 0  # frames covered by that read
        self.poll_min_interval = self.POLL_INTERVAL_HOP
        self._last_poll_time = 0.0
        self.staleness_log = []  # frames-behind at each harvest (diagnostics)

    # -- dispatch-side hook --------------------------------------------------

    def _record_status(self, status: torch.Tensor, n_frames: int = 1) -> None:
        """Snapshot a launch's status (``n_frames`` frames covered) without
        waiting for the device, retire completed predecessors, and harvest
        the newest completed vector if the rate limit allows."""
        self._frames_dispatched += n_frames
        if self._stopped_cached:
            return
        if status.is_cuda:
            host = torch.empty(status.shape, dtype=status.dtype, pin_memory=True)
            host.copy_(status, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host, event = status.clone(), None
        self._outstanding.append((self._frames_dispatched, host, event))
        self._probe()
        if self._latest_done is not None:
            now = time.monotonic()
            if now - self._last_poll_time >= self.poll_min_interval:
                self._last_poll_time = now
                self._harvest()

    # -- free local probes ---------------------------------------------------

    def _probe(self) -> None:
        """Retire completed in-flight statuses (front scan of event
        queries); keeps the newest completed one for a later harvest."""
        q = self._outstanding
        while q and (q[0][2] is None or q[0][2].query()):
            self._latest_done = q.pop(0)

    def in_flight(self) -> int:
        """Number of dispatched-but-unfinished launches."""
        self._probe()
        return len(self._outstanding)

    # -- reads ---------------------------------------------------------------

    def _harvest(self):
        entry, self._latest_done = self._latest_done, None
        if entry is None:
            return None
        frames, host, _ = entry
        return self._consume_status(host.numpy(), frames)

    def poll(self, block: bool = False):
        """Check the newest completed status; returns ``"stop"`` or None.

        ``block=True`` waits for ALL in-flight launches and reads the newest
        status."""
        if self._stopped_cached:
            return "stop"
        if block:
            if self._outstanding:
                frames, host, event = self._outstanding[-1]
                if event is not None:
                    event.synchronize()
                self._outstanding = []
                self._latest_done = None
                return self._consume_status(host.numpy(), frames)
            return self._harvest()
        self._probe()
        if self._latest_done is None:
            return None
        now = time.monotonic()
        if now - self._last_poll_time < self.poll_min_interval:
            return None
        self._last_poll_time = now
        return self._harvest()

    def flush(self):
        """Wait for all in-flight launches; returns ``"stop"`` or None."""
        return self.poll(block=True)

    def _consume_status(self, vec: np.ndarray, frames: Optional[int] = None):
        if frames is None:
            frames = self._frames_dispatched
        if frames < self._last_point_frames:
            # an older cumulative vector than the one already read
            return "stop" if self._stopped_cached else None
        self.staleness_log.append(self._frames_dispatched - frames)
        self._last_point_frames = frames
        flags = int(vec[0])
        self._last_point = (int(vec[1]), int(vec[2]), int(vec[3]))
        if flags & 2:  # sticky in the kernel's scalar state
            raise AssertionError(self._overflow_msg)
        if flags & 1:
            self._stopped_cached = True
            # post-stop state is frozen; older in-flight vectors are moot
            self._outstanding = []
            self._latest_done = None
            return "stop"
        return None

    @property
    def last_point(self):
        """(path_len, live, ref) from the most recent status read — the
        current score position (== path[-1]) without fetching the path."""
        return self._last_point

    @property
    def last_point_age_frames(self) -> int:
        """How many frames have been dispatched beyond the state
        ``last_point`` reflects — the current score-position staleness."""
        return self._frames_dispatched - self._last_point_frames
