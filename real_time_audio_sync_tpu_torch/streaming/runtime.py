"""Host-side streaming runtime: hop framing + score following.

Mirrors the live apps' audio plumbing (livenote_live.py:161-209): incoming
mic buffers accumulate; every time a full ``fft_len`` window is available a
chroma column is extracted (on the follower's device) and fed to the
engine, then the buffer advances by ``hop_size``.  The ``ScoreFollower``
adds the beat/rehearsal-label lookup against the reference's ground-truth
CSV (livenote_live.py:198,211-227) and field-log recording
(livenote_live.py:138-154); the ``WTWFollower`` is the raw-audio WTW app
(wtw_live.py).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from real_time_audio_sync_tpu_torch.config import FFT_LEN, FRAME_PERIOD_SEC, HOP_SIZE
from real_time_audio_sync_tpu_torch.eval.ground_truth import GroundTruth, get_beat, get_beat_and_label
from real_time_audio_sync_tpu_torch.eval.logs import write_field_log
from real_time_audio_sync_tpu_torch.streaming.writer import combine_buffers
from real_time_audio_sync_tpu_torch.utils.profiling import EMACpuLoad, LatencyRecorder


class HopFramer:
    """Accumulates raw sample buffers; emits fft_len windows every hop_size
    samples (livenote_live.py:164-168,185-208 cadence)."""

    def __init__(self, fft_len: int = FFT_LEN, hop_size: int = HOP_SIZE):
        self.fft_len = fft_len
        self.hop_size = hop_size
        self._pending = np.empty(0, np.float32)

    def push(self, frames) -> List[np.ndarray]:
        self._pending = combine_buffers([self._pending, frames])
        out = []
        while len(self._pending) >= self.fft_len:
            out.append(self._pending[: self.fft_len].copy())
            self._pending = self._pending[self.hop_size :]
        return out


@dataclasses.dataclass
class FollowEvent:
    """One engine update: where we are in the score."""

    live_frame: int
    ref_frame: int
    beat: Optional[float]
    label: Optional[str]
    time_sec: float  # position in the reference, seconds
    stopped: bool = False


class ScoreFollower:
    """Follows a live performance against a reference recording.

    Feed raw audio via :meth:`receive_audio` (returns follow events), read
    ``.path``; ``"stop"`` is handled internally; recording start/stop
    mirrors the 'r' key toggle (on stop a field log in the reference's
    exact format is written, livenote_live.py:150-154).

    The positional parameters are the JAX package's, in its order; chroma
    and alignment both run on ``device``.  ``fused=True`` runs the fused
    K-insert engine (float32; ``dtype`` is then the reference chroma's):
    it picks its layout as the JAX package's does, a reference of
    ``_LONG_REF_THRESHOLD`` frames or more (about 9.3 minutes) taking the
    long-reference delta layout.  ``fused=False`` runs the tensor engine of
    ``engine`` (:class:`OnlineTimeWarping`, :class:`LiveNote` or
    :class:`LiveNoteV2`) in ``dtype``, in one of three modes: synchronous
    inserts, one a hop (the default), ``use_blocks`` (a hop's columns in
    one ``insert_block``) or ``pipelined`` (``insert_block_nowait``, never
    waiting for the card).  In the pipelined and fused modes the score
    position comes from the polled status vector; in the synchronous ones
    from the status each insert reads back (the engine's ``last_point``,
    which is ``path[-1]``).  ``fused_interpret`` is accepted and ignored,
    since the device decides where a kernel runs.
    """

    def __init__(
        self,
        ref_wav: str,
        engine: str = "otw",
        params: Optional[dict] = None,
        log_dir: Optional[str] = None,
        dtype=np.float32,
        use_blocks: bool = False,
        pipelined: bool = False,
        fused: bool = False,
        fused_interpret: bool = False,
        *,
        device="cuda",
    ):
        from real_time_audio_sync_tpu_torch.eval.corpus import DEFAULT_PARAMS
        from real_time_audio_sync_tpu_torch.features.chroma import torch_dtype, wav_to_chroma
        from real_time_audio_sync_tpu_torch.models import FusedStreamingEngine, LiveNote, LiveNoteV2, OnlineTimeWarping
        from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES

        del fused_interpret  # the tensors' device decides
        if engine not in ("otw", "livenote", "livenote_v2"):
            # the follower feeds plain chroma; the diff-feature engine
            # (livenote_v2_diff) belongs to the corpus harness, not the live app
            raise ValueError(f"unknown follower engine {engine!r}")
        self.ref_wav = ref_wav
        self.engine_name = engine
        self.params = dict(params or DEFAULT_PARAMS)
        self.device = torch.device(device)
        self.use_blocks = use_blocks
        # pipelined: issue inserts without waiting for the card and poll the
        # compact status vector instead of reading the path
        self.pipelined = pipelined or fused
        self.fused = fused

        ref_seq = wav_to_chroma(ref_wav, torch_dtype(dtype), device=self.device)
        if fused:
            self.engine = FusedStreamingEngine(
                ref_seq, self.params, cfg_overrides=ENGINE_OVERRIDES[engine], device=self.device, long_ref=None)
        else:
            cls = {"otw": OnlineTimeWarping, "livenote": LiveNote, "livenote_v2": LiveNoteV2}[engine]
            self.engine = cls(ref_seq, self.params, dtype=dtype, device=self.device)
        self._frame_dtype = torch_dtype(self.engine.dtype)

        csv_path = ref_wav[:-4] + ".csv"
        self.ground_truth = GroundTruth.from_csv(csv_path) if os.path.exists(csv_path) else None

        self.framer = HopFramer()
        self.meter = AudioMeter()
        self.latency = LatencyRecorder(audio_seconds_per_event=FRAME_PERIOD_SEC)
        self.cpu_load = EMACpuLoad()

        self.log_dir = log_dir
        self.recording = False
        self.stopped = False
        self._log_path: Optional[str] = None

    # -- 'r' key toggle (livenote_live.py:145-154) --------------------------
    def start(self) -> None:
        self.recording = True

    def stop(self) -> Optional[str]:
        """Stop following; write the path log if a log_dir was configured."""
        self.recording = False
        if self.pipelined and self.engine.flush() == "stop":
            self.stopped = True
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            self._log_path = os.path.join(
                self.log_dir, f"{self.engine_name}_test_live_{time.time()}.txt"
            )
            band = self.params.get("c", self.params.get("search_band_width", 0))
            write_field_log(
                self._log_path,
                self.ref_wav,
                [
                    ("fft_len", FFT_LEN),
                    ("hop_size", HOP_SIZE),
                    ("search_band_width", band),
                    ("max_run_count", self.params.get("max_run_count", 0)),
                ],
                self.path,
            )
        return self._log_path

    # -- audio input (livenote_live.py:161-209) ------------------------------
    def receive_audio(self, frames) -> List[FollowEvent]:
        t0 = time.perf_counter()
        self.meter.update(frames)
        events: List[FollowEvent] = []
        if self.recording and not self.stopped:
            windows = self.framer.push(frames)
            if windows:
                events = self._process(windows)
        self.cpu_load.update(time.perf_counter() - t0)
        return events

    def _process(self, windows: List[np.ndarray]) -> List[FollowEvent]:
        from real_time_audio_sync_tpu_torch.features.chroma import chroma_frames

        frames = torch.from_numpy(np.stack(windows)).to(device=self.device, dtype=self._frame_dtype)
        cols = chroma_frames(frames)  # (12, T) on the follower's device
        events: List[FollowEvent] = []
        if self.pipelined:
            # issue without waiting; the follow event reports the newest
            # completed status (== path[-1]).  The fused engine takes
            # columns one at a time (dispatched at once while the pipeline
            # has room, coalesced only under saturation)
            self.latency.start()
            if self.fused:
                status = None
                for k in range(cols.shape[1]):
                    status = self.engine.feed(cols[:, k])
                    if status == "stop":
                        break
            else:
                status = self.engine.insert_block_nowait(cols)
            self.latency.stop()
            if status != "stop":
                status = self.engine.poll()  # non-blocking opportunistic read
            if status == "stop":
                self.stopped = True
            events.append(self._event_from_status())
        elif self.use_blocks:
            self.latency.start()
            status = self.engine.insert_block(cols)
            self.latency.stop()
            if status == "stop":
                self.stopped = True
            events.append(self._event_from_status())
        else:
            for k in range(cols.shape[1]):
                self.latency.start()
                status = self.engine.insert(cols[:, k])
                self.latency.stop()
                if status == "stop":
                    self.stopped = True
                    events.append(self._event_from_status())
                    break
                events.append(self._event_from_status())
        return events

    def _event_from_status(self) -> FollowEvent:
        """Follow event from the engine's last status read (``last_point``
        == ``path[-1]``): the polled one in the pipelined mode, never a
        device synchronization; the one each synchronous insert read."""
        lp = self.engine.last_point
        if lp is None or lp[0] == 0:
            return FollowEvent(0, 0, None, None, 0.0, self.stopped)
        _, live_f, ref_f = lp
        beat, label = (None, None)
        if self.ground_truth is not None:
            beat, label = get_beat_and_label(ref_f, self.ground_truth)
        return FollowEvent(
            int(live_f), int(ref_f), beat, label, ref_f * FRAME_PERIOD_SEC, self.stopped
        )

    @property
    def path(self):
        return self.engine.path


class AudioMeter:
    """RMS→dB input meter (livenote_live.py:171-177)."""

    def __init__(self):
        self.db = -96.0

    def update(self, frames) -> float:
        mono = np.asarray(frames)
        if mono.size:
            rms = np.sqrt(np.mean(mono ** 2))
            rms = np.clip(rms, 1e-10, 1)
            self.db = float(20 * np.log10(rms))
        return self.db


class WTWFollower:
    """Live follower around the raw-audio WTW engines — the wtw_live.py
    app (the JAX package's ``streaming/runtime.py:260-403``): mic buffers go
    straight to the engine's ``insert`` (it frames its own audio), the
    display shows the current reference beat, stopping writes a field log
    in the WTW header format (wtw_live.py:169-174) and, when live ground
    truth exists, appends the accuracy-summary lines of the 'e' key
    (wtw_live.py:299-307).

    The positional parameters are the JAX follower's.  ``engine``: "wtw"
    (the host engine, windows through kernels #7 and #8 on a card),
    "wtw_async" (``AsyncWTW``: the block step on the device, each due
    window through kernels #7 and #8, float32 or float64, any window) or
    "wtw_fused" (the fused kernel, float32, windows up to 128 frames); the
    device-resident two take the position from the polled status vector,
    never from a device synchronization.  ``interpret`` is recorded by the
    fused engine and otherwise ignored; ``device`` is where chroma and
    alignment run."""

    def __init__(
        self,
        ref_wav: str,
        live_wav: Optional[str] = None,
        params: Optional[dict] = None,
        log_dir: Optional[str] = None,
        dtype=np.float32,
        engine: str = "wtw",
        transfer_dtype: str = "float32",
        interpret: bool = False,
        *,
        device="cuda",
    ):
        # live-app window sizes (wtw_live.py:106)
        self.params = dict(
            params
            or {"fft_len": 4096, "hop_size": 2048, "dtw_win_size": 4096 * 50, "dtw_hop_size": 2048 * 50}
        )
        self.ref_wav = ref_wav
        self.device = torch.device(device)
        if engine == "wtw":
            if transfer_dtype != "float32":
                raise ValueError(
                    "transfer_dtype applies to the device-resident engines "
                    "('wtw_async'/'wtw_fused') only")
            from real_time_audio_sync_tpu_torch.models.wtw import WTW

            self.dtw = WTW(ref_wav, self.params, dtype=dtype, device=self.device)
        elif engine == "wtw_async":
            # device-resident stepper: inserts dispatch asynchronously and the
            # follow position comes from the polled status vector
            from real_time_audio_sync_tpu_torch.models.wtw_async import AsyncWTW

            self.dtw = AsyncWTW(ref_wav, self.params, dtype=dtype, transfer_dtype=transfer_dtype, device=self.device)
        elif engine == "wtw_fused":
            from real_time_audio_sync_tpu_torch.models.fused_wtw import FusedWTW

            if np.dtype(dtype) != np.float32:
                raise ValueError("engine='wtw_fused' is float32-only")
            self.dtw = FusedWTW(ref_wav, self.params, transfer_dtype=transfer_dtype, interpret=interpret,
                                device=self.device)
        else:
            raise ValueError(f"unknown WTW follower engine {engine!r}")
        self.engine_name = engine
        self.ref_gt = GroundTruth.from_csv(ref_wav[:-4] + ".csv") if os.path.exists(ref_wav[:-4] + ".csv") else None
        self.live_gt = (
            GroundTruth.from_csv(live_wav[:-4] + ".csv")
            if live_wav and os.path.exists(live_wav[:-4] + ".csv")
            else None
        )
        self.meter = AudioMeter()
        self.latency = LatencyRecorder(audio_seconds_per_event=FRAME_PERIOD_SEC)
        self.log_dir = log_dir
        self.recording = False
        self.stopped = False

    def start(self) -> None:
        self.recording = True

    def receive_audio(self, frames) -> List[FollowEvent]:
        self.meter.update(frames)
        if not self.recording or self.stopped:
            return []
        self.latency.start()
        status = self.dtw.insert(np.asarray(frames, np.float32))
        self.latency.stop()
        if status == "stop":
            self.stopped = True
        if self.engine_name in ("wtw_async", "wtw_fused"):
            # the score position from the last polled status vector
            lp = self.dtw.last_point
            if lp is None or lp[0] <= 0:
                return []
            live_f, ref_f = lp[1], lp[2]
        elif not self.dtw.path:
            return []
        else:
            live_f, ref_f = self.dtw.path[-1]
        beat = get_beat(ref_f, self.ref_gt.times, self.ref_gt.beats) if self.ref_gt is not None else None
        return [FollowEvent(int(live_f), int(ref_f), beat, None, ref_f * FRAME_PERIOD_SEC, self.stopped)]

    def compute_error(self):
        """'e'-key behaviour (wtw_live.py:212-214,267-309): beat-bucket
        accuracy of the committed path; needs live ground truth."""
        if self.live_gt is None or self.ref_gt is None:
            return None
        from real_time_audio_sync_tpu_torch.eval.scorer import PathScorer

        return PathScorer(self.ref_gt, self.live_gt).score(self.dtw.path)

    def stop(self) -> Optional[str]:
        self.recording = False
        if self.engine_name in ("wtw_async", "wtw_fused") and self.dtw.flush() == "stop":  # drain in-flight launches
            self.stopped = True
        if not self.log_dir:
            return None
        os.makedirs(self.log_dir, exist_ok=True)
        log_path = os.path.join(self.log_dir, f"wtw_test_live_{time.time()}.txt")
        summary = []
        score = self.compute_error()
        if score is not None:
            for t_, label in ((1, "1 beat"), (3, "3 beats"), (5, "5 beats"), (10, "10 beats")):
                summary.append(f"Percent incorrect (within {label}):{score.pct_off_beats[t_]}%")
        write_field_log(
            log_path,
            self.ref_wav,
            [
                ("fft_len", self.params["fft_len"]),
                ("hop_size", self.params["hop_size"]),
                ("dtw_win_size", self.params["dtw_win_size"]),
                ("dtw_hop_size", self.params["dtw_hop_size"]),
            ],
            self.dtw.path,
            summary=summary,
        )
        return log_path

    @property
    def path(self):
        return self.dtw.path
