"""FusedWTW — streaming windowed time warping on the fused CUDA kernel
(the JAX package's ``models/fused_wtw.py``).

The raw-audio surface of the host ``WTW`` engine (reference wtw.py:21-130):
buffer samples, process ``k_block`` hop columns per launch, and poll
"stop" and the score position lazily from the status vector.  Each launch
is ``ops/wtw_insert.wtw_insert_block``: the column appends, every due w×w
window's cost, DP and backtrack, the subpath commit and the pointer
advance in one kernel (TPU kernel #9), on state the engine owns on
``device`` and the kernel updates in place.  A CUDA device launches the
kernel, ``"cpu"`` runs its plain version.

Each launch writes its status and the points it committed into a fresh
int32 row ``[status | dx | dy]`` (JAX's row layout); rows pending on the
device fold into one stack every ``_DELTA_STACK`` launches
(``fold_delta_tail``) and a path read drains them into the host path in
dispatch order (``drain_delta_rows``), as in the JAX engine
(fused_wtw.py:216-226).  The device holds the reference and the whole live
history; the JAX kernel's sliding live window and reference window fit
VMEM and have no counterpart here.

Committed paths equal the host ``WTW`` engine's on the same columns; as
with the other fused engines, only the timing of "stop" differs (lazy;
post-stop launches are frozen no-ops in the kernel).

Payloads (``transfer_dtype``): ``"float32"`` and ``"int16"`` sample spans
run the port's device frontend over ``k_block`` frames a launch (a ragged
last block zero-padded), in the host engine's fixed tiles
(``features/chroma.chroma_frames_tiled``), so its columns, and so its path,
are the host engine's whatever ``k_block`` and the feed; ``"chroma"``
extracts the columns on the host
(``features/chroma.host_chroma_frames``, the JAX package's bits);
``"auto"`` resolves through ``parallel/transfer.py``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from real_time_audio_sync_tpu_torch.config import WTWParams
from real_time_audio_sync_tpu_torch.features.chroma import chroma_frames_tiled, chroma_from_samples, frame_span
from real_time_audio_sync_tpu_torch.models.fused_streaming import _DELTA_STACK, drain_delta_rows, fold_delta_tail
from real_time_audio_sync_tpu_torch.models.online_core import StatusPolling
from real_time_audio_sync_tpu_torch.models.wtw import SampleFIFO, _check_ref_window
from real_time_audio_sync_tpu_torch.models.wtw_async import build_span, host_chroma_block
from real_time_audio_sync_tpu_torch.ops import wtw_insert
from real_time_audio_sync_tpu_torch.ops.wtw_insert import WS_CHROMA, WS_LIVE, WS_REF
from real_time_audio_sync_tpu_torch.utils.wavio import load_wav


class FusedWTW(StatusPolling):
    """Raw-audio streaming WTW on the fused kernel, float32 only.

    The positional order is the JAX engine's: ``k_block`` hop columns a
    launch, ``transfer_dtype`` in {"auto", "float32", "int16", "chroma"};
    ``interpret`` (its Pallas interpret switch) is recorded and otherwise
    ignored: ``device`` decides where the kernel runs."""

    dtype = np.dtype(np.float32)

    def __init__(self, ref_recording, params, debug_params=None, k_block: int = 8,
                 transfer_dtype: str = "float32", interpret: bool = False, *, device="cuda"):
        self.params = WTWParams.from_any(params)
        self.debug_params = debug_params or {}
        self.k_block = int(k_block)
        self.interpret = bool(interpret)
        self.device = torch.device(device)
        if transfer_dtype not in ("auto", "float32", "int16", "chroma"):
            raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}")
        if transfer_dtype == "auto":
            from real_time_audio_sync_tpu_torch.parallel.transfer import resolve_transfer_mode

            transfer_dtype = resolve_transfer_mode("auto", 1, self.k_block, self.params.fft_len,
                                                   self.params.hop_size, device=self.device)
        self.transfer_dtype = transfer_dtype

        if isinstance(ref_recording, (str, bytes)):
            self.ref, self.fs = load_wav(ref_recording)
            assert self.fs == 22050
        else:  # raw 22.05 kHz samples
            self.ref = np.asarray(ref_recording)
            self.fs = 22050

        self.fft_len = self.params.fft_len
        self.hop_size = self.params.hop_size
        self._w = self.params.dtw_win_size // self.hop_size
        self._hop_frames = self.params.dtw_hop_size // self.hop_size
        if self._w > wtw_insert.MAX_W:
            raise ValueError(
                f"window of {self._w} frames exceeds the fused kernel's "
                f"{wtw_insert.MAX_W}-lane layout; use AsyncWTW for larger windows")

        self.chroma_ref = chroma_from_samples(self.ref, dtype=self.dtype, device=self.device)
        self.M = self.chroma_ref.shape[1]
        _check_ref_window(self.M, self.params)
        self.N = 2 * self.M  # live capacity (wtw.py:52)
        self._state = wtw_insert.new_state(self.chroma_ref, self.N)
        self._delta_len = wtw_insert.delta_width(self._w, self._hop_frames, self.k_block)

        # per-launch rows pending host accumulation: (status, dx, dy) views
        # of one launch's row, or one folded stack
        self._deltas: list = []
        self._host_px: list = []
        self._host_py: list = []
        self._drained_plen = 0

        self.buf = SampleFIFO(self.dtype)
        self._init_status_polling()

    def _avail_cols(self) -> int:
        n = len(self.buf)
        return 0 if n < self.fft_len else (n - self.fft_len) // self.hop_size + 1

    def _columns(self, k: int) -> torch.Tensor:
        """The next block's (k_block, F) columns on the device, consuming
        its k·hop samples."""
        if self.transfer_dtype == "chroma":
            cols = host_chroma_block(self.buf, k, self.k_block, self.hop_size, self.fft_len, self.dtype)
            return torch.from_numpy(np.ascontiguousarray(cols.T)).to(self.device)
        span = build_span(self.buf, k, self.k_block, self.hop_size, self.fft_len, self.dtype)
        if self.transfer_dtype == "int16":
            span = np.clip(np.round(span * 32768.0), -32768, 32767).astype(np.int16)
        samples = torch.from_numpy(span).to(self.device)
        if self.transfer_dtype == "int16":
            samples = samples.to(torch.float32) / 32768.0
        frames = frame_span(samples, self.k_block, self.fft_len, self.hop_size)
        return chroma_frames_tiled(frames, self.fft_len, self.fs).T.contiguous()

    def _dispatch(self, k: int) -> None:
        cols = self._columns(k)
        row = torch.empty(self._delta_len, dtype=torch.int32, device=self.device)
        wtw_insert.wtw_insert_block(self._state, cols, (self.M, self.N, k), self._w, self._hop_frames,
                                    self.k_block, row)
        views = wtw_insert.delta_views(row)
        self._deltas.append(views)
        fold_delta_tail(self._deltas, _DELTA_STACK)
        self._record_status(views[0], k)

    def insert(self, live_audio_buf):
        """Insert raw audio samples; non-blocking, lazy "stop" (wtw.py:71)."""
        self.buf.extend(live_audio_buf)
        if self._stopped_cached or self.poll() == "stop":
            return "stop"
        while self._avail_cols() >= self.k_block:
            self._dispatch(self.k_block)
        return None

    insert_nowait = insert

    def flush(self):
        """Dispatch the whole remaining hop columns and wait for every
        launch; returns ``"stop"`` or None."""
        k = self._avail_cols()
        if k > 0 and not self._stopped_cached:
            self._dispatch(k)
        return self.poll(block=True)

    _overflow_msg = "FusedWTW per-launch path delta overflow"

    def _drain_deltas(self) -> None:
        """Accumulate every pending launch's committed points into the host
        path (waits for the device)."""
        self._drained_plen = drain_delta_rows(self._deltas, self._host_px, self._host_py, self._drained_plen)

    @property
    def path_array(self) -> np.ndarray:
        """(plen, 2) int32 committed (live, ref) points (waits for the device)."""
        self._drain_deltas()
        if not self._host_px:
            return np.zeros((0, 2), np.int32)
        return np.stack([np.concatenate(self._host_px), np.concatenate(self._host_py)], axis=1)

    @property
    def path(self) -> List[tuple]:
        return [tuple(int(v) for v in p) for p in self.path_array]

    @property
    def pointers(self):
        """(chroma_ptr, live_ptr, ref_ptr) (waits for the device)."""
        sc = self._state.scalars.cpu()
        return int(sc[WS_CHROMA]), int(sc[WS_LIVE]), int(sc[WS_REF])
