"""WTW — windowed time warping over raw audio (reference wtw.py:19-240;
the JAX package's ``models/wtw.py:37-355``).

The only engine that takes raw samples rather than chroma columns: it
buffers incoming audio, makes a chroma column a hop, and whenever
``dtw_win_size/hop_size`` fresh live frames exist runs a full DTW on the
w×w window ``[live_ptr:+w, ref_ptr:+w]``, commits the subpath up to
``dtw_hop_size``, then advances both pointers (the diagonal when the
subpath never crosses the hop boundary) — wtw.py:71-130.

This host engine replays that per-window control flow on the host: the
live chroma history lives on ``device``, every available column is
extracted on it per insert, in tiles of a fixed shape
(``features/chroma.chroma_frames_tiled``, so the columns do not depend on
how the audio arrives), and each window runs
:func:`_window_cost` and the wavefront DP and backtrack of
``ops/wavefront`` under ``WTW_SPEC`` — on the card the kernels #7 and #8,
the JAX package's ``pallas_wavefront_supported`` route
(``models/wtw.py:238-240``).  It is the parity oracle of the fused engine
(``models/fused_wtw.py``) and of ``align_pair(engine="wtw",
mode="oracle")``.

Python-2 integer division of ``dtw_win_size/hop_size`` and
``dtw_hop_size/hop_size`` (wtw.py:96-107) is kept as floor division.
"""

from __future__ import annotations

import warnings
from typing import List

import numpy as np
import torch

from real_time_audio_sync_tpu_torch.config import WTWParams
from real_time_audio_sync_tpu_torch.features.chroma import chroma_frames_tiled, chroma_from_samples, torch_dtype
from real_time_audio_sync_tpu_torch.ops.wavefront import WTW_SPEC, backtrack, wavefront_dp
from real_time_audio_sync_tpu_torch.ops.wtw_insert import window_cost
from real_time_audio_sync_tpu_torch.utils.wavio import load_wav


class WTWLongReferenceWarning(UserWarning):
    """WTW pointed at a reference far beyond its validated regime."""


# The reference only field-validated WTW on a ~35 s excerpt
# (wtw_live.py:108-109); warn at ~2x that.  WTW commits each window's
# subpath irrevocably on a fixed hop (wtw.py:110-128), so a bad early
# window cannot be revised; the online band engines are the tool for
# multi-minute pieces.
_WTW_VALIDATED_REF_S = 70.0


def _check_ref_window(m: int, params: WTWParams, fs: int = 22050) -> None:
    """Reject a reference shorter than one DTW window (the reference would
    run a degenerate short-sliced window), and warn with
    :class:`WTWLongReferenceWarning` when the reference is far longer than
    the regime WTW was validated in."""
    w = params.dtw_win_size // params.hop_size
    if m < w:
        raise ValueError(
            f"reference too short for WTW: {m} chroma frames < one DTW "
            f"window of {w} frames (dtw_win_size={params.dtw_win_size} "
            f"samples / hop_size={params.hop_size}); use a longer "
            f"reference or a smaller dtw_win_size")
    ref_s = m * params.hop_size / fs
    if ref_s > _WTW_VALIDATED_REF_S:
        warnings.warn(
            f"WTW reference is {ref_s:.0f} s — far beyond the ~35 s regime "
            "the algorithm was validated in.  WTW commits window subpaths "
            "irrevocably and measured 45-48% of beats >3 s off on "
            "multi-minute jittered pieces (docs/ACCURACY.md); prefer the "
            "online band engines (OnlineTimeWarping/LiveNote/LiveNoteV2) "
            "at this scale, or suppress this warning if the tempo is "
            "known-steady.", WTWLongReferenceWarning, stacklevel=3)


class SampleFIFO:
    """Amortized-O(1) numpy sample queue (the reference re-slices a Python
    list every hop, wtw.py:73,81-83): consumption is a pointer bump and
    compaction copies each sample at most once."""

    def __init__(self, dtype, capacity: int = 1 << 16):
        self._data = np.zeros(capacity, dtype)
        self._start = 0
        self._end = 0

    @classmethod
    def from_array(cls, arr, dtype):
        fifo = cls(dtype, capacity=max(1 << 16, 2 * len(arr)))
        fifo.extend(arr)
        return fifo

    def __len__(self) -> int:
        return self._end - self._start

    def extend(self, samples) -> None:
        samples = np.asarray(samples, self._data.dtype).ravel()
        n = len(samples)
        if self._end + n > len(self._data):
            live = self._end - self._start
            if live + n > len(self._data):  # grow
                new = np.zeros(max(2 * len(self._data), live + n), self._data.dtype)
                new[:live] = self._data[self._start : self._end]
                self._data = new
            else:  # compact
                self._data[:live] = self._data[self._start : self._end]
            self._start, self._end = 0, live
        self._data[self._end : self._end + n] = samples
        self._end += n

    def view(self, n: int) -> np.ndarray:
        """Zero-copy view of the first ``n`` queued samples."""
        return self._data[self._start : self._start + n]

    def consume(self, n: int) -> None:
        self._start += n

    def to_array(self) -> np.ndarray:
        return self.view(len(self)).copy()


def _window_cost(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Cosine cost with norm division (wtw.py:162-171) between the live
    window ``x`` (F, w) and the reference window ``y`` (F, w), in the
    fused kernel's order (:func:`~real_time_audio_sync_tpu_torch.ops.
    wtw_insert.window_cost`).  The columns are L2-normalised already, but
    the reference divides by the norms anyway, and so does this (zero
    columns give its non-finite values)."""
    return window_cost(x.T, y.T)


class WTW:
    """The host WTW engine on ``device`` (reference wtw.py:21-130).
    ``dtype`` is float32 (default) or float64; ``keep_acc_canvas`` keeps the
    dense (N, M) accumulated-cost canvas the reference paints windows into
    (wtw.py:105), a host array."""

    def __init__(self, ref_recording, params, debug_params=None, dtype=None, keep_acc_canvas=True, *,
                 device="cuda"):
        self.params = WTWParams.from_any(params)
        self.debug_params = debug_params or {}
        self.dtype = np.dtype(dtype or np.float32)
        self.device = torch.device(device)

        if isinstance(ref_recording, (str, bytes)):
            self.ref, self.fs = load_wav(ref_recording)
            assert self.fs == 22050
        else:  # raw 22.05 kHz samples
            self.ref = np.asarray(ref_recording)
            self.fs = 22050

        self.fft_len = self.params.fft_len
        self.hop_size = self.params.hop_size
        self.dtw_win_size = self.params.dtw_win_size
        self.dtw_hop_size = self.params.dtw_hop_size

        # the reference chromagram through the shared frontend (wtw.py:37-41)
        self.chroma_ref = chroma_from_samples(self.ref, dtype=self.dtype, device=self.device)
        self.N = self.chroma_ref.shape[1] * 2  # live capacity
        self.M = self.chroma_ref.shape[1]
        _check_ref_window(self.M, self.params)

        self._live_dev = torch.zeros((12, self.N), dtype=torch_dtype(self.dtype), device=self.device)
        self.keep_acc_canvas = bool(keep_acc_canvas)
        self.acc_cost = np.full((self.N, self.M), np.inf, self.dtype) if keep_acc_canvas else None

        self.buf = SampleFIFO(self.dtype)
        self.path: List[tuple] = []

        self.chroma_ptr = 0
        self.live_ptr = 0
        self.ref_ptr = 0

        self._w = self.dtw_win_size // self.hop_size  # window in frames
        self._hop_frames = self.dtw_hop_size // self.hop_size

    def insert(self, live_audio_buf):
        """Insert raw audio samples (list or array) — wtw.py:71-130.  Every
        column the buffer completes is extracted in one batch on the device;
        the reference's one-column-per-iteration bookkeeping then runs on
        host counters."""
        self.buf.extend(live_audio_buf)

        if self.ref_ptr >= self.M - 1 or self.live_ptr >= self.N - 1:
            return "stop"

        w = self._w
        while len(self.buf) >= self.fft_len:
            n_cols = (len(self.buf) - self.fft_len) // self.hop_size + 1
            avail = self.buf.view((n_cols - 1) * self.hop_size + self.fft_len)
            frames = np.lib.stride_tricks.sliding_window_view(avail, self.fft_len)[:: self.hop_size]
            cols = chroma_frames_tiled(torch.from_numpy(np.array(frames)).to(self.device), self.fft_len, self.fs)
            room = self.N - self.chroma_ptr
            if room > 0:
                cols = cols[:, :room]
                self._live_dev[:, self.chroma_ptr : self.chroma_ptr + cols.shape[1]] = cols

            for _ in range(n_cols):
                self.buf.consume(self.hop_size)
                if self.chroma_ptr >= self.N:
                    return "stop"  # live buffer capacity exhausted
                self.chroma_ptr += 1

                if self.ref_ptr >= (self.M - 1 - w) or self.live_ptr >= (self.N - 1 - w):
                    return "stop"

                while self.chroma_ptr - self.live_ptr >= w:
                    self._run_window()
        return None

    @property
    def chroma_live(self) -> np.ndarray:
        """Host copy of the live chromagram (F, N) (waits for the device)."""
        return self._live_dev.cpu().numpy()

    @chroma_live.setter
    def chroma_live(self, value) -> None:
        self._live_dev = torch.as_tensor(np.asarray(value)).to(device=self.device,
                                                                dtype=torch_dtype(self.dtype)).clone()

    def _run_window(self):
        """One w×w window DTW + subpath commit (wtw.py:100-128).  The
        committed live advance is exactly hop_frames a window and the
        per-column stop margins keep ``ref_ptr ≤ M-2-w`` and
        ``live_ptr ≤ N-2-w`` at window time, so a window never crosses a
        chromagram's end."""
        w = self._w
        assert self.ref_ptr + w <= self.M and self.live_ptr + w <= self.N
        x = self._live_dev[:, self.live_ptr : self.live_ptr + w]
        y = self.chroma_ref[:, self.ref_ptr : self.ref_ptr + w]
        acc, back = wavefront_dp(_window_cost(x, y).contiguous(), WTW_SPEC)
        points, length = backtrack(back, WTW_SPEC)
        if self.keep_acc_canvas:
            self.acc_cost[self.live_ptr : self.live_ptr + w, self.ref_ptr : self.ref_ptr + w] = acc.cpu().numpy()
        subpath = points[: int(length)].cpu().numpy()[::-1]  # origin → end

        next_start = self._hop_frames
        change = False
        index = None
        for i in range(len(subpath)):
            l, r = int(subpath[i][0]), int(subpath[i][1])
            if l <= next_start:
                self.path.append((l + self.live_ptr, r + self.ref_ptr))
            else:
                change = True
                index = i - 1
                break
        if change:
            self.live_ptr = int(subpath[index][0]) + self.live_ptr
            self.ref_ptr = int(subpath[index][1]) + self.ref_ptr
        else:
            # subpath never crossed the hop boundary: take the diagonal
            self.live_ptr = self.live_ptr + self._hop_frames
            self.ref_ptr = self.ref_ptr + self._hop_frames
