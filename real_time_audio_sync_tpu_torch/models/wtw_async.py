"""AsyncWTW — the device-resident streaming WTW engine (the JAX package's
``models/wtw_async.py``), and the block step it shares with
``parallel/wtw_serving.MultiStreamWTW``.

The host ``WTW`` engine (``models/wtw.py``) replays the reference's
per-window control flow (wtw.py:71-130) on the host and reads every
window's subpath back.  Here the whole streaming step stays on the device:
the live chromagram, the pointers, the committed path and the stop flag
are device tensors carried across dispatches, and each dispatch takes a
block of hop columns: it appends them, runs every window that comes due
(its cosine cost, the DP and backtrack under ``WTW_SPEC`` and the commit
of the points with ``l ≤ hop_frames``) and advances the pointers.  "stop"
and the score position are polled lazily from a status vector
``[flags, path_len, last x, last y]`` (``models/online_core.StatusPolling``).

Nothing on the insert path reads a device value on the host.  The JAX
module's invariant (its docstring, :15-23) makes that possible: a window's
subpath attains every live offset from 0 to w−1, so each window advances
``live_ptr`` by exactly ``hop_frames``, and ``chroma_ptr`` advances by one
a column until a stop.  The host therefore knows, without a read, which
column of a block makes a window due, where its live rows start, and the
capacity and live-margin stops (:class:`StreamSchedule`).  Only
``ref_ptr`` is known on the device alone, and with it the reference-margin
stop: each block ships a small table of the block's segments (the columns
between two windows) with its payload, the device applies the margin check
at each segment's first column (``ref_ptr`` changes only at a window), and
a window of a stopped stream is a masked no-op.  The window's reference
rows are gathered by an index tensor from the device ``ref_ptr``.

On the card the windows of a block's window slot run through the
hand-written wavefront kernels, TPU kernels #7 (``wavefront_dp_pallas``)
and #8 (``backtrack_pallas``), as ONE launch of each over the streams due
in that slot (``ops/wavefront``'s batched call; a solo engine's batch is
1).  ``window_backend`` "auto" and "pallas" take them at every window size
(the JAX package's crossover at 2w−1 ≤ 64 is a TPU measurement);
"scan" and "unroll", JAX's lax routes, run the plain tensor DP and
backtrack explicitly on any device.  JAX's ``body_hoisted`` (a TPU
scheduling device) has no counterpart: ``block_impl`` "hoisted" and
"cols" are two spellings of one implementation, with the semantics of
JAX's ``body_cols`` (:131-214).  Past ``chroma_ptr`` the live buffer is
unspecified, as JAX documents (:553-562).

Live columns come from the span on the device through
``features/chroma.chroma_frames_tiled`` in tiles of 8 frames, as in
``FusedWTW``, so a column's bits do not depend on ``k_block`` or on how
the audio arrives; ``transfer_dtype="chroma"`` extracts them on the host
(the JAX package's bits).

Committed paths equal the host ``WTW`` engine's on the same columns; only
the timing of "stop" differs (lazy; dispatches after a stop are no-ops).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from real_time_audio_sync_tpu_torch.config import FS, WTWParams
from real_time_audio_sync_tpu_torch.features.chroma import (
    chroma_frames_tiled,
    chroma_from_samples,
    frame_span,
    host_chroma_frames,
    torch_dtype,
)
from real_time_audio_sync_tpu_torch.models.online_core import StatusPolling
from real_time_audio_sync_tpu_torch.models.wtw import SampleFIFO, _check_ref_window
from real_time_audio_sync_tpu_torch.ops import wavefront
from real_time_audio_sync_tpu_torch.ops.wavefront import WTW_SPEC
from real_time_audio_sync_tpu_torch.ops.wtw_insert import window_cost
from real_time_audio_sync_tpu_torch.utils.wavio import load_wav

# scalar-state layout (int32[8]), the JAX engine's (wtw_async.py:90-95)
W_CHROMA = 0  # columns appended so far
W_LIVE = 1  # live window origin (frames)
W_REF = 2  # reference window origin (frames)
W_PLEN = 3  # committed path length
W_FLAGS = 4  # bit 0 stopped, bit 1 path-buffer overflow
N_SCALARS = 8

WINDOW_BACKENDS = ("auto", "unroll", "scan", "pallas")
TRANSFER_MODES = ("auto", "float32", "int16", "chroma")


def build_span(fifo, k: int, k_block: int, hop: int, fft: int, dtype) -> np.ndarray:
    """One block's contiguous sample span from a ``SampleFIFO``, consuming
    its ``k·hop`` samples.  Always the static ``(k_block−1)·hop + fft``
    samples (a ragged tail zero-padded; the padded columns are past
    ``n_valid``) and always a copy: the FIFO's storage is mutated in place
    by ``consume``/``extend`` while a copy to the card may still read it."""
    span_len = (k_block - 1) * hop + fft
    avail = fifo.view((k - 1) * hop + fft)
    if avail.shape[0] < span_len:
        span = np.zeros(span_len, dtype)
        span[: avail.shape[0]] = avail
    else:
        span = np.array(avail, dtype, copy=True)
    fifo.consume(k * hop)
    return span


def host_chroma_block(fifo, k: int, k_block: int, hop: int, fft: int, dtype) -> np.ndarray:
    """One block's (12, k_block) chroma columns extracted on the host,
    consuming the block's ``k·hop`` samples (``transfer_dtype="chroma"``);
    the span and consumption of :func:`build_span`."""
    span = build_span(fifo, k, k_block, hop, fft, dtype)
    stride = span.strides[0]
    frames = np.lib.stride_tricks.as_strided(span, shape=(k_block, fft), strides=(hop * stride, stride))
    return host_chroma_frames(frames, n_fft=fft)


def path_capacity(n_cap: int, w: int, hop_frames: int) -> int:
    """The committed path's exact bound (the JAX engine's p_cap): at most
    2w−1 points a window, at most n_cap/hop_frames + 2 windows."""
    return (n_cap // hop_frames + 2) * (2 * w - 1) + 64


class StreamSchedule:
    """The host's view of one stream's ``chroma_ptr`` and ``live_ptr`` and
    of the stops it can see (capacity and live margin), kept without a read
    of the device.  :meth:`segments` steps a block's columns with the JAX
    ``body_cols`` order — capacity stop before the increment, margin stop,
    then at most one due window a column — and cuts them into segments,
    each ending at a due window, a stop or the block's end."""

    def __init__(self, w: int, hop_frames: int, n_cap: int):
        self.w, self.hop, self.n_cap = w, hop_frames, n_cap
        self.chroma = self.live = 0
        self.stopped = False

    def segments(self, k: int) -> list:
        """``[(columns counted, host stop, window live_ptr or -1), ...]`` for
        the block's next ``k`` columns; updates the view."""
        segs, n_inc, stopped_now = [], 0, False
        for _ in range(k):
            if self.stopped:
                break
            if self.chroma >= self.n_cap:  # capacity stop, before the increment
                self.stopped = stopped_now = True
                break
            self.chroma += 1
            n_inc += 1
            if self.live >= self.n_cap - 1 - self.w:  # the live margin
                self.stopped = stopped_now = True
                break
            if self.chroma - self.live >= self.w:  # a window is due at this column
                segs.append((n_inc, 0, self.live))
                n_inc = 0
                self.live += self.hop
        if n_inc or stopped_now:
            segs.append((n_inc, int(stopped_now), -1))
        return segs


class BlockStepper:
    """The block step of B streams on device tensors: the state of the JAX
    engines (live chromagram, committed path, scalars; JAX's ``live_dev``
    (F, N) as rows (N, F)) with a leading stream axis, each stream on its
    own reference length ``m`` and live capacity ``n_cap``, the references
    stored once each (``ref_ids`` maps a stream to its reference).

    Device state: ``ref`` (U, m_max, F), ``live`` (B, n_buf + 1, F) and
    ``px``, ``py`` (B, p_cap + 1) int32, each with a last row or column that
    takes dropped writes, and ``sc`` (B, 8) int32."""

    def __init__(self, refs: Sequence[torch.Tensor], ref_ids: Sequence[int], n_caps: Sequence[int], w: int,
                 hop_frames: int, k_block: int, window_backend: str, dtype, device, n_buf: Optional[int] = None):
        self.w, self.hop, self.k_block = int(w), int(hop_frames), int(k_block)
        self.window_backend = window_backend
        self.device = torch.device(device)
        self.dtype = torch_dtype(dtype)
        self.b = len(ref_ids)
        f = refs[0].shape[0]
        ms = [int(refs[i].shape[1]) for i in ref_ids]
        self.m_max = max(int(r.shape[1]) for r in refs)
        self.n_buf = max([int(n) for n in n_caps] + [n_buf or 0])  # n_buf: a larger batch's rows (a shard)
        self.p_cap = path_capacity(self.n_buf, self.w, self.hop)
        self.max_pts = 2 * self.w - 1
        self.max_slots = self.k_block + 1  # segments a block: one a due window, and the tail
        dev, dt = self.device, self.dtype
        self.ref = torch.zeros((len(refs), self.m_max, f), dtype=dt, device=dev)
        for u, r in enumerate(refs):
            self.ref[u, : r.shape[1]] = r.T.to(dt)
        self.ref_ids = torch.tensor(list(ref_ids), dtype=torch.long).to(dev)
        self.live = torch.zeros((self.b, self.n_buf + 1, f), dtype=dt, device=dev)
        self.px = torch.zeros((self.b, self.p_cap + 1), dtype=torch.int32, device=dev)
        self.py = torch.zeros_like(self.px)
        self.sc = torch.zeros((self.b, N_SCALARS), dtype=torch.int32, device=dev)
        # the reference margin of each stream (wtw.py's window-feasibility guard)
        self.ref_limit = torch.tensor([m - 1 - self.w for m in ms], dtype=torch.int32).to(dev)
        self.ar_w = torch.arange(self.w, device=dev)
        self.ar_pts = torch.arange(self.max_pts, device=dev)
        self.ar_b = torch.arange(self.b, device=dev)
        self.schedules = [StreamSchedule(self.w, self.hop, int(n)) for n in n_caps]

    # -- the host's plan of a block (no device read) ---------------------------

    def plan(self, ks) -> tuple:
        """The block's host arrays for per-stream column counts ``ks``:
        ``pos`` (B·k_block,) int64 flat live rows of the appended columns
        (dropped ones to each stream's last row), ``table`` (slots, 4, B)
        int32 — each slot's [columns counted, host stop, window due, window
        live_ptr] a stream — and ``due`` (slots, B) int64, the streams with a
        window in each slot first; with the host's slots used and windows a
        slot."""
        b, kb, stride = self.b, self.k_block, self.n_buf + 1
        pos = np.empty((b, kb), np.int64)
        pos[:] = (np.arange(b, dtype=np.int64) * stride + self.n_buf)[:, None]
        table = np.zeros((self.max_slots, 4, b), np.int32)
        due = np.zeros((self.max_slots, b), np.int64)
        counts = [0] * self.max_slots
        slots = 0
        for i, (sched, k) in enumerate(zip(self.schedules, ks)):
            k = int(k)
            if k and not sched.stopped:
                k_app = max(0, min(k, sched.n_cap - sched.chroma))
                pos[i, :k_app] = i * stride + sched.chroma + np.arange(k_app)
            for s, (n_inc, stop, lp) in enumerate(sched.segments(k)):
                table[s, :, i] = (n_inc, stop, lp >= 0, max(lp, 0))
                if lp >= 0:
                    due[s, counts[s]] = i
                    counts[s] += 1
                slots = max(slots, s + 1)
        return pos.reshape(-1), table, due, slots, counts[:slots]

    # -- the device step -------------------------------------------------------

    def run(self, cols: torch.Tensor, pos: torch.Tensor, table: torch.Tensor, due: torch.Tensor, slots: int,
            counts) -> torch.Tensor:
        """Apply one planned block to the device state: ``cols`` (B,
        k_block, F) live columns, the plan's arrays on the device; returns
        the (B, 4) int32 status ``[flags, path_len, last x, last y]``."""
        f = self.live.shape[-1]
        self.live.view(-1, f).index_copy_(0, pos, cols.reshape(-1, f).to(self.dtype))
        sc = self.sc
        for s in range(slots):
            n_inc, host_stop = table[s, 0], table[s, 1]
            # a stream takes part where it has a segment in this slot (columns
            # or a stop) and has not stopped
            act = ((sc[:, W_FLAGS] & 1) == 0) & ((n_inc > 0) | (host_stop != 0))
            at_margin = sc[:, W_REF] >= self.ref_limit
            # a stop at the segment's first column counts that column only
            sc[:, W_CHROMA].add_(torch.where(act, torch.where(at_margin, n_inc.clamp(max=1), n_inc), 0))
            sc[:, W_FLAGS].bitwise_or_((act & (at_margin | (host_stop != 0))).to(torch.int32))
            if counts[s]:
                self._window(due[s, : counts[s]], act & ~at_margin)
        plen = sc[:, W_PLEN]
        last = (plen.long() - 1).clamp(min=0)[:, None]
        has = plen > 0
        return torch.stack([sc[:, W_FLAGS], plen, torch.where(has, self.px.gather(1, last)[:, 0], -1),
                            torch.where(has, self.py.gather(1, last)[:, 0], -1)], dim=1)

    def _window(self, idx: torch.Tensor, run: torch.Tensor) -> None:
        """The due window of each stream in ``idx`` (wtw.py:100-128): its
        cost, DP and backtrack as one batch, then the commit of the points
        with ``l ≤ hop_frames`` and the pointer advance where ``run``."""
        w, hop, p_cap, n_pts = self.w, self.hop, self.p_cap, self.max_pts
        sc = self.sc
        lp, rp = sc[idx, W_LIVE].long(), sc[idx, W_REF].long()
        x = self.live[idx[:, None], lp[:, None] + self.ar_w]  # (Bs, w, F)
        rows = (rp[:, None] + self.ar_w).clamp(max=self.m_max - 1)  # a stopped stream's rows stay in range
        y = self.ref[self.ref_ids[idx][:, None], rows]
        cost = window_cost(x, y)
        if self.window_backend in ("scan", "unroll"):
            _, back = wavefront.wavefront_dp_reference(cost, WTW_SPEC)
            points, length = wavefront.backtrack_reference(back, WTW_SPEC)
        else:
            _, back = wavefront.wavefront_dp(cost, WTW_SPEC)
            points, length = wavefront.backtrack(back, WTW_SPEC)
        length = length.long()
        j = self.ar_pts
        # committed prefix: the points with l ≤ hop_frames (l is nondecreasing
        # from the origin, so their count is the prefix length) — wtw.py:110-115
        n_c = ((j < length[:, None]) & (points[..., 0] <= hop)).sum(1)
        # origin-order point j is points[length-1-j]
        order = (length[:, None] - 1 - j).clamp(0, n_pts - 1)
        pts = points.gather(1, order[..., None].expand(-1, -1, 2))
        go = run[idx]
        plen = sc[idx, W_PLEN].long()
        dest = plen[:, None] + j
        dest = torch.where((j < n_c[:, None]) & go[:, None] & (dest < p_cap), dest, p_cap)  # p_cap: dropped
        self.px[idx[:, None], dest] = pts[..., 0] + lp[:, None].to(torch.int32)
        self.py[idx[:, None], dest] = pts[..., 1] + rp[:, None].to(torch.int32)
        over = go & (plen + n_c > p_cap)
        change = n_c < length  # some subpath point crossed the hop boundary
        last = pts[self.ar_b[: idx.shape[0]], (n_c - 1).clamp(0, n_pts - 1)]  # the last committed point
        new_lp = lp + torch.where(change, last[:, 0].long(), hop)
        new_rp = rp + torch.where(change, last[:, 1].long(), hop)
        sc[idx, W_LIVE] = torch.where(go, new_lp, lp).to(torch.int32)
        sc[idx, W_REF] = torch.where(go, new_rp, rp).to(torch.int32)
        sc[idx, W_PLEN] = torch.where(go, (plen + n_c).clamp(max=p_cap), plen).to(torch.int32)
        sc[idx, W_FLAGS] |= over.to(torch.int32) * 2

    # -- reads and loads (each waits for the device) ----------------------------

    def paths(self) -> List[np.ndarray]:
        """Each stream's committed (plen, 2) int32 points."""
        px, py, plen = self.px.cpu().numpy(), self.py.cpu().numpy(), self.sc[:, W_PLEN].cpu().numpy()
        return [np.stack([px[i, : plen[i]], py[i, : plen[i]]], axis=1) for i in range(self.b)]

    def pointers(self) -> list:
        sc = self.sc.cpu().numpy()
        return [(int(s[W_CHROMA]), int(s[W_LIVE]), int(s[W_REF])) for s in sc]

    def set_state(self, live: torch.Tensor, px: torch.Tensor, py: torch.Tensor, sc: torch.Tensor) -> None:
        """Load a whole state in this layout (``utils/convert``'s
        ``*async_wtw_state_from_jax``) and the host's view from its scalars."""
        self.live.copy_(live)
        self.px.copy_(px)
        self.py.copy_(py)
        self.sc.copy_(sc)
        for sched, s in zip(self.schedules, sc.cpu().numpy()):
            sched.chroma, sched.live = int(s[W_CHROMA]), int(s[W_LIVE])
            sched.stopped = bool(s[W_FLAGS] & 1)

    def device_bytes(self) -> int:
        """Bytes of the state on the device (the references counted once)."""
        return sum(t.numel() * t.element_size() for t in (self.ref, self.live, self.px, self.py, self.sc))


def check_window_backend(window_backend: str, device: torch.device) -> str:
    """``window_backend`` validated for ``device``: "pallas" names the
    kernels and raises off a CUDA device, as ``models/dtw``'s
    ``backend="pallas"`` does; "auto" takes them there too."""
    if window_backend not in WINDOW_BACKENDS:
        raise ValueError(f"unknown window_backend {window_backend!r}")
    if window_backend == "pallas" and device.type != "cuda":
        raise ValueError(f"window_backend='pallas' unsupported on this platform ({device.type}): "
                         "the wavefront kernels run on a CUDA device")
    return window_backend


def check_dtype(dtype) -> np.dtype:
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    return dtype


class AsyncWTW(StatusPolling):
    """Raw-audio streaming WTW with asynchronous dispatch: ``k_block`` hop
    columns a dispatch, every due window through kernels #7 and #8 on the
    card, "stop" and the score position polled lazily.

    The positional parameters are the JAX engine's (wtw_async.py:358-563):
    ``dtype`` float32 or float64 (on the card too), ``window_backend`` in
    {"auto", "pallas", "scan", "unroll"}, ``block_impl`` "hoisted" or
    "cols" (one implementation), ``transfer_dtype`` in {"auto", "float32",
    "int16", "chroma"}.  ``device`` is where the state lives and the block
    step runs: a CUDA device launches the kernels, ``"cpu"`` runs their
    plain versions."""

    def __init__(self, ref_recording, params, debug_params=None, k_block: int = 8, window_backend: str = "auto",
                 dtype=np.float32, block_impl: str = "hoisted", transfer_dtype: str = "float32", *,
                 device="cuda"):
        self.params = WTWParams.from_any(params)
        self.debug_params = debug_params or {}
        self.k_block = int(k_block)
        self.device = torch.device(device)
        if transfer_dtype not in TRANSFER_MODES:
            raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}")
        if transfer_dtype == "auto":
            from real_time_audio_sync_tpu_torch.parallel.transfer import resolve_transfer_mode

            transfer_dtype = resolve_transfer_mode("auto", 1, self.k_block, self.params.fft_len,
                                                   self.params.hop_size, device=self.device)
        self.transfer_dtype = transfer_dtype
        self.dtype = check_dtype(dtype)
        if block_impl not in ("hoisted", "cols"):
            raise ValueError(f"unknown block_impl {block_impl!r}")
        self.block_impl = block_impl
        self.window_backend = check_window_backend(window_backend, self.device)

        if isinstance(ref_recording, (str, bytes)):
            self.ref, self.fs = load_wav(ref_recording)
            assert self.fs == FS
        else:  # raw 22.05 kHz samples (parity with MultiStreamWTW)
            self.ref = np.asarray(ref_recording)
            self.fs = FS

        self.fft_len = self.params.fft_len
        self.hop_size = self.params.hop_size
        self._w = self.params.dtw_win_size // self.hop_size
        self._hop_frames = self.params.dtw_hop_size // self.hop_size
        assert self._hop_frames >= 1  # WTWParams validates it

        self.chroma_ref = chroma_from_samples(self.ref, dtype=torch_dtype(self.dtype), device=self.device)
        self.M = self.chroma_ref.shape[1]
        _check_ref_window(self.M, self.params)
        self.N = 2 * self.M  # live capacity (wtw.py:52)
        self._stepper = BlockStepper([self.chroma_ref], [0], [self.N], self._w, self._hop_frames, self.k_block,
                                     self.window_backend, self.dtype, self.device)
        self._staging = None
        if self.device.type == "cuda":
            from real_time_audio_sync_tpu_torch.parallel.serving import PinnedStaging

            span = (self.k_block - 1) * self.hop_size + self.fft_len
            nbytes = 12 * self.k_block * self.dtype.itemsize if self.transfer_dtype == "chroma" else (
                span * (2 if self.transfer_dtype == "int16" else self.dtype.itemsize))
            st = self._stepper
            self._staging = PinnedStaging(PinnedStaging.nbytes(nbytes, st.k_block * 8, st.max_slots * 4 * 4,
                                                               st.max_slots * 8), self.device)
        self.buf = SampleFIFO(self.dtype)
        self._init_status_polling()

    # ------------------------------------------------------------------

    def _avail_cols(self) -> int:
        n = len(self.buf)
        return 0 if n < self.fft_len else (n - self.fft_len) // self.hop_size + 1

    def _payload(self, k: int) -> np.ndarray:
        """The block's host payload, consuming its k·hop samples: the sample
        span (float or int16) or the host chroma columns (k_block, 12)."""
        if self.transfer_dtype == "chroma":
            cols = host_chroma_block(self.buf, k, self.k_block, self.hop_size, self.fft_len, self.dtype)
            return np.ascontiguousarray(cols.T)
        span = build_span(self.buf, k, self.k_block, self.hop_size, self.fft_len, self.dtype)
        if self.transfer_dtype == "int16":
            return np.clip(np.round(span * 32768.0), -32768, 32767).astype(np.int16)
        return span

    def _columns(self, payload: torch.Tensor) -> torch.Tensor:
        """The block's (1, k_block, F) live columns on the device."""
        if self.transfer_dtype == "chroma":
            return payload[None]
        if self.transfer_dtype == "int16":
            payload = payload.to(torch_dtype(self.dtype)) / 32768.0
        frames = frame_span(payload, self.k_block, self.fft_len, self.hop_size)
        return chroma_frames_tiled(frames, self.fft_len, self.fs).T[None]

    def _dispatch(self, k: int) -> None:
        payload = self._payload(k)
        st = self._stepper
        if st.schedules[0].stopped:  # the host saw the stop: the block is a no-op on the device
            return
        pos, table, due, slots, counts = st.plan([k])
        if self._staging is not None:
            payload_d, pos_d, table_d, due_d = self._staging.put(payload, pos, table, due)
        else:
            payload_d, pos_d, table_d, due_d = (torch.from_numpy(a) for a in (payload, pos, table, due))
        status = st.run(self._columns(payload_d), pos_d, table_d, due_d, slots, counts)
        self._record_status(status[0], k)

    def insert(self, live_audio_buf):
        """Insert raw audio samples; non-blocking.  Returns ``"stop"`` once a
        polled status showed it (lazy; later dispatches are no-ops, so the
        committed path is unaffected)."""
        self.buf.extend(live_audio_buf)
        if self._stopped_cached or self.poll() == "stop":
            return "stop"
        while self._avail_cols() >= self.k_block:
            self._dispatch(self.k_block)
        return None

    insert_nowait = insert

    def flush(self):
        """Dispatch the whole remaining hop columns (a trailing partial
        frame of < fft_len samples stays buffered, as in the reference) and
        wait for every dispatch; returns ``"stop"`` or None."""
        k = self._avail_cols()
        if k > 0 and not self._stopped_cached:
            self._dispatch(k)
        return self.poll(block=True)

    _overflow_msg = "AsyncWTW path buffer overflow"

    # -- inspection (each waits for the device) --------------------------------

    @property
    def path_array(self) -> np.ndarray:
        """(plen, 2) int32 committed (live, ref) points."""
        return self._stepper.paths()[0]

    @property
    def path(self) -> List[tuple]:
        return [tuple(int(v) for v in p) for p in self.path_array]

    @property
    def pointers(self):
        """(chroma_ptr, live_ptr, ref_ptr)."""
        return self._stepper.pointers()[0]

    @property
    def chroma_live(self) -> np.ndarray:
        """The live chromagram (F, N).  Columns at ``chroma_ptr`` and past it
        are unspecified: a block's columns are appended before its stops
        are known (the JAX engine's contract, wtw_async.py:553-562)."""
        return self._stepper.live[0, : self.N].T.cpu().numpy()

