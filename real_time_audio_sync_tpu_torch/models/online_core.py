"""Shared core of the online score followers: direction encodings, the
per-engine config deltas, the static engine config, lazy status polling,
and the online engine itself on tensors (the JAX package's
``models/online_core.py``).

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

The engine (:class:`BandedOnlineEngine`, the JAX package's XLA engine) runs
the recurrence as PyTorch tensor code on the caller's device over the
dense (2N, N) accumulator, with a leading stream axis B on every state
tensor (one engine is B = 1; ``parallel/serving.MultiStreamFollower`` runs
B).  Per insert one row band is evaluated, then the row/column state
machine runs ``max_run_count + 3`` masked iterations (the slope
constraint forces the direction away from Column once run_count
saturates), so nothing on the insert path reads a device value on the
host: a pipelined caller never waits for the card.  A CUDA device runs
this as many small kernel launches (the band's costs, the chain's
log₂ c stages, the argmins, six times an insert); it launches no
hand-written kernel.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from real_time_audio_sync_tpu_torch.config import OTWParams
from real_time_audio_sync_tpu_torch.ops.band import _arange, _cost_vector, band_argmin, col_update, eval_cell, row_update

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
    exact_chain: bool = False  # sequential band chain (parity mode); only the tensor engine reads it

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


# ---------------------------------------------------------------------------
# The online engine on tensors (the JAX package's online_core.py:328-834)
# ---------------------------------------------------------------------------


class OnlineState(NamedTuple):
    """Complete engine state: the JAX package's 14 fields, each with a
    leading stream axis B, on one device.  Pointers and path entries are
    int64 (torch indexes with them); ``utils/convert`` carries a state to
    and from the JAX layout."""

    live: torch.Tensor  # (B, F, M) live feature buffer, M = 2N
    acc: torch.Tensor  # (B, M, N) accumulated cost
    t: torch.Tensor  # (B,) live pointer
    j: torch.Tensor  # (B,) ref pointer
    direction: torch.Tensor  # ROW/COL/BOTH
    previous: torch.Tensor  # PREV_NONE/ROW/COL
    run_count: torch.Tensor
    path: torch.Tensor  # (B, P, 2), P = M + N + 8
    path_len: torch.Tensor
    last_x: torch.Tensor  # last appended path point (V2 monotone guard), kept
    last_y: torch.Tensor  # as scalars so the guard never reads the path
    first: torch.Tensor  # bool: next insert is the first
    stopped: torch.Tensor  # bool: ref sequence exhausted ("stop")
    overflow: torch.Tensor  # bool: unrolled loop bound violated (never, by design)


def init_state(ref: torch.Tensor, cfg: OnlineConfig, dtype) -> OnlineState:
    """A fresh state for the (B, F, N) references ``ref``, on their device."""
    b, f, n = ref.shape
    m = 2 * n
    # the dense (2N, N) accumulator is this engine's parity-with-reference
    # artifact (otw_eran.py:23-27); past ~8 GB a stream it cannot exist on
    # any card.  Long scores belong on the banded engines, which are
    # path-identical.
    acc_bytes = 2 * n * n * torch.empty((), dtype=dtype).element_size()
    if acc_bytes > 8 << 30:
        raise ValueError(
            f"reference of {n} frames needs a {acc_bytes / 2**30:.0f} GB dense"
            f" accumulator in the tensor engine; hour-scale references belong on"
            f" the banded engines: FusedStreamingEngine or"
            f" parallel.FusedMultiStreamFollower (long-reference kernel"
            f" auto-engages above N=6000), or the WTW engines for raw audio"
        )
    dev = ref.device

    def scalar(value, dt=torch.int64):
        return torch.full((b,), value, dtype=dt, device=dev)

    return OnlineState(
        live=torch.zeros((b, f, m), dtype=dtype, device=dev),
        acc=torch.full((b, m, n), cfg.sentinel, dtype=dtype, device=dev),
        t=scalar(0),
        j=scalar(0),
        direction=scalar(BOTH),
        previous=scalar(PREV_NONE),
        run_count=scalar(cfg.run_count_init),
        path=torch.zeros((b, m + n + 8, 2), dtype=torch.int64, device=dev),
        path_len=scalar(0),
        last_x=scalar(-1),
        last_y=scalar(-1),
        first=scalar(True, torch.bool),
        stopped=scalar(False, torch.bool),
        overflow=scalar(False, torch.bool),
    )


def _append_point(path, path_len, last_x, last_y, x, y, monotone: bool, enable=None):
    """Append (x, y) at ``path_len`` (in place); under the V2 guard only
    when strictly forward in live and non-backward in ref
    (livenote_v2.py:197-199).  The slot clamps to the buffer's last, as
    ``dynamic_update_slice`` does.  Returns (path_len, last_x, last_y)."""
    b, p, _ = path.shape
    ok = (path_len == 0) | ((x > last_x) & (y >= last_y)) if monotone else None
    if enable is not None:
        ok = enable if ok is None else ok & enable
    if ok is None:
        ok = torch.ones_like(path_len, dtype=torch.bool)
    flat = path.view(b, 2 * p)
    slot = (2 * path_len.clamp(max=p - 1))[:, None] + _arange(2, path.device)
    flat.scatter_(1, slot, torch.where(ok[:, None], torch.stack([x, y], dim=1), torch.gather(flat, 1, slot)))
    return path_len + ok, torch.where(ok, x, last_x), torch.where(ok, y, last_y)


def _set_direction(acc, t, j, run_count, previous, path, path_len, last_x, last_y, cfg: OnlineConfig, enable=None,
                   old_direction=None):
    """otw_eran.py:153-188 / livenote.py:184-207 as integer arithmetic.

    Appends the best point, chooses the next direction, updates
    run_count/previous.  Returns (direction, run_count, previous, path_len,
    last_x, last_y); the path is written in place.  ``enable=False`` makes
    a stream's call a no-op."""
    x, y = band_argmin(acc, t, j, c=cfg.c)
    path_len, last_x, last_y = _append_point(path, path_len, last_x, last_y, x, y, cfg.monotone_path, enable)

    forced_dir = torch.where(previous == ROW, COL, ROW)
    free_dir = torch.where(x < t, COL, torch.where(y < j, ROW, BOTH))
    d = torch.where(t < cfg.c, BOTH, torch.where(run_count >= cfg.max_run_count, forced_dir, free_dir))
    rc_new = torch.where(d == previous, run_count + 1, 1)
    prev_new = torch.where(d != BOTH, d, previous)
    if enable is not None:
        d = torch.where(enable, d, old_direction)
        rc_new = torch.where(enable, rc_new, run_count)
        prev_new = torch.where(enable, prev_new, previous)
    return d, rc_new, prev_new, path_len, last_x, last_y


def _column_phase(state: OnlineState, ref, cfg: OnlineConfig, ref_len=None, active_init=None) -> OnlineState:
    """The reference's inner while-loop (otw_eran.py:64-85) as
    ``loop_iters`` masked iterations: the slope constraint caps consecutive
    Column directions at max_run_count, so the loop ends within the bound
    by construction (``overflow`` flags any violation).  A masked
    iteration is a no-op, so the result is the early-exit loop's (JAX
    ``online_core.py:436-442``), and no iteration asks the device whether
    it may stop."""
    n = ref.shape[2] if ref_len is None else ref_len
    st = state
    active = ~st.stopped if active_init is None else active_init
    for _ in range(cfg.loop_iters):
        do_col = active & (st.direction != ROW)
        j_new = st.j + do_col
        new_stop = do_col & (j_new >= n)
        col_update(st.acc, st.live, ref, st.t, j_new, c=cfg.c, sentinel=cfg.sentinel, euclidean=cfg.euclidean,
                   exact=cfg.exact_chain, enable=do_col & ~new_stop)
        do_dir = active & ~new_stop
        d, rc, prev, plen, lx, ly = _set_direction(
            st.acc, st.t, j_new, st.run_count, st.previous, st.path, st.path_len, st.last_x, st.last_y, cfg,
            enable=do_dir, old_direction=st.direction)
        st = st._replace(j=j_new, direction=d, run_count=rc, previous=prev, path_len=plen, last_x=lx, last_y=ly,
                         stopped=st.stopped | new_stop)
        active = do_dir & (d == COL)
    return st._replace(overflow=st.overflow | active)


def _write_live_column(live, pos, col, enable):
    """``live[:, :, pos] = col`` where ``enable``, in place; ``pos`` is
    clamped to the buffer as ``dynamic_update_slice`` clamps it."""
    b, f, m = live.shape
    idx = pos.clamp(0, m - 1).view(b, 1, 1).expand(b, f, 1)
    live.scatter_(2, idx, torch.where(enable[:, None, None], col[:, :, None], torch.gather(live, 2, idx)))


def _insert_body(state: OnlineState, col, ref, cfg: OnlineConfig, ref_len=None, live_cap=None,
                 active=None) -> OnlineState:
    """One streaming insert of each stream's column ``col`` (B, F)
    (otw_eran.py:38-85 / livenote.py:37-98); ``acc``, ``live`` and
    ``path`` are updated in place.

    ``ref_len``/``live_cap`` ((B,) tensors) override the shape-derived
    sequence bounds for zero-padded batched serving; ``active`` (B,) bool
    freezes the streams it clears, as the JAX ``_batched_insert``'s
    ``where(act, new, old)`` does.  After "stop" every effect is masked
    off (the reference's caller must cease calling insert or it reads out
    of bounds; this freezes instead)."""
    st = state
    cap = st.live.shape[2] if live_cap is None else live_cap
    alive = ~st.stopped if active is None else active & ~st.stopped
    is_first = alive & st.first
    is_normal = alive & ~st.first

    # the first insert fills live column 0 and evaluates the origin cell; a
    # normal one advances t ("ran out of room" keeps incrementing t and does
    # nothing else, otw_eran.py:50-54) and fills column t
    t_new = st.t + is_normal
    do_row = is_normal & (t_new < cap)
    _write_live_column(st.live, torch.where(is_first, 0, t_new), col, is_first | do_row)
    origin = st.acc.view(st.acc.shape[0], -1)[:, 0]
    c00 = _cost_vector(col, ref[:, :, :1], cfg.euclidean)[:, 0]
    origin.copy_(torch.where(is_first, c00, origin))
    row_update(st.acc, st.live, ref, t_new, st.j, c=cfg.c, sentinel=cfg.sentinel, euclidean=cfg.euclidean,
               exact=cfg.exact_chain, enable=do_row)
    st = st._replace(t=t_new, first=st.first & ~is_first)
    return _column_phase(st, ref, cfg, ref_len, active_init=do_row)


def _status_vec(st: OnlineState) -> torch.Tensor:
    """(B, 4) status ``[stopped | overflow<<1, path_len, last_x, last_y]``:
    a separate small tensor, so the host can detect "stop" and read the
    current score position (== ``path[-1]``, otw_eran.py:158-160) with one
    tiny copy behind an event, never synchronizing on the state."""
    return torch.stack([st.overflow * 2 + st.stopped, st.path_len, st.last_x, st.last_y], dim=1)


def insert_step(state: OnlineState, col, ref, cfg: OnlineConfig):
    """One streaming insert of ``col`` (B, F) against ``ref`` (B, F, N);
    returns ``(state, status)``.  The column phase's iterations are all
    issued; nothing waits for the device."""
    st = _insert_body(state, col, ref, cfg)
    return st, _status_vec(st)


def insert_block(state: OnlineState, cols, ref, cfg: OnlineConfig):
    """K inserts of ``cols`` (B, F, K), one after another; returns
    ``(state, status)`` after the last.  The same as K :func:`insert_step`
    calls (inserts after "stop" freeze), with one status."""
    for k in range(cols.shape[2]):
        state = _insert_body(state, cols[:, :, k], ref, cfg)
    return state, _status_vec(state)


def set_live_scan_body(state: OnlineState, live_full, ref, cfg: OnlineConfig, live_len=None, ref_len=None,
                       reset: bool = False) -> OnlineState:
    """Batch alignment (otw_eran.py:91-142 / livenote.py:102-149) of
    ``live_full`` (B, F, T): ``T + N`` steps issued back to back, none
    waiting for the device.

    Each step is one iteration of the reference's set_live loop: direction
    decision first (appending a path point), then predicated row and/or
    column band updates.  Every live iteration advances t and/or j, so
    ``T + N`` steps cover it; a stopped stream's steps are no-ops.

    ``reset=True`` replays OnlineTimeWarping.set_live's state reset
    (otw_eran.py:92-97): pointers, direction state and path restart, while
    the dense cost matrix and live buffer keep their streamed contents.
    LiveNote's set_live (livenote.py:102) does not reset and continues from
    the current ``(t, j)`` frontier, which the prologue covers."""
    b, f, m = state.live.shape
    t_cols = live_full.shape[2]
    n = ref.shape[2] if ref_len is None else ref_len
    t_live = t_cols if live_len is None else live_len

    def gather_live(pos):
        idx = pos.clamp(0, t_cols - 1).view(b, 1, 1).expand(b, f, 1)
        return torch.gather(live_full, 2, idx)[:, :, 0]

    if reset:
        zero = torch.zeros_like(state.t)
        state = state._replace(
            t=zero, j=zero, direction=torch.full_like(zero, BOTH), previous=torch.full_like(zero, PREV_NONE),
            run_count=torch.full_like(zero, cfg.run_count_init), path_len=zero, last_x=zero - 1, last_y=zero - 1,
            stopped=torch.zeros_like(state.stopped))

    # prologue: fill_input + eval_path_cost(t, j) (otw_eran.py:99-100,
    # livenote.py:103-108) — the origin cell on a fresh state, the current
    # frontier cell when continuing after streaming inserts
    _write_live_column(state.live, state.t, gather_live(state.t), torch.ones_like(state.stopped))
    eval_cell(state.acc, state.live, ref, state.t, state.j, euclidean=cfg.euclidean)
    s = state._replace(first=torch.zeros_like(state.first))

    for _ in range(t_cols + ref.shape[2]):
        live_on = ~s.stopped
        d, rc, prev, plen, lx, ly = _set_direction(
            s.acc, s.t, s.j, s.run_count, s.previous, s.path, s.path_len, s.last_x, s.last_y, cfg,
            enable=live_on, old_direction=s.direction)

        # row step
        do_row = live_on & (d != COL)
        t_new = s.t + do_row
        row_done = do_row & ((t_new >= t_live) | (t_new >= m))
        do_row_eval = do_row & ~row_done
        _write_live_column(s.live, t_new, gather_live(t_new), do_row_eval)
        row_update(s.acc, s.live, ref, t_new, s.j, c=cfg.c, sentinel=cfg.sentinel, euclidean=cfg.euclidean,
                   exact=cfg.exact_chain, enable=do_row_eval)
        stopped = s.stopped | row_done

        # column step (skipped if the row step broke out)
        do_col = live_on & (d != ROW) & ~stopped
        j_new = s.j + do_col
        col_done = do_col & (j_new >= n)
        col_update(s.acc, s.live, ref, t_new, j_new, c=cfg.c, sentinel=cfg.sentinel, euclidean=cfg.euclidean,
                   exact=cfg.exact_chain, enable=do_col & ~col_done)
        s = s._replace(t=t_new, j=j_new, direction=d, run_count=rc, previous=prev, path_len=plen, last_x=lx,
                       last_y=ly, stopped=stopped | col_done)
    return s


set_live_scan = set_live_scan_body  # the JAX package's jitted name; here the same issued steps


# ---------------------------------------------------------------------------
# Host-facing engine
# ---------------------------------------------------------------------------


def _columns(cols, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Feature columns (F,) or (F, K) as a tensor on ``device``.  A host
    array goes through pinned memory with an asynchronous copy, so a
    pipelined caller does not wait for the card's queue."""
    if isinstance(cols, torch.Tensor):
        return cols.to(device=device, dtype=dtype)
    host = torch.tensor(np.asarray(cols), dtype=dtype)  # a copy: the caller may reuse its buffer
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


class BandedOnlineEngine(StatusPolling):
    """Host wrapper: owns the state on ``device``, streams frames through
    the insert step, exposes the reference attribute surface (``.path``,
    ``.acc_cost``, ...).  The positional parameters are the JAX engine's;
    ``device`` is where the state lives and the steps run (``"cuda"``
    unless the caller asks for ``"cpu"``)."""

    def __init__(self, ref, params, cfg_overrides: dict, dtype=None, exact_chain=False, reset_on_set_live=False,
                 *, device="cuda"):
        p = OTWParams.from_any(params)
        # OnlineTimeWarping.set_live resets pointers/direction/path
        # (otw_eran.py:92-97); LiveNote's continues from the current state
        # (livenote.py:102-108)
        self.reset_on_set_live = bool(reset_on_set_live)
        self.dtype = np.dtype(dtype or np.float32)
        self._tdtype = torch.from_numpy(np.zeros(0, self.dtype)).dtype
        self.device = torch.device(device)
        self.params = p
        self.cfg = OnlineConfig(c=p.c, max_run_count=p.max_run_count, exact_chain=bool(exact_chain),
                                **cfg_overrides)
        ref = _columns(ref, self._tdtype, self.device)
        if ref.shape[1] < self.cfg.c:
            raise ValueError(f"reference length {ref.shape[1]} shorter than search band {self.cfg.c}")
        self.ref = ref
        self.state = init_state(ref[None], self.cfg, self._tdtype)
        self._batch_mode = False
        # pipelined-streaming bookkeeping ("stop" is sticky, so only the
        # newest status vector matters) — see StatusPolling
        self._init_status_polling()

    # -- reference API surface ---------------------------------------------

    def insert(self, live_col):
        """Insert one feature column; returns ``"stop"`` when the reference
        sequence is exhausted (otw_eran.py:69-71), else None.  Synchronous:
        it reads the status back (waits for the card).  For streaming
        without waiting use :meth:`insert_nowait` + :meth:`poll`."""
        self.state, status = insert_step(self.state, self._col(live_col), self.ref[None], self.cfg)
        return self._read_status(status, 1)

    def insert_block(self, cols):
        """Insert K feature columns (F, K), one after another, reading one
        status; returns ``"stop"`` if the reference sequence was exhausted
        anywhere in the block."""
        cols = self._block(cols)
        self.state, status = insert_block(self.state, cols, self.ref[None], self.cfg)
        return self._read_status(status, cols.shape[2])

    # -- pipelined streaming (dispatch without synchronizing) ----------------

    def insert_nowait(self, live_col):
        """Issue one insert WITHOUT waiting for the card.

        "stop" is detected lazily: this returns ``"stop"`` as soon as a
        previously *polled* status showed it, which may be a few frames
        after the insert that exhausted the reference.  Post-stop inserts
        are frozen no-ops, so the committed path is the synchronous form's;
        only the return-value timing differs."""
        if self._stopped_cached or self.poll() == "stop":
            return "stop"
        self.state, status = insert_step(self.state, self._col(live_col), self.ref[None], self.cfg)
        self._record_status(status[0], 1)
        return None

    def insert_block_nowait(self, cols):
        """Issue a (F, K) block without waiting; see :meth:`insert_nowait`."""
        if self._stopped_cached or self.poll() == "stop":
            return "stop"
        cols = self._block(cols)
        self.state, status = insert_block(self.state, cols, self.ref[None], self.cfg)
        self._record_status(status[0], cols.shape[2])
        return None

    def _col(self, live_col) -> torch.Tensor:
        return _columns(live_col, self._tdtype, self.device).reshape(1, -1)

    def _block(self, cols) -> torch.Tensor:
        cols = _columns(cols, self._tdtype, self.device)
        if cols.ndim != 2:
            raise ValueError("insert_block expects a (F, K) column block")
        return cols[None]

    def _read_status(self, status, n_frames: int):
        self._frames_dispatched += n_frames
        # this synchronous read covers everything issued so far: drop older
        # in-flight vectors, else a later rate-limited harvest of one of
        # them would move last_point backwards
        self._outstanding = []
        self._latest_done = None
        return self._consume_status(status[0].cpu().numpy())

    def set_live(self, live):
        """Batch mode: align a full live sequence (F, T), every step issued
        without waiting.

        For OnlineTimeWarping this replays the reference's state reset
        (otw_eran.py:92-97), so set_live after streaming inserts restarts
        the alignment; LiveNote/V2 continue from the current frontier
        (livenote.py:102-108)."""
        live = _columns(live, self._tdtype, self.device)
        self.state = set_live_scan(self.state, live[None], self.ref[None], self.cfg, reset=self.reset_on_set_live)
        stopped = self._stopped_cached and not self.reset_on_set_live
        interval = self.poll_min_interval
        self._init_status_polling()
        self.poll_min_interval = interval
        self._stopped_cached = stopped
        self._batch_mode = True
        return self.path

    @property
    def path(self):
        """Committed best-point path as a list of (live, ref) int tuples."""
        return [tuple(p) for p in self.path_array.tolist()]

    @property
    def path_array(self) -> np.ndarray:
        """(plen, 2) int32 committed points (waits for the card)."""
        n = int(self.state.path_len[0])
        return self.state.path[0, :n].cpu().numpy().astype(np.int32)

    @property
    def acc_cost(self) -> np.ndarray:
        """Dense accumulated-cost matrix (uncomputed cells = sentinel), for
        notebook heatmaps and debugging."""
        return self.state.acc[0].cpu().numpy()

    @property
    def live_ptr(self) -> int:
        return int(self.state.t[0])

    @property
    def ref_ptr(self) -> int:
        return int(self.state.j[0])
