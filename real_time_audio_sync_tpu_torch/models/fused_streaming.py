"""Fused-kernel streaming engine: K inserts per launch with persistent state.

Drives ``ops.otw_insert.insert_block`` — up to ``k_block`` streaming inserts
executed inside one CUDA kernel launch, or by its plain PyTorch version for
CPU tensors.  The complete engine state (the band-relative window, the live
feature history, the committed path and the scalar pointers) is owned by
the engine as device tensors and updated IN PLACE by every launch, so
nothing is rebuilt or re-transferred between hops.

API of the JAX package's ``FusedStreamingEngine``:
``feed`` / ``insert_block_nowait`` / ``poll`` / ``flush`` / ``.path`` /
``.last_point``, with "stop" semantics identical to the reference
(otw_eran.py:69-71; frozen no-op inserts after stop, lazy detection via the
status vector).

Two layouts, chosen as the JAX package chooses them (``long_ref=None``:
long at N ≥ ``_LONG_REF_THRESHOLD`` reference frames), with bit-equal
paths:

- standard: the device keeps the whole committed path;
- long reference: the kernel's delta mode (TPU kernel
  ``_pallas_insert_block_long``).  Each launch writes its status and its
  committed points into a fresh int32 row ``[status | dx | dy]``; rows
  pending on the device fold into one stacked array every
  ``_DELTA_STACK`` launches (:func:`fold_delta_tail`, a device-side
  concatenation), and a path read drains them into the host path in
  dispatch order (:func:`iter_delta_rows`), one device-to-host copy per
  pending entry.  The device holds no whole-path buffer.

In both layouts the reference and the whole live history stay in device
memory; the JAX long kernel's sliding live window and reference window
exist only to fit VMEM and have no counterpart here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from real_time_audio_sync_tpu_torch.config import OTWParams
from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES, OnlineConfig, StatusPolling
from real_time_audio_sync_tpu_torch.ops import otw_insert
from real_time_audio_sync_tpu_torch.ops.otw_insert import N_STATUS, S_LASTX, S_LASTY, S_PLEN

# references this long or longer take the long-reference (delta) layout
# when long_ref=None, as in the JAX package (whose checkpoints record the
# layout and reject a mismatch, so the same call must choose the same one)
_LONG_REF_THRESHOLD = 6000
# pending delta rows fold into one device-side stack at this size, so a
# drain makes one device-to-host copy per _DELTA_STACK launches
_DELTA_STACK = 64


def fold_delta_tail(deltas: list, stack: int) -> None:
    """Fold the trailing run of unstacked (status, dx, dy) triples in
    ``deltas`` into ONE device tensor once ``stack`` have accumulated — a
    device-side concatenation, never a read.  Each component may carry
    extra leading batch dims (multi-stream ``(B, 1, X)`` rows); the fold
    stacks a new launch axis in front and concatenates [status | dx | dy]
    along the last axis (the JAX package's layout,
    fused_streaming.py:62-78)."""
    tail = [d for d in deltas[-stack:] if isinstance(d, tuple)]
    if len(deltas) < stack or len(tail) < stack:
        return
    stacked = torch.cat([torch.stack([t[i] for t in tail]) for i in range(3)], dim=-1)
    del deltas[len(deltas) - len(tail):]
    deltas.append(stacked)


def iter_delta_rows(deltas: list):
    """Yield each pending entry as a launch-major ``(M, ..., 8 + 2·d_pad)``
    numpy block in dispatch order (waiting for in-flight launches), one
    device-to-host copy per entry, then clear the list.  The inverse of
    :func:`fold_delta_tail`'s layout."""
    for entry in deltas:
        if isinstance(entry, tuple):
            yield torch.cat(entry, dim=-1)[None].cpu().numpy()
        else:
            yield entry.cpu().numpy()
    deltas.clear()


def drain_delta_rows(deltas: list, host_px: list, host_py: list, drained_plen: int) -> int:
    """Append every pending launch's committed points (rows ``[status | dx
    | dy]``, in dispatch order) to the host path's ``host_px``/``host_py``
    chunks and return the path length drained (waits for the device).  A
    launch that committed nothing — LiveNoteV2's guard, a frozen post-stop
    launch — carries ``plen_end == drained_plen`` and adds nothing."""
    for rows in iter_delta_rows(deltas):
        d_pad = (rows.shape[-1] - N_STATUS) // 2
        for row in rows:
            plen_end = int(row[1])
            n_new = plen_end - drained_plen
            if n_new > 0:
                host_px.append(row[N_STATUS : N_STATUS + n_new].astype(np.int32))
                host_py.append(row[N_STATUS + d_pad : N_STATUS + d_pad + n_new].astype(np.int32))
                drained_plen = plen_end
    return drained_plen


def _column_copy(col, device: torch.device) -> torch.Tensor:
    """A float32 copy of one column on ``device`` — never a view of the
    caller's buffer, which the caller may reuse while the column is queued."""
    if isinstance(col, torch.Tensor):
        return col.to(device=device, dtype=torch.float32, copy=True).reshape(-1)
    return torch.tensor(np.asarray(col, np.float32).reshape(-1), device=device)


class FusedStreamingEngine(StatusPolling):
    """Streams chroma columns through the fused K-insert kernel.

    ``device`` is where the state lives and the kernel runs: a CUDA device
    launches the hand-written kernel, ``"cpu"`` runs its plain version.
    ``long_ref`` picks the layout (module docstring); None means
    ``n >= _LONG_REF_THRESHOLD``.  The positional order is the JAX
    engine's; ``interpret`` (its Pallas interpret switch) is recorded and
    otherwise ignored: the device decides."""

    dtype = np.dtype(np.float32)  # the kernel is float32-only, as in the JAX engine

    def __init__(self, ref, params, cfg_overrides: Optional[dict] = None, k_block: int = 8,
                 interpret: bool = False, long_ref: Optional[bool] = None, *, device="cuda"):
        self.interpret = bool(interpret)  # recorded, as in the JAX engine; the tensors' device decides
        p = OTWParams.from_any(params)
        over = dict(ENGINE_OVERRIDES["otw"])
        over.update(cfg_overrides or {})
        self.cfg = OnlineConfig(c=p.c, max_run_count=p.max_run_count, **over)
        self.k_block = int(k_block)
        self.device = torch.device(device)

        ref = torch.as_tensor(ref).to(device=self.device, dtype=torch.float32)
        f, n = ref.shape
        if n < self.cfg.c:
            raise ValueError(f"reference length {n} shorter than search band {self.cfg.c}")
        self.f, self.n = f, n
        self.cap = 2 * n  # pre-allocated live capacity (otw_eran.py:14)
        self.long_ref = bool(n >= _LONG_REF_THRESHOLD if long_ref is None else long_ref)
        self._state = otw_insert.new_state(ref, self.cfg, self.cap, whole_path=not self.long_ref)
        if self.long_ref:
            self._delta_len = otw_insert.delta_width(self.cfg, self.k_block)
            # per-launch rows pending host accumulation: (status, dx, dy)
            # views of one launch's row, or one stacked (M, 8 + 2·d_pad) fold
            self._deltas: list = []
            self._host_px: list = []  # drained path (host, append-only)
            self._host_py: list = []
            self._drained_plen = 0

        self._init_status_polling()
        # adaptive per-frame coalescing (see feed()): frames held only while
        # the pipeline is saturated, never waiting for future input
        self._pending: list = []
        self.max_in_flight = 4
        self.dispatched_block_sizes: list = []  # columns of every launch, in order

    def seed_origin_point(self) -> None:
        """Pre-commit the (0, 0) best point that set_live appends right
        after the origin eval, BEFORE the first row/column step
        (otw_eran.py:103-107).  Fresh engines only."""
        if self._frames_dispatched or self._pending:
            raise RuntimeError("seed_origin_point requires a fresh engine")
        sc = self._state.scalars
        sc[S_PLEN] = 1
        sc[S_LASTX] = 0
        sc[S_LASTY] = 0
        if self.long_ref:
            self._host_px = [np.zeros(1, np.int32)]
            self._host_py = [np.zeros(1, np.int32)]
            self._drained_plen = 1
        # else path_x/path_y are zero-initialized: slot 0 already reads (0, 0)

    # -- pipelined streaming API ---------------------------------------------

    def insert_block_nowait(self, cols):
        """Dispatch up to k_block chroma columns (F, K); returns "stop" once
        a previously polled status showed it (lazy; post-stop inserts are
        frozen no-ops in the kernel, so the committed path is unaffected)."""
        if self._stopped_cached or self.poll() == "stop":
            return "stop"
        # frames queued by feed() dispatch FIRST — mixing the two APIs
        # under a saturated pipeline must not reorder the stream
        self._dispatch_pending()
        cols = torch.as_tensor(cols).to(device=self.device, dtype=torch.float32)
        if cols.ndim == 1:
            cols = cols[:, None]
        k = cols.shape[1]
        if k > self.k_block:  # oversize blocks split into k_block launches
            for s in range(0, k, self.k_block):
                if self.insert_block_nowait(cols[:, s : s + self.k_block]) == "stop":
                    return "stop"
            return None
        self._dispatch_rows(cols.T.contiguous())
        return None

    insert_nowait = insert_block_nowait  # a single column is a K=1 block

    def _dispatch_rows(self, rows: torch.Tensor) -> None:
        """One launch over a (k <= k_block, F) block of columns as rows."""
        k = rows.shape[0]
        self.dispatched_block_sizes.append(k)
        lens = (self.cap, self.n, k)
        if not self.long_ref:
            otw_insert.insert_block(self._state, rows, lens, self.cfg, self.k_block)
            self._record_status(self._state.status, k)
            return
        # a fresh row per launch: it stays pending until a path read drains it
        row = torch.empty(self._delta_len, dtype=torch.int32, device=self.device)
        otw_insert.insert_block(self._state, rows, lens, self.cfg, self.k_block, delta=row)
        views = otw_insert.delta_views(row, self.cfg, self.k_block)
        self._deltas.append(views)
        fold_delta_tail(self._deltas, _DELTA_STACK)
        self._record_status(views[0], k)

    def _drain_deltas(self) -> None:
        """Accumulate every pending launch's committed points into the host
        path (waits for in-flight launches)."""
        self._drained_plen = drain_delta_rows(self._deltas, self._host_px, self._host_py, self._drained_plen)

    def _dispatch_pending(self) -> None:
        pend = self._pending
        while pend and not self._stopped_cached:
            k = min(len(pend), self.k_block)
            self._dispatch_rows(torch.stack(pend[:k]))
            del pend[:k]

    # -- adaptive per-frame streaming ----------------------------------------

    def feed(self, col):
        """Insert ONE chroma column with adaptive dispatch coalescing — the
        per-frame (hop-by-hop) production entry point.

        The column is dispatched at once whenever fewer than
        ``max_in_flight`` launches are unfinished (``event.query()`` probes,
        no synchronization); only while the device pipeline is saturated do
        arriving frames coalesce into one multi-column launch (up to
        ``k_block``), never waiting for audio that has not arrived.  A
        k-column block is k successive inserts, so the committed path is
        that of frame-by-frame insert.  Returns ``"stop"`` lazily like
        :meth:`insert_block_nowait`."""
        if self._stopped_cached or self.poll() == "stop":
            return "stop"
        self._pending.append(_column_copy(col, self.device))
        pend = self._pending
        while pend:
            # liveness safeguard: an over-full queue dispatches anyway
            if self.in_flight() >= self.max_in_flight and len(pend) < 4 * self.k_block:
                break
            k = min(len(pend), self.k_block)
            self._dispatch_rows(torch.stack(pend[:k]))
            del pend[:k]
        return None

    def flush(self):
        """Dispatch any coalesce-pending frames, then wait for all in-flight
        launches; returns ``"stop"`` or None."""
        self._dispatch_pending()
        self._pending.clear()  # post-stop remainder is semantically a frozen no-op
        return StatusPolling.flush(self)

    @property
    def path_array(self) -> np.ndarray:
        """(plen, 2) int32 committed (live, ref) points (waits for the device)."""
        if self.long_ref:
            self._drain_deltas()
            if not self._host_px:
                return np.zeros((0, 2), np.int32)
            return np.stack([np.concatenate(self._host_px), np.concatenate(self._host_py)], axis=1)
        st = self._state
        plen = int(st.scalars[S_PLEN])
        return torch.stack([st.path_x[:plen], st.path_y[:plen]], dim=1).cpu().numpy()

    @property
    def path(self):
        return [tuple(int(v) for v in p) for p in self.path_array]
