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

On the card the reference and live features sit in device memory, so there
is no reference-length cap and the standard layout serves every N (the JAX
package switches to its long-reference kernel at N ≥ 6000 only to fit
VMEM; its paths are bit-equal to the standard kernel's).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from real_time_audio_sync_tpu_torch.config import OTWParams
from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES, OnlineConfig, StatusPolling
from real_time_audio_sync_tpu_torch.ops import otw_insert
from real_time_audio_sync_tpu_torch.ops.otw_insert import S_LASTX, S_LASTY, S_PLEN


def _column_copy(col, device: torch.device) -> torch.Tensor:
    """A float32 copy of one column on ``device`` — never a view of the
    caller's buffer, which the caller may reuse while the column is queued."""
    if isinstance(col, torch.Tensor):
        return col.to(device=device, dtype=torch.float32, copy=True).reshape(-1)
    return torch.tensor(np.asarray(col, np.float32).reshape(-1), device=device)


class FusedStreamingEngine(StatusPolling):
    """Streams chroma columns through the fused K-insert kernel.

    ``device`` is where the state lives and the kernel runs: a CUDA device
    launches the hand-written kernel, ``"cpu"`` runs its plain version."""

    def __init__(self, ref, params, cfg_overrides: Optional[dict] = None, k_block: int = 8, *,
                 device="cuda", long_ref: Optional[bool] = None):
        if long_ref:
            raise NotImplementedError(
                "long_ref=True (per-launch path deltas of the long-reference kernel) is not "
                "ported yet: ROADMAP.md Queue 2, kernel #4")
        p = OTWParams.from_any(params)
        over = dict(ENGINE_OVERRIDES["otw"])
        over.update(cfg_overrides or {})
        self.cfg = OnlineConfig(c=p.c, max_run_count=p.max_run_count, **over)
        self.k_block = int(k_block)
        self.device = torch.device(device)
        self.long_ref = False

        ref = torch.as_tensor(ref).to(device=self.device, dtype=torch.float32)
        f, n = ref.shape
        if n < self.cfg.c:
            raise ValueError(f"reference length {n} shorter than search band {self.cfg.c}")
        self.f, self.n = f, n
        self.cap = 2 * n  # pre-allocated live capacity (otw_eran.py:14)
        self._state = otw_insert.new_state(ref, self.cfg, self.cap)

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
        # path_x/path_y are zero-initialized, so slot 0 already reads (0, 0)
        sc = self._state.scalars
        sc[S_PLEN] = 1
        sc[S_LASTX] = 0
        sc[S_LASTY] = 0

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
        otw_insert.insert_block(self._state, rows, (self.cap, self.n, k), self.cfg, self.k_block)
        self._record_status(self._state.status, k)

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
        st = self._state
        plen = int(st.scalars[S_PLEN])
        return torch.stack([st.path_x[:plen], st.path_y[:plen]], dim=1).cpu().numpy()

    @property
    def path(self):
        return [tuple(int(v) for v in p) for p in self.path_array]
