"""Multi-stream serving: follow B concurrent live performances on one card.

The counterparts of the JAX package's ``parallel/serving.py``:

- ``FusedMultiStreamFollower``: one launch of the K-insert kernel per hop
  block for the whole batch (``ops/otw_insert.multi_insert_block``, a grid
  of B thread blocks, one per stream), O(c²) band state per stream instead
  of a dense (2N, N) matrix.  Users: one card following many live
  performances, or one concert with many listeners who joined at
  different times.
- ``MultiStreamFollower``: the tensor engine of ``models/online_core``
  over B streams at once, one batched insert step a hop (the JAX
  follower's ``vmap``), each stream on its own reference zero-padded to
  the longest, with a dense (2·N_max, N_max) accumulator a stream.

Two layouts with bit-equal paths, as in the JAX package:

- windowed, the default at every N (``long_ref=None`` or True): the
  kernel's delta mode (TPU kernel ``_pallas_multi_insert_block_long``);
  each launch writes one (B, 8 + 2·d_pad) int32 row block, pending rows
  fold on the device every ``_delta_stack`` launches
  (``fold_delta_tail``), and :meth:`FusedMultiStreamFollower.paths`
  drains them into host paths, vectorised over streams;
- whole buffer (``long_ref=False``): the kernel's whole-path mode (TPU
  kernel ``_pallas_multi_insert_block``); the device keeps every stream's
  path.

``mesh=`` (``parallel/mesh.Mesh``, ``parallel/corpus.corpus_mesh``) splits
the streams of either follower over the mesh's entries, as the JAX
followers shard their stream axis with no collective: each shard's state
lies on its entry's device, each dispatch runs once a shard, and the host
side (queue, dispatch decision, status snapshot, paths) stays one object
in stream order.  Entries may repeat: the CPU eight times in the tests, one
card four times.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from real_time_audio_sync_tpu_torch.config import OTWParams
from real_time_audio_sync_tpu_torch.features.chroma import torch_dtype
from real_time_audio_sync_tpu_torch.models.fused_streaming import _DELTA_STACK, fold_delta_tail, iter_delta_rows
from real_time_audio_sync_tpu_torch.models.online_core import (
    ENGINE_OVERRIDES,
    OnlineConfig,
    OnlineState,
    _columns,
    _insert_body,
    init_state,
)
from real_time_audio_sync_tpu_torch.ops import otw_insert
from real_time_audio_sync_tpu_torch.ops.otw_insert import N_STATUS, S_PLEN
from real_time_audio_sync_tpu_torch.parallel.mesh import (  # noqa: F401  (JAX's names, parallel/serving.py:38,49)
    Mesh,
    batch_axis_sharding_put,
    gather_rows,
    on_device,
    per_device,
    require_batch_divisible,
    scatter_rows,
    shards,
)
from real_time_audio_sync_tpu_torch.parallel.polling import BatchedStatusPolling

#: pinned host slots of the staging ring (each guarded by the event
#: of the copy that last read it)
_STAGING_SLOTS = 8


class PinnedStaging:
    """One dispatch's host arrays (any dtypes and shapes) in one pinned host
    slot of raw bytes, shipped to the card with ONE asynchronous copy into a
    device buffer (stream-ordered behind the previous launch that read it),
    and handed back as device tensors of the same dtypes and shapes.  A slot
    is rewritten only after the event recorded behind its last copy has
    completed: a follower may dispatch past ``max_in_flight``, so the ring's
    size alone does not guarantee it."""

    _ALIGN = 16  # bytes: each array starts on a boundary every dtype's view accepts

    def __init__(self, nbytes: int, device: torch.device):
        self.host = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True) for _ in range(_STAGING_SLOTS)]
        self.events: list = [None] * _STAGING_SLOTS
        self.dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
        self.slot = 0

    @classmethod
    def nbytes(cls, *arrays_bytes: int) -> int:
        """Slot size for arrays of these byte sizes."""
        return sum(-(-n // cls._ALIGN) * cls._ALIGN for n in arrays_bytes)

    def put(self, *arrays: np.ndarray):
        i, self.slot = self.slot, (self.slot + 1) % _STAGING_SLOTS
        if self.events[i] is not None:
            self.events[i].synchronize()
        view = self.host[i].numpy()
        placed, off = [], 0
        for a in arrays:
            a = np.ascontiguousarray(a)
            view[off : off + a.nbytes] = a.reshape(-1).view(np.uint8)
            placed.append((off, a))
            off += -(-a.nbytes // self._ALIGN) * self._ALIGN
        with on_device(self.dev.device):  # the copy and its event on the buffer's device
            self.dev[:off].copy_(self.host[i][:off], non_blocking=True)
            self.events[i] = torch.cuda.Event()
            self.events[i].record()
        return tuple(self.dev[o : o + a.nbytes].view(torch_dtype(a.dtype)).view(a.shape) for o, a in placed)


class DeltaPathDrain:
    """Mixin: B streams' committed paths drained from per-launch delta rows
    ``[status | dx | dy]`` (status slot 1 the stream's cumulative path
    length), kept on the host as flat chunks of points with their stream
    index, in dispatch order within each stream.  The subclass sets
    ``self.b`` and ``self._shards`` (``parallel/mesh.Shard``: each shard's
    pending rows in ``deltas``, as ``fold_delta_tail`` keeps them)."""

    def _reset_host_paths(self, paths: Optional[list] = None) -> None:
        """Set the drained host paths to ``paths`` (one (P_b, 2) array per
        stream; None: empty) and drop every pending entry."""
        for sh in self._shards:
            sh.deltas.clear()
        paths = [np.zeros((0, 2), np.int32)] * self.b if paths is None else paths
        counts = [len(p) for p in paths]
        pts = np.concatenate([np.asarray(p, np.int32).reshape(-1, 2) for p in paths])
        self._host_keys = [np.repeat(np.arange(self.b), counts)]
        self._host_x, self._host_y = [pts[:, 0]], [pts[:, 1]]
        self._drained_plen = np.asarray(counts, np.int64)

    def _drain_deltas(self) -> None:
        """Move every pending launch's committed points into the host paths
        (waits for in-flight launches), vectorised over a shard's streams
        and launches: launch m's row of stream b holds ``plen_m −
        plen_{m−1}`` new points.  Zero-commit rows — a stream with no
        column in the launch, a frozen post-stop stream, LiveNoteV2's
        guard — repeat ``plen`` and add nothing (serving.py:467-481)."""
        for sh in self._shards:
            streams = np.arange(self.b)[sh.rows]
            for rows in iter_delta_rows(sh.deltas):
                rows = rows.reshape(rows.shape[0], len(streams), -1)  # (M, B_shard, 8 + 2·d_pad)
                d_pad = (rows.shape[-1] - N_STATUS) // 2
                plens = rows[:, :, 1].astype(np.int64)  # (M, B_shard), monotone per stream
                drained = self._drained_plen[sh.rows]
                n_new = plens - np.concatenate([drained[None], plens[:-1]])
                take = (np.arange(d_pad) < n_new[..., None]).transpose(1, 0, 2)  # (B_shard, M, d_pad)
                self._host_x.append(rows[:, :, N_STATUS : N_STATUS + d_pad].transpose(1, 0, 2)[take])
                self._host_y.append(rows[:, :, N_STATUS + d_pad :].transpose(1, 0, 2)[take])
                self._host_keys.append(np.repeat(streams, take.sum(axis=(1, 2))))
                self._drained_plen[sh.rows] = np.maximum(drained, plens[-1])

    def _host_paths(self) -> List[np.ndarray]:
        """Drain, then each stream's (P_b, 2) int32 path."""
        self._drain_deltas()
        keys = np.concatenate(self._host_keys)
        order = np.argsort(keys, kind="stable")  # stream-major, dispatch order within a stream
        pts = np.stack([np.concatenate(self._host_x)[order], np.concatenate(self._host_y)[order]], axis=1)
        pts = pts.astype(np.int32)
        counts = np.bincount(keys, minlength=self.b)
        self._host_keys = [np.repeat(np.arange(self.b), counts)]  # keep the merged chunk
        self._host_x, self._host_y = [pts[:, 0].copy()], [pts[:, 1].copy()]
        return np.split(pts, np.cumsum(counts)[:-1])


@dataclasses.dataclass
class _FollowerShard:
    """A :class:`MultiStreamFollower` shard's state on its device: its
    streams' zero-padded references (B_shard, F, N_max), their true
    lengths, and their batched :class:`OnlineState`."""

    refs: torch.Tensor
    ref_lens: torch.Tensor
    online: OnlineState


class MultiStreamFollower:
    """Follows ``B`` live streams concurrently with one batched insert step
    per hop (the JAX package's ``parallel/serving.py:70-155``).

    ``refs``: one (F, N_b) reference a stream (arrays or tensors), each
    zero-padded to the longest; each stream's true length drives its stop
    and its live capacity 2·N_b.  :meth:`insert` takes one column per
    stream (B, F); ``active`` masks streams with no new frame this hop
    (or feed NaNs), and a stopped stream stays frozen.  The step runs on
    ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``); every
    stream's state is a dense (2·N_max, N_max) accumulator there.  The
    positional parameters are the JAX follower's.

    ``mesh`` (B divisible by its size) splits the streams over its entries,
    B/n a shard in stream order, each shard's state on its entry's device
    and one batched step a shard a hop; its entries decide the devices.
    ``states`` and ``refs`` then read every shard's rows as one batch."""

    def __init__(self, refs: Sequence, params, dtype=np.float32, sentinel: float = 1e10, run_count_init: int = 1,
                 monotone_path: bool = False, euclidean: bool = False, mesh: Optional[Mesh] = None, *,
                 device="cuda"):
        p = OTWParams.from_any(params)
        self.cfg = OnlineConfig(c=p.c, max_run_count=p.max_run_count, sentinel=sentinel,
                                run_count_init=run_count_init, monotone_path=monotone_path, euclidean=euclidean)
        self.dtype = np.dtype(dtype)
        self._tdtype = torch_dtype(self.dtype)
        self.mesh = mesh
        self._shards = shards(mesh, len(refs), device)
        self.device = self._shards[0].device
        refs = [_columns(r, self._tdtype, self.device) for r in refs]
        self.b = len(refs)
        f = refs[0].shape[0]
        n_max = max(r.shape[1] for r in refs)
        if min(r.shape[1] for r in refs) < self.cfg.c:
            raise ValueError("every reference must be at least one band wide")
        self.ref_lens = np.asarray([r.shape[1] for r in refs], np.int32)
        padded = torch.zeros((self.b, f, n_max), dtype=self._tdtype, device=self.device)
        for i, r in enumerate(refs):
            padded[i, :, : r.shape[1]] = r
        for sh in self._shards:  # the global padded shapes, row-sliced
            sh_refs = padded[sh.rows].to(sh.device, copy=True)
            lens = torch.as_tensor(self.ref_lens[sh.rows], dtype=torch.int64).to(sh.device)
            sh.state = _FollowerShard(sh_refs, lens, init_state(sh_refs, self.cfg, self._tdtype))

    @property
    def refs(self) -> torch.Tensor:
        """(B, F, N_max) zero-padded references (every shard's, gathered)."""
        return gather_rows([sh.state.refs for sh in self._shards])

    @property
    def states(self) -> OnlineState:
        """Every stream's state, (B, ...) fields (every shard's, gathered)."""
        return OnlineState(*(gather_rows(x) for x in zip(*(sh.state.online for sh in self._shards))))

    def insert(self, cols, active: Optional[np.ndarray] = None) -> np.ndarray:
        """Insert one column per stream (B, F).  Returns the per-stream
        stopped flags (a stream stops when its true reference is
        exhausted); reading them waits for the card."""
        cols = _columns(cols, self._tdtype, self.device)
        if cols.shape[0] != self.b:
            raise ValueError(f"expected {self.b} stream columns, got {cols.shape[0]}")
        act = None if active is None else _columns(np.asarray(active, bool), torch.bool, self.device)
        for sh in self._shards:
            st = sh.state
            sh_act = None if act is None else act[sh.rows].to(sh.device)
            st.online = _insert_body(st.online, cols[sh.rows].to(sh.device), st.refs, self.cfg,
                                     ref_len=st.ref_lens, live_cap=2 * st.ref_lens, active=sh_act)
        return self.stopped

    @property
    def stopped(self) -> np.ndarray:
        return np.concatenate([sh.state.online.stopped.cpu().numpy() for sh in self._shards])

    def paths(self) -> List[np.ndarray]:
        out = []
        for sh in self._shards:
            st = sh.state.online
            lens, path = st.path_len.cpu().numpy(), st.path.cpu().numpy().astype(np.int32)
            out += [path[i, : lens[i]] for i in range(len(lens))]
        return out

    def pointers(self) -> Tuple[np.ndarray, np.ndarray]:
        st = [sh.state.online for sh in self._shards]
        return (np.concatenate([s.t.cpu().numpy() for s in st]).astype(np.int32),
                np.concatenate([s.j.cpu().numpy() for s in st]).astype(np.int32))


class FusedMultiStreamFollower(DeltaPathDrain, BatchedStatusPolling):
    """Follow ``B`` live performances with the fused K-insert kernel, one
    launch per hop block for the whole batch.

    ``ref``: one shared reference (an array or tensor (F, N)) followed by
    all ``n_streams`` streams — held once on the card — or a sequence of
    per-stream references (zero-padded to the longest; each stream stops at
    its true length).

    :meth:`feed` takes one chroma column per stream (``active`` masks
    streams with no new frame) with the solo engine's adaptive coalescing:
    frames dispatch at once while fewer than ``max_in_flight`` launches are
    unfinished and coalesce into up-to-``k_block`` launches only under
    saturation, never waiting for audio that has not arrived.  Committed
    paths are bit-equal to solo ``FusedStreamingEngine`` streams.

    The positional order is the JAX follower's.  ``interpret`` is accepted
    and ignored (the device decides).  ``device`` is where the state lives
    and the kernel runs: a CUDA device launches the kernel, ``"cpu"`` runs
    its plain version.

    ``mesh`` (B divisible by its size; its entries decide the devices)
    splits the streams over its entries, B/n a shard in stream order: each
    shard keeps its state (the batch's padded shapes, a shared reference
    held once a device), its staging and its pending delta rows on its
    entry's device, and a dispatch launches the kernel once a shard.  The
    queue, the dispatch decision and the status snapshot stay one for the
    whole batch."""

    def __init__(self, ref, params, n_streams: Optional[int] = None, cfg_overrides: Optional[dict] = None,
                 k_block: int = 8, interpret: bool = False, mesh: Optional[Mesh] = None, max_in_flight: int = 4,
                 long_ref: Optional[bool] = None, *, device="cuda"):
        self.mesh = mesh
        self.interpret = bool(interpret)  # recorded, as in the JAX follower; the tensors' device decides
        p = OTWParams.from_any(params)
        over = dict(ENGINE_OVERRIDES["otw"])
        over.update(cfg_overrides or {})
        self.cfg = OnlineConfig(c=p.c, max_run_count=p.max_run_count, **over)
        self.k_block = int(k_block)
        self.max_in_flight = int(max_in_flight)

        self.shared_ref = isinstance(ref, (np.ndarray, torch.Tensor)) and ref.ndim == 2
        if self.shared_ref:
            if n_streams is None:
                raise ValueError("n_streams is required with a shared reference")
            self.b = int(n_streams)
            refs = [ref] * self.b
        else:
            refs = list(ref)
            self.b = len(refs)
            if n_streams is not None and n_streams != self.b:
                raise ValueError(f"n_streams {n_streams} != {self.b} references")
        self._shards = shards(mesh, self.b, device)
        self.device = self._shards[0].device
        # one reference row where the unsharded state holds one: a shared
        # reference, or one float32 tensor on the device that every stream
        # reads (new_multi_state receives that object B times)
        first = refs[0]
        self._one_ref = self.shared_ref or (all(r is first for r in refs) and isinstance(first, torch.Tensor)
                                            and first.dtype == torch.float32 and first.device == self.device)
        self.ref_lens = np.asarray([r.shape[1] for r in refs], np.int32)
        self.f = refs[0].shape[0]
        self.n_max = int(self.ref_lens.max())
        self.caps = 2 * self.ref_lens  # per-stream live capacity (otw_eran.py:14)

        # windowed (delta) layout by default at every N (serving.py:250-267)
        self.long_ref = True if long_ref is None else bool(long_ref)
        self._delta_stack = _DELTA_STACK
        # the shared reference once a device (JAX replicates it, serving.py:297-301)
        shared = (per_device(self._shards, lambda d: torch.as_tensor(ref, dtype=torch.float32, device=d))
                  if self.shared_ref else {})
        held_rows = {}
        for sh in self._shards:
            sh_refs = ([shared[sh.device]] * (sh.rows.stop - sh.rows.start) if self.shared_ref else
                       [torch.as_tensor(r, dtype=torch.float32, device=sh.device) for r in refs[sh.rows]])
            sh.state = otw_insert.new_multi_state(sh_refs, self.cfg, whole_path=not self.long_ref, n_max=self.n_max)
            if self.shared_ref:  # shards on one device read one copy of the reference rows
                sh.state.ref = held_rows.setdefault(sh.device, sh.state.ref)
            if sh.device.type == "cuda":
                nb = sh.rows.stop - sh.rows.start
                sh.staging = PinnedStaging(PinnedStaging.nbytes(nb * self.k_block * self.f * 4, nb * 4), sh.device)
        if self.long_ref:
            self._delta_len = otw_insert.delta_width(self.cfg, self.k_block)
            self._reset_host_paths()

        # columnar pending queue (serving.py:386-398): one (B, cap, F) buffer
        # with per-stream counts.  _drain dispatches whenever any stream holds
        # 4*k_block, and feed appends one column per stream per call, so
        # counts never exceed 4*k_block.
        self._pend_cap = 4 * self.k_block
        self._pend_buf = np.zeros((self.b, self._pend_cap, self.f), np.float32)
        self._pend_n = np.zeros(self.b, np.int64)
        self._stopped = np.zeros(self.b, bool)
        self._last_points = np.zeros((self.b, 3), np.int64)  # plen, x, y
        self.dispatched_block_sizes: List[int] = []
        self._init_batched_polling()

    # -- streaming API -------------------------------------------------------

    def feed(self, cols, active: Optional[np.ndarray] = None) -> np.ndarray:
        """Queue one chroma column per stream (B, F) and dispatch adaptively;
        returns the per-stream stopped mask as of the last harvest (lazy,
        like the solo engines)."""
        cols = np.asarray(cols, np.float32)
        if cols.shape != (self.b, self.f):
            raise ValueError(f"expected a ({self.b}, {self.f}) column batch")
        act = np.ones(self.b, bool) if active is None else np.asarray(active, bool)
        rows = np.nonzero(act & ~self._stopped)[0]
        if rows.size:
            # the fancy write COPIES each column into the queue, so a caller
            # may reuse its cols buffer while the frames are queued
            self._pend_buf[rows, self._pend_n[rows]] = cols[rows]
            self._pend_n[rows] += 1
        self._drain()
        self.poll()
        return self._stopped.copy()

    def _drain(self) -> None:
        while True:
            avail = int(self._pend_n.max()) if self.b else 0
            if avail == 0:
                return
            # liveness safeguard: an over-full queue dispatches anyway
            if self._in_flight() >= self.max_in_flight and avail < 4 * self.k_block:
                return
            self._dispatch()

    def _reset_pending(self) -> None:
        """Drop every queued column (checkpoint restore: queued feed()
        columns predate the restored state)."""
        self._pend_n[:] = 0

    def _dispatch(self) -> None:
        """One launch over each stream's first (up to k_block) queued columns."""
        ks = np.minimum(self._pend_n, self.k_block).astype(np.int32)
        k_max = int(ks.max())
        # positions past a stream's k hold stale queue rows: shipped as zeros
        valid = np.arange(k_max)[None, :, None] < ks[:, None, None]
        block = np.where(valid, self._pend_buf[:, :k_max], np.float32(0))
        rem = self._pend_n - ks
        rem_max = int(rem.max())
        if rem_max:  # pop each stream's first k rows: a vectorised forward shift
            take = np.minimum(ks[:, None] + np.arange(rem_max)[None, :], self._pend_cap - 1)
            self._pend_buf[:, :rem_max] = np.take_along_axis(self._pend_buf, take[:, :, None], axis=1)
        self._pend_n = rem
        self.dispatched_block_sizes.append(k_max)
        statuses = []
        for sh in self._shards:  # one launch a shard, on its device
            if sh.staging is not None:
                cols, ks_t = sh.staging.put(block[sh.rows], ks[sh.rows])
            else:
                cols, ks_t = torch.from_numpy(block[sh.rows]).to(sh.device), torch.from_numpy(ks[sh.rows]).to(sh.device)
            if self.long_ref:
                # a fresh row block per launch: it stays pending until paths() drains it
                rows = torch.empty((cols.shape[0], self._delta_len), dtype=torch.int32, device=sh.device)
                otw_insert.multi_insert_block(sh.state, cols, ks_t, self.cfg, self.k_block, delta=rows)
                views = otw_insert.multi_delta_views(rows, self.cfg, self.k_block)
                sh.deltas.append(views)
                fold_delta_tail(sh.deltas, self._delta_stack)
                statuses.append(views[0])
            else:
                otw_insert.multi_insert_block(sh.state, cols, ks_t, self.cfg, self.k_block)
                statuses.append(sh.state.status)
        self._record_status(statuses)
        self.poll()

    # -- status --------------------------------------------------------------

    def poll(self) -> np.ndarray:
        """Non-blocking status refresh (the solo engines' ``poll``): retire
        finished launches and consume the newest completed status if the
        rate limit allows.  Returns the per-stream stopped mask."""
        self._poll_status()
        return self._stopped.copy()

    def _consume(self, vec: np.ndarray) -> None:
        vec = vec.reshape(self.b, -1)  # (B, 8) status rows
        self._stopped |= (vec[:, 0] & 1).astype(bool)
        if (vec[:, 0] & 2).any():  # sticky in the kernel's scalar state
            raise AssertionError("column-phase loop bound violated")
        # per-row monotone guard (serving.py:494-509): the rows are
        # cumulative — (plen, live) never decreases per stream — so only
        # rows at or ahead of the current snapshot are applied
        pts = vec[:, 1:4].astype(np.int64)
        cur = self._last_points
        newer = (pts[:, 0] > cur[:, 0]) | ((pts[:, 0] == cur[:, 0]) & (pts[:, 1] >= cur[:, 1]))
        self._last_points = np.where(newer[:, None], pts, cur)

    def flush(self) -> np.ndarray:
        """Dispatch all queued columns and wait for every in-flight launch;
        returns the final per-stream stopped mask."""
        while self._pend_n.any():
            self._dispatch()
        self._settle_status()
        return self._stopped.copy()

    # -- inspection ----------------------------------------------------------

    @property
    def stopped(self) -> np.ndarray:
        return self.poll()

    @property
    def last_points(self) -> np.ndarray:
        """(B, 3) [path_len, live, ref] per stream from the newest harvest —
        score positions without fetching paths."""
        self.poll()
        return self._last_points.copy()

    def paths(self) -> List[np.ndarray]:
        """Per-stream committed paths, (P_b, 2) int32 each (waits for the
        device; the windowed layout drains every pending launch's rows)."""
        if self.long_ref:
            return self._host_paths()
        out = []
        for sh in self._shards:
            st = sh.state
            plens = st.scalars[:, S_PLEN].cpu().numpy()
            m = int(plens.max())
            px, py = st.path_x[:, :m].cpu().numpy(), st.path_y[:, :m].cpu().numpy()
            out += [np.stack([px[i, : plens[i]], py[i, : plens[i]]], axis=1) for i in range(len(plens))]
        return out

    # -- the state as one batch (checkpoints) ---------------------------------

    @property
    def _state(self) -> otw_insert.MultiOTWState:
        """Every stream's state as one :class:`~real_time_audio_sync_tpu_torch.
        ops.otw_insert.MultiOTWState` in stream order: the one shard's
        state itself, or the shards' rows gathered onto the first device (a
        copy: write through :meth:`_load_state`)."""
        if len(self._shards) == 1:
            return self._shards[0].state
        parts = [sh.state for sh in self._shards]

        def rows(name):
            return None if getattr(parts[0], name) is None else gather_rows([getattr(p, name) for p in parts])

        fields = {f.name: rows(f.name) for f in dataclasses.fields(parts[0])}
        # the unsharded state's reference rows (a shard whose streams read
        # one tensor holds R = 1 where the batch holds one row a stream)
        fields["ref"] = (parts[0].ref[:1] if self._one_ref else
                         gather_rows([p.ref.expand(p.batch, -1, -1) for p in parts]))
        return otw_insert.MultiOTWState(**fields)

    def _load_state(self, **fields: torch.Tensor) -> None:
        """Write stream-ordered (B, ...) tensors into the named fields of
        every shard's state, row slice by row slice."""
        for name, value in fields.items():
            scatter_rows(self._shards, [getattr(sh.state, name) for sh in self._shards], value)
