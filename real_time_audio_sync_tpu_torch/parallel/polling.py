"""Status polling for the batched (multi-stream) followers.

The counterpart of the JAX package's ``parallel/polling.py``
``BatchedStatusPolling``, under its method names, built the way the port's
solo ``StatusPolling`` is built (``models/online_core.py``): after every
launch the (B, 8) status rows are copied into a fresh pinned host buffer
with an asynchronous copy on the current stream of the rows' device, and a
``torch.cuda.Event`` is recorded behind it there (under a mesh, the rows of
every shard go into one buffer, with one event a device).  Completion is
probed with ``event.query()`` (a local check, no synchronization) and
reading a completed pinned buffer costs nothing, so no harvest thread is
needed: the JAX worker thread exists for a relay round-trip that the card
does not have.  On the CPU the status is ready at once.

The contract is the JAX one: the per-stream status rows are cumulative, so
the newest completed vector subsumes everything dispatched before it; the
final status is never lost (a completed entry stays in ``_latest_done``
until it is consumed, and :meth:`_settle_status` waits for the newest);
stop masks are monotone ORs (the subclass's ``_consume``), and the
overflow bit raises there.

Subclasses provide ``_consume(vec)``, which applies one harvested
(B, 8) int32 status array to ``self._stopped`` and friends.

Thread model (the JAX one): ONE feed/dispatch thread; ``stopped`` /
``last_points`` readers may poll from other threads at the same time.
``_drain_lock`` serialises the probe → pop → consume sequence (and the
queue append behind each launch), so two pollers never retire the same
entry, consume a popped ``None`` or interleave the read-modify-writes of
``_consume``.  It is held only for local work; the blocking settle alone
waits on an event under it.
"""

from __future__ import annotations

import threading
import time

import torch

from real_time_audio_sync_tpu_torch.parallel.mesh import on_device


class _AllEvents:
    """The events of one snapshot's copies on several devices, as one."""

    def __init__(self, events):
        self.events = events

    def query(self) -> bool:
        return all(e.query() for e in self.events)

    def synchronize(self) -> None:
        for e in self.events:
            e.synchronize()


class BatchedStatusPolling:
    """Mixin: rate-limited, non-blocking reads of B streams' status rows."""

    def _init_batched_polling(self) -> None:
        self._outstanding: list = []  # [(host (B, 8) int32, event | None)], oldest first
        self._latest_done = None  # newest completed-but-unread host status
        self.poll_min_interval = 2048 / 22050.0  # one feature hop
        self._last_poll_time = 0.0
        self._drain_lock = threading.Lock()

    def _record_status(self, status) -> None:
        """Snapshot a launch's status rows without waiting for the device:
        ``status`` is one (B, ...) tensor, or one tensor a shard in stream
        order (a mesh), all copied into one (B, 8) host snapshot.  Each
        copy runs on the current stream of its tensor's device, and one
        event is recorded behind the copies on each device: the snapshot
        is complete once every event has completed."""
        parts = [status] if isinstance(status, torch.Tensor) else list(status)
        rows = [p.reshape(p.shape[0], -1) for p in parts]
        cuda = rows[0].is_cuda
        host = torch.empty((sum(r.shape[0] for r in rows), rows[0].shape[1]), dtype=rows[0].dtype, pin_memory=cuda)
        devices, off = [], 0
        for r in rows:
            dst = host[off : off + r.shape[0]]
            off += r.shape[0]
            if not cuda:
                dst.copy_(r)
                continue
            with on_device(r.device):
                dst.copy_(r, non_blocking=True)
            if r.device not in devices:
                devices.append(r.device)
        events = []
        for dev in devices:  # once a device, behind its last copy (one stream, in order)
            with on_device(dev):
                events.append(torch.cuda.Event())
                events[-1].record()
        event = None if not events else events[0] if len(events) == 1 else _AllEvents(events)
        with self._drain_lock:
            self._outstanding.append((host, event))

    # -- free local probes ---------------------------------------------------

    def _probe(self) -> None:
        """Retire completed in-flight statuses (execution is in stream order,
        so a completed entry subsumes all before it).  The caller holds
        ``_drain_lock``."""
        q = self._outstanding
        while q and (q[0][1] is None or q[0][1].query()):
            self._latest_done = q.pop(0)[0]

    def _in_flight(self) -> int:
        with self._drain_lock:
            self._probe()
            return len(self._outstanding)

    # -- reads ---------------------------------------------------------------

    def _poll_status(self) -> None:
        """Non-blocking refresh: retire finished launches and consume the
        newest completed vector if the rate limit allows; otherwise the
        vector stays in ``_latest_done`` for a later poll."""
        with self._drain_lock:
            self._probe()
            if self._latest_done is None or self._stopped.all():
                return
            now = time.monotonic()
            if now - self._last_poll_time < self.poll_min_interval:
                return
            self._last_poll_time = now
            done, self._latest_done = self._latest_done, None
            self._consume(done.numpy())

    def _settle_status(self) -> None:
        """Blocking: consume the NEWEST in-flight status (waiting on the tail
        subsumes everything before), or the newest completed one."""
        with self._drain_lock:
            if self._outstanding:
                host, event = self._outstanding[-1]
                if event is not None:
                    event.synchronize()
                self._outstanding = []
                self._latest_done = None
                self._consume(host.numpy())
            elif self._latest_done is not None:
                done, self._latest_done = self._latest_done, None
                self._consume(done.numpy())
