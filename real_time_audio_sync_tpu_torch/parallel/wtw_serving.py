"""Multi-stream WTW serving: follow B concurrent raw-audio performances on
one card, one dispatch a hop block for all of them (the JAX package's
``parallel/wtw_serving.py``): ``MultiStreamWTW`` (:56-341), B
``AsyncWTW`` block steps advanced together at any window size and in
float64, and ``FusedMultiStreamWTW`` (:386-616), one kernel launch a block
for windows up to 128 frames.

Users: one card following many listeners, each with a microphone, against
one concert (the reference stored once), and WTW corpus sweeps, which run
every pair of a corpus as one stream of the same engine
(``eval/corpus.CorpusRunner(engine="wtw", mode="fused")``).

Each launch is ``ops/wtw_insert.multi_wtw_insert_block``: the WTW kernel
over a grid of B thread blocks, one per stream (TPU kernel #10), each on
its own reference length, live capacity and column count, read from a
device (B, 3) array that goes up with the block's payload in one copy.
Per-stream delta rows ``[status | dx | dy]`` fold on the device and drain
into host paths vectorised over streams (``parallel/serving.DeltaPathDrain``).

The live columns: ``"float32"`` and ``"int16"`` sample spans run the
port's device frontend stream by stream in the solo engines' fixed tiles
(``features/chroma.chroma_spans_tiled``), so each stream's columns, and so
its path, are a solo ``FusedWTW``'s whatever the other streams are fed;
``"chroma"`` packs the valid frames of every stream into one host
extraction, as the JAX engine does; ``"auto"`` resolves through
``parallel/transfer.py``.

``MultiStreamWTW`` runs ``models/wtw_async.BlockStepper`` over B streams:
the host plans each stream's block (which column makes a window due, its
live rows, the stops it can see) without a read of the card, and each
window slot of a block in which any stream has a due window is ONE launch
of the DP kernel and one of the backtrack kernel (TPU kernels #7 and #8)
over the due streams' windows, gathered by an index tensor; a stream whose
device state has stopped is masked in the commit.  Where the JAX engine
vmaps its block step and so takes the lax wavefront (its Pallas batching
rule does not apply), the card batches the kernels themselves.

``mesh=`` (``parallel/mesh.Mesh``) splits either engine's streams over the
mesh's entries, B/n a shard in stream order, with no exchange between
shards (JAX ``wtw_serving.py:167-190``, ``:490-535``): each shard's state,
staging and pending rows lie on its entry's device, the references once a
device, and a dispatch runs the kernel (or the block step) once a shard;
the host side stays one object in stream order.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from real_time_audio_sync_tpu_torch.config import FS, WTWParams
from real_time_audio_sync_tpu_torch.features.chroma import (
    chroma_from_samples,
    chroma_spans_tiled,
    host_chroma_frames,
    torch_dtype,
)
from real_time_audio_sync_tpu_torch.models.fused_streaming import _DELTA_STACK, fold_delta_tail
from real_time_audio_sync_tpu_torch.models.wtw import SampleFIFO, _check_ref_window
from real_time_audio_sync_tpu_torch.models.wtw_async import TRANSFER_MODES, BlockStepper, build_span, check_dtype
from real_time_audio_sync_tpu_torch.ops import wtw_insert
from real_time_audio_sync_tpu_torch.ops.wtw_insert import WS_CHROMA, WS_LIVE, WS_REF
from real_time_audio_sync_tpu_torch.parallel.mesh import Mesh, gather_rows, per_device, shards
from real_time_audio_sync_tpu_torch.parallel.polling import BatchedStatusPolling
from real_time_audio_sync_tpu_torch.parallel.serving import DeltaPathDrain, PinnedStaging
from real_time_audio_sync_tpu_torch.utils.wavio import load_wav



def _pack_chroma(bufs, ks, k_block: int, hop: int, fft: int, dtype) -> np.ndarray:
    """(B, 12, k_block) host chroma columns of a block, consuming each
    stream's ``ks[i]`` columns of samples: the valid frames of every stream
    packed into one host extraction, as the JAX engines do (columns past a
    stream's count stay zero; the block step never reads them)."""
    active = [(i, int(k)) for i, k in enumerate(ks) if k > 0]
    out = np.zeros((len(bufs), 12, k_block), dtype)
    if not active:
        return out
    frames = np.zeros((sum(k for _, k in active), fft), dtype)
    row = 0
    for i, k in active:
        span = build_span(bufs[i], k, k_block, hop, fft, dtype)
        stride = span.strides[0]
        frames[row : row + k] = np.lib.stride_tricks.as_strided(span, shape=(k, fft), strides=(hop * stride, stride))
        row += k
    cols = host_chroma_frames(frames, n_fft=fft, overwrite_frames=True)
    row = 0
    for i, k in active:
        out[i, :, :k] = cols[:, row : row + k]
        row += k
    return out


def _sample_spans(bufs, ks, k_block: int, hop: int, fft: int, dtype, transfer_dtype: str) -> np.ndarray:
    """(B, span) sample spans of a block (float, or int16 for
    ``transfer_dtype="int16"``), consuming each stream's ``ks[i]`` columns."""
    spans = np.zeros((len(bufs), (k_block - 1) * hop + fft), dtype)
    for i, k in enumerate(ks):
        if k > 0:
            spans[i] = build_span(bufs[i], int(k), k_block, hop, fft, dtype)
    if transfer_dtype == "int16":
        return np.clip(np.round(spans * 32768.0), -32768, 32767).astype(np.int16)
    return spans


class MultiStreamWTW(BatchedStatusPolling):
    """Follow ``B`` raw-audio streams concurrently, one dispatch a block.

    ``refs``: per-stream reference recordings (wav paths or 1-D sample
    arrays); identical entries (by path, or by object identity for arrays)
    are extracted and stored once, and a reference the streams share is
    stored once on the card.  ``ref_chromas``: precomputed (12, m)
    chromagrams, one per stream or one for all (identical entries by
    object identity count as shared).  Each stream keeps its own reference
    length ``m`` and live capacity ``n_cap = 2m``, zero-padded to the
    longest.  :meth:`insert` takes one sample buffer per stream (``None``
    for no new audio); a block dispatches whenever any stream holds
    ``k_block`` hop columns, every other stream contributing what it has,
    so a stream's path does not depend on how the others are fed.
    :meth:`flush` dispatches the ragged tails and waits; :meth:`paths`,
    :meth:`pointers` and :attr:`stopped` read per-stream results (each
    waits for the card).

    The positional order is the JAX engine's; ``dtype`` is float32 or
    float64; ``device`` is where the state lives and the block step runs (a
    CUDA device launches kernels #7 and #8, ``"cpu"`` runs their plain
    versions).  ``mesh`` (B divisible by its size; its entries decide the
    devices) runs one block step a shard, each shard's due windows of a
    slot one launch of #7 and one of #8 on its device."""

    def __init__(self, refs: Sequence, params, k_block: int = 8, dtype=np.float32, mesh: Optional[Mesh] = None,
                 transfer_dtype: str = "auto", ref_chromas: Optional[Sequence] = None, *, device="cuda"):
        self.mesh = mesh
        self.params = WTWParams.from_any(params)
        self.k_block = int(k_block)
        self._shards = shards(mesh, len(refs), device)
        self.device = self._shards[0].device
        if transfer_dtype not in TRANSFER_MODES:
            raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}")
        from real_time_audio_sync_tpu_torch.parallel.transfer import resolve_transfer_mode

        self.transfer_dtype = resolve_transfer_mode(transfer_dtype, len(refs), self.k_block, self.params.fft_len,
                                                    self.params.hop_size, device=self.device)
        self.dtype = check_dtype(dtype)
        self.fft_len = self.params.fft_len
        self.hop_size = self.params.hop_size
        self._w = self.params.dtw_win_size // self.hop_size
        self._hop_frames = self.params.dtw_hop_size // self.hop_size

        unique, ids = self._ref_chromas(refs, ref_chromas)
        self.b = len(ids)
        if self.b == 0:
            raise ValueError("need at least one stream")
        self.ms = np.asarray([unique[u].shape[1] for u in ids], np.int32)
        for i, m in enumerate(self.ms):
            try:
                _check_ref_window(int(m), self.params)
            except ValueError as e:
                raise ValueError(f"stream {i}: {e}") from None
        self.n_caps = (2 * self.ms).astype(np.int32)  # per-stream live capacity (wtw.py:52)
        self._shared_ref = len(unique) == 1
        self._span_len = (self.k_block - 1) * self.hop_size + self.fft_len
        item = self.dtype.itemsize
        payload = {"chroma": 12 * self.k_block * item, "int16": self._span_len * 2}.get(
            self.transfer_dtype, self._span_len * item)
        held = per_device(self._shards, lambda d: [u.to(d) for u in unique])  # the references once a device
        ref_rows = {}
        for sh in self._shards:
            st = BlockStepper(held[sh.device], ids[sh.rows], self.n_caps[sh.rows], self._w, self._hop_frames,
                              self.k_block, "auto", self.dtype, sh.device, n_buf=int(self.n_caps.max()))
            st.ref = ref_rows.setdefault(sh.device, st.ref)  # shards on one device read one copy
            sh.state = st
            if sh.device.type == "cuda":
                nb = st.b
                sh.staging = PinnedStaging(PinnedStaging.nbytes(
                    nb * payload, nb * self.k_block * 8, st.max_slots * 4 * nb * 4, st.max_slots * nb * 8), sh.device)

        self.bufs = [SampleFIFO(self.dtype) for _ in range(self.b)]
        self._stopped = np.zeros(self.b, bool)
        self._init_batched_polling()

    def _ref_chromas(self, refs, ref_chromas):
        """The distinct (12, m) reference chromagrams on the device, and each
        stream's index into them (the JAX engine's dedupe,
        wtw_serving.py:94-128)."""
        dt = torch_dtype(self.dtype)
        unique, ids, memo = [], [], {}
        if ref_chromas is not None:
            if len(ref_chromas) == 1 and len(refs) > 1:
                ref_chromas = list(ref_chromas) * len(refs)
            if len(ref_chromas) != len(refs):
                raise ValueError(f"ref_chromas has {len(ref_chromas)} entries for {len(refs)} streams")
            for c in ref_chromas:
                if id(c) not in memo:
                    memo[id(c)] = len(unique)
                    unique.append(torch.tensor(np.asarray(c, self.dtype), device=self.device))
                ids.append(memo[id(c)])
            return unique, ids
        for r in refs:
            key = r if isinstance(r, (str, bytes)) else id(r)
            if key not in memo:
                if isinstance(r, (str, bytes)):
                    wav, fs = load_wav(r)
                    assert fs == FS
                else:
                    wav = np.asarray(r)
                memo[key] = len(unique)
                unique.append(chroma_from_samples(wav, dtype=dt, device=self.device))
            ids.append(memo[key])
        return unique, ids

    # -- the block's payload (wtw_serving.py:214-260) ---------------------------

    def _avail_cols(self, i: int) -> int:
        n = len(self.bufs[i])
        return 0 if n < self.fft_len else (n - self.fft_len) // self.hop_size + 1

    def _spans(self, ks: np.ndarray) -> np.ndarray:
        """The block's host payload, consuming each stream's ``ks[i]``
        columns of samples: (B, span) samples, or (B, 12, k_block) host
        chroma for ``transfer_dtype="chroma"``."""
        if self.transfer_dtype == "chroma":
            return _pack_chroma(self.bufs, ks, self.k_block, self.hop_size, self.fft_len, self.dtype)
        return _sample_spans(self.bufs, ks, self.k_block, self.hop_size, self.fft_len, self.dtype,
                             self.transfer_dtype)

    def _columns(self, payload: torch.Tensor, ks: np.ndarray) -> torch.Tensor:
        """The block's (B, k_block, F) live columns on the device, each
        stream's in the solo engine's tiles."""
        if self.transfer_dtype == "chroma":
            return payload.transpose(1, 2)
        if self.transfer_dtype == "int16":
            payload = payload.to(torch_dtype(self.dtype)) / 32768.0
        return chroma_spans_tiled(payload, self.k_block, self.fft_len, self.hop_size, FS,
                                  streams=np.nonzero(ks)[0].tolist())

    def _dispatch(self, ks: np.ndarray) -> None:
        payload = self._spans(ks)
        statuses = []
        for sh in self._shards:  # one block step a shard, on its device
            st, k = sh.state, ks[sh.rows]
            pos, table, due, slots, counts = st.plan(k)
            if sh.staging is not None:
                payload_d, pos_d, table_d, due_d = sh.staging.put(payload[sh.rows], pos, table, due)
            else:
                payload_d, pos_d, table_d, due_d = (torch.from_numpy(np.ascontiguousarray(a)).to(sh.device)
                                                    for a in (payload[sh.rows], pos, table, due))
            statuses.append(st.run(self._columns(payload_d, k), pos_d, table_d, due_d, slots, counts))
        self._record_status(statuses)
        self._poll()

    # -- streaming API ---------------------------------------------------------

    def _block_counts(self) -> np.ndarray:
        return np.asarray([0 if self._stopped[i] else min(self._avail_cols(i), self.k_block)
                           for i in range(self.b)], np.int32)

    def insert(self, stream_bufs: Sequence) -> np.ndarray:
        """Append raw samples per stream (``None``: no new audio) and
        dispatch every full block; non-blocking.  Returns the stopped mask
        as of the last consumed status (lazy, like the solo engines)."""
        if len(stream_bufs) != self.b:
            raise ValueError(f"expected {self.b} buffers, got {len(stream_bufs)}")
        for i, buf in enumerate(stream_bufs):
            if buf is not None and not self._stopped[i]:
                self.bufs[i].extend(buf)
        while True:
            ks = self._block_counts()
            if ks.max(initial=0) < self.k_block:
                break
            self._dispatch(ks)
        self._poll()
        return self._stopped.copy()

    def flush(self) -> np.ndarray:
        """Dispatch every stream's remaining whole hop columns and wait for
        every dispatch; returns the final stopped mask."""
        while True:
            ks = self._block_counts()
            if ks.max(initial=0) <= 0:
                break
            self._dispatch(ks)
        self._poll(block=True)
        return self._stopped.copy()

    def _poll(self, block: bool = False) -> None:
        if block:
            self._settle_status()
        else:
            self._poll_status()

    def _consume(self, vec: np.ndarray) -> None:
        self._stopped |= (vec[:, 0] & 1).astype(bool)
        if (vec[:, 0] & 2).any():  # pragma: no cover - exact capacity bound
            raise AssertionError("MultiStreamWTW path buffer overflow")

    # -- inspection (each waits for the card) ----------------------------------

    @property
    def stopped(self) -> np.ndarray:
        self._poll(block=True)
        return self._stopped.copy()

    def paths(self) -> List[List[tuple]]:
        """Per-stream committed (live, ref) paths, as lists of tuples."""
        return [list(zip(p[:, 0].tolist(), p[:, 1].tolist())) for sh in self._shards for p in sh.state.paths()]

    def pointers(self) -> List[Tuple[int, int, int]]:
        """Per-stream (chroma_ptr, live_ptr, ref_ptr)."""
        return [p for sh in self._shards for p in sh.state.pointers()]

    # -- the state as one batch (checkpoints) ----------------------------------

    @property
    def _stepper(self):
        """The block step's state of every stream in stream order: the one
        shard's ``BlockStepper`` itself, or (a mesh) its tensors ``ref``,
        ``ref_ids``, ``live``, ``px``, ``py`` and ``sc`` with the shards'
        rows gathered onto the first device (copies: write through
        :meth:`_load_state`)."""
        if len(self._shards) == 1:
            return self._shards[0].state
        parts = [sh.state for sh in self._shards]
        rows = {n: gather_rows([getattr(p, n) for p in parts]) for n in ("ref_ids", "live", "px", "py", "sc")}
        return SimpleNamespace(ref=parts[0].ref, **rows)

    def _load_state(self, live: torch.Tensor, px: torch.Tensor, py: torch.Tensor, sc: torch.Tensor) -> None:
        """Load stream-ordered (B, ...) state (``BlockStepper.set_state``'s
        layout) into every shard, row slice by row slice."""
        for sh in self._shards:
            sh.state.set_state(live[sh.rows], px[sh.rows], py[sh.rows], sc[sh.rows])


class FusedMultiStreamWTW(DeltaPathDrain, BatchedStatusPolling):
    """B concurrent raw-audio WTW streams on the fused kernel's grid.

    ``refs``: per-stream reference recordings (wav paths or 1-D sample
    arrays); identical entries (by path, or by object identity for arrays)
    are extracted once, and when one reference is left it is stored once
    on the card.  ``ref_chromas``: precomputed (12, m) chromagrams, one per
    stream or one for all.  :meth:`insert` takes one sample buffer per
    stream (``None`` for no new audio); a block dispatches whenever any
    stream holds ``k_block`` hop columns, every other stream contributing
    what it has, so a stream's path does not depend on how the others are
    fed.  :meth:`flush` dispatches the ragged tails and waits;
    :meth:`paths`, :meth:`pointers` and :attr:`stopped` read per-stream
    results (each waits for the card).

    Memory: each stream keeps its whole live history on the card, 2·m rows
    of 12 float32 (about 2.3 MB a stream on a 24,456-frame concert), where
    the JAX engine keeps a sliding window flat in reference length (336
    rows of 128 lanes at w = 100, k_block 8: about 170 KB); a ring of live
    rows in the kernel is later work (ROADMAP.md).

    The positional order is the JAX engine's.  ``interpret`` is recorded
    and otherwise ignored (the device decides); ``device`` is where the
    state lives and the kernel runs: a CUDA device launches the kernel,
    ``"cpu"`` runs its plain version.  ``mesh`` (B divisible by its size;
    its entries decide the devices) launches the kernel once a shard, a
    shared reference held once a device, mixed ones padded to the batch's
    longest."""

    def __init__(self, refs: Sequence, params, k_block: int = 8, mesh: Optional[Mesh] = None,
                 transfer_dtype: str = "auto", ref_chromas: Optional[Sequence] = None, interpret: bool = False, *,
                 device="cuda"):
        self.mesh = mesh
        self.params = WTWParams.from_any(params)
        self.k_block = int(k_block)
        self.interpret = bool(interpret)
        self._shards = shards(mesh, len(refs), device)
        self.device = self._shards[0].device
        if transfer_dtype not in ("auto", "float32", "int16", "chroma"):
            raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}")
        from real_time_audio_sync_tpu_torch.parallel.transfer import resolve_transfer_mode

        self.transfer_dtype = resolve_transfer_mode(transfer_dtype, len(refs), self.k_block, self.params.fft_len,
                                                    self.params.hop_size, device=self.device)
        self.dtype = np.dtype(np.float32)  # the kernel is float32 only
        self.fft_len = self.params.fft_len
        self.hop_size = self.params.hop_size
        self._w = self.params.dtw_win_size // self.hop_size
        self._hop_frames = self.params.dtw_hop_size // self.hop_size
        if self._w > wtw_insert.MAX_W:
            raise ValueError(
                f"window of {self._w} frames exceeds the fused kernel's {wtw_insert.MAX_W}-lane layout; "
                "use MultiStreamWTW for larger windows")

        chromas = self._ref_chromas(refs, ref_chromas)
        self.b = len(chromas)
        if self.b == 0:
            raise ValueError("need at least one stream")
        self.f = chromas[0].shape[0]
        self.ms = np.asarray([c.shape[1] for c in chromas], np.int32)
        for i, c in enumerate(chromas):
            try:
                _check_ref_window(c.shape[1], self.params)
            except ValueError as e:
                raise ValueError(f"stream {i}: {e}") from None
        self.n_caps = (2 * self.ms).astype(np.int32)  # per-stream live capacity (wtw.py:52)
        self._shared_ref = len({id(c) for c in chromas}) == 1
        self._lens = np.stack([self.ms, self.n_caps, np.zeros(self.b, np.int32)], axis=1)  # [m, n_cap, n_valid]
        self._delta_len = wtw_insert.delta_width(self._w, self._hop_frames, self.k_block)
        self._span_len = (self.k_block - 1) * self.hop_size + self.fft_len
        payload = {"chroma": 12 * self.k_block * 4, "int16": self._span_len * 2}.get(self.transfer_dtype,
                                                                                     self._span_len * 4)
        # each distinct chroma once a device, the same object for every stream that shares it
        held = per_device(self._shards, lambda d: {id(c): c.to(d) for c in chromas})
        ref_rows = {}
        for sh in self._shards:
            sh_chromas = [held[sh.device][id(c)] for c in chromas[sh.rows]]
            st = wtw_insert.new_multi_state(sh_chromas, self.n_caps[sh.rows], m_max=int(self.ms.max()),
                                            n_cap_max=int(self.n_caps.max()))
            if st.ref.shape[0] == 1:  # shards on one device read one copy of a shared reference
                st.ref = ref_rows.setdefault((sh.device, id(sh_chromas[0])), st.ref)
            sh.state = st
            if sh.device.type == "cuda":
                nb = st.batch
                sh.staging = PinnedStaging(PinnedStaging.nbytes(nb * payload, self._lens[sh.rows].nbytes), sh.device)
        self._reset_host_paths()

        self.bufs = [SampleFIFO(self.dtype) for _ in range(self.b)]
        self._stopped = np.zeros(self.b, bool)
        self._init_batched_polling()

    def _ref_chromas(self, refs, ref_chromas) -> List[torch.Tensor]:
        """One (12, m) float32 chroma tensor on the device per stream; the
        same tensor object wherever two streams share a reference (by path,
        or by object identity for arrays), as the JAX engine dedupes them
        (wtw_serving.py:94-128)."""
        if ref_chromas is not None:
            if len(ref_chromas) == 1 and len(refs) > 1:
                ref_chromas = list(ref_chromas) * len(refs)
            if len(ref_chromas) != len(refs):
                raise ValueError(f"ref_chromas has {len(ref_chromas)} entries for {len(refs)} streams")
            memo = {}
            for c in ref_chromas:
                if id(c) not in memo:
                    memo[id(c)] = torch.tensor(np.asarray(c, self.dtype), device=self.device)
            return [memo[id(c)] for c in ref_chromas]
        out, memo = [], {}
        for r in refs:
            key = r if isinstance(r, (str, bytes)) else id(r)
            if key not in memo:
                if isinstance(r, (str, bytes)):
                    wav, fs = load_wav(r)
                    assert fs == FS
                else:
                    wav = np.asarray(r)
                memo[key] = chroma_from_samples(wav, dtype=self.dtype, device=self.device)
            out.append(memo[key])
        return out

    # -- the block's payload (MultiStreamWTW, wtw_serving.py:214-260) --------

    def _avail_cols(self, i: int) -> int:
        n = len(self.bufs[i])
        return 0 if n < self.fft_len else (n - self.fft_len) // self.hop_size + 1

    def _spans(self, ks: np.ndarray) -> np.ndarray:
        """The block's payload, consuming each stream's ``ks[i]`` columns of
        samples: (B, span) raw samples (float32 or int16), or (B, 12,
        k_block) host-extracted chroma for ``transfer_dtype="chroma"``,
        the valid frames of every stream packed into one host extraction
        (columns past a stream's count stay zero; the kernel masks them by
        its n_valid)."""
        if self.transfer_dtype == "chroma":
            return _pack_chroma(self.bufs, ks, self.k_block, self.hop_size, self.fft_len, self.dtype)
        return _sample_spans(self.bufs, ks, self.k_block, self.hop_size, self.fft_len, self.dtype,
                             self.transfer_dtype)

    def _columns(self, payload: torch.Tensor, ks: np.ndarray) -> torch.Tensor:
        """The block's (B, k_block, F) live columns on the device."""
        if self.transfer_dtype == "chroma":
            return payload.transpose(1, 2).contiguous()
        if self.transfer_dtype == "int16":
            payload = payload.to(torch.float32) / 32768.0
        return chroma_spans_tiled(payload, self.k_block, self.fft_len, self.hop_size, FS,
                                  streams=np.nonzero(ks)[0].tolist())

    def _dispatch(self, ks: np.ndarray) -> None:
        payload = self._spans(ks)
        lens = self._lens.copy()
        lens[:, 2] = ks
        statuses = []
        for sh in self._shards:  # one launch a shard, on its device
            if sh.staging is not None:
                payload_t, lens_t = sh.staging.put(payload[sh.rows], lens[sh.rows])
            else:
                payload_t, lens_t = (torch.from_numpy(np.ascontiguousarray(a)).to(sh.device)
                                     for a in (payload[sh.rows], lens[sh.rows]))
            cols = self._columns(payload_t, ks[sh.rows])
            # a fresh row block per launch: it stays pending until paths() drains it
            rows = torch.empty((cols.shape[0], self._delta_len), dtype=torch.int32, device=sh.device)
            wtw_insert.multi_wtw_insert_block(sh.state, cols, lens_t, self._w, self._hop_frames, self.k_block, rows)
            views = wtw_insert.delta_views(rows[:, None])  # (B, 1, X) each: the JAX engine's row-shaped layout
            sh.deltas.append(views)
            fold_delta_tail(sh.deltas, _DELTA_STACK)
            statuses.append(views[0])
        self._record_status(statuses)
        self._poll()

    # -- streaming API ---------------------------------------------------------

    def _block_counts(self) -> np.ndarray:
        return np.asarray([0 if self._stopped[i] else min(self._avail_cols(i), self.k_block)
                           for i in range(self.b)], np.int32)

    def insert(self, stream_bufs: Sequence) -> np.ndarray:
        """Append raw samples per stream (``None``: no new audio) and
        dispatch every full block; non-blocking.  Returns the stopped mask
        as of the last consumed status (lazy, like the solo engines)."""
        if len(stream_bufs) != self.b:
            raise ValueError(f"expected {self.b} buffers, got {len(stream_bufs)}")
        for i, buf in enumerate(stream_bufs):
            if buf is not None and not self._stopped[i]:
                self.bufs[i].extend(buf)
        while True:
            ks = self._block_counts()
            if ks.max(initial=0) < self.k_block:
                break
            self._dispatch(ks)
        self._poll()
        return self._stopped.copy()

    def flush(self) -> np.ndarray:
        """Dispatch every stream's remaining whole hop columns and wait for
        every launch; returns the final stopped mask."""
        while True:
            ks = self._block_counts()
            if ks.max(initial=0) <= 0:
                break
            self._dispatch(ks)
        self._poll(block=True)
        return self._stopped.copy()

    def _poll(self, block: bool = False) -> None:
        if block:
            self._settle_status()
        else:
            self._poll_status()

    def _consume(self, vec: np.ndarray) -> None:
        vec = vec.reshape(self.b, -1)  # (B, 8) status rows
        self._stopped |= (vec[:, 0] & 1).astype(bool)
        if (vec[:, 0] & 2).any():  # sticky in the kernel's scalar state
            raise AssertionError("FusedMultiStreamWTW path delta overflow")

    # -- inspection (each waits for the card) ----------------------------------

    @property
    def stopped(self) -> np.ndarray:
        self._poll(block=True)
        return self._stopped.copy()

    def paths(self) -> List[List[tuple]]:
        """Per-stream committed (live, ref) paths, as lists of tuples."""
        return [list(zip(p[:, 0].tolist(), p[:, 1].tolist())) for p in self._host_paths()]

    def pointers(self) -> List[Tuple[int, int, int]]:
        """Per-stream (chroma_ptr, live_ptr, ref_ptr)."""
        sc = np.concatenate([sh.state.scalars.cpu().numpy() for sh in self._shards])
        return [(int(s[WS_CHROMA]), int(s[WS_LIVE]), int(s[WS_REF])) for s in sc]

    @property
    def _state(self) -> wtw_insert.MultiWTWState:
        """Every stream's state in stream order: the one shard's state
        itself, or (a mesh) the shards' rows gathered onto the first device,
        the reference rows one a stream unless one reference serves all (a
        copy)."""
        if len(self._shards) == 1:
            return self._shards[0].state
        parts = [sh.state for sh in self._shards]
        ref = (parts[0].ref if self._shared_ref else
               gather_rows([p.ref.expand(p.batch, -1, -1) for p in parts]))
        return wtw_insert.MultiWTWState(ref=ref, live=gather_rows([p.live for p in parts]),
                                        scalars=gather_rows([p.scalars for p in parts]))
