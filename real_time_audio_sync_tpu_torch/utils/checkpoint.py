"""Engine state checkpoint/resume (the JAX package's ``utils/checkpoint.py``).

A checkpoint is one ``.npz``: save mid-performance, restore in a new
process, on another card or on the CPU, and keep following from the same
frame.  The file format is the JAX package's, key for key, with its
shapes, layouts and dtypes: the state goes through ``utils/convert``'s
converters into the JAX engines' TPU layouts on save and back on load, so
a checkpoint written by either package loads in the other.  The checks
are JAX's, with its messages: the reference (compared in JAX's layout),
the engine parameters that change no shape (``c``, ``max_run_count``,
``k_block``, the WTW window geometry; fields absent from older snapshots
are skipped), dtype and transfer encoding, the layout, and every shape.

Resume semantics are JAX's too: a save flushes first, so every dispatched
(in-flight) launch is in the snapshot; a load drops queued columns and
in-flight status reads but keeps a tuned ``poll_min_interval``; the
sticky stop flag rides the snapshot.  A load writes into the engine's own
tensors on its own device.
"""

from __future__ import annotations

import numpy as np

from real_time_audio_sync_tpu_torch.models.online_core import BandedOnlineEngine, OnlineState
from real_time_audio_sync_tpu_torch.models.wtw import SampleFIFO
from real_time_audio_sync_tpu_torch.utils import convert


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _reset_polling(engine) -> None:
    """No in-flight work survives a restore (a status read queued before it
    must not be consumed against the restored state), but a tuned
    ``poll_min_interval`` is an engine setting, not stream state: keep it
    (as ``set_live``'s reset does, models/online_core.py)."""
    interval = engine.poll_min_interval
    engine._init_status_polling()
    engine.poll_min_interval = interval


def _reset_batched_polling(follower) -> None:
    """The batched followers' counterpart of :func:`_reset_polling`."""
    follower._outstanding = []
    follower._latest_done = None
    follower._last_poll_time = 0.0


def _check_params(data, *fields) -> None:
    """Engine parameters that change no validated SHAPE: a mismatch would
    otherwise restore silently and misalign.  Fields absent from older
    snapshots are skipped."""
    for name, want in fields:
        if name in data.files and int(data[name]) != int(want):
            raise ValueError(
                f"checkpoint {name} {int(data[name])} != engine {name} {int(want)}")


def _check_shapes(data, want: dict) -> None:
    for name, shape in want.items():
        if data[name].shape != tuple(shape):
            raise ValueError(f"checkpoint field {name!r} has shape {data[name].shape}, engine expects {tuple(shape)}")


def _check_reference(stored, mine, what: str = "a different reference sequence") -> None:
    if stored.shape != mine.shape or not np.array_equal(stored, mine):
        raise ValueError(f"checkpoint was taken against {what}")


def _set_host_path(engine, p: np.ndarray) -> None:
    """A solo delta-mode engine's drained host path, nothing pending."""
    engine._deltas.clear()
    engine._host_px = [p[:, 0].astype(np.int32)] if len(p) else []
    engine._host_py = [p[:, 1].astype(np.int32)] if len(p) else []
    engine._drained_plen = len(p)


# -- the online tensor engines (OnlineTimeWarping, LiveNote, LiveNoteV2) ------


def save_state(engine: BandedOnlineEngine, path: str) -> None:
    """Snapshot a streaming engine's full state to ``path`` (.npz).  The
    copy to the host waits for the card, so every dispatched (including
    in-flight pipelined) insert is captured."""
    arrays = dict(zip(OnlineState._fields, convert.online_state_to_jax(engine.state)))
    np.savez_compressed(
        path, ref=_host(engine.ref),
        batch_mode=np.int32(engine._batch_mode),
        c=np.int32(engine.cfg.c),
        max_run_count=np.int32(engine.cfg.max_run_count), **arrays,
    )


def load_state(engine: BandedOnlineEngine, path: str) -> None:
    """Restore a snapshot into a compatibly-constructed engine (same
    reference sequence, params and dtype)."""
    data = np.load(path)
    _check_reference(data["ref"], _host(engine.ref))
    _check_params(data, ("c", engine.cfg.c), ("max_run_count", engine.cfg.max_run_count))
    _check_shapes(data, {f: cur.shape[1:] for f, cur in zip(OnlineState._fields, engine.state)})
    fields = convert.online_state_from_jax([data[f] for f in OnlineState._fields])
    engine.state = OnlineState(*(x.to(device=cur.device, dtype=cur.dtype) for x, cur in zip(fields, engine.state)))
    # the sticky stop flag is part of OnlineState and rides the snapshot
    _reset_polling(engine)
    engine._stopped_cached = bool(np.asarray(data["stopped"]))
    # .path's return type follows the mode the snapshot was taken in
    # (set_live -> array, streaming -> list of tuples; otw.py's surface)
    engine._batch_mode = bool(int(data["batch_mode"])) if "batch_mode" in data.files else False


# -- FusedStreamingEngine (kernel #1, and #4 in the long-reference layout) ----


def _fused_ref_t(engine) -> np.ndarray:
    return convert.otw_ref_to_jax(engine._state.ref, c=engine.cfg.c, k_block=engine.k_block,
                                  loop_iters=engine.cfg.loop_iters, long_ref=engine.long_ref)


def _fused_arrays(engine, host_path) -> dict:
    """The engine's state in the JAX engine's layout, by key."""
    st, dims = engine._state, {"c": engine.cfg.c, "n": engine.n, "f": engine.f}
    if engine.long_ref:
        w, live_win, sc, hp = convert.long_state_to_jax(st.window, st.live, st.scalars, host_path,
                                                        k_block=engine.k_block, **dims)
        return {"w": w, "live_win": live_win, "scalars": sc, "host_path": hp}
    w, live_t, px, py, sc = convert.otw_state_to_jax(st.window, st.live, st.path_x, st.path_y, st.scalars, **dims)
    return {"w": w, "live_t": live_t, "path_x": px, "path_y": py, "scalars": sc}


def save_fused_state(engine, path: str) -> None:
    """Snapshot a FusedStreamingEngine (window, live features, path,
    scalars) to ``path`` (.npz).  Long-reference engines snapshot the
    JAX engine's sliding live window plus the host path (pending delta rows
    drained first).  Flushes first in BOTH layouts: feed()'s coalesce
    queue may hold undispatched columns, which a snapshot of the device
    state alone would silently lose."""
    engine.flush()
    extra = {"long_ref": np.int32(1)} if engine.long_ref else {}
    arrays = _fused_arrays(engine, engine.path_array if engine.long_ref else None)
    np.savez_compressed(
        path, ref_t=_fused_ref_t(engine), **arrays, **extra,
        stopped=np.int32(engine._stopped_cached),
        c=np.int32(engine.cfg.c),
        max_run_count=np.int32(engine.cfg.max_run_count),
        k_block=np.int32(engine.k_block),
    )


def load_fused_state(engine, path: str) -> None:
    """Restore a snapshot into a compatibly-constructed fused engine."""
    data = np.load(path)
    ck_long = bool(int(data["long_ref"])) if "long_ref" in data.files else False
    if ck_long != engine.long_ref:
        raise ValueError("checkpoint and engine disagree on long_ref mode")
    _check_reference(data["ref_t"], _fused_ref_t(engine))
    _check_params(data, ("c", engine.cfg.c),
                  ("max_run_count", engine.cfg.max_run_count),
                  ("k_block", engine.k_block))
    want = _fused_arrays(engine, np.zeros((0, 2), np.int32))
    want.pop("host_path", None)
    _check_shapes(data, {k: v.shape for k, v in want.items()})
    st, dims = engine._state, {"c": engine.cfg.c, "n": engine.n, "f": engine.f}
    if engine.long_ref:
        window, live, sc, p = convert.long_state_from_jax(data["w"], data["live_win"], data["scalars"],
                                                          data["host_path"], **dims)
        _set_host_path(engine, p)
    else:
        window, live, px, py, sc = convert.otw_state_from_jax(
            *(data[n] for n in ("w", "live_t", "path_x", "path_y", "scalars")), **dims)
        st.path_x.copy_(px)
        st.path_y.copy_(py)
    st.window.copy_(window)
    st.live.copy_(live)
    st.scalars.copy_(sc)
    _reset_polling(engine)
    engine._pending.clear()  # queued feed() columns predate the restore
    engine._stopped_cached = bool(int(data["stopped"]))


# -- FusedMultiStreamFollower (kernels #5 and #6) ------------------------------


def _multi_ref_t(fms) -> np.ndarray:
    return convert.otw_ref_to_jax(fms._state.ref, c=fms.cfg.c, k_block=fms.k_block,
                                  loop_iters=fms.cfg.loop_iters, long_ref=fms.long_ref)


def _multi_arrays(fms, host_paths) -> dict:
    st, c = fms._state, fms.cfg.c
    if fms.long_ref:
        w, live_win, sc, _ = convert.multi_long_state_to_jax(st.window, st.live, st.scalars, host_paths, c=c,
                                                             ref_lens=fms.ref_lens, f=fms.f, k_block=fms.k_block)
        return {"w": w, "live_win": live_win, "scalars": sc}
    w, live_t, px, py, sc = convert.multi_otw_state_to_jax(st.window, st.live, st.path_x, st.path_y, st.scalars,
                                                           c=c, n_max=fms.n_max, f=fms.f)
    return {"w": w, "live_t": live_t, "path_x": px, "path_y": py, "scalars": sc}


def save_multi_stream_state(fms, path: str) -> None:
    """Snapshot a :class:`~real_time_audio_sync_tpu_torch.parallel.serving.
    FusedMultiStreamFollower`: all ``B`` streams' banded window, live
    features, committed paths and scalar state in one ``.npz``.  Flushes
    first (dispatches queued columns, waits for in-flight launches), so the
    snapshot is a consistent frontier across every stream.  The windowed
    layout snapshots the JAX follower's sliding live windows plus the
    per-stream host paths (delta rows drained first)."""
    fms.flush()
    common = dict(
        ref_t=_multi_ref_t(fms),
        stopped=fms._stopped.astype(np.int32),
        last_points=np.asarray(fms._last_points, np.int64),
        k_block=np.int32(fms.k_block),
        c=np.int32(fms.cfg.c),
        max_run_count=np.int32(fms.cfg.max_run_count),
    )
    if fms.long_ref:
        paths = fms.paths()  # drains pending deltas
        lens = np.asarray([len(p) for p in paths], np.int64)
        cat = np.concatenate(paths, axis=0) if lens.sum() else np.zeros((0, 2), np.int32)
        np.savez_compressed(path, **_multi_arrays(fms, paths), host_paths=cat, host_path_lens=lens,
                            long_ref=np.int32(1), **common)
        return
    np.savez_compressed(path, **_multi_arrays(fms, None), **common)


def load_multi_stream_state(fms, path: str) -> None:
    """Restore a snapshot into a compatibly-constructed follower (same
    references, params, k_block and stream count)."""
    data = np.load(path)
    ck_long = bool(int(data["long_ref"])) if "long_ref" in data.files else False
    if ck_long != fms.long_ref:
        raise ValueError("checkpoint and follower disagree on long_ref mode")
    _check_reference(data["ref_t"], _multi_ref_t(fms), "different reference sequences")
    for field, want in (("k_block", fms.k_block), ("c", fms.cfg.c),
                        ("max_run_count", fms.cfg.max_run_count)):
        if int(data[field]) != want:
            raise ValueError(
                f"checkpoint {field} {int(data[field])} != engine {field} {want}")
    empty = [np.zeros((0, 2), np.int32)] * fms.b
    _check_shapes(data, {k: v.shape for k, v in _multi_arrays(fms, empty).items()})
    st = fms._state
    if ck_long:
        lens = data["host_path_lens"].astype(np.int64)
        paths = np.split(data["host_paths"].astype(np.int32).reshape(-1, 2), np.cumsum(lens)[:-1])
        window, live, sc, paths = convert.multi_long_state_from_jax(
            data["w"], data["live_win"], data["scalars"], paths, c=fms.cfg.c, ref_lens=fms.ref_lens, f=fms.f)
        fms._deltas.clear()
        fms._reset_host_paths(paths)
    else:
        window, live, px, py, sc = convert.multi_otw_state_from_jax(
            *(data[n] for n in ("w", "live_t", "path_x", "path_y", "scalars")), c=fms.cfg.c, n_max=fms.n_max, f=fms.f)
        st.path_x.copy_(px)
        st.path_y.copy_(py)
    st.window.copy_(window)
    st.live.copy_(live)
    st.scalars.copy_(sc)
    fms._stopped = data["stopped"].astype(bool)
    fms._last_points = data["last_points"].astype(np.int64)
    # no queued columns or in-flight work survives a restore
    fms._reset_pending()
    _reset_batched_polling(fms)


# -- MultiStreamWTW and AsyncWTW (kernels #7/#8 over a batch of windows) -------


def _fifo_arrays(bufs) -> tuple:
    arrays = [b.to_array().astype(np.float64) for b in bufs]
    return (np.concatenate(arrays) if arrays else np.zeros(0)), np.asarray([len(a) for a in arrays], np.int64)


def _window_geometry(data, params) -> None:
    _check_params(data, ("dtw_win_size", params.dtw_win_size), ("dtw_hop_size", params.dtw_hop_size))


def save_multi_wtw_state(ms, path: str) -> None:
    """Snapshot a :class:`~real_time_audio_sync_tpu_torch.parallel.
    wtw_serving.MultiStreamWTW`: the live chromagrams, paths and scalar
    state on the card plus every stream's host sample FIFO.  Flushes first
    so the snapshot is a consistent frontier."""
    ms.flush()
    st = ms._stepper
    live_dev, px, py, sc = convert.multi_async_wtw_state_to_jax(st.live, st.px, st.py, st.sc)
    buf_cat, buf_lens = _fifo_arrays(ms.bufs)
    np.savez_compressed(
        path,
        ref_dev=convert.wtw_refs_to_jax(st.ref, st.ref_ids, ms.ms, ms._shared_ref), live_dev=live_dev,
        path_x=px, path_y=py, scalars=sc,
        buf_cat=buf_cat, buf_lens=buf_lens,
        stopped=ms._stopped.astype(np.int32),
        dtype=np.str_(ms.dtype.name),
        k_block=np.int32(ms.k_block),
        transfer_dtype=np.str_(ms.transfer_dtype),
        dtw_win_size=np.int32(ms.params.dtw_win_size),
        dtw_hop_size=np.int32(ms.params.dtw_hop_size),
    )


def load_multi_wtw_state(ms, path: str) -> None:
    """Restore a snapshot into a compatibly-constructed MultiStreamWTW
    (same references, params, k_block, dtype and transfer encoding)."""
    data = np.load(path)
    st = ms._stepper
    _check_reference(data["ref_dev"], convert.wtw_refs_to_jax(st.ref, st.ref_ids, ms.ms, ms._shared_ref),
                     "different reference recordings")
    if str(data["dtype"]) != ms.dtype.name:
        raise ValueError(f"checkpoint dtype {data['dtype']} != engine dtype {ms.dtype.name}")
    if str(data["transfer_dtype"]) != ms.transfer_dtype:
        raise ValueError(
            f"checkpoint transfer_dtype {data['transfer_dtype']} != engine {ms.transfer_dtype}")
    for field in ("k_block", "dtw_win_size", "dtw_hop_size"):
        want = ms.k_block if field == "k_block" else getattr(ms.params, field)
        if int(data[field]) != want:
            raise ValueError(
                f"checkpoint {field} {int(data[field])} != engine {field} {want}")
    names = ("live_dev", "path_x", "path_y", "scalars")
    mine = convert.multi_async_wtw_state_to_jax(st.live, st.px, st.py, st.sc)
    _check_shapes(data, {n: a.shape for n, a in zip(names, mine)})
    st.set_state(*convert.multi_async_wtw_state_from_jax(*(data[n] for n in names)))
    splits = np.cumsum(data["buf_lens"])[:-1]
    ms.bufs = [SampleFIFO.from_array(a, ms.dtype) for a in np.split(data["buf_cat"], splits)]
    ms._stopped = data["stopped"].astype(bool)
    _reset_batched_polling(ms)


def _async_chroma_ref(engine) -> np.ndarray:
    """The reference chroma (F, M) the engine's windows read."""
    return np.ascontiguousarray(_host(engine._stepper.ref[0, : engine.M]).T)


def save_async_wtw_state(engine, path: str) -> None:
    """Snapshot an AsyncWTW engine: the live chromagram, path buffers and
    scalar state on the card, plus the host sample FIFO.  Waits for
    in-flight dispatches (flush) so the snapshot is a consistent
    frontier."""
    engine.flush()
    st = engine._stepper
    live_dev, px, py, sc = convert.async_wtw_state_to_jax(st.live, st.px, st.py, st.sc)
    np.savez_compressed(
        path,
        chroma_ref=_async_chroma_ref(engine),
        live_dev=live_dev,
        path_x=px, path_y=py, scalars=sc,
        buf=engine.buf.to_array().astype(np.float64),
        stopped=np.int32(engine._stopped_cached),
        dtype=np.str_(engine.dtype.name),
        k_block=np.int32(engine.k_block),
        dtw_win_size=np.int32(engine.params.dtw_win_size),
        dtw_hop_size=np.int32(engine.params.dtw_hop_size),
    )


def load_async_wtw_state(engine, path: str) -> None:
    """Restore a snapshot into a compatibly-constructed AsyncWTW engine
    (same reference recording, params, k_block and dtype)."""
    data = np.load(path)
    _check_reference(data["chroma_ref"], _async_chroma_ref(engine), "a different reference recording")
    # shapes alone don't catch these: a dtype mismatch would mix precisions
    # in the next step, a k_block mismatch would change the dispatch
    # batching the snapshot's FIFO remainder assumes
    if str(data["dtype"]) != engine.dtype.name:
        raise ValueError(
            f"checkpoint dtype {data['dtype']} != engine dtype {engine.dtype.name}")
    if int(data["k_block"]) != engine.k_block:
        raise ValueError(
            f"checkpoint k_block {int(data['k_block'])} != engine k_block {engine.k_block}")
    # window geometry: two engines on one reference with different window
    # params can share every array shape, and the scalar pointers would be
    # reinterpreted under the wrong geometry
    _window_geometry(data, engine.params)
    names = ("live_dev", "path_x", "path_y", "scalars")
    st = engine._stepper
    _check_shapes(data, {n: a.shape for n, a in zip(names, convert.async_wtw_state_to_jax(st.live, st.px, st.py,
                                                                                          st.sc))})
    st.set_state(*convert.async_wtw_state_from_jax(*(data[n] for n in names)))
    engine.buf = SampleFIFO.from_array(data["buf"], engine.dtype)
    _reset_polling(engine)
    engine._stopped_cached = bool(int(data["stopped"]))


# -- the host WTW (kernels #7 and #8 a window) --------------------------------


def save_wtw_state(wtw, path: str) -> None:
    """Snapshot a WTW engine mid-stream (its state is the host's, its live
    chromagram is read back from the device)."""
    acc = wtw.acc_cost if wtw.acc_cost is not None else np.empty((0, 0), wtw.dtype)
    np.savez_compressed(
        path,
        chroma_ref=_host(wtw.chroma_ref),
        chroma_live=wtw.chroma_live,
        acc_cost=acc,
        buf=wtw.buf.to_array().astype(np.float64),
        path=np.asarray(wtw.path, np.int64).reshape(-1, 2),
        ptrs=np.asarray([wtw.chroma_ptr, wtw.live_ptr, wtw.ref_ptr], np.int64),
    )


def load_wtw_state(wtw, path: str) -> None:
    data = np.load(path)
    _check_reference(data["chroma_ref"], _host(wtw.chroma_ref), "a different reference recording")
    wtw.chroma_live = data["chroma_live"]
    acc = data["acc_cost"]
    wtw.acc_cost = acc if acc.size else None
    wtw.keep_acc_canvas = bool(acc.size)
    wtw.buf = SampleFIFO.from_array(data["buf"], wtw.dtype)
    wtw.path = [tuple(int(v) for v in p) for p in data["path"]]
    wtw.chroma_ptr, wtw.live_ptr, wtw.ref_ptr = (int(x) for x in data["ptrs"])


# -- FusedWTW (kernel #9) -------------------------------------------------------


def _fused_wtw_chroma_ref(engine) -> np.ndarray:
    """The reference chroma (F, M) the engine's kernel reads."""
    return np.ascontiguousarray(_host(engine._state.ref).T)


def _fused_wtw_arrays(engine, host_path) -> tuple:
    return convert.fused_wtw_state_to_jax(engine._state.live, engine._state.scalars, host_path, w=engine._w,
                                          hop_frames=engine._hop_frames, k_block=engine.k_block)


def save_fused_wtw_state(engine, path: str) -> None:
    """Snapshot a FusedWTW engine: the JAX engine's sliding live window
    and its 16 scalars, the host path (pending delta rows drained first)
    and the host sample FIFO.  Flushes first so the snapshot is a
    consistent frontier."""
    engine.flush()
    live_win, sc, hp = _fused_wtw_arrays(engine, engine.path_array)
    np.savez_compressed(
        path,
        chroma_ref=_fused_wtw_chroma_ref(engine),
        live_win=live_win,
        scalars=sc,
        host_path=hp,
        buf=engine.buf.to_array().astype(np.float64),
        stopped=np.int32(engine._stopped_cached),
        k_block=np.int32(engine.k_block),
        dtw_win_size=np.int32(engine.params.dtw_win_size),
        dtw_hop_size=np.int32(engine.params.dtw_hop_size),
        transfer=np.str_(engine.transfer_dtype),
    )


def load_fused_wtw_state(engine, path: str) -> None:
    """Restore a snapshot into a compatibly-constructed FusedWTW engine
    (same reference recording, params, k_block and transfer_dtype)."""
    data = np.load(path)
    _check_reference(data["chroma_ref"], _fused_wtw_chroma_ref(engine), "a different reference recording")
    if int(data["k_block"]) != engine.k_block:
        raise ValueError(
            f"checkpoint k_block {int(data['k_block'])} != engine k_block {engine.k_block}")
    if str(data["transfer"]) != engine.transfer_dtype:
        raise ValueError(
            f"checkpoint transfer_dtype {data['transfer']} != engine "
            f"{engine.transfer_dtype}")
    # the window geometry (load_async_wtw_state's rationale): two window
    # configs can collide on every array shape
    _window_geometry(data, engine.params)
    live_win, sc, _ = _fused_wtw_arrays(engine, np.zeros((0, 2), np.int32))
    _check_shapes(data, {"live_win": live_win.shape, "scalars": sc.shape})
    live, sc, p = convert.fused_wtw_state_from_jax(data["live_win"], data["scalars"], data["host_path"], m=engine.M,
                                                   f=engine._state.live.shape[1])
    engine._state.live.copy_(live)
    engine._state.scalars.copy_(sc)
    _set_host_path(engine, p)
    engine.buf = SampleFIFO.from_array(data["buf"], engine.dtype)
    _reset_polling(engine)
    engine._stopped_cached = bool(int(data["stopped"]))

