"""Carry fused-engine state between the JAX package and the port.

The system has no weights: its parameters are the chroma filterbank
(copied bit-identically) and the streaming engine state.  The JAX fused
engine keeps that state in TPU layouts — a (8,128)-tiled window, the live
history transposed onto 128 lanes, 128-rounded path buffers — and the port
keeps the canonical layout of :class:`~..ops.otw_insert.OTWState`.  The
standard-layout functions take and return the state tuple in the engine's
order ``(window, live, path_x, path_y, scalars)``; the long-reference
functions take and return ``(window, live, scalars, host_path)``, where the
JAX engine's live history is a sliding window of rows and the committed
path lives on the host.  The ``multi_*`` functions carry a JAX
``FusedMultiStreamFollower``'s batched state (a leading stream axis, its
SMEM arrays row-shaped ``(B, 1, X)``) stream by stream over the same
functions, into the port's ``MultiOTWState`` layout and back.  The
``fused_wtw_*`` functions carry a ``FusedWTW``'s state: JAX's sliding live
window (rows on 128 lanes), 16 scalars and host path against the port's
whole live history (n_cap, F), scalars and host path; the
``multi_fused_wtw_*`` functions carry a ``FusedMultiStreamWTW``'s stream by
stream over them, each stream on its own reference length.  The
``async_wtw_state_*`` functions carry an ``AsyncWTW``'s state (JAX's
``live_dev`` (F, N), ``px``, ``py`` and ``sc`` int32[8]) against the
port's ``BlockStepper`` layout, and the ``multi_async_wtw_state_*``
functions a ``MultiStreamWTW``'s, batched in both packages.  The
``online_state_*`` functions carry the online tensor engine's state
(``models/online_core.OnlineState``: the JAX engine's 14 fields, the
dense accumulator among them) and the ``multi_online_state_*`` functions a
``MultiStreamFollower``'s, whose fields carry a leading stream axis in
both packages.  The reference features are not state (each engine builds
them from the same chroma).
"""

from __future__ import annotations

import numpy as np
import torch

from real_time_audio_sync_tpu_torch.ops.wtw_insert import WS_BASE, WS_CHROMA, WS_LIVE

_LANES, _SUBLANES = 128, 8
# scalar slots (pallas_otw.py:638-641, 865): t, first insert pending, and
# the JAX long kernel's live-window base (the virtual live row at physical
# row 0); the port's kernel leaves slot 11 alone
_S_T, _S_FIRST, _S_LIVE_BASE = 0, 7, 11


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def otw_state_from_jax(w, live_t, path_x, path_y, scalars, *, c: int, n: int, f: int):
    """JAX ``FusedStreamingEngine._state`` arrays (numpy) → the port's state
    tensors (CPU) for band ``c``, reference length ``n`` and feature width
    ``f``.  Only the window's (c+1)² block, the first ``f`` lanes of the
    live history and the port's path length are meaningful; the rest of
    the JAX buffers is padding."""
    cap = 2 * n
    p_len = cap + n + 16

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype))  # a writable copy

    return (
        t(np.asarray(w)[: c + 1, : c + 1], np.float32),
        t(np.asarray(live_t)[: c + cap, :f], np.float32),
        t(np.asarray(path_x)[:p_len], np.int32),
        t(np.asarray(path_y)[:p_len], np.int32),
        t(np.asarray(scalars), np.int32),
    )


def otw_state_to_jax(window, live, path_x, path_y, scalars, *, c: int, n: int, f: int):
    """The port's state tensors → numpy arrays in the JAX engine's layout
    (the inverse of :func:`otw_state_from_jax`), zero-padded to its
    shapes; the padding is never read by the JAX kernel's band cells."""
    cap = 2 * n
    w_sub, w_lane = _round_up(c + 1, _SUBLANES), _round_up(c + 1, _LANES)
    p_pad = _round_up(cap + n + 16, _LANES)

    def host(x):
        return x.detach().cpu().numpy()

    w = np.zeros((w_sub, w_lane), np.float32)
    w[: c + 1, : c + 1] = host(window)
    live_t = np.zeros((_round_up(c + cap + w_sub + 8, _SUBLANES), _LANES), np.float32)
    live_t[: c + cap, :f] = host(live)
    px = np.zeros(p_pad, np.int32)
    py = np.zeros(p_pad, np.int32)
    px[: path_x.shape[0]] = host(path_x)
    py[: path_y.shape[0]] = host(path_y)
    return w, live_t, px, py, host(scalars).astype(np.int32)


def _live_rows_written(scalars, c: int, cap: int):
    """Virtual live rows ``[lo, hi)`` that hold frames: row c+t ↔ frame t,
    written up to frame min(t, cap-1) once the first insert ran."""
    if int(scalars[_S_FIRST]):
        return c, c
    return c, c + min(int(scalars[_S_T]), cap - 1) + 1


def long_state_from_jax(w, live_win, scalars, host_path, *, c: int, n: int, f: int):
    """A JAX long-reference engine's state (numpy: the window, the sliding
    live window, the scalars, and its host path (P, 2)) → the port's
    ``(window, live, scalars, host_path)``, CPU tensors and an int32 array.

    The live window's physical row p is virtual live row ``base + p``
    (``base`` = scalar slot 11).  Rows before ``base`` are gone from the JAX
    state; the band never reads them again (it reads rows t..t+c, and
    base ≤ t), so the port's rows there stay zero."""
    cap = 2 * n
    sc = np.array(scalars, dtype=np.int32)
    base = int(sc[_S_LIVE_BASE])
    live = np.zeros((c + cap, f), np.float32)
    lo, hi = _live_rows_written(sc, c, cap)
    lo = max(lo, base)
    if hi > lo:
        live[lo:hi] = np.asarray(live_win)[lo - base : hi - base, :f]
    return (
        torch.from_numpy(np.array(np.asarray(w)[: c + 1, : c + 1], dtype=np.float32)),
        torch.from_numpy(live),
        torch.from_numpy(sc),
        np.array(host_path, dtype=np.int32).reshape(-1, 2),
    )


def long_state_to_jax(window, live, scalars, host_path, *, c: int, n: int, f: int, k_block: int):
    """The port's long-reference state → the JAX long engine's (window,
    live window, scalars, host path), the inverse of
    :func:`long_state_from_jax` for the rows the band can still read.  The
    live window starts at the current t (scalar slot 11 = t), so the JAX
    kernel's next realignment moves nothing; its size is the JAX engine's
    ``_long_geometry`` for band ``c`` and ``k_block``."""
    cap = 2 * n
    w_sub, w_lane = _round_up(c + 1, _SUBLANES), _round_up(c + 1, _LANES)
    l_win = _round_up(c + k_block + 16, _SUBLANES)
    l_pad = l_win + _round_up(k_block + 8, _SUBLANES)

    def host(x):
        return x.detach().cpu().numpy()

    sc = host(scalars).astype(np.int32).copy()
    base = int(sc[_S_T])
    sc[_S_LIVE_BASE] = base
    w = np.zeros((w_sub, w_lane), np.float32)
    w[: c + 1, : c + 1] = host(window)
    live_win = np.zeros((l_pad, _LANES), np.float32)
    rows = host(live)[base : min(base + l_pad, c + cap)]
    live_win[: rows.shape[0], :f] = rows
    return w, live_win, sc, np.array(host_path, dtype=np.int32).reshape(-1, 2)


def multi_otw_state_from_jax(w, live_t, path_x, path_y, scalars, *, c: int, n_max: int, f: int):
    """A JAX multi-stream follower's whole-buffer state (numpy: w (B, ·, ·),
    live_t (B, ·, 128), path_x/path_y (B, 1, P), scalars (B, 1, 16)) → the
    port's ``(window, live, path_x, path_y, scalars)`` with a leading
    stream axis, CPU tensors; ``n_max`` is the longest reference."""
    per = [otw_state_from_jax(np.asarray(w)[b], np.asarray(live_t)[b], np.asarray(path_x)[b, 0],
                              np.asarray(path_y)[b, 0], np.asarray(scalars)[b, 0], c=c, n=n_max, f=f)
           for b in range(np.asarray(w).shape[0])]
    return tuple(torch.stack([p[i] for p in per]) for i in range(5))


def multi_otw_state_to_jax(window, live, path_x, path_y, scalars, *, c: int, n_max: int, f: int):
    """The inverse of :func:`multi_otw_state_from_jax`: numpy arrays in the
    JAX follower's whole-buffer layout."""
    per = [otw_state_to_jax(window[b], live[b], path_x[b], path_y[b], scalars[b], c=c, n=n_max, f=f)
           for b in range(window.shape[0])]
    w, live_t, px, py, sc = (np.stack([p[i] for p in per]) for i in range(5))
    return w, live_t, px[:, None], py[:, None], sc[:, None]


def multi_long_state_from_jax(w, live_win, scalars, host_paths, *, c: int, ref_lens, f: int):
    """A JAX multi-stream follower's windowed state (numpy: w, live_win
    (B, l_pad, 128), scalars (B, 1, 16)) and its drained host paths (one
    (P_b, 2) array per stream; drain its pending rows first) → the port's
    ``(window, live, scalars, host_paths)``, the live history zero-padded
    to the longest reference's ``c + 2·N_max`` rows."""
    ref_lens = [int(n) for n in ref_lens]
    n_max = max(ref_lens)
    per = [long_state_from_jax(np.asarray(w)[b], np.asarray(live_win)[b], np.asarray(scalars)[b, 0],
                               host_paths[b], c=c, n=n, f=f) for b, n in enumerate(ref_lens)]
    live = torch.zeros((len(per), c + 2 * n_max, f), dtype=torch.float32)
    for b, p in enumerate(per):
        live[b, : p[1].shape[0]] = p[1]
    return torch.stack([p[0] for p in per]), live, torch.stack([p[2] for p in per]), [p[3] for p in per]


def multi_long_state_to_jax(window, live, scalars, host_paths, *, c: int, ref_lens, f: int, k_block: int):
    """The inverse of :func:`multi_long_state_from_jax` for the rows the band
    can still read: numpy arrays in the JAX follower's windowed layout and
    its host paths."""
    per = [long_state_to_jax(window[b], live[b, : c + 2 * int(n)], scalars[b], host_paths[b], c=c, n=int(n), f=f,
                             k_block=k_block) for b, n in enumerate(ref_lens)]
    w, live_win, sc = (np.stack([p[i] for p in per]) for i in range(3))
    return w, live_win, sc[:, None], [p[3] for p in per]


def fused_wtw_state_from_jax(live_win, scalars, host_path, *, m: int, f: int):
    """A JAX ``FusedWTW``'s state (numpy: its live window ``_live_win``,
    ``_scalars`` and drained host path (P, 2)) → the port's ``(live,
    scalars, host_path)``: CPU tensors (2m, f) and int32[16], and an int32
    array.

    The window's physical row p is live frame ``base + p`` (``base`` =
    slot ``WS_BASE``, which the port's kernel leaves alone); it holds frames ``[base, chroma_ptr)``.  Frames before
    ``base`` are gone from the JAX state and never read again (a window
    reads frames from ``live_ptr`` on, and base ≤ live_ptr), so the port's
    rows there stay zero."""
    sc = np.array(scalars, dtype=np.int32)
    base, cp = int(sc[WS_BASE]), int(sc[WS_CHROMA])
    live = np.zeros((2 * m, f), np.float32)
    if cp > base:
        live[base:cp] = np.asarray(live_win)[: cp - base, :f]
    sc[WS_BASE] = 0
    return torch.from_numpy(live), torch.from_numpy(sc), np.array(host_path, dtype=np.int32).reshape(-1, 2)


def fused_wtw_state_to_jax(live, scalars, host_path, *, w: int, hop_frames: int, k_block: int):
    """The port's FusedWTW state ``(live (n_cap, F), scalars, host_path)``
    → the JAX engine's ``(live_win (l_pad, 128), scalars, host_path)``,
    numpy.  The window starts at ``base = live_ptr``: the JAX kernel's next
    realign then moves nothing (pallas_wtw.py:185-188), and the frames
    ``[live_ptr, chroma_ptr)`` it will read are in place."""
    sc = np.array(scalars.detach().cpu().numpy(), dtype=np.int32)
    lp, cp = int(sc[WS_LIVE]), int(sc[WS_CHROMA])
    max_adv = (1 + -(-k_block // hop_frames)) * hop_frames  # the JAX wtw_geometry (pallas_wtw.py:108-112)
    l_win = _round_up(w + k_block + max_adv + 16, _SUBLANES)
    l_pad = l_win + _round_up(max_adv + 8, _SUBLANES)
    rows = live.detach().cpu().numpy()
    live_win = np.zeros((l_pad, _LANES), np.float32)
    if cp > lp:
        live_win[: cp - lp, : rows.shape[1]] = rows[lp:cp]
    sc[WS_BASE] = lp
    return live_win, sc, np.array(host_path, dtype=np.int32).reshape(-1, 2)


def multi_fused_wtw_state_from_jax(live_win, scalars, host_paths, *, ms, f: int):
    """A JAX ``FusedMultiStreamWTW``'s state (numpy: its live windows
    ``_live_win`` (B, l_pad, 128), ``_scalars`` (B, 1, 16) and drained host
    paths, one (P_b, 2) array per stream; drain its pending rows first) →
    the port's ``(live, scalars, host_paths)``: CPU tensors (B, 2·m_max, F)
    and (B, 16), and int32 arrays, stream by stream over
    :func:`fused_wtw_state_from_jax` with each stream's own m."""
    per = [fused_wtw_state_from_jax(np.asarray(live_win)[b], np.asarray(scalars)[b, 0], host_paths[b], m=int(m), f=f)
           for b, m in enumerate(ms)]
    live = torch.zeros((len(per), 2 * int(max(ms)), f), dtype=torch.float32)
    for b, p in enumerate(per):
        live[b, : p[0].shape[0]] = p[0]
    return live, torch.stack([p[1] for p in per]), [p[2] for p in per]


def multi_fused_wtw_state_to_jax(live, scalars, host_paths, *, w: int, hop_frames: int, k_block: int):
    """The inverse of :func:`multi_fused_wtw_state_from_jax`: the port's
    ``(live (B, n_cap_max, F), scalars (B, 16), host_paths)`` → the JAX
    engine's ``(live_win (B, l_pad, 128), scalars (B, 1, 16),
    host_paths)``, numpy, stream by stream over
    :func:`fused_wtw_state_to_jax`."""
    per = [fused_wtw_state_to_jax(live[b], scalars[b], host_paths[b], w=w, hop_frames=hop_frames, k_block=k_block)
           for b in range(live.shape[0])]
    return np.stack([p[0] for p in per]), np.stack([p[1] for p in per])[:, None], [p[2] for p in per]


def multi_async_wtw_state_from_jax(live_dev, px, py, sc):
    """A JAX ``MultiStreamWTW``'s state (numpy or JAX arrays: ``live_dev``
    (B, F, n_buf), ``px`` and ``py`` (B, p_cap), ``sc`` (B, 8) int32) →
    the port's ``BlockStepper`` state ``(live, px, py, sc)``, CPU tensors:
    live rows (B, n_buf + 1, F) and path buffers (B, p_cap + 1), each with
    the last row or column that takes dropped writes (zero)."""
    live_dev, px, py = np.asarray(live_dev), np.asarray(px, np.int32), np.asarray(py, np.int32)
    b, f, n_buf = live_dev.shape
    live = np.zeros((b, n_buf + 1, f), live_dev.dtype)
    live[:, :n_buf] = live_dev.transpose(0, 2, 1)
    pad = np.zeros((b, 1), np.int32)
    return (torch.from_numpy(live), torch.from_numpy(np.concatenate([px, pad], 1)),
            torch.from_numpy(np.concatenate([py, pad], 1)), torch.from_numpy(np.array(sc, np.int32)))


def multi_async_wtw_state_to_jax(live, px, py, sc):
    """The inverse of :func:`multi_async_wtw_state_from_jax`: the port's
    ``(live, px, py, sc)`` → JAX's ``(live_dev (B, F, n_buf), px, py (B,
    p_cap), sc (B, 8))``, numpy."""
    live = live.detach().cpu().numpy()
    return (np.ascontiguousarray(live[:, :-1].transpose(0, 2, 1)), px.detach().cpu().numpy()[:, :-1].copy(),
            py.detach().cpu().numpy()[:, :-1].copy(), sc.detach().cpu().numpy().astype(np.int32))


def async_wtw_state_from_jax(live_dev, px, py, sc):
    """One JAX ``AsyncWTW``'s state (``live_dev`` (F, N), ``px``, ``py``
    (p_cap,), ``sc`` int32[8]) → the port's ``BlockStepper`` state with
    B = 1, CPU tensors; an engine given it (``_stepper.set_state``, on its
    device) goes on to the JAX engine's path."""
    return multi_async_wtw_state_from_jax(np.asarray(live_dev)[None], np.asarray(px)[None], np.asarray(py)[None],
                                          np.asarray(sc)[None])


def async_wtw_state_to_jax(live, px, py, sc):
    """The port's B = 1 ``AsyncWTW`` state → one JAX engine's
    ``(live_dev, px, py, sc)``, numpy; the inverse of
    :func:`async_wtw_state_from_jax`."""
    return tuple(a[0] for a in multi_async_wtw_state_to_jax(live, px, py, sc))


# the online engine's fields in the JAX OnlineState's order (online_core.py:328-345)
_ONLINE_FIELDS = ("live", "acc", "t", "j", "direction", "previous", "run_count", "path", "path_len", "last_x",
                  "last_y", "first", "stopped", "overflow")
_ONLINE_FLAGS = ("first", "stopped", "overflow")


def multi_online_state_from_jax(fields):
    """A JAX ``MultiStreamFollower``'s ``states`` (its OnlineState, or the
    14 arrays in its field order, each with a leading stream axis B) → the
    port's :class:`~..models.online_core.OnlineState`, CPU tensors: the
    feature buffer and accumulator in their dtype, the flags bool, the
    pointers and path int64 (move it to the engine's device with
    ``OnlineState(*(x.to(device) for x in state))``)."""
    from real_time_audio_sync_tpu_torch.models.online_core import OnlineState

    out = []
    for name, a in zip(_ONLINE_FIELDS, fields):
        a = np.asarray(a)
        dtype = a.dtype if name in ("live", "acc") else (bool if name in _ONLINE_FLAGS else np.int64)
        out.append(torch.from_numpy(np.array(a, dtype=dtype)))
    return OnlineState(*out)


def multi_online_state_to_jax(state):
    """The port's batched online state → the JAX layout's 14 numpy arrays
    (leading stream axis B; pointers and path int32, flags bool), in the
    JAX OnlineState's field order: ``jax OnlineState(*arrays)`` rebuilds
    it."""
    out = []
    for name, x in zip(_ONLINE_FIELDS, state):
        a = x.detach().cpu().numpy()
        out.append(a if name in ("live", "acc") else a.astype(bool if name in _ONLINE_FLAGS else np.int32))
    return tuple(out)


def online_state_from_jax(fields):
    """One JAX engine's ``state`` (``BandedOnlineEngine.state``, or its 14
    arrays) → the port's OnlineState with B = 1, CPU tensors; a port engine
    given it (on its device) continues to the JAX engine's path."""
    return multi_online_state_from_jax([np.asarray(a)[None] for a in fields])


def online_state_to_jax(state):
    """The port's B = 1 online state → one JAX engine's 14 numpy arrays,
    the inverse of :func:`online_state_from_jax`."""
    return tuple(a[0] for a in multi_online_state_to_jax(state))
