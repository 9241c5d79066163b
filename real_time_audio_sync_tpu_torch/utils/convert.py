"""Carry fused-engine state between the JAX package and the port.

The system has no weights: its parameters are the chroma filterbank
(copied bit-identically) and the streaming engine state.  The JAX fused
engine keeps that state in TPU layouts — a (8,128)-tiled window, the live
history transposed onto 128 lanes, 128-rounded path buffers — and the port
keeps the canonical layout of :class:`~..ops.otw_insert.OTWState`.  Both
functions take and return the state tuple in the engine's order
``(window, live, path_x, path_y, scalars)``; the reference features are
not state (each engine builds them from the same chroma).
"""

from __future__ import annotations

import numpy as np
import torch

_LANES, _SUBLANES = 128, 8


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
