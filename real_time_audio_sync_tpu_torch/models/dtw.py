"""Offline full-sequence DTW (reference dtw.py:5-53; the JAX package's
``models/dtw.py:23-186``).

``DTW(seq_a, seq_b) -> (cost, acc_cost, path)`` on (F, M)/(F, N) feature
matrices: cosine cost ``1 − AᵀB`` (one ``torch.matmul``, float32 exact
with TF32 off — ``numerics.py``), the 3-step recurrence with the diagonal
weighted 2×, first-min tie-breaking (left, up, diag), backtracking from
(M−1, N−1).  On the card the DP and the backtrack are the hand-written
kernels of ``ops/wavefront.py``; pairs whose dense matrices exceed the
byte budget go to the banded engine (``ops/banded_dtw.py``) exactly as in
the JAX package.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from real_time_audio_sync_tpu_torch.ops.banded_dtw import _as_features, dtw_banded
from real_time_audio_sync_tpu_torch.ops.wavefront import (
    DTW_SPEC,
    backtrack,
    backtrack_reference,
    wavefront_dp,
    wavefront_dp_reference,
)

# Dense-path device footprint per DP cell: cost + acc (float32) + back
# (int8), plus working set — the JAX package's budget, kept so that the
# same pairs take the same route.
_DENSE_BYTES_PER_CELL = 13
# Default delegation threshold: beyond it the public surface routes to the
# banded engine.  Override per call (max_dense_bytes=) or process-wide with
# RTAS_DTW_DENSE_LIMIT_BYTES.
_DENSE_LIMIT_DEFAULT = 2 << 30  # 2 GiB


def _cosine_cost(seq_a: torch.Tensor, seq_b: torch.Tensor) -> torch.Tensor:
    return 1.0 - torch.matmul(seq_a.T, seq_b)


def _dp_functions(backend: str, device: torch.device):
    """The (DP, backtrack) pair ``backend`` selects: ``"auto"`` the
    device-dispatching wrappers (kernels on a CUDA tensor, plain versions
    on a CPU one), ``"scan"`` the plain versions, ``"pallas"`` the kernels,
    which need a CUDA device."""
    if backend not in ("auto", "scan", "pallas"):
        raise ValueError(f"unknown backend {backend!r}; choose 'auto', 'scan' or 'pallas'")
    if backend == "scan":
        return wavefront_dp_reference, backtrack_reference
    if backend == "pallas" and device.type != "cuda":
        raise ValueError(
            f"backend='pallas' unsupported on this platform ({device.type}): the "
            f"hand-written kernels need a CUDA device; use backend='scan' or 'auto'")
    return wavefront_dp, backtrack


def dtw_device(seq_a, seq_b, backend: str = "auto", device="cuda"):
    """Device-resident DTW: ``(cost, acc, path_points, path_len)`` as
    tensors on ``device``; ``path_points`` is reversed (end → origin) and
    padded (``ops/wavefront.backtrack``'s contract)."""
    device = torch.device(device)
    dp, bt = _dp_functions(backend, device)
    cost = _cosine_cost(_as_features(seq_a, device), _as_features(seq_b, device))
    acc, back = dp(cost, DTW_SPEC)
    points, length = bt(back, DTW_SPEC)
    return cost, acc, points, length


def _dense_limit_bytes(max_dense_bytes=None) -> int:
    if max_dense_bytes is not None:
        return int(max_dense_bytes)
    env = os.environ.get("RTAS_DTW_DENSE_LIMIT_BYTES")
    if env:
        try:
            return int(env)
        except ValueError:
            warnings.warn(f"ignoring malformed RTAS_DTW_DENSE_LIMIT_BYTES={env!r}")
    return _DENSE_LIMIT_DEFAULT


def _round_up_128(x: int) -> int:
    return -(-int(x) // 128) * 128


def _initial_band(m: int, n: int) -> int:
    """Band width from the pair's length ratio: similar-length pairs start
    at 512; a pair whose lengths differ by ratio ρ opens the band
    proportionally."""
    ratio = max(m, n) / max(min(m, n), 1)
    return min(n, max(512, _round_up_128(n * (ratio - 1.0) * 0.25)))


def dtw_auto(seq_a, seq_b, band: int | None = None, max_widenings: int = 6, device="cuda"):
    """Banded DTW with exactness by retry: run at ``band`` (default from
    the length ratio) and, while the path touches a band edge interior to
    the matrix, double the band, up to the full width.  Returns
    ``(path, final_cost, band_used)``."""
    seq_a = _as_features(seq_a, device)
    seq_b = _as_features(seq_b, device)
    m, n = seq_a.shape[1], seq_b.shape[1]
    w = min(n, int(band) if band is not None else _initial_band(m, n))
    for _ in range(max_widenings + 1):
        path, final, edge = dtw_banded(seq_a, seq_b, band=w, return_edge_touch=True, device=device)
        if not edge or w >= n:
            return path, final, w
        w = min(n, w * 2)
    raise ValueError(
        f"banded DTW path still touches the band edge at band={w} after "
        f"{max_widenings} widenings; pass an explicit larger `band`")


def DTW(seq_a, seq_b, dtype=None, backend: str = "auto", max_dense_bytes=None, device="cuda"):
    """Reference-parity offline DTW on ``device``.

    Takes (F, M) and (F, N) numpy arrays or tensors and returns numpy
    ``(cost, acc_cost, path)``, ``path`` ordered origin → end as
    dtw.py:42-52 builds it.  When the dense matrices would exceed
    ``max_dense_bytes`` (default 2 GiB; env RTAS_DTW_DENSE_LIMIT_BYTES) the
    call goes to :func:`dtw_auto` and returns ``(None, None, path)`` with a
    warning."""
    device = torch.device(device)
    seq_a = _as_features(seq_a, device, dtype)
    seq_b = _as_features(seq_b, device, dtype)
    m, n = seq_a.shape[1], seq_b.shape[1]
    if m * n * _DENSE_BYTES_PER_CELL > _dense_limit_bytes(max_dense_bytes):
        warnings.warn(
            f"DTW({m}x{n}): dense matrices exceed the "
            f"{_dense_limit_bytes(max_dense_bytes)}-byte budget; delegating "
            "to the banded engine (cost/acc returned as None, path exact via "
            "widen-and-retry)")
        path, _, _ = dtw_auto(seq_a, seq_b, device=device)
        return None, None, path
    cost, acc, points, length = dtw_device(seq_a, seq_b, backend, device)
    path = points[: int(length)].flip(0).cpu().numpy()
    return cost.cpu().numpy(), acc.cpu().numpy(), path
