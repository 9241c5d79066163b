"""Banded offline DTW — hour-scale full-pair alignment in O(M·band) memory
(the JAX package's ``ops/banded_dtw.py:44-210``, on tensors).

The dense wavefront (``ops/wavefront.py``) materialises O(M·N) ``acc`` and
``back`` matrices; this module restricts the DP to a band of ``band``
reference frames around the resampled main diagonal:

- row ``i`` keeps ``acc[i, off(i) : off(i)+W]`` with
  ``off(i) = clip(i·(N−1)//(M−1) − W/2, 0, N−W)``, a (W,) vector carried
  from row to row; advancing a row shifts the window by
  ``off(i) − off(i−1)``.  The offsets are a formula of the shape, so they
  are Python integers and a row's work is queued without a host sync;
- the within-row left dependency is the min-plus chain, here the
  Hillis–Steele scan of ``ops/otw_insert._minplus_doubling`` where the JAX
  package runs ``lax.associative_scan``.  The two reassociate the cost
  sums differently, so ``final_cost`` differs from JAX's by a few ulps;
- back codes are recomputed from the final row values in the reference's
  first-min order (left, up, diag — DTW_SPEC), so the backtrack follows the
  reference's tie-breaking;
- cells outside the band read ``+inf``: the result is the exact dense DTW
  whenever the optimal path stays inside the band, which the backtrack
  reports (``edge_touched``) and ``models/dtw.dtw_auto`` enforces by
  widening.

No TPU kernel runs here in the JAX package (a ``lax.scan`` and an
associative scan), so this is tensor code on the features' device, and the
backtrack a host loop over the (M, W) int8 codes.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def _as_features(x, device, dtype=None) -> torch.Tensor:
    """(F, T) features — a numpy array or a tensor — as a tensor on
    ``device``; ``dtype`` (numpy or torch) casts."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if dtype is not None and not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    return x.to(device=device, dtype=dtype)


def _banded_dp(seq_a: torch.Tensor, seq_b: torch.Tensor, band: int) -> Tuple[torch.Tensor, List[int], torch.Tensor]:
    """Returns ``(last_row (W,), offs [M] ints, codes (M, W) int8)``;
    codes 0=left, 1=up, 2=diag (DTW_SPEC; corner code 2)."""
    # imported here: ops.otw_insert imports the models package, whose
    # __init__ imports this module (through models.dtw)
    from real_time_audio_sync_tpu_torch.ops.otw_insert import _minplus_doubling

    f, m = seq_a.shape
    n = seq_b.shape[1]
    w = band
    dtype, dev = seq_a.dtype, seq_a.device
    inf = float("inf")
    denom = max(m - 1, 1)
    dmax = -(-(n - 1) // denom) + 1  # largest per-row window shift, + 1
    offs = [min(max(i * (n - 1) // denom - w // 2, 0), max(n - w, 0)) for i in range(m)]
    pad_lo = torch.full((1,), inf, dtype=dtype, device=dev)
    pad_hi = torch.full((dmax,), inf, dtype=dtype, device=dev)
    codes = torch.empty((m, w), dtype=torch.int8, device=dev)
    prev, prev_off = torch.full((w,), inf, dtype=dtype, device=dev), 0
    for i in range(m):
        off = offs[i]
        delta = off - prev_off
        cost = 1.0 - seq_a[:, i] @ seq_b[:, off : off + w]  # (W,) cosine cost
        prev_pad = torch.cat([pad_lo, prev, pad_hi])
        up = prev_pad[delta + 1 : delta + 1 + w]  # prev[b + delta]
        diag = prev_pad[delta : delta + w]  # prev[b + delta - 1]
        bvec = torch.minimum(up + cost, diag + 2.0 * cost)
        corner = i == 0 and off == 0
        if corner:  # acc[0, 0] = cost folds in before the chain
            bvec[0] = cost[0]
        r = _minplus_doubling(bvec, cost)
        left_cand = torch.cat([pad_lo, r[:-1] + cost[1:]])  # the band's first cell has no left
        up_cand = up + cost
        diag_cand = diag + 2.0 * cost
        best = torch.minimum(torch.minimum(left_cand, up_cand), diag_cand)
        code = torch.where(left_cand == best, 0, torch.where(up_cand == best, 1, 2))
        if corner:
            code[0] = 2
        codes[i] = code.to(torch.int8)
        prev, prev_off = r, off
    return prev, offs, codes


def _banded_backtrack(codes: torch.Tensor, offs: List[int], n: int):
    """Trace the path from (M−1, N−1) through the band-relative codes.

    Same output contract as ``ops/wavefront.backtrack`` — ``(points
    (M+N−1, 2) int32 end → origin with frozen repeats, length)`` — plus
    ``edge_touched``: True when a visited cell sat on a band edge interior
    to the matrix, where the band may have constrained the path.
    Coordinates are clamped at 0, so a band too narrow yields a
    terminating (degraded) path instead of negative coordinates."""
    m, w = codes.shape
    host = codes.cpu().numpy()
    max_len = m + n - 1
    points = np.empty((max_len, 2), np.int32)
    i, j, done, edge, length = m - 1, n - 1, False, False, 0
    for s in range(max_len):
        if done:  # frozen repeats
            points[s:] = (i, j)
            break
        b_raw = j - offs[i]
        b = min(max(b_raw, 0), w - 1)
        edge = edge or (b_raw <= 0 and offs[i] > 0) or (b_raw >= w - 1 and offs[i] + w < n)
        points[s] = (i, j)
        length += 1
        done = i == 0 and j == 0
        if not done:
            code = int(host[i, b])
            i = max(i - (code != 0), 0)  # left keeps i
            j = max(j - (code != 1), 0)  # up keeps j
    return points, length, edge


def _validate_path(path: np.ndarray, m: int, n: int) -> None:
    """Monotone steps in {(1,0),(0,1),(1,1)}, origin → corner; otherwise
    the band was too narrow for even a degraded path — raise."""
    ok = len(path) >= 1 and tuple(path[0]) == (0, 0) and tuple(path[-1]) == (m - 1, n - 1)
    if ok and len(path) > 1:
        d = np.diff(path, axis=0)
        ok = bool(np.all((d >= 0) & (d <= 1)) and np.all(d.sum(axis=1) >= 1))
    if not ok:
        raise ValueError(
            "banded DTW backtrack produced an invalid path — the band is too "
            "narrow for this pair; widen `band` (or use dtw_auto, which "
            "widens and retries automatically)")


def dtw_banded(seq_a, seq_b, band: int = 512, *, return_edge_touch: bool = False, device="cuda"):
    """Banded offline DTW of (F, M) and (F, N) features (numpy or tensors)
    on ``device``: ``(path (L, 2) origin → end, final_cost)``, and with
    ``return_edge_touch=True`` a third value, True when the path touched a
    band edge interior to the matrix (the widen-and-retry signal of
    ``dtw_auto``).

    ``path`` equals the dense DTW path whenever the optimal path stays
    within ``band`` reference frames of the resampled diagonal;
    ``final_cost`` is ``acc[M−1, N−1]``.  The path is always validated
    monotone origin → corner; a band too narrow for that raises
    ValueError."""
    seq_a = _as_features(seq_a, device)
    seq_b = _as_features(seq_b, device).to(seq_a.dtype)
    m, n = seq_a.shape[1], seq_b.shape[1]
    w = min(int(band), n)
    if w < 1:
        raise ValueError("empty reference")
    last_row, offs, codes = _banded_dp(seq_a, seq_b, w)
    points, length, edge = _banded_backtrack(codes, offs, n)
    final = float(last_row[n - 1 - offs[m - 1]])
    path = points[:length][::-1]
    _validate_path(path, m, n)
    if return_edge_touch:
        return path, final, edge
    return path, final
