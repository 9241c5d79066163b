"""Banded DP primitives of the online engines (the JAX package's
``ops/band.py:33-215``), on tensors with a leading stream axis B.

The reference's OTW/LiveNote engines evaluate DP cells one at a time in
Python: a width-``c`` row band per live frame (otw_eran.py:58-62), a
width-``c`` column band per reference advance (otw_eran.py:73-77), and band
argmins for the best point (otw_eran.py:192-211).  Here each band update is
a fixed-shape computation against the dense accumulated-cost matrix
``acc`` (B, M, N): the window's costs, the up/diagonal candidates, a
length-``c`` min-plus chain for the within-band left/up dependency, and a
write of the ``c`` window cells IN PLACE (a gather and a scatter of c
values a stream; the dense matrix is never copied).  One solo engine is
B = 1; ``parallel/serving.MultiStreamFollower`` runs B streams in the same
calls.

Every pointer argument is an int64 tensor of shape (B,).  No function
reads a device value on the host: a dynamic slice becomes an index tensor,
and predication is by masking.  The index tensors follow JAX's
``lax.dynamic_slice`` / ``dynamic_update_slice``: a start past the end
clamps (a live pointer past the buffer, a reference pointer at the stop),
and a negative start counts from the end (the previous row ``t − 1 = −1``
of the first insert reads the last row, the previous column ``j − 1 =
−1`` the last column).  The engines mask every such read out; the
functions agree with JAX's at those edges all the same.

Numerics, shared with the plain versions of the K-insert and set_live
kernels (``ops/otw_insert``, which run this module's cost and scan), so
that the engines compute the kernels' bits in float32: every cost is a
sequential sum over the feature index f, then ``1 − s`` (cosine) or a
correctly rounded ``sqrt(s)`` (Euclidean); the fast chain is a
Hillis–Steele scan in pallas_otw.py:87-108's stage order.
The JAX package reduces the dot with a matrix product and runs the fast
chain as a ``lax.associative_scan``, which reassociates the same sums in
another tree, so the two packages' cells differ by about an ulp (JAX
``band.py:54-62``).  ``exact=True`` is the reference's sequential
left-to-right chain in both.
"""

from __future__ import annotations

import functools

import torch

_INF = float("inf")


@functools.lru_cache(maxsize=64)
def _arange(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, device=device)


@functools.lru_cache(maxsize=64)
def _scalar(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=device)


def _cost_vector(query: torch.Tensor, bank: torch.Tensor, euclidean: bool) -> torch.Tensor:
    """Cost of each stream's feature column ``query`` (B, F) against the
    columns of its ``bank`` (B, F, K): (B, K).

    cosine (otw_eran.py:220, livenote.py:161): ``1 − q·bank``
    euclidean (livenote_v2.py:167-168): ``sqrt(Σ (bank − q)²)``

    The sum runs over f in order, as the K-insert and set_live kernels sum
    it (``otw_insert._cost`` is this function); a float32 root is taken in
    float64 and rounded, which is the correctly rounded float32 root on
    every device."""
    if euclidean:
        d = bank - query[:, :, None]
        terms = d * d
    else:
        terms = bank * query[:, :, None]
    return _finish_cost(terms, euclidean)


def _finish_cost(terms: torch.Tensor, euclidean: bool) -> torch.Tensor:
    """Sum the (B, F, ...) cost terms over f in order, then ``1 − s`` or the
    correctly rounded ``sqrt(s)``: the kernels' ``__fsqrt_rn``.  ATen's
    vectorised float32 sqrt on AVX-512 CPUs is not correctly rounded (about
    0.6 % of values land one ulp off), while a float64 sqrt rounded to
    float32 is."""
    parts = terms.unbind(1)
    s = parts[0]
    for part in parts[1:]:
        s = s + part
    if not euclidean:
        return 1.0 - s
    return torch.sqrt(s.double()).float() if s.dtype == torch.float32 else torch.sqrt(s)


def _shift_fill_inf(v: torch.Tensor) -> torch.Tensor:
    """v[..., k] ← v[..., k-1], +inf into slot 0 (masks the k=0 diagonal/up
    step)."""
    return torch.nn.functional.pad(v[..., :-1], (1, 0), value=_INF)


def _minplus_doubling(b: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """Hillis–Steele inclusive scan of ``r_k = min(b_k, r_{k-1} + c_k)``
    along the last axis, in pallas_otw.py:87-108's stage order.  The
    K-insert and set_live kernels' plain versions and the banded DTW scan
    run this one."""
    return _scan_in_place(b.clone(), cost)


def _scan_in_place(r: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """:func:`_minplus_doubling` on ``r``, each stage updating the tail of
    ``r`` in place."""
    n = r.shape[-1]
    csum = cost
    shift = 1
    while shift < n:
        tail = r[..., shift:]
        torch.minimum(tail, r[..., :-shift] + csum[..., shift:], out=tail)
        if 2 * shift < n:
            csum = torch.cat([csum[..., :shift], csum[..., :-shift] + csum[..., shift:]], dim=-1)
        shift *= 2
    return r


def _minplus_chain(b_win: torch.Tensor, c_win: torch.Tensor, r_init: torch.Tensor, exact: bool) -> torch.Tensor:
    """Band recurrence ``r_k = min(b_k, r_{k-1} + c_k)`` with ``r_{-1} =
    r_init``, over the last axis of (B, c) windows; ``r_init`` (B,).

    ``exact=False``: the boundary value folds into element 0, then the
    log-depth scan of :func:`_minplus_doubling`.  ``exact=True``: the
    reference's left-to-right evaluation order (JAX ``band.py:70-77``)."""
    if exact:
        r, out = r_init, []
        for k in range(b_win.shape[-1]):
            r = torch.minimum(b_win[:, k], r + c_win[:, k])
            out.append(r)
        return torch.stack(out, dim=1)
    first = torch.minimum(b_win[:, :1], r_init[:, None] + c_win[:, :1])
    return _scan_in_place(torch.cat([first, b_win[:, 1:]], dim=1), c_win)


def _band_update(acc, fixed, bank, ptr, pos, *, along_row: bool, c: int, sentinel: float, euclidean: bool,
                 exact: bool, enable):
    """One band of the recurrence, written in place: the cells ``(ptr,
    s..s+c-1)`` of a row (``along_row``) or ``(s..s+c-1, ptr)`` of a
    column, ``s = max(pos − c + 1, 0)``, with ``fixed`` the (B, F, ·)
    features on the fresh line's side and ``bank`` those along the band."""
    b_, m, n = acc.shape
    f = fixed.shape[1]
    lines, width = (m, n) if along_row else (n, m)
    dev = acc.device
    ar = _arange(c, dev)

    ptr_c = ptr.clamp(0, lines - 1)
    own = torch.gather(fixed, 2, ptr_c.view(b_, 1, 1).expand(b_, f, 1))[:, :, 0]
    s = (pos - (c - 1)).clamp(0, width - c)  # the slice start, clamped as dynamic_slice does
    idx = s[:, None] + ar  # (B, c) band positions
    cost = _cost_vector(own, torch.gather(bank, 2, idx[:, None, :].expand(b_, f, c)), euclidean)

    # the previous line at positions idx - 1 .. idx (diagonal, then up/left);
    # line -1 is the last, as a negative dynamic_slice start counts from the end
    prev_line = (ptr - 1).clamp(max=lines - 1).remainder(lines)
    ext = (s[:, None] - 1 + _arange(c + 1, dev)).clamp(min=0)
    flat = acc.view(b_, m * n)
    if along_row:
        g = torch.gather(flat, 1, (prev_line * n)[:, None] + ext)
        write = (ptr_c * n)[:, None] + idx
    else:
        g = torch.gather(flat, 1, ext * n + prev_line[:, None])
        write = idx * n + ptr_c[:, None]
    diag = torch.where(idx == 0, _INF, g[:, :-1])
    b = torch.minimum(g[:, 1:] + cost, diag + 2.0 * cost)

    # left (row) / up (column) neighbour of the band's first cell: the
    # uncomputed-cell sentinel when the band does not start at 0
    r_init = torch.where(pos >= c, _scalar(sentinel, acc.dtype, dev), _scalar(_INF, acc.dtype, dev))
    chain = _minplus_chain(b, cost, r_init, exact)

    mask = idx <= pos[:, None]
    if enable is not None:
        mask = mask & enable[:, None]
    flat.scatter_(1, write, torch.where(mask, chain, torch.gather(flat, 1, write)))


def row_update(acc, live, ref, t, j, *, c: int, sentinel: float, euclidean: bool, exact: bool = False, enable=None):
    """Evaluate row band ``(t, [max(0, j−c+1) .. j])`` (otw_eran.py:58-62)
    of every stream, in place; returns ``acc``.

    ``acc`` (B, M, N), ``live`` (B, F, M), ``ref`` (B, F, N); ``enable``
    (B,) bool or None.  Row ``t`` is fresh, so the left neighbour of the
    band's first cell is the uncomputed-cell sentinel, exactly as the
    reference reads it."""
    _band_update(acc, live, ref, t, j, along_row=True, c=c, sentinel=sentinel, euclidean=euclidean, exact=exact,
                 enable=enable)
    return acc


def col_update(acc, live, ref, t, j, *, c: int, sentinel: float, euclidean: bool, exact: bool = False, enable=None):
    """Evaluate column band ``([max(0, t−c+1) .. t], j)``
    (otw_eran.py:73-77) of every stream, in place; returns ``acc``.

    Column ``j`` is fresh; cells of column ``j−1`` are read whether or not
    they were ever evaluated — uncomputed ones hold the sentinel, as in the
    reference's dense matrices."""
    _band_update(acc, ref, live, j, t, along_row=False, c=c, sentinel=sentinel, euclidean=euclidean, exact=exact,
                 enable=enable)
    return acc


def eval_cell(acc, live, ref, x, y, *, euclidean: bool):
    """Single-cell DP evaluation at ``(x, y)`` of each stream
    (otw_eran.py:215-239), in place; returns ``acc``.

    Used by set_live's prologue, which evaluates cell ``(t, j)`` before the
    main loop — the origin cell on a fresh state, the current frontier cell
    after streaming inserts (livenote.py:105-108).  Edge neighbours are
    excluded from the min as the reference's ``if x > 0`` / ``if y > 0``
    guards do (the reads those guards discard are clamped to the matrix)."""
    b_, m, n = acc.shape
    f = live.shape[1]
    xc, yc = x.clamp(0, m - 1), y.clamp(0, n - 1)
    live_x = torch.gather(live, 2, xc.view(b_, 1, 1).expand(b_, f, 1))[:, :, 0]
    ref_y = torch.gather(ref, 2, yc.view(b_, 1, 1).expand(b_, f, 1))
    cost = _cost_vector(live_x, ref_y, euclidean)[:, 0]

    xm, ym = (x - 1).clamp(0, m - 1), (y - 1).clamp(0, n - 1)
    flat = acc.view(b_, m * n)
    left, up, diag = torch.gather(flat, 1, torch.stack([xc * n + ym, xm * n + yc, xm * n + ym], dim=1)).unbind(1)
    best = torch.minimum(
        torch.minimum(torch.where(y > 0, left + cost, _INF), torch.where(x > 0, up + cost, _INF)),
        torch.where((x > 0) & (y > 0), diag + 2.0 * cost, _INF),
    )
    new = torch.where((x == 0) & (y == 0), cost, best)
    flat.scatter_(1, (xc * n + yc)[:, None], new[:, None])
    return acc


def band_argmin(acc, t, j, *, c: int):
    """Best point of each stream over its row band ∪ column band
    (otw_eran.py:192-211): ``(x, y)``, (B,) each.

    First-min tie-breaking within each band matches ``np.argmin``; on a
    row/column tie the column result wins (the reference tests ``cost_j <
    cost_t`` strictly).  Band windows are clamped to width ``c`` at the
    matrix edge; the extra cells they cover hold the uncomputed-cell
    sentinel and never win."""
    b_, m, n = acc.shape
    ar = _arange(c, acc.device)
    sj = (j - (c - 1)).clamp(min=0)
    st = (t - (c - 1)).clamp(min=0)
    row = (t.clamp(0, m - 1) * n + sj.clamp(max=n - c))[:, None] + ar
    col = (st.clamp(max=m - c)[:, None] + ar) * n + j.clamp(0, n - 1)[:, None]
    wins = torch.gather(acc.view(b_, m * n), 1, torch.cat([row, col], dim=1)).view(b_, 2, c)
    costs, arg = wins.min(dim=2)  # first minimum of each window
    use_row = costs[:, 0] < costs[:, 1]
    return torch.where(use_row, t, st + arg[:, 1]), torch.where(use_row, sj + arg[:, 0], j)
