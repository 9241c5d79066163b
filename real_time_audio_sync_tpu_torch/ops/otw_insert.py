"""K streaming OTW inserts per launch on a band-relative window: the CUDA
kernel's wrapper, its plain PyTorch version, and the engine state layout.

Replaces the TPU kernel ``real_time_audio_sync_tpu/ops/pallas_otw.py``:
``_pallas_insert_block`` (:803) with its body ``_insert_block_body`` (:644)
and band primitives ``_build_ops`` (:125), ``_minplus_doubling`` (:87) and
``_first_min`` (:111).  The CUDA source is ``csrc/otw_insert.cu``.

What bounds it on an H100: latency, not bytes or FLOPs.  One stream is one
thread block running a serial chain of about ``K·loop_iters`` band steps,
each a (c+1)-wide cost + min-plus scan + argmin separated by block
barriers, over a few KB of state.  The design keeps the whole (c+1)² window
in shared memory for the launch (a ring offset replaces the TPU's physical
rolls, so a band step touches O(c) cells), keeps the scalar state machine
in registers (every thread computes it identically from the same reduced
values), and touches device memory only for the 12-float feature rows, the
path points and the launch's prologue/epilogue.

State at a launch boundary (:class:`OTWState`, all on one device) is
updated IN PLACE by each launch — this replaces the TPU kernel's
``input_output_aliases`` and its defensive self-copies
(pallas_otw.py:779-794).  The layout is canonical (window row a / column b
↔ acc[t-c+a, j-c+b]), so state converts to and from the JAX engine's
layout (``utils/convert.py``).

Numerics shared by the kernel and :func:`insert_block_reference`, so the
two agree bit for bit: every cost is a sequential float32 sum over the
feature index f (``s = s + x_f·y_f`` from ``s = 0``, no fused
multiply-add), then ``1 − s`` (cosine) or ``sqrt(s)`` (Euclidean, of
``window-side − fixed-row`` differences); the min-plus chain is a
Hillis–Steele scan in ``_minplus_doubling``'s stage order; argmins keep the
first minimum among valid cells.  Against the JAX kernel (which sums the
dot over 128 lanes in another order) costs differ by about an ulp.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from real_time_audio_sync_tpu_torch.models.online_core import BOTH, COL, PREV_NONE, ROW, OnlineConfig

# scalar-state slots (int32[16]), as pallas_otw.py:638-641
(S_T, S_J, S_RC, S_PREV, S_PLEN, S_LASTX, S_LASTY, S_FIRST,
 S_STOPPED, S_DIR, S_OVERFLOW) = range(11)
N_SCALARS = 16
N_STATUS = 8

#: launches of the CUDA kernel in this process (the plain version does not
#: count); a caller may reset it to 0 before the run it wants to inspect
launches = 0


@dataclasses.dataclass
class OTWState:
    """One stream's engine state; every tensor lies on the same device.

    - ``window`` (c+1, c+1) f32: ``window[a, b] = acc[t-c+a, j-c+b]``;
    - ``ref`` (c+N, F) f32: reference features, row ``c+j`` ↔ ref frame j
      (c leading zero rows, read by band cells left of frame 0);
    - ``live`` (c+cap, F) f32: live feature history, row ``c+t`` ↔ frame t;
    - ``path_x``/``path_y`` (cap+N+16,) int32: committed path points;
    - ``scalars`` int32[16]: slots ``S_*``;
    - ``status`` int32[8]: the last launch's
      ``[stopped | overflow<<1, plen, lastx, lasty, 0, 0, 0, 0]``.
    """

    window: torch.Tensor
    ref: torch.Tensor
    live: torch.Tensor
    path_x: torch.Tensor
    path_y: torch.Tensor
    scalars: torch.Tensor
    status: torch.Tensor


def new_state(ref: torch.Tensor, cfg: OnlineConfig, cap: int) -> OTWState:
    """Fresh state for reference features ``ref`` (F, N) with live capacity
    ``cap``, on ``ref``'s device (scalars as fused_streaming.py:129-135)."""
    f, n = ref.shape
    c = cfg.c
    dev = ref.device
    ref_rows = torch.zeros((c + n, f), dtype=torch.float32, device=dev)
    ref_rows[c:] = ref.T
    scalars = torch.zeros(N_SCALARS, dtype=torch.int32)
    scalars[S_RC] = cfg.run_count_init
    scalars[S_PREV] = PREV_NONE
    scalars[S_LASTX] = -1
    scalars[S_LASTY] = -1
    scalars[S_FIRST] = 1
    scalars[S_DIR] = BOTH
    p_len = cap + n + 16
    return OTWState(
        window=torch.full((c + 1, c + 1), cfg.sentinel, dtype=torch.float32, device=dev),
        ref=ref_rows,
        live=torch.zeros((c + cap, f), dtype=torch.float32, device=dev),
        path_x=torch.zeros(p_len, dtype=torch.int32, device=dev),
        path_y=torch.zeros(p_len, dtype=torch.int32, device=dev),
        scalars=scalars.to(dev),
        status=torch.zeros(N_STATUS, dtype=torch.int32, device=dev),
    )


def _check(state: OTWState, cols: torch.Tensor, lens: Tuple[int, int, int], cfg: OnlineConfig, k_block: int) -> None:
    c = cfg.c
    live_cap, ref_len, n_valid = (int(v) for v in lens)
    dev = cols.device
    f = state.ref.shape[1]
    want = {
        "window": (state.window, torch.float32, (c + 1, c + 1)),
        "ref": (state.ref, torch.float32, (c + ref_len, f)),
        "live": (state.live, torch.float32, (c + live_cap, f)),
        "path_x": (state.path_x, torch.int32, None),
        "path_y": (state.path_y, torch.int32, state.path_x.shape),
        "scalars": (state.scalars, torch.int32, (N_SCALARS,)),
        "status": (state.status, torch.int32, (N_STATUS,)),
        "cols": (cols, torch.float32, None),
    }
    for name, (x, dtype, shape) in want.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, cols on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if state.path_x.ndim != 1:
        raise ValueError("path buffers must be 1-D")
    if cols.ndim != 2 or cols.shape[1] != f:
        raise ValueError(f"cols must be (k, {f}), got {tuple(cols.shape)}")
    if not 0 <= n_valid <= cols.shape[0] <= k_block:
        raise ValueError(f"need 0 <= n_valid ({n_valid}) <= k ({cols.shape[0]}) <= k_block ({k_block})")
    if c < 1:
        raise ValueError(f"band c={c} must be >= 1")
    if ref_len < c:
        raise ValueError(f"reference length {ref_len} shorter than search band {c}")


def insert_block(state: OTWState, cols: torch.Tensor, lens: Tuple[int, int, int], cfg: OnlineConfig, k_block: int) -> None:
    """Run up to ``k_block`` streaming inserts — the rows of ``cols`` (k, F),
    the first ``n_valid`` of them — updating ``state`` in place.

    ``lens = (live_cap, ref_len, n_valid)``.  CUDA tensors launch the
    kernel (and count in :data:`launches`); CPU tensors run
    :func:`insert_block_reference`.  Nothing falls back: a failed build or
    launch raises."""
    global launches
    if cols.device.type == "cpu":
        insert_block_reference(state, cols, lens, cfg, k_block)
        return
    _check(state, cols, lens, cfg, k_block)
    if cols.device.type != "cuda":
        raise ValueError(f"no otw_insert kernel for device {cols.device}")
    c = cfg.c
    from real_time_audio_sync_tpu_torch.ops import _build

    lib = _build.load("otw_insert").lib
    live_cap, ref_len, n_valid = (int(v) for v in lens)
    with torch.cuda.device(cols.device):
        stream = torch.cuda.current_stream(cols.device).cuda_stream
        err = lib.otw_insert_block(
            state.window.data_ptr(), state.ref.data_ptr(), state.live.data_ptr(),
            state.path_x.data_ptr(), state.path_y.data_ptr(), state.scalars.data_ptr(),
            state.status.data_ptr(), cols.data_ptr(),
            c, state.ref.shape[1], state.path_x.shape[0], live_cap, ref_len, n_valid,
            cfg.sentinel, cfg.max_run_count, int(cfg.monotone_path),
            int(cfg.euclidean), cfg.loop_iters, stream,
        )
    if err != 0:
        # e.g. a band too wide for shared memory: the (c+1)² window must fit
        raise RuntimeError(f"otw_insert_block launch failed (c={c}): {lib.otw_error_string(err).decode()}")
    launches += 1


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------


def _cost(rows: torch.Tensor, fixed: torch.Tensor, euclidean: bool) -> torch.Tensor:
    """Cost of each of ``rows`` (m, F) against ``fixed`` (F,), summed
    sequentially over f as the kernel does."""
    if euclidean:
        d = rows - fixed
        terms = d * d
    else:
        terms = rows * fixed
    s = torch.zeros(rows.shape[0], dtype=torch.float32, device=rows.device)
    for f in range(rows.shape[1]):
        s = s + terms[:, f]
    return torch.sqrt(s) if euclidean else 1.0 - s


def _minplus_doubling(b: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """Hillis–Steele inclusive scan of ``r_k = min(b_k, r_{k-1} + c_k)``,
    in pallas_otw.py:87-108's stage order."""
    n = b.shape[0]
    r, csum = b, cost
    shift = 1
    while shift < n:
        r_sh = F.pad(r[:-shift], (shift, 0), value=float("inf"))
        c_sh = F.pad(csum[:-shift], (shift, 0))
        r = torch.minimum(r, r_sh + csum)
        csum = c_sh + csum
        shift *= 2
    return r


def _band_step(fresh_cost, prev_line, lo, neighbour_init, no_diag_at, sentinel):
    """One band of the recurrence over positions 0..c (lane or sublane):
    ``bvec = min(prev + cost, diag + 2·cost)`` with the diagonal masked at
    position 0 and at ``no_diag_at``, the band [lo, c], the first cell's
    left/up neighbour ``neighbour_init``, then the min-plus chain
    (pallas_otw.py:226-271).  Returns the new line."""
    inf = float("inf")
    idx = torch.arange(prev_line.shape[0], device=prev_line.device)
    diag = torch.cat([torch.full((1,), inf, dtype=torch.float32, device=prev_line.device), prev_line[:-1]])
    diag = torch.where(idx == no_diag_at, inf, diag)
    band = idx >= lo
    bvec = torch.minimum(prev_line + fresh_cost, diag + 2 * fresh_cost)
    b_m = torch.where(band, bvec, inf)
    c_m = torch.where(band, fresh_cost, inf)
    b_m[lo] = torch.minimum(b_m[lo], neighbour_init + c_m[lo])
    return torch.where(band, _minplus_doubling(b_m, c_m), sentinel)


def row_update(w, ref, live, t: int, j: int, cfg: OnlineConfig) -> None:
    """Advance the window ``w`` one live row (in place) and evaluate the row
    band at live frame t against ref frames j-c..j (pallas_otw.py:226-248);
    ``ref``/``live`` are the padded feature rows (row c+k ↔ frame k)."""
    c, sentinel = cfg.c, float(cfg.sentinel)
    w.copy_(torch.roll(w, -1, 0))  # W[a] ← W[a+1]
    cost = _cost(ref[j : j + c + 1], live[t + c], cfg.euclidean)  # lane b ↔ ref j-c+b
    w[c] = _band_step(cost, w[c - 1], max(c - j, 1), sentinel if j >= c else float("inf"), c - j, sentinel)


def col_update(w, ref, live, t: int, j: int, cfg: OnlineConfig) -> None:
    """Advance the window ``w`` one ref column (in place) and evaluate the
    column band at ref frame j against live frames t-c..t
    (pallas_otw.py:250-271)."""
    c, sentinel = cfg.c, float(cfg.sentinel)
    w.copy_(torch.roll(w, -1, 1))  # W[:, b] ← W[:, b+1]
    cost = _cost(live[t : t + c + 1], ref[j + c], cfg.euclidean)  # sublane a ↔ live t-c+a
    w[:, c] = _band_step(cost, w[:, c - 1], max(c - t, 1), sentinel if t >= c else float("inf"), c - t, sentinel)


def best_point(w, t: int, j: int, c: int) -> Tuple[int, int]:
    """First minimum of window row c over the band and of window column c
    over the band; the row's wins only when strictly smaller
    (pallas_otw.py:196-212)."""
    b0, a0 = max(c - j, 1), max(c - t, 1)
    row, col = w[c, b0:], w[a0:, c]
    bj, ak = torch.argmin(row), torch.argmin(col)  # first minimum
    cost_j, cost_t, bj, ak = torch.stack([row[bj], col[ak], bj.float(), ak.float()]).tolist()
    if cost_j < cost_t:
        return t, j - c + b0 + int(bj)
    return t - c + a0 + int(ak), j


def append_point(path_x, path_y, x: int, y: int, plen: int, lastx: int, lasty: int,
                 cfg: OnlineConfig) -> Tuple[int, int, int]:
    """Commit (x, y) at slot ``plen`` unless LiveNoteV2's monotone guard
    rejects it (pallas_otw.py:181-194); a point past the buffer is counted
    but not stored.  Returns ``(plen, lastx, lasty)``."""
    if cfg.monotone_path and plen > 0 and not (x > lastx and y >= lasty):
        return plen, lastx, lasty
    if plen < path_x.shape[0]:
        path_x[plen] = x
        path_y[plen] = y
    return plen + 1, x, y


def set_direction(x: int, y: int, t: int, j: int, rc: int, prev: int, cfg: OnlineConfig) -> Tuple[int, int, int]:
    """The next direction after best point (x, y) at (t, j) — startup, forced
    or free — with the updated run count and previous direction
    (pallas_otw.py:214-224): ``(d, rc, prev)``."""
    if t < cfg.c:
        d = BOTH
    elif rc >= cfg.max_run_count:
        d = COL if prev == ROW else ROW
    else:
        d = COL if x < t else (ROW if y < j else BOTH)
    return d, (rc + 1 if d == prev else 1), (d if d != BOTH else prev)


def insert_block_reference(state: OTWState, cols: torch.Tensor, lens: Tuple[int, int, int], cfg: OnlineConfig, k_block: int) -> None:
    """Plain PyTorch version of the kernel, on any device: the same window
    algorithm on tensors, with the scalar state machine of
    ``_insert_block_body`` (pallas_otw.py:644-746) in Python integers —
    the first-insert origin, the "ran out of room" freeze at
    ``t >= live_cap``, the bounded column phase with the sticky overflow
    flag, and stop-and-freeze once ``j`` passes the reference."""
    _check(state, cols, lens, cfg, k_block)
    live_cap, ref_len, n_valid = (int(v) for v in lens)
    c = cfg.c
    w, ref, live = state.window, state.ref, state.live
    sentinel = float(cfg.sentinel)
    sc = state.scalars.tolist()
    t, j, rc, prev, plen, lastx, lasty = (sc[s] for s in (S_T, S_J, S_RC, S_PREV, S_PLEN, S_LASTX, S_LASTY))
    first, stopped, direction, overflow = bool(sc[S_FIRST]), bool(sc[S_STOPPED]), sc[S_DIR], bool(sc[S_OVERFLOW])

    for k in range(n_valid):
        if stopped:
            break
        t_new, do_row = t, False
        if first:
            live[c] = cols[k]
            w[c] = sentinel
            w[c, c] = _cost(live[c : c + 1], ref[c], cfg.euclidean)[0]
            first = False
        else:
            t_new = t + 1
            do_row = t_new < live_cap
            if do_row:
                live[t_new + c] = cols[k]
                row_update(w, ref, live, t_new, j, cfg)
        active, d = do_row, direction
        for _ in range(cfg.loop_iters):
            if not active:
                break
            if d != ROW:
                j += 1
                if j >= ref_len:
                    stopped, active = True, False
                    break
                col_update(w, ref, live, t_new, j, cfg)
            x, y = best_point(w, t_new, j, c)
            plen, lastx, lasty = append_point(state.path_x, state.path_y, x, y, plen, lastx, lasty, cfg)
            d, rc, prev = set_direction(x, y, t_new, j, rc, prev, cfg)
            active = d == COL
        direction = d
        overflow = overflow or active
        t = t_new

    sc[S_T], sc[S_J], sc[S_RC], sc[S_PREV] = t, j, rc, prev
    sc[S_PLEN], sc[S_LASTX], sc[S_LASTY] = plen, lastx, lasty
    sc[S_FIRST], sc[S_STOPPED], sc[S_DIR], sc[S_OVERFLOW] = int(first), int(stopped), direction, int(overflow)
    state.scalars.copy_(torch.tensor(sc, dtype=torch.int32))
    state.status.copy_(torch.tensor([int(stopped) | (int(overflow) << 1), plen, lastx, lasty, 0, 0, 0, 0], dtype=torch.int32))
