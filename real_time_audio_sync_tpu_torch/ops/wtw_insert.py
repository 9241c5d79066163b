"""K hop columns of streaming WTW per launch, for one stream or a grid of B:
the CUDA kernel's wrappers, their plain PyTorch versions, the window cost,
and the engine state layouts.

Replaces the TPU kernel ``real_time_audio_sync_tpu/ops/pallas_wtw.py``
``_pallas_wtw_insert_block`` (:360; kernel ``_make_wtw_kernel`` :122,
geometry ``wtw_geometry`` :94) with the hand-written CUDA kernel
``csrc/wtw_insert.cu``.  A launch appends up to ``k_block`` chroma columns
to the live history and runs every window that falls due (at most one a
column): the w×w cosine cost with norm division, the 2w−1-diagonal DP under
``WTW_SPEC``, the backtrack, the commit of the points whose live coordinate
is at most ``hop_frames`` into the launch's ``[status | dx | dy]`` row, and
the pointer advance.  The per-column order is ``models/wtw_async.py``
``body_cols`` (:167-214): append if ``chroma_ptr < n_cap``; the capacity
stop comes before the increment; the margin stop is
``ref_ptr >= m-1-w or live_ptr >= n_cap-1-w``; a window is due when
``chroma_ptr - live_ptr >= w``; stopped streams and columns past
``n_valid`` are no-ops.

TPU kernel #10, ``_pallas_multi_wtw_insert_block`` (:408), is the same
kernel over a grid of B thread blocks (:func:`multi_wtw_insert_block`):
block b is stream b, on its own reference length, live capacity and
column count from a device (B, 3) array, the reference shared (stored
once) or stacked (:class:`MultiWTWState`).

Layout: the reference (M, F) and the whole live history (2M, F) stay in
device memory as rows; the TPU kernel's sliding live window, its realign
and its reference DMA window only fit VMEM and have no counterpart here,
so scalar slot 5 (the TPU's window base) is left alone.  The delta row has
JAX's layout (``d_pad = n_w·(2w−1) + 8`` slots, ``n_w = 1 + ⌈k_block /
hop_frames⌉``), so the drain and the state converters keep JAX's rows.

What bounds it on an H100: latency.  Each due window is a chain of at
least 2w−1 dependent cells and a serial pointer chase of up to 2w−1 steps;
a launch moves a few KB.  The kernel is one block of ⌈w/32⌉ warps per
stream: the scalars and columns staged once a launch, each window's cost
fused into a systolic DP (one row a lane, warps handing their bottom rows
down in shared memory, no block barrier in the sweep), only the back steps
kept (w² bytes), and one lane chasing them to the origin
(:func:`plan` reports a launch's geometry; the design is in the source's
header).  The kernel takes 12 features a frame (chroma); a CUDA launch of
another width raises.

Numerics shared by the kernel and :func:`wtw_insert_block_reference`, so
the two agree bit for bit: :func:`window_cost` (a sequential 12-term sum of
rounded products for each dot and squared norm, the norm a correctly
rounded square root, then ``1 − dot / (nx·ny)``), and each DP cell as
``ops/wavefront``'s.  The JAX kernel sums its dots over 128 lanes in the
matrix unit's order, so its costs can differ in the last ulp.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from real_time_audio_sync_tpu_torch.ops.otw_insert import _require
from real_time_audio_sync_tpu_torch.ops.wavefront import (
    WTW_SPEC,
    _KIND,
    _step_table,
    backtrack_reference,
    wavefront_dp_reference,
)

# scalar-state slots (int32[16]), as pallas_wtw.py:89-90: columns appended,
# live and ref window origins (frames), committed path length, flags (bit 0
# stopped, bit 1 overflow), the JAX kernel's live-window base (the port's
# kernel leaves it alone) and the last committed point
(WS_CHROMA, WS_LIVE, WS_REF, WS_PLEN, WS_FLAGS, WS_BASE, WS_LASTX, WS_LASTY) = range(8)
N_SCALARS = 16
N_STATUS = 8
#: the widest window the kernel takes (one lane per DP row, four warps)
MAX_W = 128
#: the features a frame the kernel takes
FEATURES = 12

#: launches of the CUDA kernel in this process (the plain version does not
#: count); a caller may reset it to 0 before the run it wants to inspect
launches = 0


def wtw_geometry(w: int, hop_frames: int, k_block: int) -> Tuple[int, int, int]:
    """``(n_w, maxpts, d_pad)``: at most ``n_w = 1 + ⌈k_block/hop_frames⌉``
    windows a launch (one window advances live_ptr by exactly hop_frames,
    wtw_async.py:15-23), at most ``maxpts = 2w − 1`` points a window, and
    ``d_pad = n_w·maxpts + 8`` point slots a row (pallas_wtw.py:94-119)."""
    n_w = 1 + -(-k_block // hop_frames)
    maxpts = 2 * w - 1
    return n_w, maxpts, n_w * maxpts + 8


def delta_width(w: int, hop_frames: int, k_block: int) -> int:
    """Int32 slots of one launch's row ``[status | dx | dy]``."""
    return N_STATUS + 2 * wtw_geometry(w, hop_frames, k_block)[2]


def delta_views(row: torch.Tensor):
    """(status, dx, dy) views of one row ``[status | dx | dy]``."""
    d_pad = (row.shape[-1] - N_STATUS) // 2
    return row[..., :N_STATUS], row[..., N_STATUS : N_STATUS + d_pad], row[..., N_STATUS + d_pad :]


@dataclasses.dataclass
class WTWState:
    """One stream's state at a launch boundary, every tensor on one device,
    updated in place by each launch:

    - ``ref`` (M, F) f32: reference chroma, row j ↔ frame j;
    - ``live`` (n_cap, F) f32: live chroma history, row t ↔ frame t
      (rows at or past ``chroma_ptr`` are unspecified);
    - ``scalars`` int32[16]: slots ``WS_*``."""

    ref: torch.Tensor
    live: torch.Tensor
    scalars: torch.Tensor


def new_state(ref: torch.Tensor, n_cap: int) -> WTWState:
    """A fresh stream on reference chroma ``ref`` (F, M), on its device;
    every scalar starts at 0, as ``FusedWTW``'s (fused_wtw.py:152)."""
    f = ref.shape[0]
    dev = ref.device
    return WTWState(
        ref=ref.T.to(torch.float32).contiguous(),
        live=torch.zeros((n_cap, f), dtype=torch.float32, device=dev),
        scalars=torch.zeros(N_SCALARS, dtype=torch.int32, device=dev),
    )


def _sqrt_rn(s: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as ``__fsqrt_rn``: ATen's
    vectorised float32 sqrt on AVX-512 CPUs is not, while a float64 root
    rounded to the input's type is."""
    return torch.sqrt(s.double()).to(s.dtype)


def window_cost(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(w_x, w_y) cosine cost with norm division between live rows ``x``
    (w_x, F) and reference rows ``y`` (w_y, F) (wtw.py:162-171):
    ``1 − dot / (nx·ny)``, each dot and squared norm a sequential sum over
    f of rounded products — the kernel's order.  Leading batch axes of
    ``x`` and ``y`` broadcast, each window with the same operations.  Zero
    columns give the reference's non-finite values."""
    dot = torch.zeros((*x.shape[:-1], y.shape[-2]), dtype=x.dtype, device=x.device)
    sx = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    sy = torch.zeros(y.shape[:-1], dtype=y.dtype, device=y.device)
    for f in range(x.shape[-1]):
        dot = dot + x[..., :, f, None] * y[..., None, :, f]
        sx = sx + x[..., f] * x[..., f]
        sy = sy + y[..., f] * y[..., f]
    return 1.0 - dot / (_sqrt_rn(sx)[..., :, None] * _sqrt_rn(sy)[..., None, :])


def _check(state: WTWState, cols: torch.Tensor, lens, w: int, hop_frames: int, k_block: int,
           row: torch.Tensor) -> None:
    m, n_cap, n_valid = (int(v) for v in lens)
    dev = cols.device
    f = state.ref.shape[1]
    _require({
        "ref": (state.ref, torch.float32, None),
        "live": (state.live, torch.float32, None),
        "scalars": (state.scalars, torch.int32, (N_SCALARS,)),
        "cols": (cols, torch.float32, None),
        "row": (row, torch.int32, (delta_width(w, hop_frames, k_block),)),
    }, dev)
    if not 1 <= w <= MAX_W:
        raise ValueError(f"window of {w} frames: the kernel takes 1..{MAX_W}")
    if hop_frames < 1:
        raise ValueError(f"hop_frames {hop_frames} must be >= 1")
    for name, x, rows in (("ref", state.ref, m), ("live", state.live, n_cap)):
        if x.ndim != 2 or x.shape[0] < rows or x.shape[1] != f:
            raise ValueError(f"{name} must have at least {rows} rows of {f}, got {tuple(x.shape)}")
    if cols.ndim != 2 or cols.shape[1] != f:
        raise ValueError(f"cols must be (k, {f}), got {tuple(cols.shape)}")
    if not 0 <= n_valid <= cols.shape[0] <= k_block:
        raise ValueError(f"need 0 <= n_valid ({n_valid}) <= k ({cols.shape[0]}) <= k_block ({k_block})")


def _check_kernel(cols: torch.Tensor, f: int) -> None:
    if cols.device.type != "cuda":
        raise ValueError(f"no wtw_insert kernel for device {cols.device}")
    if f != FEATURES:
        raise ValueError(f"the wtw_insert kernel takes {FEATURES} features a frame, got {f}")


def plan(w: int, f: int = FEATURES) -> Tuple[int, int, int, int]:
    """``(warps a block, threads a block, dynamic shared bytes, blocks an
    SM)`` of a launch at window ``w`` on the current CUDA device (the
    library's ``wtw_insert_plan``; builds the kernel)."""
    import ctypes

    from real_time_audio_sync_tpu_torch.ops import _build

    out = (ctypes.c_int * 4)()
    lib = _build.load("wtw_insert").lib
    err = lib.wtw_insert_plan(w, f, out)
    if err != 0:
        raise RuntimeError(f"wtw_insert_plan(w={w}, f={f}) failed: {lib.wtw_error_string(err).decode()}")
    return tuple(out)


def wtw_insert_block(state: WTWState, cols: torch.Tensor, lens, w: int, hop_frames: int, k_block: int,
                     row: torch.Tensor) -> None:
    """Append the first ``n_valid`` rows of ``cols`` (k ≤ k_block, F) and run
    every window that falls due, updating ``state`` in place and writing
    this launch's ``[status | dx | dy]`` into ``row`` (int32,
    :func:`delta_width` slots; unused slots read 0).  ``lens = (m, n_cap,
    n_valid)``: reference frames, live capacity, columns to take.

    CUDA tensors launch the kernel (counted in :data:`launches`); CPU
    tensors run :func:`wtw_insert_block_reference`.  Nothing falls back: a
    failed build or launch raises."""
    global launches
    if cols.device.type == "cpu":
        wtw_insert_block_reference(state, cols, lens, w, hop_frames, k_block, row)
        return
    _check(state, cols, lens, w, hop_frames, k_block, row)
    _check_kernel(cols, state.ref.shape[1])
    from real_time_audio_sync_tpu_torch.ops import _build

    lib = _build.load("wtw_insert").lib
    m, n_cap, n_valid = (int(v) for v in lens)
    spec = WTW_SPEC
    table = _step_table(spec)
    with torch.cuda.device(cols.device):
        stream = torch.cuda.current_stream(cols.device).cuda_stream
        err = lib.wtw_insert_block(
            state.ref.data_ptr(), state.live.data_ptr(), state.scalars.data_ptr(), row.data_ptr(),
            cols.data_ptr(), m, n_cap, n_valid, w, hop_frames, state.ref.shape[1],
            wtw_geometry(w, hop_frames, k_block)[2],
            *(_KIND[s] for s in spec.steps), *(float(x) for x in spec.weights), *spec.codes, spec.corner_code,
            *(di for di, _ in table), *(dj for _, dj in table), stream,
        )
    if err != 0:
        raise RuntimeError(f"wtw_insert_block launch failed (w={w}): {lib.wtw_error_string(err).decode()}")
    launches += 1


def wtw_insert_block_reference(state: WTWState, cols: torch.Tensor, lens, w: int, hop_frames: int, k_block: int,
                               row: torch.Tensor) -> None:
    """Plain PyTorch version of :func:`wtw_insert_block` on any device: the
    column loop in Python on host scalars, each due window through
    :func:`window_cost`, ``ops/wavefront``'s plain DP and backtrack under
    ``WTW_SPEC``, and the commit in Python."""
    _check(state, cols, lens, w, hop_frames, k_block, row)
    m, n_cap, n_valid = (int(v) for v in lens)
    d_pad = wtw_geometry(w, hop_frames, k_block)[2]
    sc = [int(v) for v in state.scalars.cpu()]
    cp, lp, rp, plen, fl = sc[WS_CHROMA], sc[WS_LIVE], sc[WS_REF], sc[WS_PLEN], sc[WS_FLAGS]
    lastx, lasty = sc[WS_LASTX], sc[WS_LASTY]
    plen0 = plen
    dx, dy = [0] * d_pad, [0] * d_pad
    for k in range(n_valid):
        if fl & 1:
            break  # stopped: the rest of the launch is a no-op
        if cp >= n_cap:
            fl |= 1  # capacity stop, before the increment
            break
        state.live[cp] = cols[k]
        cp += 1
        if rp >= m - 1 - w or lp >= n_cap - 1 - w:
            fl |= 1  # margin stop
            break
        if cp - lp < w:
            continue
        cost = window_cost(state.live[lp : lp + w], state.ref[rp : rp + w])
        _, back = wavefront_dp_reference(cost, WTW_SPEC)
        points, length = backtrack_reference(back, WTW_SPEC)
        chase = [(int(i), int(j)) for i, j in points.cpu().tolist()]  # end → origin
        length = int(length)
        n_c = sum(1 for i, _ in chase[:length] if i <= hop_frames)
        for q in range(n_c):
            i, j = chase[length - 1 - q]
            dest = plen - plen0 + q
            if dest < d_pad:
                dx[dest], dy[dest] = i + lp, j + rp
            else:
                fl |= 2
        li, lj = chase[min(max(length - n_c, 0), len(chase) - 1)]
        lastx, lasty = li + lp, lj + rp
        plen += n_c
        change = n_c < length  # some point crossed the hop boundary
        lp, rp = (lp + li, rp + lj) if change else (lp + hop_frames, rp + hop_frames)
    for slot, v in ((WS_CHROMA, cp), (WS_LIVE, lp), (WS_REF, rp), (WS_PLEN, plen), (WS_FLAGS, fl),
                    (WS_LASTX, lastx), (WS_LASTY, lasty)):
        state.scalars[slot] = v
    row.copy_(torch.tensor([fl, plen, lastx, lasty, 0, 0, 0, 0] + dx + dy, dtype=torch.int32))


# ---------------------------------------------------------------------------
# B streams per launch (TPU kernel #10)
# ---------------------------------------------------------------------------

#: launches of the B-stream grid (:func:`multi_wtw_insert_block`) in this
#: process; the plain version does not count
multi_launches = 0


@dataclasses.dataclass
class MultiWTWState:
    """B streams' state, one launch for all; every tensor lies on one
    device, and stream b's rows are :class:`WTWState`'s layout:

    - ``ref`` (R, m_max, F) f32: R = 1, one reference every stream reads,
      or R = B, one per stream zero-padded to the longest (stream b reads
      its own first m_b rows);
    - ``live`` (B, n_cap_max, F) f32: each stream's whole live history;
    - ``scalars`` (B, 16) int32: slots ``WS_*``."""

    ref: torch.Tensor
    live: torch.Tensor
    scalars: torch.Tensor

    @property
    def batch(self) -> int:
        return self.live.shape[0]

    def stream(self, b: int) -> WTWState:
        """Stream b's state as views of the batch."""
        return WTWState(ref=self.ref[0 if self.ref.shape[0] == 1 else b], live=self.live[b], scalars=self.scalars[b])


def new_multi_state(refs, n_caps, m_max: Optional[int] = None, n_cap_max: Optional[int] = None) -> MultiWTWState:
    """Fresh state for B streams on the references' device: ``refs`` is a
    list of (F, m_b) reference chromas, one per stream (the same tensor
    object B times is stored once and shared), ``n_caps`` each stream's
    live capacity; every scalar starts at 0.  ``m_max`` and ``n_cap_max``
    pad the reference and live rows further (a shard of a larger batch
    keeps the batch's shapes)."""
    b = len(refs)
    if b == 0 or len(n_caps) != b:
        raise ValueError(f"need one live capacity per reference, got {len(n_caps)} for {b}")
    shared = all(r is refs[0] for r in refs)
    f = refs[0].shape[0]
    dev = refs[0].device
    m_max = max([r.shape[1] for r in refs] + [m_max or 0])
    ref = torch.zeros((1 if shared else b, m_max, f), dtype=torch.float32, device=dev)
    for i, r in enumerate(refs[:1] if shared else refs):
        ref[i, : r.shape[1]] = r.T
    return MultiWTWState(
        ref=ref,
        live=torch.zeros((b, max(int(max(n_caps)), n_cap_max or 0), f), dtype=torch.float32, device=dev),
        scalars=torch.zeros((b, N_SCALARS), dtype=torch.int32, device=dev),
    )


def _check_multi(state: MultiWTWState, cols: torch.Tensor, lens: torch.Tensor, w: int, hop_frames: int,
                 k_block: int, rows: torch.Tensor) -> None:
    b = state.batch
    f = state.ref.shape[-1]
    _require({
        "ref": (state.ref, torch.float32, None),
        "live": (state.live, torch.float32, None),
        "scalars": (state.scalars, torch.int32, (b, N_SCALARS)),
        "cols": (cols, torch.float32, None),
        "lens": (lens, torch.int32, (b, 3)),
        "rows": (rows, torch.int32, (b, delta_width(w, hop_frames, k_block))),
    }, cols.device)
    if not 1 <= w <= MAX_W:
        raise ValueError(f"window of {w} frames: the kernel takes 1..{MAX_W}")
    if hop_frames < 1:
        raise ValueError(f"hop_frames {hop_frames} must be >= 1")
    if state.ref.ndim != 3 or state.ref.shape[0] not in (1, b):
        raise ValueError(f"ref must be (1 or {b}, rows, F), got {tuple(state.ref.shape)}")
    if state.live.ndim != 3 or state.live.shape[2] != f:
        raise ValueError(f"live must be ({b}, rows, {f}), got {tuple(state.live.shape)}")
    if cols.ndim != 3 or cols.shape[0] != b or cols.shape[2] != f or cols.shape[1] > k_block:
        raise ValueError(f"cols must be ({b}, k <= {k_block}, {f}), got {tuple(cols.shape)}")


def multi_wtw_insert_block(state: MultiWTWState, cols: torch.Tensor, lens: torch.Tensor, w: int, hop_frames: int,
                           k_block: int, rows: torch.Tensor) -> None:
    """:func:`wtw_insert_block` for each of B streams in one launch: stream
    b appends the first ``lens[b, 2]`` rows of ``cols[b]`` (``cols`` (B, k,
    F), k ≤ k_block) and runs its due windows on its own reference length
    ``lens[b, 0]`` and live capacity ``lens[b, 1]`` (``lens`` (B, 3) int32
    on the state's device), writing its ``[status | dx | dy]`` into row b
    of ``rows`` (B, :func:`delta_width`).  A stream with no column appends
    nothing and still writes its status.

    CUDA tensors launch the kernel over a grid of B blocks (counted in
    :data:`multi_launches`); CPU tensors run
    :func:`multi_wtw_insert_block_reference`.  Nothing falls back: a failed
    build or launch raises."""
    global multi_launches
    if cols.device.type == "cpu":
        multi_wtw_insert_block_reference(state, cols, lens, w, hop_frames, k_block, rows)
        return
    _check_multi(state, cols, lens, w, hop_frames, k_block, rows)
    _check_kernel(cols, state.ref.shape[-1])
    from real_time_audio_sync_tpu_torch.ops import _build

    lib = _build.load("wtw_insert").lib
    b, f = state.batch, state.ref.shape[2]
    spec = WTW_SPEC
    table = _step_table(spec)
    ref_stride = 0 if state.ref.shape[0] == 1 else state.ref.shape[1] * f  # shared: 0
    with torch.cuda.device(cols.device):
        stream = torch.cuda.current_stream(cols.device).cuda_stream
        err = lib.wtw_multi_insert_block(
            state.ref.data_ptr(), state.live.data_ptr(), state.scalars.data_ptr(), rows.data_ptr(),
            cols.data_ptr(), lens.data_ptr(), b, state.ref.shape[1], state.live.shape[1], cols.shape[1],
            w, hop_frames, f, wtw_geometry(w, hop_frames, k_block)[2],
            *(_KIND[s] for s in spec.steps), *(float(x) for x in spec.weights), *spec.codes, spec.corner_code,
            *(di for di, _ in table), *(dj for _, dj in table),
            ref_stride, state.live.shape[1] * f, rows.shape[1], stream,
        )
    if err != 0:
        raise RuntimeError(f"wtw_multi_insert_block launch failed (B={b}, w={w}): "
                           f"{lib.wtw_error_string(err).decode()}")
    multi_launches += 1


def multi_wtw_insert_block_reference(state: MultiWTWState, cols: torch.Tensor, lens: torch.Tensor, w: int,
                                     hop_frames: int, k_block: int, rows: torch.Tensor) -> None:
    """Plain PyTorch version of the batched launch, on any device:
    :func:`wtw_insert_block_reference` over each stream's views, so it
    equals the solo plain version stream by stream by construction."""
    _check_multi(state, cols, lens, w, hop_frames, k_block, rows)
    for b, (m, n_cap, n_valid) in enumerate(lens.tolist()):
        wtw_insert_block_reference(state.stream(b), cols[b], (m, n_cap, n_valid), w, hop_frames, k_block, rows[b])
