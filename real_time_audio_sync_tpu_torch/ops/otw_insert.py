"""K streaming OTW inserts per launch on a band-relative window: the CUDA
kernel's wrapper, its plain PyTorch version, and the engine state layout.

Replaces four TPU kernels of ``real_time_audio_sync_tpu/ops/pallas_otw.py``
as one CUDA kernel (``csrc/otw_insert.cu``) in two modes, over one stream
(:func:`insert_block`) or a grid of B streams (:func:`multi_insert_block`):

- whole path: ``_pallas_insert_block`` (:803) with its body
  ``_insert_block_body`` (:644) and band primitives ``_build_ops`` (:125),
  ``_minplus_doubling`` (:87) and ``_first_min`` (:111), and its B-stream
  grid ``_pallas_multi_insert_block`` (:1080) — committed points go to the
  state's whole-path buffers;
- delta: ``_pallas_insert_block_long`` (:959) and its B-stream grid
  ``_pallas_multi_insert_block_long`` (:1002) — each launch writes each
  stream's status and the points it committed into one fresh int32 row
  ``[status (8) | dx (d_pad) | dy (d_pad)]`` (:func:`delta_slots`), the
  point at path index ``plen`` in slot ``plen − plen₀``, and the caller
  keeps the path on the host.  The TPU kernel's sliding live window and
  reference DMA window exist to fit VMEM; here the reference and the whole
  live history stay in device memory in both modes.

What bounds it on an H100: latency, not bytes or FLOPs.  One stream is one
thread block running a serial chain of about ``K·loop_iters`` band
updates, each a (c+1)-wide cost + min-plus scan + argmin that needs the
last one's window, over a few KB of state.  The design keeps the whole
(c+1)² window in shared memory for the launch (a ring offset replaces the
TPU's physical rolls, so a band update touches O(c) cells) and the scalar
state machine in registers.  Where the band has at most 8 registers a lane
(c ≤ 255) and the features are chroma, one warp runs the chain (band
position 32k + lane in register k, the scan and argmins as shuffles, no
block barrier; the band's rows in two shared-memory rings, or read from
device memory where the rings do not fit beside a shared window, c =
229–237 on an H100) and the block's other warps only share the window's
copy in and out; above it one thread per band position runs it between
block barriers, which is faster there.  A band whose window does not fit the
card's shared memory per block (c ≥ 238 on an H100) keeps its window in a
global-memory workspace instead (:func:`window_workspace`): the same
kernel source with the window in another memory space, chosen by band
width.

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
from typing import Optional, Tuple

import torch

from real_time_audio_sync_tpu_torch.models.online_core import BOTH, COL, PREV_NONE, ROW, OnlineConfig
from real_time_audio_sync_tpu_torch.ops.band import _cost_vector, _minplus_doubling  # noqa: F401  (banded_dtw's scan)

# scalar-state slots (int32[16]), as pallas_otw.py:638-641
(S_T, S_J, S_RC, S_PREV, S_PLEN, S_LASTX, S_LASTY, S_FIRST,
 S_STOPPED, S_DIR, S_OVERFLOW) = range(11)
N_SCALARS = 16
N_STATUS = 8

#: launches of the CUDA kernel in this process — one stream in whole-path
#: and delta mode, then B streams in whole-path and delta mode (the plain
#: version does not count); a caller may reset them to 0 before the run it
#: wants to inspect
launches = 0
delta_launches = 0
multi_launches = 0
multi_delta_launches = 0


def delta_slots(cfg: OnlineConfig, k_block: int) -> int:
    """Point slots ``d_pad`` of one delta row: a launch commits at most
    ``loop_iters`` points per insert (pallas_otw.py:874)."""
    return k_block * cfg.loop_iters + 8


def delta_width(cfg: OnlineConfig, k_block: int) -> int:
    """Int32 slots of one stream's delta row ``[status | dx | dy]``."""
    return N_STATUS + 2 * delta_slots(cfg, k_block)


_WORKSPACE_FLOATS: dict = {}


def window_workspace(lib, c: int, blocks: int, device: torch.device):
    """The global-memory window workspace (blocks, floats) f32 for a launch
    of ``blocks`` blocks at band ``c``, or None when the windows fit in
    shared memory.  ``floats`` — 0 or (c+1)² — is what the band library
    (``lib``, either one) says a block needs on this device
    (``otw_band_workspace_floats``, from the device's shared-memory opt-in
    limit); it is asked once per device and band."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if (index, c) not in _WORKSPACE_FLOATS:
        floats = lib.otw_band_workspace_floats(c, index)
        if floats < 0:
            raise RuntimeError(f"cannot read the shared-memory limit of cuda:{index}")
        _WORKSPACE_FLOATS[index, c] = floats
    floats = _WORKSPACE_FLOATS[index, c]
    if floats == 0:
        return None
    return torch.empty((blocks, floats), dtype=torch.float32, device=device)


@dataclasses.dataclass
class OTWState:
    """One stream's engine state; every tensor lies on the same device.

    - ``window`` (c+1, c+1) f32: ``window[a, b] = acc[t-c+a, j-c+b]``;
    - ``ref`` (c+N, F) f32: reference features, row ``c+j`` ↔ ref frame j
      (c leading zero rows, read by band cells left of frame 0);
    - ``live`` (c+cap, F) f32: live feature history, row ``c+t`` ↔ frame t;
    - ``path_x``/``path_y`` (cap+N+16,) int32: committed path points, or
      None for a stream launched in delta mode (its path is the caller's);
    - ``scalars`` int32[16]: slots ``S_*``;
    - ``status`` int32[8]: the last whole-path launch's
      ``[stopped | overflow<<1, plen, lastx, lasty, 0, 0, 0, 0]`` (a delta
      launch writes its status into its delta row).
    """

    window: torch.Tensor
    ref: torch.Tensor
    live: torch.Tensor
    path_x: Optional[torch.Tensor]
    path_y: Optional[torch.Tensor]
    scalars: torch.Tensor
    status: torch.Tensor


def new_state(ref: torch.Tensor, cfg: OnlineConfig, cap: int, whole_path: bool = True) -> OTWState:
    """Fresh state for reference features ``ref`` (F, N) with live capacity
    ``cap``, on ``ref``'s device (scalars as fused_streaming.py:129-135);
    ``whole_path=False`` allocates no path buffers (delta mode)."""
    f, n = ref.shape
    c = cfg.c
    dev = ref.device
    ref_rows = torch.zeros((c + n, f), dtype=torch.float32, device=dev)
    ref_rows[c:] = ref.T
    p_len = cap + n + 16
    path = (lambda: torch.zeros(p_len, dtype=torch.int32, device=dev)) if whole_path else (lambda: None)
    return OTWState(
        window=torch.full((c + 1, c + 1), cfg.sentinel, dtype=torch.float32, device=dev),
        ref=ref_rows,
        live=torch.zeros((c + cap, f), dtype=torch.float32, device=dev),
        path_x=path(),
        path_y=path(),
        scalars=fresh_scalars(cfg).to(dev),
        status=torch.zeros(N_STATUS, dtype=torch.int32, device=dev),
    )


def fresh_scalars(cfg: OnlineConfig) -> torch.Tensor:
    """A fresh stream's scalar state int32[16] (fused_streaming.py:129-135),
    on the CPU."""
    scalars = torch.zeros(N_SCALARS, dtype=torch.int32)
    scalars[S_RC] = cfg.run_count_init
    scalars[S_PREV] = PREV_NONE
    scalars[S_LASTX] = -1
    scalars[S_LASTY] = -1
    scalars[S_FIRST] = 1
    scalars[S_DIR] = BOTH
    return scalars


def _require(want: dict, device: torch.device) -> None:
    """Raise unless each ``name: (tensor, dtype, shape or None)`` of ``want``
    lies on ``device``, has that dtype and shape, and is contiguous."""
    for name, (x, dtype, shape) in want.items():
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, cols on {device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(state: OTWState, cols: torch.Tensor, lens: Tuple[int, int, int], cfg: OnlineConfig, k_block: int,
           delta: Optional[torch.Tensor]) -> None:
    c = cfg.c
    live_cap, ref_len, n_valid = (int(v) for v in lens)
    dev = cols.device
    f = state.ref.shape[1]
    want = {
        "window": (state.window, torch.float32, (c + 1, c + 1)),
        "ref": (state.ref, torch.float32, None),
        "live": (state.live, torch.float32, None),
        "scalars": (state.scalars, torch.int32, (N_SCALARS,)),
        "status": (state.status, torch.int32, (N_STATUS,)),
        "cols": (cols, torch.float32, None),
    }
    if delta is None:
        if state.path_x is None or state.path_y is None:
            raise ValueError("a whole-path launch needs the state's path buffers (or pass a delta row)")
        want["path_x"] = (state.path_x, torch.int32, None)
        want["path_y"] = (state.path_y, torch.int32, state.path_x.shape)
        if state.path_x.ndim != 1:
            raise ValueError("path buffers must be 1-D")
    else:
        want["delta"] = (delta, torch.int32, (delta_width(cfg, k_block),))
    _require(want, dev)
    # a stream of a batched state reads the first rows of its padded views
    for name, x, rows in (("ref", state.ref, c + ref_len), ("live", state.live, c + live_cap)):
        if x.ndim != 2 or x.shape[0] < rows or x.shape[1] != f:
            raise ValueError(f"{name} must have at least {rows} rows of {f}, got {tuple(x.shape)}")
    if cols.ndim != 2 or cols.shape[1] != f:
        raise ValueError(f"cols must be (k, {f}), got {tuple(cols.shape)}")
    if not 0 <= n_valid <= cols.shape[0] <= k_block:
        raise ValueError(f"need 0 <= n_valid ({n_valid}) <= k ({cols.shape[0]}) <= k_block ({k_block})")
    if c < 1:
        raise ValueError(f"band c={c} must be >= 1")
    if ref_len < c:
        raise ValueError(f"reference length {ref_len} shorter than search band {c}")


def delta_views(delta: torch.Tensor, cfg: OnlineConfig, k_block: int):
    """(status, dx, dy) views of one delta row ``[status | dx | dy]``."""
    d_pad = delta_slots(cfg, k_block)
    return delta[:N_STATUS], delta[N_STATUS : N_STATUS + d_pad], delta[N_STATUS + d_pad :]


def insert_block(state: OTWState, cols: torch.Tensor, lens: Tuple[int, int, int], cfg: OnlineConfig, k_block: int,
                 delta: Optional[torch.Tensor] = None) -> None:
    """Run up to ``k_block`` streaming inserts — the rows of ``cols`` (k, F),
    the first ``n_valid`` of them — updating ``state`` in place.

    ``lens = (live_cap, ref_len, n_valid)``.  With ``delta`` None the
    launch commits points to the state's whole-path buffers and its status
    to ``state.status``; with ``delta`` an int32 row of
    ``8 + 2·delta_slots(cfg, k_block)`` it writes
    ``[status | dx | dy]`` there (slots past the launch's points read 0).

    CUDA tensors launch the kernel (and count in :data:`launches` or
    :data:`delta_launches`); CPU tensors run :func:`insert_block_reference`.
    Nothing falls back: a failed build or launch raises."""
    global launches, delta_launches
    if cols.device.type == "cpu":
        insert_block_reference(state, cols, lens, cfg, k_block, delta)
        return
    _check(state, cols, lens, cfg, k_block, delta)
    if cols.device.type != "cuda":
        raise ValueError(f"no otw_insert kernel for device {cols.device}")
    c = cfg.c
    from real_time_audio_sync_tpu_torch.ops import _build

    lib = _build.load("otw_insert").lib
    live_cap, ref_len, n_valid = (int(v) for v in lens)
    if delta is None:
        status, path_x, path_y = state.status, state.path_x, state.path_y
    else:
        status, path_x, path_y = delta_views(delta, cfg, k_block)
    work = window_workspace(lib, c, 1, cols.device)
    with torch.cuda.device(cols.device):
        stream = torch.cuda.current_stream(cols.device).cuda_stream
        err = lib.otw_insert_block(
            state.window.data_ptr(), None if work is None else work.data_ptr(), state.ref.data_ptr(),
            state.live.data_ptr(), path_x.data_ptr(), path_y.data_ptr(), state.scalars.data_ptr(),
            status.data_ptr(), cols.data_ptr(),
            c, state.ref.shape[1], path_x.shape[0], live_cap, ref_len, n_valid,
            cfg.sentinel, cfg.max_run_count, int(cfg.monotone_path),
            int(cfg.euclidean), cfg.loop_iters, int(delta is not None), stream,
        )
    if err != 0:
        raise RuntimeError(f"otw_insert_block launch failed (c={c}): {lib.otw_error_string(err).decode()}")
    if delta is None:
        launches += 1
    else:
        delta_launches += 1


# ---------------------------------------------------------------------------
# B streams per launch
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MultiOTWState:
    """B streams' engine state, one launch for all; every tensor lies on the
    same device, and stream b's rows are :class:`OTWState`'s layout:

    - ``window`` (B, c+1, c+1) f32;
    - ``ref`` (R, c+N_max, F) f32: R = 1, one reference every stream reads,
      or R = B, one per stream zero-padded to the longest;
    - ``live`` (B, c+2·N_max, F) f32;
    - ``path_x``/``path_y`` (B, 3·N_max+16) int32, or None in delta mode;
    - ``scalars`` (B, 16) int32, ``status`` (B, 8) int32 (whole-path mode);
    - ``lens`` (B, 2) int32: each stream's live capacity (2·N_b) and
      reference length N_b, which decides where it stops."""

    window: torch.Tensor
    ref: torch.Tensor
    live: torch.Tensor
    path_x: Optional[torch.Tensor]
    path_y: Optional[torch.Tensor]
    scalars: torch.Tensor
    status: torch.Tensor
    lens: torch.Tensor

    @property
    def batch(self) -> int:
        return self.window.shape[0]

    def stream(self, b: int) -> OTWState:
        """Stream b's state as views of the batch."""
        return OTWState(
            window=self.window[b], ref=self.ref[0 if self.ref.shape[0] == 1 else b], live=self.live[b],
            path_x=None if self.path_x is None else self.path_x[b],
            path_y=None if self.path_y is None else self.path_y[b],
            scalars=self.scalars[b], status=self.status[b],
        )


def new_multi_state(refs, cfg: OnlineConfig, whole_path: bool = True, n_max: Optional[int] = None) -> MultiOTWState:
    """Fresh state for B streams on the references' device: ``refs`` is a
    list of (F, N_b) tensors, one per stream; a list of one tensor repeated
    (the same object B times) is held once and shared.  Each stream's
    scalars are :func:`new_state`'s; ``whole_path=False`` allocates no path
    buffers (delta mode).  ``n_max`` pads to a longer length than the
    longest reference (a shard of a larger batch keeps the batch's shapes)."""
    b = len(refs)
    shared = b > 0 and all(r is refs[0] for r in refs)
    f = refs[0].shape[0]
    n_max = max([r.shape[1] for r in refs] + [n_max or 0])
    c = cfg.c
    dev = refs[0].device
    if min(r.shape[1] for r in refs) < c:
        raise ValueError(f"every reference must be at least one band ({c}) long")
    ref_rows = torch.zeros((1 if shared else b, c + n_max, f), dtype=torch.float32, device=dev)
    for i, r in enumerate(refs[:1] if shared else refs):
        ref_rows[i, c : c + r.shape[1]] = r.T
    p_len = 3 * n_max + 16
    path = (lambda: torch.zeros((b, p_len), dtype=torch.int32, device=dev)) if whole_path else (lambda: None)
    lens = torch.tensor([[2 * r.shape[1], r.shape[1]] for r in refs], dtype=torch.int32)
    return MultiOTWState(
        window=torch.full((b, c + 1, c + 1), cfg.sentinel, dtype=torch.float32, device=dev),
        ref=ref_rows,
        live=torch.zeros((b, c + 2 * n_max, f), dtype=torch.float32, device=dev),
        path_x=path(),
        path_y=path(),
        scalars=fresh_scalars(cfg).repeat(b, 1).to(dev),
        status=torch.zeros((b, N_STATUS), dtype=torch.int32, device=dev),
        lens=lens.to(dev),
    )


def _check_multi(state: MultiOTWState, cols: torch.Tensor, ks: torch.Tensor, cfg: OnlineConfig, k_block: int,
                 delta: Optional[torch.Tensor]) -> None:
    b, c = state.batch, cfg.c
    f = state.ref.shape[2]
    want = {
        "window": (state.window, torch.float32, (b, c + 1, c + 1)),
        "ref": (state.ref, torch.float32, None),
        "live": (state.live, torch.float32, None),
        "scalars": (state.scalars, torch.int32, (b, N_SCALARS)),
        "status": (state.status, torch.int32, (b, N_STATUS)),
        "lens": (state.lens, torch.int32, (b, 2)),
        "cols": (cols, torch.float32, None),
        "ks": (ks, torch.int32, (b,)),
    }
    if delta is None:
        if state.path_x is None or state.path_y is None:
            raise ValueError("a whole-path launch needs the state's path buffers (or pass delta rows)")
        want["path_x"] = (state.path_x, torch.int32, None)
        want["path_y"] = (state.path_y, torch.int32, state.path_x.shape)
    else:
        want["delta"] = (delta, torch.int32, (b, delta_width(cfg, k_block)))
    _require(want, cols.device)
    if state.ref.ndim != 3 or state.ref.shape[0] not in (1, b):
        raise ValueError(f"ref must be (1 or {b}, rows, F), got {tuple(state.ref.shape)}")
    if state.live.ndim != 3 or state.live.shape[0] != b or state.live.shape[2] != f:
        raise ValueError(f"live must be ({b}, rows, {f}), got {tuple(state.live.shape)}")
    if delta is None and (state.path_x.ndim != 2 or state.path_x.shape[0] != b):
        raise ValueError(f"path buffers must be ({b}, P), got {tuple(state.path_x.shape)}")
    if cols.ndim != 3 or cols.shape[0] != b or cols.shape[2] != f or cols.shape[1] > k_block:
        raise ValueError(f"cols must be ({b}, k <= {k_block}, {f}), got {tuple(cols.shape)}")
    if c < 1:
        raise ValueError(f"band c={c} must be >= 1")


def multi_delta_views(delta: torch.Tensor, cfg: OnlineConfig, k_block: int):
    """(status, dx, dy) views, each (B, 1, X), of B streams' delta rows (B,
    8 + 2·d_pad) — the JAX follower's row-shaped layout."""
    d_pad = delta_slots(cfg, k_block)
    rows = delta[:, None]
    return rows[..., :N_STATUS], rows[..., N_STATUS : N_STATUS + d_pad], rows[..., N_STATUS + d_pad :]


def multi_insert_block(state: MultiOTWState, cols: torch.Tensor, ks: torch.Tensor, cfg: OnlineConfig, k_block: int,
                       delta: Optional[torch.Tensor] = None) -> None:
    """Run up to ``k_block`` streaming inserts for each of B streams in one
    launch: stream b inserts the first ``ks[b]`` rows of ``cols[b]``
    (``cols`` (B, k, F), ``ks`` (B,) int32, 0 ≤ ks[b] ≤ k ≤ k_block),
    updating ``state`` in place.  A stream with ``ks[b] = 0`` inserts
    nothing and still writes its status.

    With ``delta`` None the launch commits points to the state's whole-path
    buffers and each stream's status to ``state.status``; with ``delta`` an
    int32 (B, 8 + 2·delta_slots) array, stream b writes ``[status | dx |
    dy]`` into row b.

    CUDA tensors launch the kernel (and count in :data:`multi_launches` or
    :data:`multi_delta_launches`); CPU tensors run
    :func:`multi_insert_block_reference`.  Nothing falls back: a failed
    build or launch raises."""
    global multi_launches, multi_delta_launches
    if cols.device.type == "cpu":
        multi_insert_block_reference(state, cols, ks, cfg, k_block, delta)
        return
    _check_multi(state, cols, ks, cfg, k_block, delta)
    if cols.device.type != "cuda":
        raise ValueError(f"no otw_insert kernel for device {cols.device}")
    c, b = cfg.c, state.batch
    from real_time_audio_sync_tpu_torch.ops import _build

    lib = _build.load("otw_insert").lib
    if delta is None:
        status, path_x, path_y = state.status, state.path_x, state.path_y
        p_len, path_stride, status_stride = state.path_x.shape[1], state.path_x.shape[1], N_STATUS
    else:
        d_pad = delta_slots(cfg, k_block)
        status, path_x, path_y = delta, delta[:, N_STATUS:], delta[:, N_STATUS + d_pad :]
        p_len, path_stride, status_stride = d_pad, delta.shape[1], delta.shape[1]
    work = window_workspace(lib, c, b, cols.device)
    ref_stride = 0 if state.ref.shape[0] == 1 else state.ref.shape[1] * state.ref.shape[2]  # shared: 0
    with torch.cuda.device(cols.device):
        stream = torch.cuda.current_stream(cols.device).cuda_stream
        err = lib.otw_multi_insert_block(
            state.window.data_ptr(), None if work is None else work.data_ptr(), state.ref.data_ptr(),
            state.live.data_ptr(), path_x.data_ptr(), path_y.data_ptr(), state.scalars.data_ptr(),
            status.data_ptr(), cols.data_ptr(), state.lens.data_ptr(), ks.data_ptr(),
            b, c, state.ref.shape[2], p_len, cfg.sentinel, cfg.max_run_count, int(cfg.monotone_path),
            int(cfg.euclidean), cfg.loop_iters, int(delta is not None),
            ref_stride, state.live.shape[1] * state.live.shape[2],
            path_stride, status_stride, cols.shape[1], stream,
        )
    if err != 0:
        raise RuntimeError(f"otw_multi_insert_block launch failed (B={b}, c={c}): "
                           f"{lib.otw_error_string(err).decode()}")
    if delta is None:
        multi_launches += 1
    else:
        multi_delta_launches += 1


def multi_insert_block_reference(state: MultiOTWState, cols: torch.Tensor, ks: torch.Tensor, cfg: OnlineConfig,
                                 k_block: int, delta: Optional[torch.Tensor] = None) -> None:
    """Plain PyTorch version of the batched launch, on any device:
    :func:`insert_block_reference` over each stream's views, so it equals
    the solo plain version stream by stream by construction."""
    _check_multi(state, cols, ks, cfg, k_block, delta)
    lens = state.lens.tolist()
    for b, k in enumerate(ks.tolist()):
        k = max(0, min(k, cols.shape[1]))
        insert_block_reference(state.stream(b), cols[b, :k], (lens[b][0], lens[b][1], k), cfg, k_block,
                               None if delta is None else delta[b])


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------


def _cost(rows: torch.Tensor, fixed: torch.Tensor, euclidean: bool) -> torch.Tensor:
    """Cost of each of ``rows`` (m, F) against ``fixed`` (F,), summed
    sequentially over f as the kernel does (``ops/band._cost_vector``)."""
    return _cost_vector(fixed[None], rows.T[None], euclidean)[0]


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
                 cfg: OnlineConfig, base: int = 0) -> Tuple[int, int, int]:
    """Commit (x, y) at path index ``plen`` — slot ``plen − base`` of the
    buffers (``base`` 0 for a whole path, the launch's starting plen for a
    delta row) — unless LiveNoteV2's monotone guard rejects it
    (pallas_otw.py:181-194); a point outside the buffer is counted but not
    stored.  Returns ``(plen, lastx, lasty)``."""
    if cfg.monotone_path and plen > 0 and not (x > lastx and y >= lasty):
        return plen, lastx, lasty
    if 0 <= plen - base < path_x.shape[0]:
        path_x[plen - base] = x
        path_y[plen - base] = y
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


def insert_block_reference(state: OTWState, cols: torch.Tensor, lens: Tuple[int, int, int], cfg: OnlineConfig,
                           k_block: int, delta: Optional[torch.Tensor] = None) -> None:
    """Plain PyTorch version of the kernel, in both modes, on any device: the
    same window algorithm on tensors, with the scalar state machine of
    ``_insert_block_body`` (pallas_otw.py:644-746) in Python integers —
    the first-insert origin, the "ran out of room" freeze at
    ``t >= live_cap``, the bounded column phase with the sticky overflow
    flag, and stop-and-freeze once ``j`` passes the reference.  A delta row
    that would hold more than its slots sets the overflow flag."""
    _check(state, cols, lens, cfg, k_block, delta)
    live_cap, ref_len, n_valid = (int(v) for v in lens)
    c = cfg.c
    w, ref, live = state.window, state.ref, state.live
    sentinel = float(cfg.sentinel)
    sc = state.scalars.tolist()
    t, j, rc, prev, plen, lastx, lasty = (sc[s] for s in (S_T, S_J, S_RC, S_PREV, S_PLEN, S_LASTX, S_LASTY))
    first, stopped, direction, overflow = bool(sc[S_FIRST]), bool(sc[S_STOPPED]), sc[S_DIR], bool(sc[S_OVERFLOW])
    if delta is None:
        status, path_x, path_y, base = state.status, state.path_x, state.path_y, 0
    else:
        status, path_x, path_y = delta_views(delta, cfg, k_block)
        path_x.zero_()
        path_y.zero_()
        base = plen

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
            plen, lastx, lasty = append_point(path_x, path_y, x, y, plen, lastx, lasty, cfg, base)
            d, rc, prev = set_direction(x, y, t_new, j, rc, prev, cfg)
            active = d == COL
        direction = d
        overflow = overflow or active
        t = t_new
    if delta is not None and plen - base > path_x.shape[0]:
        overflow = True

    sc[S_T], sc[S_J], sc[S_RC], sc[S_PREV] = t, j, rc, prev
    sc[S_PLEN], sc[S_LASTX], sc[S_LASTY] = plen, lastx, lasty
    sc[S_FIRST], sc[S_STOPPED], sc[S_DIR], sc[S_OVERFLOW] = int(first), int(stopped), direction, int(overflow)
    state.scalars.copy_(torch.tensor(sc, dtype=torch.int32))
    status.copy_(torch.tensor([int(stopped) | (int(overflow) << 1), plen, lastx, lasty, 0, 0, 0, 0], dtype=torch.int32))
