"""Whole-pair online time warping (``set_live``) for a batch of pairs in one
launch: the CUDA kernel's wrapper, its plain PyTorch version, and the
public functions under the JAX package's names.

Replaces the TPU kernels ``real_time_audio_sync_tpu/ops/pallas_otw.py``
``_pallas_set_live`` (:387; public :func:`pallas_set_live`, :425) and
``_pallas_batched_set_live`` (:505; public :func:`pallas_batched_set_live`,
:554), both driven by ``_make_set_live_kernel`` (:296).  The CUDA source is
``csrc/otw_set_live.cu``: one kernel over a grid of B pairs, a solo pair
being B = 1.  Its per-cell numerics are the K-insert kernel's
(``csrc/otw_band.cuh``), and :func:`set_live_reference` reuses
``ops/otw_insert``'s plain band functions, so both kernels and both plain
versions compute every cell alike (numerics in ``ops/otw_insert.py``).

What bounds it on an H100: neither bytes nor operations but a chain of
dependent steps.  One pair is t + j band updates in a row, each needing the
last one's window and argmin, so the time is t + j times the latency of one
update.  The kernel runs one warp per pair with the band's positions in
registers (``csrc/otw_band_warp.cuh``): the min-plus scan and the argmins
are register shuffles with no block barrier, the band's feature rows sit
in shared-memory rings filled a step ahead, and the window stays in
shared memory (or, for a band too wide for it, in a global-memory
workspace of one window per pair, ``otw_insert.window_workspace``, in the
same kernel).  :func:`warp_minplus_scan` models its scan's lane and
register schedule on tensors for the tests.  The pairs of a
batch run side by side, each leaving on its own ``done``.

Layout (:func:`pack`): ``ref_rows`` (R, c + n_max, F) with c leading zero
rows (row c+j ↔ reference frame j), R = 1 when every pair shares one
reference (one copy, read by every block) and B otherwise; ``live_rows``
(B, c + t_max, F) likewise; ``lens`` (B, 2) int32 ``[live_len, ref_len]``.
The TPU kernel's 128-lane padding, identity-matmul transposes, float-score
argmax and row-shaped SMEM blocks have no counterpart here.

Every pair, of any length, takes this kernel.  The JAX package sends
pairs of 12,000 or more combined frames to its streaming engine instead
(pallas_otw.py:417-422), because its kernel holds whole sequences in
VMEM; this kernel keeps only the window and the band's feature rows on
chip and streams the rest from device memory, so it needs no such route.  Its results
equal that route's (``tests/test_torch_set_live.py``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from real_time_audio_sync_tpu_torch.config import OTWParams
from real_time_audio_sync_tpu_torch.models.online_core import COL, PREV_NONE, ROW, OnlineConfig
from real_time_audio_sync_tpu_torch.ops.otw_insert import (
    _cost,
    append_point,
    best_point,
    col_update,
    row_update,
    set_direction,
    window_workspace,
)

#: per-pair output scalars: plen, t, j, stopped, then zeros
N_OUT = 8

#: launches of the CUDA kernel in this process (the plain version does not
#: count); a caller may reset it to 0 before the run it wants to inspect
launches = 0

Result = Tuple[np.ndarray, int, int, bool]


def _config(params, sentinel, run_count_init, monotone_path, euclidean) -> OnlineConfig:
    p = OTWParams.from_any(params)
    return OnlineConfig(c=p.c, max_run_count=p.max_run_count, sentinel=sentinel,
                           run_count_init=run_count_init, monotone_path=monotone_path, euclidean=euclidean)


def _features(x, device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x, np.float32))  # a copy: the caller's array may be read-only
    return x.to(device=device, dtype=torch.float32)


def pack(refs: Sequence[torch.Tensor], lives: Sequence[torch.Tensor], c: int):
    """Ragged (F, Nᵢ) references and (F, Tᵢ) live sequences, all on one
    device, into the kernel's layout: ``(ref_rows, live_rows, lens)``; one
    reference copy when every pair has the same one (pallas_otw.py:606)."""
    b = len(lives)
    dev = lives[0].device
    f = refs[0].shape[0]
    shared = b > 1 and all(r.shape == refs[0].shape and torch.equal(r, refs[0]) for r in refs[1:])
    uniq = refs[:1] if shared else refs
    n_max = max(r.shape[1] for r in refs)
    t_max = max(max(l.shape[1] for l in lives), 1)  # live row 0 is read by the origin
    ref_rows = torch.zeros((len(uniq), c + n_max, f), dtype=torch.float32, device=dev)
    for i, r in enumerate(uniq):
        ref_rows[i, c : c + r.shape[1]] = r.T
    live_rows = torch.zeros((b, c + t_max, f), dtype=torch.float32, device=dev)
    for i, l in enumerate(lives):
        live_rows[i, c : c + l.shape[1]] = l.T
    lens = torch.tensor([[l.shape[1], r.shape[1]] for r, l in zip(refs, lives)], dtype=torch.int32).to(dev)
    return ref_rows, live_rows, lens


def _path_len(ref_rows: torch.Tensor, live_rows: torch.Tensor, c: int) -> int:
    """Path slots per pair: at most one point per step, t_max + n_max steps."""
    return (live_rows.shape[1] - c) + (ref_rows.shape[1] - c) + 8


def _check(ref_rows: torch.Tensor, live_rows: torch.Tensor, lens: torch.Tensor, cfg: OnlineConfig) -> None:
    dev = live_rows.device
    for name, x, dtype in (("ref_rows", ref_rows, torch.float32), ("live_rows", live_rows, torch.float32),
                           ("lens", lens, torch.int32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, live_rows on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b = live_rows.shape[0]
    if ref_rows.ndim != 3 or live_rows.ndim != 3 or ref_rows.shape[2] != live_rows.shape[2]:
        raise ValueError(f"ref_rows (R, rows, F) and live_rows (B, rows, F) must share F, got "
                         f"{tuple(ref_rows.shape)} and {tuple(live_rows.shape)}")
    if ref_rows.shape[0] not in (1, b):
        raise ValueError(f"ref_rows holds {ref_rows.shape[0]} references for {b} pairs (want 1 or {b})")
    if tuple(lens.shape) != (b, 2):
        raise ValueError(f"lens must have shape ({b}, 2), got {tuple(lens.shape)}")
    if cfg.c < 1:
        raise ValueError(f"band c={cfg.c} must be >= 1")


def batched_set_live(ref_rows: torch.Tensor, live_rows: torch.Tensor, lens: torch.Tensor, cfg: OnlineConfig):
    """Align every pair of a packed batch (:func:`pack`); returns
    ``(path_x, path_y, out)``: (B, P) int32 path points and (B, 8) int32
    ``[plen, t, j, stopped, 0, 0, 0, 0]``.

    CUDA tensors launch the kernel once for the whole batch (and count in
    :data:`launches`); CPU tensors run :func:`batched_set_live_reference`.
    Nothing falls back: a failed build or launch raises."""
    global launches
    if live_rows.device.type == "cpu":
        return batched_set_live_reference(ref_rows, live_rows, lens, cfg)
    _check(ref_rows, live_rows, lens, cfg)
    if live_rows.device.type != "cuda":
        raise ValueError(f"no otw_set_live kernel for device {live_rows.device}")
    from real_time_audio_sync_tpu_torch.ops import _build

    lib = _build.load("otw_set_live").lib
    c = cfg.c
    b, f = live_rows.shape[0], live_rows.shape[2]
    p_len = _path_len(ref_rows, live_rows, c)
    dev = live_rows.device
    path_x = torch.zeros((b, p_len), dtype=torch.int32, device=dev)
    path_y = torch.zeros((b, p_len), dtype=torch.int32, device=dev)
    out = torch.zeros((b, N_OUT), dtype=torch.int32, device=dev)
    work = window_workspace(lib, c, b, dev)  # None: the windows fit in shared memory
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.otw_set_live(
            ref_rows.data_ptr(), live_rows.data_ptr(), lens.data_ptr(), path_x.data_ptr(), path_y.data_ptr(),
            out.data_ptr(), None if work is None else work.data_ptr(), b, c, f, p_len, ref_rows.shape[1], live_rows.shape[1], int(ref_rows.shape[0] == 1),
            cfg.sentinel, cfg.max_run_count, cfg.run_count_init, int(cfg.monotone_path), int(cfg.euclidean),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"otw_set_live launch failed (c={c}): {lib.otw_set_live_error_string(err).decode()}")
    launches += 1
    return path_x, path_y, out


# ---------------------------------------------------------------------------
# The kernel's scan schedule, modelled on tensors (for the tests)
# ---------------------------------------------------------------------------


def warp_minplus_scan(b: torch.Tensor, cost: torch.Tensor, c: int) -> torch.Tensor:
    """The kernel's min-plus scan (``warp_minplus_scan`` in
    ``csrc/otw_band_warp.cuh``) on (32, P) tensors: band position 32k + lane
    at [lane, k], P the band's 32-position groups rounded up to a power of
    two (``warp_band_regs``), positions above c holding ``inf``.  At a lane
    shift s < 32 every lane takes register k of lane (lane − s) mod 32 (one
    shuffle) when lane ≥ s and register k−1 of it otherwise (none for
    k = 0); at s = 32q every register k ≥ q takes register k−q of its own
    lane.  Every stage runs, as in the kernel: one with s > c changes only
    positions above c.  The same stages and operands as
    :func:`ops.otw_insert._minplus_doubling` on ``b``, ``cost`` (c+1,) for
    every position up to c; returns the (c+1,) scan."""
    regs = 1
    while regs < (c + 32) // 32:
        regs *= 2
    if regs > 32:
        raise ValueError(f"band c={c} is wider than one warp's 32 x 32 positions")

    def lanes(x: torch.Tensor) -> torch.Tensor:
        padded = torch.full((32 * regs,), float("inf"), dtype=x.dtype, device=x.device)
        padded[: c + 1] = x
        return padded.reshape(regs, 32).T

    r, cv = lanes(b), lanes(cost)
    lane = torch.arange(32, device=b.device)[:, None]
    k = torch.arange(regs, device=b.device)[None, :]
    for s in (1, 2, 4, 8, 16):
        r_sh, c_sh = torch.roll(r, s, 0), torch.roll(cv, s, 0)  # __shfl_sync from lane (lane - s) & 31
        same = lane >= s
        r_src = torch.where(same, r_sh, torch.roll(r_sh, 1, 1))  # register k-1 of that lane
        c_src = torch.where(same, c_sh, torch.roll(c_sh, 1, 1))
        take = same | (k > 0)
        r, cv = torch.where(take, torch.minimum(r, r_src + cv), r), torch.where(take, c_src + cv, cv)
    q = 1
    while q < regs:
        r_src, c_src = torch.roll(r, q, 1), torch.roll(cv, q, 1)
        take = k >= q
        r, cv = torch.where(take, torch.minimum(r, r_src + cv), r), torch.where(take, c_src + cv, cv)
        q *= 2
    return r.T.reshape(-1)[: c + 1]


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------


def set_live_reference(ref_rows: torch.Tensor, live_rows: torch.Tensor, live_len: int, ref_len: int,
                       cfg: OnlineConfig, p_len: int):
    """Plain PyTorch version of one pair of the kernel, on any device: the
    window on tensors through ``ops/otw_insert``'s band functions, the loop
    of ``_make_set_live_kernel`` (pallas_otw.py:318-381) in Python integers.
    ``ref_rows`` (c + ≥N, F) and ``live_rows`` (c + ≥T, F) are one pair's
    padded rows.  Returns ``(path_x (p_len,), path_y, out (8,))``."""
    c = cfg.c
    dev = live_rows.device
    w = torch.full((c + 1, c + 1), float(cfg.sentinel), dtype=torch.float32, device=dev)
    w[c, c] = _cost(live_rows[c : c + 1], ref_rows[c], cfg.euclidean)[0]  # the origin
    path_x = torch.zeros(p_len, dtype=torch.int32, device=dev)
    path_y = torch.zeros(p_len, dtype=torch.int32, device=dev)
    live_cap = 2 * ref_len  # pre-allocated live capacity (otw_eran.py:14)
    t = j = plen = 0
    rc, prev, lastx, lasty = cfg.run_count_init, PREV_NONE, -1, -1
    for _ in range(live_len + ref_len):  # every step advances t or j
        x, y = best_point(w, t, j, c)
        plen, lastx, lasty = append_point(path_x, path_y, x, y, plen, lastx, lasty, cfg)
        d, rc, prev = set_direction(x, y, t, j, rc, prev, cfg)
        done = False
        if d != COL:
            t += 1
            if t >= live_len or t >= live_cap:
                done = True  # and no column step in this iteration
            else:
                row_update(w, ref_rows, live_rows, t, j, cfg)
        if d != ROW and not done:
            j += 1
            if j >= ref_len:
                done = True
            else:
                col_update(w, ref_rows, live_rows, t, j, cfg)
        if done:
            break
    out = torch.tensor([plen, t, j, int(j >= ref_len)] + [0] * (N_OUT - 4), dtype=torch.int32, device=dev)
    return path_x, path_y, out


def batched_set_live_reference(ref_rows: torch.Tensor, live_rows: torch.Tensor, lens: torch.Tensor,
                               cfg: OnlineConfig):
    """Plain version of :func:`batched_set_live`: one
    :func:`set_live_reference` per pair, stacked into the kernel's outputs."""
    _check(ref_rows, live_rows, lens, cfg)
    p_len = _path_len(ref_rows, live_rows, cfg.c)
    per_pair = [
        set_live_reference(ref_rows[0 if ref_rows.shape[0] == 1 else i], live_rows[i], t, n, cfg, p_len)
        for i, (t, n) in enumerate(lens.tolist())
    ]
    return tuple(torch.stack(parts) for parts in zip(*per_pair))


# ---------------------------------------------------------------------------
# The public functions (the JAX package's names and signatures, plus device)
# ---------------------------------------------------------------------------


def _results(path_x: torch.Tensor, path_y: torch.Tensor, out: torch.Tensor) -> List[Result]:
    px, py, out = (x.cpu().numpy() for x in (path_x, path_y, out))
    return [(np.stack([px[i, : out[i, 0]], py[i, : out[i, 0]]], axis=1), int(out[i, 1]), int(out[i, 2]),
             bool(out[i, 3])) for i in range(out.shape[0])]


def _checked(refs, lives, c: int, device) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    refs = [_features(r, device) for r in refs]
    lives = [_features(l, device) for l in lives]
    if len(lives) != len(refs):
        raise ValueError(f"{len(refs)} refs vs {len(lives)} lives")
    if min(r.shape[1] for r in refs) < c:
        raise ValueError("reference shorter than the search band")
    f = refs[0].shape[0]
    if any(x.ndim != 2 or x.shape[0] != f for x in refs + lives):
        raise ValueError(f"every ref and live must be (F, frames) with the feature dim F = {f}")
    return refs, lives


def pallas_set_live(ref, live, params, *, monotone_path=False, euclidean=False, sentinel=1e10, run_count_init=1,
                    device="cuda") -> Result:
    """Batch-align one pair (reference (F, N), live (F, T)) on ``device``.

    Returns ``(path (L, 2) int32 numpy, live_ptr, ref_ptr, stopped)``, as
    the JAX package's ``pallas_set_live``: one launch at B = 1."""
    cfg = _config(params, sentinel, run_count_init, monotone_path, euclidean)
    device = torch.device(device)
    (ref,), (live,) = _checked([ref], [live], cfg.c, device)
    return _results(*batched_set_live(*pack([ref], [live], cfg.c), cfg))[0]


def pallas_batched_set_live(refs, lives, params, *, monotone_path=False, euclidean=False, sentinel=1e10,
                            run_count_init=1, device="cuda") -> List[Result]:
    """Batch-align B pairs on ``device`` in one launch.

    ``refs``/``lives``: sequences of (F, Nᵢ)/(F, Tᵢ) arrays or tensors
    (ragged; each pair's own lengths drive its stop).  Returns the per-pair
    ``(path, live_ptr, ref_ptr, stopped)`` of :func:`pallas_set_live`."""
    cfg = _config(params, sentinel, run_count_init, monotone_path, euclidean)
    device = torch.device(device)
    refs, lives = _checked(refs, lives, cfg.c, device)
    return _results(*batched_set_live(*pack(refs, lives, cfg.c), cfg))
