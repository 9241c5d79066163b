"""Anti-diagonal wavefront DP for the DTW-family recurrences and its
backtrack: the CUDA kernels' wrappers and their plain PyTorch versions.

Replaces the TPU kernels ``real_time_audio_sync_tpu/ops/pallas_wavefront.py``
``wavefront_dp_pallas`` (:111, body ``_dp_kernel`` :48) and
``backtrack_pallas`` (:181, body ``_make_backtrack_kernel`` :147); the CUDA
source is ``csrc/wavefront.cu``.  The JAX package's ``ops/wavefront.py``
(:40-186) holds the step conventions and the ``lax.scan`` versions that
the plain versions here follow.

Every cell ``(i, j)`` takes the first minimum, in the spec's candidate
order, of ``nb + w·cost[i, j]`` over its left ``acc[i, j-1]``, up
``acc[i-1, j]`` and diagonal ``acc[i-1, j-1]`` neighbours (``+inf``
outside the matrix), compared with strict ``<`` as ``np.argmin`` does; the
corner is ``acc[0, 0] = cost[0, 0]`` with the spec's corner code.  Both
versions do each candidate as one multiply and one add in the cost's
dtype, so they agree bit for bit, and with the JAX package's scan version
on the same cost (and its Pallas kernel, which computes in float32, on a
float32 cost).

The TPU's skewed (diagonal-major) layout is a Mosaic layout device: here
``acc`` and ``back`` are row-major (M, N) and the plain version indexes
each anti-diagonal directly.  The DP kernel sweeps strips of rows, one
warp each, and each strip hands its bottom row to the strip below through
a zeroed workspace that the wrapper allocates at the size the library
gives (``wavefront_dp_workspace_bytes``); the backtrack kernel stages tiles
of ``back`` in shared memory (the design is in the source's header).

Backtrack contract (as the JAX package's): ``points`` (M+N-1, 2) int32,
the path from (M-1, N-1) back to (0, 0), then (0, 0) repeated; ``length``
the points up to and including the origin.  A step that would leave the
matrix (only a non-finite cost can ask for one) stops at row or column 0.

Both functions also take a leading batch axis: B matrices of one shape,
(B, M, N), give (B, M, N) ``acc`` and ``back``, (B, M+N-1, 2) ``points``
and (B,) ``length``, each matrix as if alone.  On the card a batch is one
launch of each kernel with the batch on its grid (the 2-D call is its
B = 1 case); the streaming WTW engines run the windows that come due in a
block this way (``models/wtw_async.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

#: launches of each CUDA kernel in this process (the plain versions do not
#: count), for (M, N) input and for a (B, M, N) batch apart; a caller may
#: reset them to 0 before the run it wants to inspect
dp_launches = 0
backtrack_launches = 0
dp_batched_launches = 0
backtrack_batched_launches = 0


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """DP step convention: candidates in tie-priority order."""

    # (di, dj) of each candidate, in the order the reference compares them
    steps: Tuple[Tuple[int, int], ...]
    # multiplier applied to the cell cost for each candidate
    weights: Tuple[float, ...]
    # back-pointer code recorded for each candidate
    codes: Tuple[int, ...]
    # back-pointer code of the (0, 0) corner
    corner_code: int


#: dtw.py:30-40: (left, up, diag), diagonal weighted 2x, codes 0/1/2, corner 2
DTW_SPEC = StepSpec(steps=((0, -1), (-1, 0), (-1, -1)), weights=(1.0, 1.0, 2.0), codes=(0, 1, 2), corner_code=2)
#: wtw.py:173-217: (up, left, diag), unweighted, codes 3/1/2, corner 0
WTW_SPEC = StepSpec(steps=((-1, 0), (0, -1), (-1, -1)), weights=(1.0, 1.0, 1.0), codes=(3, 1, 2), corner_code=0)

# candidate kinds the kernel takes, by step
_KIND = {(0, -1): 0, (-1, 0): 1, (-1, -1): 2}
_N_CODES = 4  # back codes 0..3 (both specs)


def _check_spec(spec: StepSpec) -> None:
    if len(spec.steps) != 3 or sorted(spec.steps) != sorted(_KIND):
        raise ValueError(f"spec steps must be the left, up and diagonal steps in some order, got {spec.steps}")
    if len(spec.weights) != 3 or len(spec.codes) != 3:
        raise ValueError("spec needs one weight and one code per step")
    if not all(0 <= c < _N_CODES for c in (*spec.codes, spec.corner_code)):
        raise ValueError(f"back codes must lie in 0..{_N_CODES - 1}, got {spec.codes} / {spec.corner_code}")


def _check_matrix(x: torch.Tensor, name: str, dtypes) -> None:
    if x.ndim not in (2, 3) or x.numel() == 0:
        raise ValueError(f"{name} must be a non-empty (M, N) matrix or a non-empty (B, M, N) batch of them, "
                         f"got shape {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {x.dtype}")


def _step_table(spec: StepSpec):
    """(di, dj) of each back code 0..3; codes the spec does not use stay (0, 0)."""
    table = [(0, 0)] * _N_CODES
    for step, code in zip(spec.steps, spec.codes):
        table[code] = step
    return table


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------


def _library():
    from real_time_audio_sync_tpu_torch.ops import _build

    return _build.load("wavefront").lib


def _launch(fn_name: str, x: torch.Tensor, *args) -> None:
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed (shape {tuple(x.shape)}): "
                           f"{lib.wavefront_error_string(err).decode()}")


def wavefront_dp(cost: torch.Tensor, spec: StepSpec = DTW_SPEC,
                 unroll: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(acc, back)`` of the DP over ``cost`` (M, N), or over each matrix
    of a (B, M, N) batch: ``acc`` in the cost's dtype (float32 or float64),
    ``back`` int8 codes per ``spec``.  ``unroll`` is the JAX package's
    tracing switch (straight-line code instead of a loop, the same result);
    it is accepted and ignored.

    A CUDA tensor launches the kernel once, the batch on its grid (counted
    in :data:`dp_launches`, or :data:`dp_batched_launches` for a batch), a
    CPU tensor runs :func:`wavefront_dp_reference`; nothing falls back."""
    global dp_launches, dp_batched_launches
    if cost.device.type == "cpu":
        return wavefront_dp_reference(cost, spec)
    _check_spec(spec)
    _check_matrix(cost, "cost", (torch.float32, torch.float64))
    if cost.device.type != "cuda":
        raise ValueError(f"no wavefront kernel for device {cost.device}")
    if not cost.is_contiguous():
        raise ValueError("cost must be contiguous")
    batched = cost.ndim == 3
    b = cost.shape[0] if batched else 1
    m, n = cost.shape[-2:]
    acc = torch.empty_like(cost)
    back = torch.empty(cost.shape, dtype=torch.int8, device=cost.device)
    kinds = [_KIND[s] for s in spec.steps]
    is_double = int(cost.dtype == torch.float64)
    # the strips' ticket and the rows they hand down, zeroed, as the library sizes it
    ws_bytes = _library().wavefront_dp_workspace_bytes(b, m, n, is_double)
    workspace = torch.zeros(ws_bytes, dtype=torch.uint8, device=cost.device)
    _launch("wavefront_dp", cost, cost.data_ptr(), acc.data_ptr(), back.data_ptr(), b, m, n, is_double, *kinds,
            *(float(w) for w in spec.weights), *spec.codes, spec.corner_code, workspace.data_ptr())
    if batched:
        dp_batched_launches += 1
    else:
        dp_launches += 1
    return acc, back


def backtrack(back: torch.Tensor, spec: StepSpec = DTW_SPEC,
              unroll: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(points, length)`` of the path through ``back`` (M, N) int8, or
    through each matrix of a (B, M, N) batch, on ``back``'s device
    (contract in the module docstring).  ``unroll`` is accepted and
    ignored, as in :func:`wavefront_dp`.

    A CUDA tensor launches the kernel once, a warp a matrix (counted in
    :data:`backtrack_launches`, or :data:`backtrack_batched_launches` for a
    batch), a CPU tensor runs :func:`backtrack_reference`; nothing falls
    back."""
    global backtrack_launches, backtrack_batched_launches
    if back.device.type == "cpu":
        return backtrack_reference(back, spec)
    _check_spec(spec)
    _check_matrix(back, "back", (torch.int8,))
    if back.device.type != "cuda":
        raise ValueError(f"no backtrack kernel for device {back.device}")
    if not back.is_contiguous():
        raise ValueError("back must be contiguous")
    batched = back.ndim == 3
    b = back.shape[0] if batched else 1
    m, n = back.shape[-2:]
    points = torch.empty((*back.shape[:-2], m + n - 1, 2), dtype=torch.int32, device=back.device)
    length = torch.empty(back.shape[:-2], dtype=torch.int32, device=back.device)
    table = _step_table(spec)
    _launch("wavefront_backtrack", back, back.data_ptr(), points.data_ptr(), length.data_ptr(), b, m, n,
            *(di for di, _ in table), *(dj for _, dj in table))
    if batched:
        backtrack_batched_launches += 1
    else:
        backtrack_launches += 1
    return points, length


# ---------------------------------------------------------------------------
# The plain PyTorch versions
# ---------------------------------------------------------------------------


def wavefront_dp_reference(cost: torch.Tensor, spec: StepSpec = DTW_SPEC) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the DP kernel, on any device, for (M, N)
    or (B, M, N) ``cost``: one vectorised update per anti-diagonal (over
    the batch too) on an inf-bordered copy of ``acc`` (row i+1, column
    j+1 ↔ cell (i, j)), so every neighbour is a fixed offset of the cell's
    flat index."""
    _check_spec(spec)
    _check_matrix(cost, "cost", (torch.float32, torch.float64))
    batched = cost.ndim == 3
    cost3 = cost if batched else cost[None]
    b, m, n = cost3.shape
    dev = cost.device
    accp = torch.full((b, m + 1, n + 1), float("inf"), dtype=cost.dtype, device=dev)
    back = torch.empty((b, m, n), dtype=torch.int8, device=dev)
    flat, cflat, bflat = accp.view(b, -1), cost3.contiguous().view(b, -1), back.view(b, -1)
    offset = {0: 1, 1: n + 1, 2: n + 2}  # left, up, diag: flat distance back from the cell
    kinds = [_KIND[s] for s in spec.steps]
    accp[:, 1, 1] = cflat[:, 0]
    bflat[:, 0] = spec.corner_code
    for d in range(1, m + n - 1):
        i = torch.arange(max(0, d - n + 1), min(d, m - 1) + 1, device=dev)
        j = d - i
        c = cflat[:, i * n + j]
        p = (i + 1) * (n + 1) + (j + 1)
        best = code = None
        for kind, w, bcode in zip(kinds, spec.weights, spec.codes):
            cand = flat[:, p - offset[kind]] + w * c
            if best is None:
                best, code = cand, torch.full_like(cand, bcode, dtype=torch.int8)
            else:
                take = cand < best  # strict < keeps the first minimum
                best = torch.where(take, cand, best)
                code = torch.where(take, bcode, code)
        flat[:, p] = best
        bflat[:, i * n + j] = code
    acc = accp[:, 1:, 1:].contiguous()
    return (acc, back) if batched else (acc[0], back[0])


def backtrack_reference(back: torch.Tensor, spec: StepSpec = DTW_SPEC) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backtrack kernel: a Python loop over a host
    copy of each (M, N) matrix of ``back`` (or of the one matrix) with the
    spec's code → step table; the result lies on ``back``'s device."""
    _check_spec(spec)
    _check_matrix(back, "back", (torch.int8,))
    m, n = back.shape[-2:]
    codes = back.cpu().numpy().reshape(-1, m, n)
    table = _step_table(spec)
    max_len = m + n - 1
    all_pts, lengths = [], []
    for mat in codes:
        pts = []
        i, j = m - 1, n - 1
        while True:
            pts.append((i, j))
            if i == 0 and j == 0:
                break
            code = int(mat[i, j])
            di, dj = table[code] if 0 <= code < _N_CODES else (0, 0)
            i, j = max(i + di, 0), max(j + dj, 0)
            if len(pts) == max_len:
                break
        lengths.append(len(pts))
        all_pts.append(pts + [(i, j)] * (max_len - len(pts)))
    points = torch.tensor(all_pts, dtype=torch.int32).reshape(*back.shape[:-2], max_len, 2).to(back.device)
    length = torch.tensor(lengths, dtype=torch.int32).reshape(back.shape[:-2]).to(back.device)
    return points, length
