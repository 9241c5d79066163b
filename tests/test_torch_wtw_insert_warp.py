"""The streaming WTW kernel's Hopper design (``csrc/wtw_insert.cu``)
modelled on the CPU, launch by launch, against its plain version
(``ops/wtw_insert.wtw_insert_block_reference``):

- the column loop's decisions taken from the scalars as every thread holds
  them, the columns staged COLS_STAGE at a time, a window's live rows read
  from the staged columns (this stage's) or from the live history (earlier
  ones), the stage's appended rows written out at its end;
- each window's cost fused into the DP: a lane's live row and norm against
  the reference window's rows, a dot and a squared norm a sequential sum
  over f of rounded products, the column clamped into the window where a
  lane is off it (the kernel makes each cost in stages a step apart, and
  its division checks its own rounding; the model computes the same
  correctly rounded operations at once);
- the systolic DP: each warp's 32 lanes as a vector, lane l computing
  column t - l at step t, the up neighbour lane l-1's value by a shift (the
  shuffle), the diagonal the previous step's up, and lane 0 taking both
  from the row above its warp, which that warp hands down as tagged 64-bit
  words (the model runs the warps one after another, a schedule the tags
  allow, and checks that every word a warp reads carries the window's tag);
  each cell stores its step as the byte offset to subtract, the clamps at
  row and column 0 and the origin folded in;
- the chase in batches of CHASE_BATCH untested steps until the origin or
  2w - 1 points, the path's length and its committed suffix found by
  ballots over 32 entries, the commit with its overflow bit, and the
  pointer advance.

The model's constants are read from the CUDA source.  Tolerance: zero
(``torch.equal`` on rows, scalars and the live history after every
launch); every cost and cell is the plain version's float32 operations on
the same operands.
"""

import math
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from real_time_audio_sync_tpu_torch.ops import wtw_insert as tw  # noqa: E402
from real_time_audio_sync_tpu_torch.ops.wavefront import WTW_SPEC, _step_table  # noqa: E402

SOURCE = (pathlib.Path(tw.__file__).resolve().parent.parent / "csrc" / "wtw_insert.cu").read_text()
_CONSTS = {}
for _name in ("LANES", "F", "MAX_W", "GROUP", "FIRST_GROUPS", "COLS_STAGE", "CHASE_BATCH"):
    _m = re.search(rf"constexpr int {_name} = ([^;]+);", SOURCE)
    assert _m, _name
    _CONSTS[_name] = int(eval(_m.group(1).replace("/", "//"), {}, dict(_CONSTS)))  # noqa: S307
LANES, F, MAX_W = _CONSTS["LANES"], _CONSTS["F"], _CONSTS["MAX_W"]
GROUP, FIRST_GROUPS = _CONSTS["GROUP"], _CONSTS["FIRST_GROUPS"]
COLS_STAGE, CHASE_BATCH = _CONSTS["COLS_STAGE"], _CONSTS["CHASE_BATCH"]
INF = np.float32(np.inf)
# nb of each candidate kind: left 0, up 1, diagonal 2 (the kernel's template arguments)
_KINDS = [{(0, -1): 0, (-1, 0): 1, (-1, -1): 2}[s] for s in WTW_SPEC.steps]


def _per_candidate_steps():
    """(up, left) flags of each candidate's step, as the library's
    ``set_steps`` derives them from the spec's codes and its step table."""
    table = _step_table(WTW_SPEC)
    up, left = [], []
    for code in WTW_SPEC.codes:
        di, dj = table[code] if 0 <= code < 4 else (0, 0)
        up.append(int(di < 0))
        left.append(int(dj < 0))
    return np.array(up), np.array(left)


UP, LEFT = _per_candidate_steps()


def _sqrt_rn(s):
    return np.sqrt(s.astype(np.float64)).astype(np.float32)


def _norms(v):
    s = np.zeros(v.shape[:-1], np.float32)
    for f in range(F):
        s = s + v[..., f] * v[..., f]
    return _sqrt_rn(s)


def _first_min(left, up, dg, c):
    """wavefront_step.cuh's first_min on lane vectors, returning the
    candidate's index (the kernel's codes 0, 1, 2)."""
    nb = (left, up, dg)
    best = cand = None
    for k, (kind, wt) in enumerate(zip(_KINDS, WTW_SPEC.weights)):
        val = nb[kind] + np.float32(wt) * c
        if best is None:
            best, cand = val, np.zeros(c.shape, np.int64)
        else:
            take = val < best
            best = np.where(take, val, best)
            cand = np.where(take, k, cand)
    return best, cand


def _window(x_all, ys, w, n_win):
    """The systolic DP of one window: ``x_all`` (w, F) live rows, ``ys``
    (w, F) reference rows; returns the (w*w,) step offsets."""
    nx_all, ny = _norms(x_all), _norms(ys)
    warps = -(-w // LANES)
    hand = np.zeros((max(warps - 1, 0), w), np.uint64)
    steps = np.full(w * w, 255, np.int64)  # every cell is stored before the chase reads it
    lanes = np.arange(LANES)
    for q in range(warps):
        below = q < warps - 1
        n_steps = w + (LANES if below else w - q * LANES) - 1
        n_groups = -(-n_steps // GROUP)
        ri = q * LANES + lanes  # each lane's DP row
        xi = np.minimum(ri, w - 1)
        x, nx = x_all[xi], nx_all[xi]
        # the fused cost of every step a lane takes (and a group past them), in the kernel's order
        jj = np.clip(np.arange((n_groups + 1) * GROUP)[:, None] - lanes[None, :], 0, w - 1)
        d = np.zeros(jj.shape, np.float32)
        for f in range(F):
            d = d + x[None, :, f] * ys[jj][:, :, f]
        cost = np.float32(1) - d / (nx[None, :] * ny[jj])
        o_up = np.where(UP[:, None].astype(bool) & (ri[None] > 0), w, 0)  # (3, 32)
        cur = np.full(LANES, INF, np.float32)
        prev_up = np.full(LANES, INF, np.float32)
        for g in range(n_groups):
            t0 = g * GROUP
            ab = np.full(LANES, INF, np.float32)
            if q > 0:
                col = t0 + (lanes & (GROUP - 1))
                words = hand[q - 1][np.minimum(col, w - 1)]
                ok = (col >= w) | ((words >> np.uint64(32)) == np.uint64(n_win))
                assert ok.all(), "a warp would wait on a word its producer never wrote"
                ab = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.float32)
            for k in range(GROUP):
                t = t0 + k
                j = t - lanes
                from_lane = np.concatenate((cur[:1], cur[:-1]))  # shfl_up by 1
                up = np.where(lanes == 0, ab[k], from_lane)
                dg, prev_up = prev_up, up
                left = cur
                v, cand = _first_min(left, up, dg, cost[t])
                u = o_up[cand, lanes]
                o = u + LEFT[cand]
                if g < FIRST_GROUPS:
                    o = np.where(j == 0, u, o)
                    corner = (q == 0) & (lanes == 0) & (j == 0)
                    v = np.where(corner, cost[t], v)
                    o = np.where(corner, 0, o)
                    v = np.where(j >= 0, v, left)
                cur = v
                keep = (j >= 0) & (j < w) & (ri < w)
                steps[ri[keep] * w + j[keep]] = o[keep]
                jb = t - (LANES - 1)
                if below and 0 <= jb < w:
                    hand[q][jb] = (np.uint64(n_win) << np.uint64(32)) | np.uint64(
                        cur[LANES - 1 : LANES].view(np.uint32)[0])
    assert (steps <= w + 1).all()
    return steps


def _chase(steps, w, hop):
    """(length, points end -> origin as tile offsets, n_c) as the warp
    finds them."""
    maxpts = 2 * w - 1
    buf = [0] * (maxpts + CHASE_BATCH)
    a, s = w * w - 1, 0
    while True:
        for u in range(CHASE_BATCH):
            buf[s + u] = a
            a -= int(steps[a])
        s += CHASE_BATCH
        if a == 0 or s >= maxpts:
            break
    buf[s] = a
    n_scan = min(s + 1, maxpts)
    thr = (min(hop, w - 1) + 1) * w
    length, first_c = maxpts, -1
    for base in range(0, n_scan, LANES):
        v = np.array(buf[base : min(base + LANES, n_scan)])
        zero, com = np.flatnonzero(v == 0), np.flatnonzero(v < thr)
        if first_c < 0 and com.size:
            first_c = base + int(com[0])
        if zero.size:
            length = base + int(zero[0]) + 1
            break
    n_c = 0 if first_c < 0 or first_c >= length else length - first_c
    return length, buf, n_c


def model_launch(state, cols, lens, w, hop, k_block, row):
    """The kernel's launch on a WTWState, in place, as the reference's
    contract."""
    m, n_cap, n_valid = (int(v) for v in lens)
    d_pad = tw.wtw_geometry(w, hop, k_block)[2]
    sc = [int(v) for v in state.scalars]
    cp, lp, rp, plen, fl = sc[tw.WS_CHROMA], sc[tw.WS_LIVE], sc[tw.WS_REF], sc[tw.WS_PLEN], sc[tw.WS_FLAGS]
    lastx, lasty = sc[tw.WS_LASTX], sc[tw.WS_LASTY]
    plen0, n_win = plen, 0
    out = np.zeros(tw.N_STATUS + 2 * d_pad, np.int64)
    dx, dy = out[tw.N_STATUS : tw.N_STATUS + d_pad], out[tw.N_STATUS + d_pad :]
    live = state.live.numpy()
    ref = state.ref.numpy()
    cols = cols.numpy()
    maxpts = 2 * w - 1
    k0 = 0
    while k0 < n_valid and not fl & 1:
        staged = cols[k0 : k0 + min(COLS_STAGE, n_valid - k0)].copy()
        cp_stage = cp
        for _ in range(k0, min(n_valid, k0 + COLS_STAGE)):
            if cp >= n_cap:
                fl |= 1
                break
            cp += 1
            if rp >= m - 1 - w or lp >= n_cap - 1 - w:
                fl |= 1
                break
            if cp - lp < w:
                continue
            n_win += 1
            g = lp + np.arange(w)
            x_all = np.where((g >= cp_stage)[:, None], staged[np.clip(g - cp_stage, 0, len(staged) - 1)],
                             live[np.minimum(g, live.shape[0] - 1)])
            steps = _window(x_all.astype(np.float32), ref[rp : rp + w].copy(), w, n_win)
            length, buf, n_c = _chase(steps, w, hop)
            over = False
            for u in range(n_c):
                a = buf[length - 1 - u]
                dest = plen - plen0 + u
                if dest < d_pad:
                    dx[dest], dy[dest] = a // w + lp, a % w + rp
                else:
                    over = True
            last = min(max(length - n_c, 0), maxpts - 1)
            a = buf[last] if last < length else 0
            li, lj = a // w, a % w
            change = n_c < length
            lastx, lasty = li + lp, lj + rp
            lp, rp = (lp + li, rp + lj) if change else (lp + hop, rp + hop)
            plen += n_c
            fl |= 2 if over else 0
        live[cp_stage:cp] = staged[: cp - cp_stage]
        k0 += COLS_STAGE
    for slot, v in ((tw.WS_CHROMA, cp), (tw.WS_LIVE, lp), (tw.WS_REF, rp), (tw.WS_PLEN, plen),
                    (tw.WS_FLAGS, fl), (tw.WS_LASTX, lastx), (tw.WS_LASTY, lasty)):
        state.scalars[slot] = v
    out[:4] = (fl, plen, lastx, lasty)
    row.copy_(torch.from_numpy(out.astype(np.int32)))


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------


def _unit(x):
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return (x / np.where(n == 0, 1, n)).astype(np.float32)


def _stream(seed, w, hop, scenario, lag=None):
    """(ref (m, F), live rows, m, n_cap, start (cp, lp, rp)).  "run": a
    stream w - 1 columns in, so its first column makes a window due;
    "margin": the live capacity puts live_ptr at n_cap-1-w after the first
    window; "capacity": chroma_ptr one column short of n_cap, w + 3 ahead
    of live_ptr; "lag": chroma_ptr ``lag`` columns ahead of live_ptr, so a
    window falls due at every column; "ties": every reference and live
    frame the same unit vector; "zeros": live frames of zeros here and
    there (non-finite costs: steps off the matrix, paths that never reach
    the origin)."""
    rng = np.random.default_rng(seed)
    m = 3 * w + hop + 10 + (lag or 0)
    n_cap, cp0, lp0 = 2 * m, w - 1, 0
    if scenario == "margin":
        n_cap, cp0 = w + 1 + hop, w - 2
    elif scenario == "capacity":
        cp0 = n_cap - 1
        lp0 = cp0 - (w + 3)
    elif scenario == "lag":
        cp0 = lag
    ref = _unit(rng.random((m, F)) + 0.05)
    path = np.clip(np.cumsum(rng.integers(0, 3, n_cap + 64)) // 2, 0, m - 1)
    live = _unit(ref[path] + 0.1 * rng.random((n_cap + 64, F)))
    if scenario == "ties":
        ref[:] = ref[0]
        live[:] = ref[0]
    elif scenario == "zeros":
        live[rng.random(len(live)) < 0.15] = 0.0
    return ref, live, m, n_cap, (cp0, lp0, 0)


def _run(seed, w, hop, k_block, scenario, max_windows=None, after=2, lag=None):
    """One stream through the model and the plain version launch by launch
    (every third block ragged) until ``after`` frozen launches past the
    stop, or ``max_windows`` windows; asserts equality after every launch.
    Returns the plain state's scalars and the flags seen."""
    ref, live, m, n_cap, (cp0, lp0, rp0) = _stream(seed, w, hop, scenario, lag)
    states = []
    for _ in range(2):
        st = tw.new_state(torch.from_numpy(ref.T.copy()), n_cap)
        st.live[:cp0] = torch.from_numpy(live[:cp0])
        st.scalars[:3] = torch.tensor((cp0, lp0, rp0), dtype=torch.int32)
        states.append(st)
    model, plain = states
    width = tw.delta_width(w, hop, k_block)
    launches, frozen, flags = 0, 0, 0
    while frozen < after:
        assert launches <= 4 * n_cap, "no stop"
        pos = int(plain.scalars[tw.WS_CHROMA])
        n_valid = k_block if launches % 3 != 1 else max(1, k_block - 2)
        cols = np.zeros((k_block, F), np.float32)
        take = live[pos : pos + k_block]
        cols[: len(take)] = take
        rows = [torch.empty(width, dtype=torch.int32) for _ in range(2)]
        with np.errstate(all="ignore"):  # inf - inf and 0 / 0 are the point where they occur
            model_launch(model, torch.from_numpy(cols), (m, n_cap, n_valid), w, hop, k_block, rows[0])
        tw.wtw_insert_block_reference(plain, torch.from_numpy(cols), (m, n_cap, n_valid), w, hop, k_block,
                                      rows[1])
        for name, a, b in (("row", rows[0], rows[1]), ("scalars", model.scalars, plain.scalars),
                           ("live", model.live, plain.live)):
            assert torch.equal(a, b), f"{name} differs at launch {launches}"
        flags |= int(plain.scalars[tw.WS_FLAGS])
        launches += 1
        frozen += int(plain.scalars[tw.WS_FLAGS]) & 1
        if max_windows is not None and int(plain.scalars[tw.WS_LIVE]) >= max_windows * hop + lp0 and not frozen:
            break
    return plain.scalars, flags


# hops a window: one below it and one at or above it (w = 1: both above)
HOPS = {1: (1, 3), 20: (10, 30), 31: (15, 31), 32: (16, 40), 33: (16, 33), 64: (32, 64), 65: (32, 70),
        100: (50, 100), 128: (64, 130)}


@pytest.mark.parametrize("w", sorted(HOPS))
@pytest.mark.parametrize("which", [0, 1], ids=["hop_below_w", "hop_at_or_above_w"])
def test_model_equals_plain_across_the_warp_edges(w, which):
    """Every warp count (1..4), both sides of each warp edge, the one-frame
    window, and the diagonal fallback (hop >= w commits every point)."""
    hop = HOPS[w][which]
    sc, _ = _run(1700 + w + which, w, hop, 8, "run", max_windows=2 if w > 64 else 4)
    assert int(sc[tw.WS_PLEN]) > 0


@pytest.mark.parametrize("k_block", [1, 8, 32])
@pytest.mark.parametrize("scenario", ["run", "margin", "capacity"])
def test_model_stops_and_frozen_launches(k_block, scenario):
    """Two warps (w = 33): the run to the margin stop, a mid-stream margin
    stop and the capacity stop, then two frozen launches."""
    sc, flags = _run(1800 + k_block + len(scenario), 33, 16, k_block, scenario)
    assert flags & 1 and int(sc[tw.WS_FLAGS]) & 1


def test_model_overflow_bit():
    """A stream whose live_ptr lags far behind: a window at every column,
    more committed points than the row's d_pad slots, so the sticky
    overflow bit is set and the slots past d_pad are dropped."""
    _, flags = _run(1900, 20, 20, 32, "lag", lag=300, after=1)
    assert flags & 2


def test_model_all_ties():
    """Every cost of every window equal: each cell decided by the first
    minimum's order."""
    sc, _ = _run(1901, 65, 32, 8, "ties", max_windows=3)
    assert int(sc[tw.WS_PLEN]) > 0


def test_model_non_finite_costs():
    """Zero live frames make NaN costs: steps that would leave the matrix
    stop at row or column 0, and a path stuck there fills 2w - 1 points."""
    _run(1902, 20, 10, 8, "zeros", max_windows=12)
    _run(1903, 33, 16, 8, "zeros", max_windows=6)


def test_model_stages_columns():
    """A k_block above COLS_STAGE: windows that read rows of the launch's
    earlier stage from the live history and of this stage from the staged
    columns."""
    k_block = COLS_STAGE + 9
    _run(1904, 20, 10, k_block, "run", max_windows=8)


def test_constants_fit_the_widest_window():
    assert MAX_W == tw.MAX_W and F == tw.FEATURES
    assert math.ceil(MAX_W / LANES) * LANES <= 1024
    assert FIRST_GROUPS * GROUP == LANES
    assert MAX_W + 1 <= 255  # a step's byte offset (up and left) fits a byte
