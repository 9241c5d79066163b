"""The wavefront kernels' Hopper designs (``csrc/wavefront.cu``) modelled on
the CPU, against their plain versions (``ops/wavefront.py``):

- the DP kernel's strip schedule: a warp of 32 lanes (a vector) sweeps a
  strip of 32·R rows, lane l computing column t - l of its R rows at step
  t; the up neighbour comes from lane l-1 by a shift (``__shfl_up_sync``),
  the diagonal is the previous step's up, and lane 0 takes both from the
  row above the strip, handed down chunk by chunk as tagged words that the
  model checks were all written before it reads them; cost enters through
  a three-tile shared ring and acc and back leave through a two-tile ring
  at the kernel's ring columns, stored a chunk at a time; after the first
  phase, lanes past the last column compute from whatever the rings hold;
- the backtrack kernel: 64 × 64 tiles of ``back`` anchored at the current
  cell and clipped at row and column 0, staged from 4-byte words realigned
  by a funnel shift (at every alignment of the matrix's first byte), each
  code turned into the byte offset of its step (the clamp at row and
  column 0 and the origin folded in) with off-tile bytes of 0 around the
  tile; the chase in batches of up to 32 untested steps, each batch
  checked for the first address off the tile or at the origin; the point
  buffer's limit, and the frozen tail.

The model's constants are read from the CUDA source, so it follows the
kernel's rows a lane, chunk, rings and tile.  Tolerance: zero
(``torch.equal``); each cell is the plain version's multiply, add and
strict compare on the same operands.  Ring slots that hold no cost yet are
NaN in the model, so a cell that read one would differ.
"""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from real_time_audio_sync_tpu_torch.ops import wavefront as twf  # noqa: E402

SOURCE = (pathlib.Path(twf.__file__).resolve().parent.parent / "csrc" / "wavefront.cu").read_text()


def _const(name: str) -> int:
    m = re.search(rf"constexpr (?:int|unsigned) {name} = ([^;]+);", SOURCE)
    assert m, name
    return int(eval(m.group(1).split("//")[0], {"LANES": 32, "CHUNK": 32, "BT_TILE": 64}))  # noqa: S307


LANES = 32
R = _const("DP_R")
CHUNK = _const("CHUNK")
COST_RING = _const("COST_RING")
OUT_RING = _const("OUT_RING")
BT_TILE = _const("BT_TILE")
BT_STRIDE = _const("BT_STRIDE")
BT_BUF = _const("BT_BUF")
SPECS = {"dtw": twf.DTW_SPEC, "wtw": twf.WTW_SPEC}


# ---------------------------------------------------------------------------
# The DP kernel's strip schedule
# ---------------------------------------------------------------------------


def _first_min(left, up, dg, c, spec):
    """wavefront_step.cuh's first_min on lane vectors: the plain version's
    ``nb + w * c`` per candidate, strict ``<`` in the spec's order."""
    nbs = {(0, -1): left, (-1, 0): up, (-1, -1): dg}
    best = code = None
    for step, w, k in zip(spec.steps, spec.weights, spec.codes):
        cand = nbs[step] + w * c
        if best is None:
            best, code = cand, torch.full(c.shape, k, dtype=torch.int32)
        else:
            take = cand < best
            best = torch.where(take, cand, best)
            code = torch.where(take, torch.tensor(k, dtype=torch.int32), code)
    return best, code


def dp_model(cost: torch.Tensor, spec, rows_per_lane: int = R):
    """(acc, back) of the DP kernel's schedule: strips in ticket order,
    each a sweep of phases of CHUNK steps."""
    m, n = cost.shape
    h = LANES * rows_per_lane
    strips = -(-m // h)
    n_chunks = -(-n // CHUNK)
    dt = cost.dtype
    inf = torch.tensor(float("inf"), dtype=dt)
    lanes = torch.arange(LANES)
    acc = torch.full((m, n), float("nan"), dtype=dt)
    back = torch.full((m, n), -128, dtype=torch.int8)
    # the workspace's edge rows: strip s's bottom row, a tag and a value a column
    tags = torch.zeros((strips, n), dtype=torch.bool)
    edge = torch.zeros((strips, n), dtype=dt)
    for s in range(strips):  # a strip's producer holds an earlier ticket
        row0 = s * h
        rows = min(h, m - row0)
        has_below = row0 + h < m
        cost_ring = torch.full((h, COST_RING), float("nan"), dtype=dt)
        acc_ring = torch.full((h, OUT_RING), float("nan"), dtype=dt)
        code_ring = torch.full((h, OUT_RING), -1, dtype=torch.int32)

        def load_cost(q):
            cols = torch.arange(q * CHUNK, min((q + 1) * CHUNK, n))
            cost_ring[:rows, (q % 3) * CHUNK + cols - q * CHUNK] = cost[row0 : row0 + rows, cols]

        cur = [inf.expand(LANES).clone() for _ in range(rows_per_lane)]
        prev_up = inf.expand(LANES).clone()
        above = inf.expand(LANES).clone()
        load_cost(0)
        for p in range(n_chunks + 1):
            if p + 1 < n_chunks:
                load_cost(p + 1)
            if p < n_chunks and s > 0:
                cols = torch.arange(p * CHUNK, min((p + 1) * CHUNK, n))
                assert bool(tags[s - 1, cols].all()), f"strip {s} read an unwritten word of chunk {p}"
                above = inf.expand(LANES).clone()
                above[: len(cols)] = edge[s - 1, cols]
            cbase, obase = (p % 3) * CHUNK, (p & 1) * CHUNK
            for u in range(CHUNK):
                j = p * CHUNK + u - lanes
                from_lane = torch.roll(cur[-1], 1)  # lane l-1's last row; lane 0's is replaced
                up = from_lane.clone()
                up[0] = above[u]
                dg, prev_up = prev_up, up
                cc = (cbase + u - lanes) % COST_RING
                oc = (obase + u - lanes) % OUT_RING
                for r in range(rows_per_lane):
                    row = lanes * rows_per_lane + r
                    c = cost_ring[row, cc]
                    left = cur[r]
                    v, code = _first_min(left, up, dg, c, spec)
                    if p == 0:  # later phases leave lanes past column N-1 to compute what no cell reads
                        if r == 0 and s == 0:
                            corner = (lanes == 0) & (j == 0)
                            v = torch.where(corner, c, v)
                            code = torch.where(corner, torch.tensor(spec.corner_code, dtype=torch.int32), code)
                        v = torch.where(j >= 0, v, left)
                    cur[r] = v
                    acc_ring[row, oc] = v
                    code_ring[row, oc] = code
                    dg, up = left, v
            if p > 0:  # chunk p-1 complete: its bottom row handed down, then stored a row segment at a time
                q = p - 1
                cols = torch.arange(q * CHUNK, min((q + 1) * CHUNK, n))
                oc = (q & 1) * CHUNK + cols - q * CHUNK
                if has_below:
                    tags[s, cols] = True
                    edge[s, cols] = acc_ring[h - 1, oc]
                acc[row0 : row0 + rows, cols] = acc_ring[:rows][:, oc]
                back[row0 : row0 + rows, cols] = code_ring[:rows][:, oc].to(torch.int8)
        assert not has_below or bool(tags[s].all()), f"strip {s} left words of its bottom row unwritten"
    return acc, back


EDGE_M = [1, 31, 32, 33, 64, 65]
EDGE_N = [1, 7, 31, 32, 33, 100]


def _cost(shape, dtype, kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return torch.ones(shape, dtype=dtype)
    x = rng.random(shape)
    if kind == "inf":
        x[rng.random(shape) < 0.15] = np.inf
        x[0, :] = np.where(rng.random(shape[1]) < 0.5, np.inf, x[0, :])
    return torch.from_numpy(x.astype(np.float32 if dtype == torch.float32 else np.float64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("m", EDGE_M)
def test_dp_model_equals_plain_at_the_strip_and_chunk_edges(m, spec, dtype):
    for n in EDGE_N:
        cost = _cost((m, n), dtype, "random", 100 * m + n)
        acc, back = dp_model(cost, SPECS[spec])
        ref_acc, ref_back = twf.wavefront_dp_reference(cost, SPECS[spec])
        assert torch.equal(acc, ref_acc), (m, n)
        assert torch.equal(back, ref_back), (m, n)


@pytest.mark.parametrize("kind", ["ties", "inf"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("spec", list(SPECS))
def test_dp_model_equals_plain_on_ties_and_infinite_costs(spec, dtype, kind):
    for m, n in ((33, 40), (65, 33), (2 * LANES * R + 1, 9)):
        cost = _cost((m, n), dtype, kind, m + n)
        acc, back = dp_model(cost, SPECS[spec])
        ref_acc, ref_back = twf.wavefront_dp_reference(cost, SPECS[spec])
        assert torch.equal(acc, ref_acc), (m, n)
        assert torch.equal(back, ref_back), (m, n)


@pytest.mark.parametrize("rows_per_lane", [1, 4])
def test_dp_model_holds_at_other_rows_a_lane(rows_per_lane):
    """The schedule does not depend on the kernel's choice of rows a lane."""
    for m, n in ((33, 40), (2 * LANES * rows_per_lane + 3, 35)):
        cost = _cost((m, n), torch.float32, "random", 7 * m + n)
        acc, back = dp_model(cost, twf.DTW_SPEC, rows_per_lane)
        ref_acc, ref_back = twf.wavefront_dp_reference(cost, twf.DTW_SPEC)
        assert torch.equal(acc, ref_acc) and torch.equal(back, ref_back)


# ---------------------------------------------------------------------------
# The backtrack kernel's staged tiles
# ---------------------------------------------------------------------------


def _stage(flat: np.ndarray, misalign: int, n: int, ti: int, tj: int, i: int, deltas: list) -> np.ndarray:
    """The staged tile (as the kernel's shared bytes) of rows ti..i: the
    matrix's bytes lie at addresses misalign + k (``flat`` padded with zero
    bytes to whole words, as the allocation is), read as aligned 4-byte
    words, two rows a warp access, realigned by a funnel shift; off-tile
    bytes are 0."""
    end = misalign + len(flat)
    mem = np.zeros(-(-end // 4) * 4 + 8, np.uint8)
    mem[misalign:end] = flat
    words = mem.view("<u4")
    tile = np.zeros((BT_TILE + 2) * BT_STRIDE, np.int64)
    for r in range(BT_TILE):
        if ti + r > i:
            continue
        p = misalign + (ti + r) * n + tj
        a = p & ~3
        lo = [int(words[(a + 4 * k) // 4]) if a + 4 * k < end else 0 for k in range(17)]
        for k in range(BT_TILE // 4):
            hi = lo[k + 1] if (k < 15 or (p & 3 and a + 64 < end)) else 0
            codes = ((hi << 32 | lo[k]) >> (8 * (p & 3))) & 0xFFFFFFFF
            for b in range(4):
                code = (codes >> (8 * b)) & 0xFF
                d = deltas[code] if code < 4 else 0
                col = 4 * k + b
                if ti + r == 0:
                    d &= 1  # row 0: no step up
                if tj + col == 0:
                    d &= ~1  # column 0: no step left (the origin: none)
                tile[(r + 2) * BT_STRIDE + col] = d
    return tile


def _off_tile(a: int) -> bool:
    return a < 2 * BT_STRIDE or a % BT_STRIDE >= BT_TILE


def backtrack_model(back: torch.Tensor, spec, misalign: int = 0):
    """(points, length) of the backtrack kernel's tiles, batched chase,
    parallel checks and tail."""
    m, n = back.shape
    flat = back.numpy().view(np.uint8).reshape(-1)
    table = twf._step_table(spec)
    deltas = [(BT_STRIDE if di < 0 else 0) + (1 if dj < 0 else 0) for di, dj in table]
    max_len = m + n - 1
    points = np.zeros((max_len, 2), np.int32)
    i, j, s, done = m - 1, n - 1, 0, False
    while not done and s < max_len:
        ti, tj = max(i - (BT_TILE - 1), 0), max(j - (BT_TILE - 1), 0)
        steps = _stage(flat, misalign, n, ti, tj, i, deltas)
        origin = 2 * BT_STRIDE if ti == 0 and tj == 0 else -1
        limit = min(max_len - s, BT_BUF)
        a = (i - ti + 2) * BT_STRIDE + (j - tj)
        buf, prev, off = [], None, None
        while len(buf) < limit:
            kk = min(limit - len(buf), LANES)
            batch = []
            for _ in range(kk):  # lane 0: no test a step
                batch.append(a)
                a -= int(steps[a])
                assert 0 <= a < len(steps)
            bad = [q for q, v in enumerate(batch) if _off_tile(v)]  # the warp's ballots
            org = [q for q, v in enumerate(batch) if v == origin]
            fb = bad[0] if bad else LANES
            fo = org[0] if org else LANES
            if fo < fb:
                buf += batch[: fo + 1]
                done = True
                break
            if fb < LANES:
                prev, off = (buf + batch)[len(buf) + fb - 1], batch[fb]
                buf += batch[:fb]
                break
            buf += batch
            if _off_tile(a):
                prev, off = buf[-1], a
                break
        if done:
            i = j = 0
        elif prev is not None:
            step = prev - off
            i = ti + prev // BT_STRIDE - 2 - (step >= BT_STRIDE)
            j = tj + prev % BT_STRIDE - (step & 1)
            assert i >= ti - 1 and j >= tj - 1 and (i < ti or j < tj)
        else:
            assert not _off_tile(a)
            i, j = ti + a // BT_STRIDE - 2, tj + a % BT_STRIDE
        for q, b in enumerate(buf):
            assert not _off_tile(b)
            points[s + q] = (ti + b // BT_STRIDE - 2, tj + b % BT_STRIDE)
        s += len(buf)
    points[s:] = (i, j)
    return torch.from_numpy(points), torch.tensor(s, dtype=torch.int32)


def _assert_backtrack_equal(back, spec, misaligns=(0, 1, 2, 3)):
    ref_pts, ref_len = twf.backtrack_reference(back, spec)
    for misalign in misaligns:
        pts, ln = backtrack_model(back, spec, misalign)
        assert torch.equal(pts, ref_pts), misalign
        assert int(ln) == int(ref_len), misalign


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("shape", [(1, 1), (1, 70), (70, 1), (63, 64), (65, 65), (130, 97), (200, 7)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_backtrack_model_equals_plain_on_dp_paths(shape, spec):
    cost = _cost(shape, torch.float32, "random", shape[0] * 1000 + shape[1])
    _, back = twf.wavefront_dp_reference(cost, SPECS[spec])
    _assert_backtrack_equal(back, SPECS[spec])


@pytest.mark.parametrize("spec", list(SPECS))
def test_backtrack_model_equals_plain_with_infinite_costs(spec):
    """Non-finite costs ask for steps off the matrix: the clamp at row and
    column 0 (WTW's up code from row 0 stays there to the end)."""
    for m, n in ((40, 90), (90, 40), (70, 70)):
        _, back = twf.wavefront_dp_reference(_cost((m, n), torch.float32, "inf", m * n), SPECS[spec])
        _assert_backtrack_equal(back, SPECS[spec], misaligns=(0, 3))


@pytest.mark.parametrize("code", [0, 1, 2, 3, 7, -1])
def test_backtrack_model_equals_plain_along_row_and_column_zero(code):
    """Every cell one code: the path runs straight to row or column 0 and
    is clamped there (or never moves: an unknown code), until max_len."""
    for m, n in ((3, 150), (150, 3), (66, 66)):
        back = torch.full((m, n), code, dtype=torch.int8)
        for spec in SPECS.values():
            _assert_backtrack_equal(back, spec, misaligns=(0, 1))


def test_backtrack_model_equals_plain_on_random_codes():
    """Random codes, unknown ones included, so paths stall, wrap the
    buffer and leave tiles every way."""
    rng = np.random.default_rng(16)
    for m, n in ((5, 5), (97, 131), (300, 40), (40, 300)):
        back = torch.from_numpy(rng.integers(-2, 6, (m, n)).astype(np.int8))
        for spec in SPECS.values():
            _assert_backtrack_equal(back, spec, misaligns=(0, 2))
