"""The set_live kernel's warp schedule (``csrc/otw_band_warp.cuh``: band
position 32k + lane in register k of a lane, the min-plus scan as register
shuffles, the argmins as an in-lane pass and shuffle rounds), modelled on
tensors (the scan by ``ops/otw_set_live.warp_minplus_scan``, the argmins
by ``warp_best_point`` here), against the plain stage order ``ops/otw_insert._minplus_doubling`` and
``best_point``, and against the JAX package's ``_minplus_doubling`` and
``_first_min`` (``ops/pallas_otw.py:87,111``; the scan in a Pallas call in
interpret mode).

Tolerance 0 (``torch.equal``): the model combines the same operands in the
same order as the plain scan, so every value is bit-identical; the argmins
must return the same first minimum.  The bands cover every register count
P of the kernel (1, 2, 4, 8, 16, 32) and both sides of each lane edge.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from real_time_audio_sync_tpu.ops import pallas_otw as jpo  # noqa: E402
from real_time_audio_sync_tpu_torch.ops import otw_insert, otw_set_live  # noqa: E402

BANDS = (1, 10, 31, 32, 33, 50, 63, 64, 200, 237, 238, 400, 511, 512, 1023)
INPUTS = ("random", "ties", "inf_below_lo", "sentinel_init")
SENTINEL = np.float32(1e10)


def warp_regs(c: int) -> int:
    """Band registers a lane of the kernel holds at band ``c``: the band's
    32-position groups rounded up to a power of two (``warp_band_regs``)."""
    groups, p = (c + 32) // 32, 1
    while p < groups:
        p *= 2
    return p


def _lanes(x: torch.Tensor, regs: int, fill) -> torch.Tensor:
    """(c+1,) band positions into the kernel's (32, P) layout: position
    32k + lane at [lane, k]; positions above c hold ``fill``."""
    padded = torch.full((32 * regs,), fill, dtype=x.dtype)
    padded[: x.shape[0]] = x
    return padded.reshape(regs, 32).T.contiguous()


def _warp_first_min(values: torch.Tensor, lo: int, c: int):
    """The kernel's first minimum of ``values`` (c+1,) over positions
    [lo, c]: each register's (value, index), (inf, 2³¹−1) outside the
    range; a tree over a lane's P registers, then 5 shuffle-down rounds,
    both with ``take_min``'s (value, index) order; lane 0's pair kept."""
    regs = warp_regs(c)
    pos = _lanes(torch.arange(c + 1), regs, -1)
    vals = _lanes(values, regs, float("inf"))
    valid = (pos >= lo) & (pos <= c)
    v = torch.where(valid, vals, torch.tensor(float("inf"), dtype=values.dtype))
    i = torch.where(valid, pos, torch.tensor(2**31 - 1))

    def take_min(v, i, v2, i2):
        take = (v2 < v) | ((v2 == v) & (i2 < i))
        return torch.where(take, v2, v), torch.where(take, i2, i)

    h = 1
    while h < regs:  # registers k and k + h, for k a multiple of 2h
        v, i = v.clone(), i.clone()
        v[:, :: 2 * h], i[:, :: 2 * h] = take_min(v[:, :: 2 * h], i[:, :: 2 * h], v[:, h :: 2 * h], i[:, h :: 2 * h])
        h *= 2
    v, i = v[:, 0], i[:, 0]
    off = 16
    while off:
        src = torch.arange(32) + off  # __shfl_down_sync: lanes past 31 keep their own
        inside = src < 32
        src = torch.where(inside, src, torch.arange(32))
        v2, i2 = take_min(v, i, v[src], i[src])
        v, i = torch.where(inside, v2, v), torch.where(inside, i2, i)
        off //= 2
    return float(v[0]), int(i[0])


def warp_best_point(w: torch.Tensor, t: int, j: int, c: int):
    """The kernel's best point (``warp_set_direction``) on window ``w``:
    :func:`_warp_first_min` of row c over [max(c−j, 1), c] and of column c
    over [max(c−t, 1), c]; the row's wins only when strictly smaller, as
    ``ops/otw_insert.best_point``."""
    cost_j, bj = _warp_first_min(w[c], max(c - j, 1), c)
    cost_t, ak = _warp_first_min(w[:, c], max(c - t, 1), c)
    if cost_j < cost_t:
        return t, j - c + bj
    return t - c + ak, j


def _band_inputs(c: int, kind: str, seed: int):
    """(b_m, c_m) as ``_band_step`` builds them before its scan: the band
    [lo, c] with infinities below ``lo``, the first cell's neighbour
    ``init`` folded in at ``lo``."""
    rng = np.random.default_rng(seed)
    n = c + 1
    cost = rng.random(n).astype(np.float32)
    prev = (rng.random(n) * 4).astype(np.float32)
    diag = (rng.random(n) * 4).astype(np.float32)
    lo, init = 1, np.float32(np.inf)
    if kind == "ties":  # equal and zero costs, equal neighbours
        cost = rng.choice(np.array([0.0, 0.25, 0.5], np.float32), n)
        prev = np.full(n, np.float32(1.0))
        diag = rng.choice(np.array([0.0, 1.0], np.float32), n)
    elif kind == "inf_below_lo":
        lo = int(rng.integers(1, n)) if n > 1 else 0
    elif kind == "sentinel_init":
        lo = int(rng.integers(1, n)) if n > 1 else 0
        init = SENTINEL
        prev[rng.random(n) < 0.3] = SENTINEL
    cost, prev, diag = (torch.from_numpy(x) for x in (cost, prev, diag))
    idx = torch.arange(n)
    bvec = torch.minimum(prev + cost, diag + 2 * cost)
    band = idx >= lo
    b_m = torch.where(band, bvec, torch.tensor(float("inf")))
    c_m = torch.where(band, cost, torch.tensor(float("inf")))
    b_m[lo] = torch.minimum(b_m[lo], torch.tensor(init) + c_m[lo])
    return b_m, c_m


def _jax_scan(b: torch.Tensor, cost: torch.Tensor, c: int) -> np.ndarray:
    """The JAX package's ``_minplus_doubling`` over lanes, in a Pallas call
    in interpret mode, on one row padded to whole 128-lane tiles."""
    width = -(-(c + 1) // 128) * 128
    rows = np.zeros((2, 8, width), np.float32)
    rows[0, 0, : c + 1] = b.numpy()
    rows[1, 0, : c + 1] = cost.numpy()

    def kernel(b_ref, c_ref, o_ref):
        o_ref[...] = jpo._minplus_doubling(b_ref[...], c_ref[...], c + 1, 1)

    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((8, width), jnp.float32))(rows[0], rows[1])
    return np.asarray(out)[0, : c + 1]


@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("c", BANDS)
def test_warp_scan_equals_the_plain_and_jax_stage_order(c, kind):
    b, cost = _band_inputs(c, kind, 1000 * c + INPUTS.index(kind))
    want = otw_insert._minplus_doubling(b, cost)
    got = otw_set_live.warp_minplus_scan(b, cost, c)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(_jax_scan(b, cost, c), want.numpy())


def test_warp_regs_cover_every_register_count():
    assert {warp_regs(c) for c in BANDS} == {1, 2, 4, 8, 16, 32}
    assert [warp_regs(c) for c in (31, 32, 63, 64, 511, 512)] == [1, 2, 2, 4, 16, 32]
    b = torch.zeros(1025)
    with pytest.raises(ValueError, match="wider than one warp"):
        otw_set_live.warp_minplus_scan(b, b, 1024)


def _tied_window(c: int, seed: int) -> torch.Tensor:
    """A (c+1)² window whose row c and column c hold their minimum at
    several positions (and the other line's minimum equal to it, half the
    time), so the first minimum and the row-over-column rule decide."""
    rng = np.random.default_rng(seed)
    w = (1.0 + rng.random((c + 1, c + 1))).astype(np.float32)
    m = np.float32(0.5)
    for line in (w[c, :], w[:, c]):
        hits = rng.choice(c + 1, size=min(c + 1, 4), replace=False)
        line[hits] = m
    if seed % 2:
        w[c, rng.integers(0, c + 1)] = np.float32(0.25)  # the row strictly smaller
    return torch.from_numpy(w)


@pytest.mark.parametrize("c", BANDS)
def test_warp_argmin_returns_the_first_minimum(c):
    for case in range(4):
        w = _tied_window(c, 10 * c + case)
        for t, j in ((0, 0), (c // 2, c // 3), (c, c), (2 * c + 5, c + 1), (c + 3, 0)):
            assert warp_best_point(w, t, j, c) == otw_insert.best_point(w, t, j, c), (case, t, j)
        # JAX's _first_min on the same row, over the same band
        lo = max(c - c // 3, 1)
        iota = jnp.arange(c + 1, dtype=jnp.int32)
        row = jnp.asarray(w[c].numpy())
        m, k = jpo._first_min(row, iota >= lo, iota)
        assert _warp_first_min(w[c], lo, c) == (float(m), int(k))
