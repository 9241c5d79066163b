"""The port's banded DP primitives (``ops/band.py``) against the JAX
package's, function by function, on the same numpy inputs, including the
edges where JAX's dynamic slices clamp their start indices (t = 0, j = 0,
pointers past the live buffer or the reference, the path buffer's end).

The port takes a leading stream axis B; one JAX call is the port's call
at B = 1, and a B = 3 port call equals three JAX calls.  Tolerances:

- the sequential chain (``exact=True``) on the same inputs: bit-equal in
  float64;
- the fast chain (the port's Hillis–Steele scan against JAX's
  associative scan, another tree over the same sums): rtol 1e-12 in
  float64, 1e-6 in float32;
- the band updates and ``eval_cell``, whose costs the two packages sum in
  different orders: rtol 1e-12 (float64) on computed cells;
- everywhere, the outputs hold ±inf or the sentinel exactly where JAX's
  do, and ``band_argmin`` gives the same points.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from real_time_audio_sync_tpu.models import online_core as jcore  # noqa: E402
from real_time_audio_sync_tpu.ops import band as jband  # noqa: E402
from real_time_audio_sync_tpu_torch.models import online_core as tcore  # noqa: E402
from real_time_audio_sync_tpu_torch.ops import band as tband  # noqa: E402

F, N = 12, 30
M = 2 * N


def _unit(x):
    return x / np.linalg.norm(x, axis=0, keepdims=True)


def _inputs(seed, dtype=np.float64, sentinel=1e10):
    """A live buffer, a reference and an accumulator whose cells are
    finite, the sentinel or +inf (the uncomputed cells of either engine)."""
    rng = np.random.default_rng(seed)
    live = _unit(rng.random((F, M)) + 0.05).astype(dtype)
    ref = _unit(rng.random((F, N)) + 0.05).astype(dtype)
    acc = (rng.random((M, N)) * 20).astype(dtype)
    acc[rng.random((M, N)) < 0.3] = sentinel
    acc[rng.random((M, N)) < 0.1] = np.inf
    return live, ref, acc


def _t(x):
    return torch.from_numpy(np.array(x))


def _ptr(*v):
    return torch.tensor(v, dtype=torch.int64)


def _same_specials(got, want, sentinel):
    for special in (np.inf, -np.inf, sentinel):
        np.testing.assert_array_equal(got == special, want == special)


def _close(got, want, sentinel, rtol):
    _same_specials(got, want, sentinel)
    finite = np.isfinite(want) & (want != sentinel)
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol, atol=rtol)


@pytest.mark.parametrize("euclidean", [False, True])
@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12), (np.float32, 1e-6)])
def test_cost_vector(euclidean, dtype, rtol):
    live, ref, _ = _inputs(0, dtype)
    want = np.asarray(jband._cost_vector(jnp.asarray(live[:, 5]), jnp.asarray(ref), euclidean))
    got = tband._cost_vector(_t(live[None, :, 5]), _t(ref[None]), euclidean)[0].numpy()
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)


def test_cost_vector_is_the_kernels_sequential_sum():
    """float32: the cost is the kernels' (``csrc/otw_band.cuh``): each term
    rounded, the terms summed in order of f, then ``1 - s`` or a correctly
    rounded root — equal to that sum written out in numpy, bit for bit."""
    rng = np.random.default_rng(1)
    bank = rng.random((F, 64)).astype(np.float32)
    q = rng.random(F).astype(np.float32)
    for euclidean in (False, True):
        got = tband._cost_vector(_t(q[None]), _t(bank[None]), euclidean)[0].numpy()
        terms = (bank - q[:, None]) ** 2 if euclidean else bank * q[:, None]
        s = np.zeros(64, np.float32)
        for f in range(F):
            s = s + terms[f]
        want = np.sqrt(s.astype(np.float64)).astype(np.float32) if euclidean else np.float32(1) - s
        np.testing.assert_array_equal(got, want)


def test_shift_fill_inf():
    v = np.arange(6.0)
    np.testing.assert_array_equal(tband._shift_fill_inf(_t(v[None]))[0].numpy(),
                                  np.asarray(jband._shift_fill_inf(jnp.asarray(v))))


@pytest.mark.parametrize("c", [1, 2, 3, 7, 10, 32, 33, 50])
@pytest.mark.parametrize("r_init", [np.inf, 1e10, 0.5])
def test_minplus_chain(c, r_init):
    rng = np.random.default_rng(c)
    b = rng.random((3, c)) * 10
    b[rng.random((3, c)) < 0.2] = np.inf
    cost = rng.random((3, c))
    r0 = np.full(3, r_init)
    for row in range(3):
        args = (jnp.asarray(b[row]), jnp.asarray(cost[row]), jnp.asarray(r_init))
        want_exact = np.asarray(jband._minplus_chain(*args, exact=True))
        want_fast = np.asarray(jband._minplus_chain(*args, exact=False))
        got_exact = tband._minplus_chain(_t(b), _t(cost), _t(r0), exact=True)[row].numpy()
        got_fast = tband._minplus_chain(_t(b), _t(cost), _t(r0), exact=False)[row].numpy()
        np.testing.assert_array_equal(got_exact, want_exact)  # bit-equal
        _close(got_fast, want_fast, 1e10, 1e-12)
    # float32: the fast chain within 1e-6
    b32, c32 = b.astype(np.float32), cost.astype(np.float32)
    got = tband._minplus_chain(_t(b32), _t(c32), _t(r0.astype(np.float32)), exact=False).numpy()
    for row in range(3):
        want = np.asarray(jband._minplus_chain(jnp.asarray(b32[row]), jnp.asarray(c32[row]),
                                               jnp.asarray(np.float32(r_init)), exact=False))
        _close(got[row], want, np.float32(1e10), 1e-6)


def test_fast_chain_is_the_kernels_scan():
    """The fast chain folds r_init into element 0 and scans in the kernels'
    Hillis–Steele stage order (pallas_otw.py:87-108), written out here
    out of place: the same bits, float32."""
    rng = np.random.default_rng(2)
    b = rng.random(50).astype(np.float32) * 10
    cost = rng.random(50).astype(np.float32)
    got = tband._minplus_chain(_t(b[None]), _t(cost[None]), torch.tensor([3.0]), exact=False)[0].numpy()
    r, csum = b.copy(), cost.copy()
    r[0] = min(r[0], np.float32(3.0) + cost[0])
    shift = 1
    while shift < 50:
        r_sh = np.concatenate([np.full(shift, np.inf, np.float32), r[:-shift]])
        c_sh = np.concatenate([np.zeros(shift, np.float32), csum[:-shift]])
        r, csum = np.minimum(r, r_sh + csum), c_sh + csum
        shift *= 2
    np.testing.assert_array_equal(got, r)


# (t, j) pairs: the first insert (t = 0, the clamped row t - 1), j = 0 (the
# clamped column j - 1), the band's start edges, the interior, and pointers
# past the buffers (t >= M after "ran out of room", j >= N at a stop)
POINTERS = [(0, 0), (0, 5), (1, 0), (3, 2), (9, 9), (10, 10), (11, 4), (25, 20), (40, 29), (M - 1, N - 1),
            (M, 12), (M + 3, 29), (17, N), (5, N + 2)]


@pytest.mark.parametrize("which", ["row", "col"])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("euclidean", [False, True])
@pytest.mark.parametrize("sentinel", [1e10, np.inf])
def test_band_updates(which, exact, euclidean, sentinel):
    live, ref, acc = _inputs(3, sentinel=sentinel)
    c = 10
    jfn, tfn = {"row": (jband.row_update, tband.row_update), "col": (jband.col_update, tband.col_update)}[which]
    kw = dict(c=c, sentinel=sentinel, euclidean=euclidean, exact=exact)
    enables = [None, True, False]
    for k, (t, j) in enumerate(POINTERS):
        enable = enables[k % 3]
        jkw = dict(kw) if enable is None else dict(kw, enable=jnp.bool_(enable))
        want = np.asarray(jfn(jnp.asarray(acc), jnp.asarray(live), jnp.asarray(ref), jnp.int32(t), jnp.int32(j),
                              **jkw))
        tacc = _t(acc[None])
        tkw = dict(kw) if enable is None else dict(kw, enable=torch.tensor([enable]))
        out = tfn(tacc, _t(live[None]), _t(ref[None]), _ptr(t), _ptr(j), **tkw)
        assert out is tacc  # updated in place
        _close(tacc[0].numpy(), want, sentinel, 1e-12)


def test_band_updates_batched_equal_solo():
    """B = 3 streams in one call: each stream's accumulator equals its own
    B = 1 call (the batch is stream-local)."""
    rng_inputs = [_inputs(s) for s in (4, 5, 6)]
    live = np.stack([i[0] for i in rng_inputs])
    ref = np.stack([i[1] for i in rng_inputs])
    acc = np.stack([i[2] for i in rng_inputs])
    t, j, en = _ptr(0, 25, M + 1), _ptr(7, 20, 3), torch.tensor([True, True, False])
    for fn in (tband.row_update, tband.col_update):
        batched = _t(acc)
        fn(batched, _t(live), _t(ref), t, j, c=10, sentinel=1e10, euclidean=False, enable=en)
        for b in range(3):
            solo = _t(acc[b : b + 1])
            fn(solo, _t(live[b : b + 1]), _t(ref[b : b + 1]), t[b : b + 1], j[b : b + 1], c=10, sentinel=1e10,
               euclidean=False, enable=en[b : b + 1])
            assert torch.equal(batched[b], solo[0])


CELLS = [(0, 0), (0, 7), (6, 0), (13, 17), (M - 1, N - 1), (M, 4), (M + 5, N + 3), (3, N)]


@pytest.mark.parametrize("euclidean", [False, True])
@pytest.mark.parametrize("sentinel", [1e10, np.inf])
def test_eval_cell(euclidean, sentinel):
    live, ref, acc = _inputs(7, sentinel=sentinel)
    for x, y in CELLS:
        want = np.asarray(jband.eval_cell(jnp.asarray(acc), jnp.asarray(live), jnp.asarray(ref), jnp.int32(x),
                                          jnp.int32(y), euclidean=euclidean))
        tacc = _t(acc[None])
        tband.eval_cell(tacc, _t(live[None]), _t(ref[None]), _ptr(x), _ptr(y), euclidean=euclidean)
        _close(tacc[0].numpy(), want, sentinel, 1e-12)


@pytest.mark.parametrize("c", [3, 10, 30])
def test_band_argmin(c):
    """Same points, ties included: an accumulator of small integers ties
    often, and the first minimum and the column's win on a row/column tie
    must match."""
    rng = np.random.default_rng(c)
    acc = rng.integers(0, 4, (M, N)).astype(np.float64)
    acc[rng.random((M, N)) < 0.2] = 1e10
    pts = POINTERS + [(t, j) for t, j in rng.integers(0, (M, N), (20, 2))]
    t, j = _ptr(*[p[0] for p in pts]), _ptr(*[p[1] for p in pts])
    x, y = tband.band_argmin(_t(np.broadcast_to(acc, (len(pts), M, N)).copy()), t, j, c=c)
    for k, (tt, jj) in enumerate(pts):
        jx, jy = jband.band_argmin(jnp.asarray(acc), jnp.int32(tt), jnp.int32(jj), c=c)
        assert (int(x[k]), int(y[k])) == (int(jx), int(jy)), (tt, jj)


@pytest.mark.parametrize("monotone", [False, True])
def test_append_point_clamps_at_the_path_end(monotone):
    """``_append_point`` against JAX's at the path buffer's end (the slot
    clamps to the last one, as ``dynamic_update_slice`` does) and under the
    V2 guard and the enable mask."""
    p = 6
    rng = np.random.default_rng(8)
    path0 = rng.integers(0, 9, (p, 2)).astype(np.int32)
    cases = [(0, -1, -1, 2, 3, True), (3, 1, 1, 2, 3, True), (3, 2, 3, 2, 3, True), (3, 1, 4, 2, 3, True),
             (p - 1, 1, 1, 5, 5, True), (p, 1, 1, 7, 8, True), (p + 4, 1, 1, 7, 8, True), (2, 1, 1, 4, 4, False)]
    for plen, lx, ly, x, y, en in cases:
        want = jcore._append_point(jnp.asarray(path0), jnp.int32(plen), jnp.int32(lx), jnp.int32(ly), jnp.int32(x),
                                   jnp.int32(y), monotone, enable=jnp.bool_(en))
        path = torch.from_numpy(path0.astype(np.int64))[None].clone()
        got = tcore._append_point(path, _ptr(plen), _ptr(lx), _ptr(ly), _ptr(x), _ptr(y), monotone,
                                  torch.tensor([en]))
        np.testing.assert_array_equal(path[0].numpy(), np.asarray(want[0]))
        assert [int(v[0]) for v in got] == [int(v) for v in want[1:]]
