"""The port's offline DTW (``models/dtw.py``, ``ops/banded_dtw.py``) on the
CPU against the JAX package and the numpy oracle, on the same numpy
features.

Tolerances: dense DTW in float64 as ``tests/test_dtw.py`` holds the JAX
package to the oracle — cost within 1e-12 (the matmul's accumulation
order), acc within 1e-10, path equal.  Banded DTW (float32): paths,
``band_used`` and edge flags equal; ``final_cost`` within a relative 1e-6
plus an absolute (M+N)·eps32.  Two things move it: the port's
Hillis–Steele min-plus scan sums the costs in another order than JAX's
``lax.associative_scan`` (a relative few ulps), and each cost ``1 − a·b``
comes from another dot-product order (±1 ulp of 1.0 each, summed over a
path of at most M+N cells — what dominates when the costs are near 0).
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from real_time_audio_sync_tpu.models import dtw as jdtw  # noqa: E402
from real_time_audio_sync_tpu.ops import banded_dtw as jband  # noqa: E402
from real_time_audio_sync_tpu_torch.models import dtw as tdtw  # noqa: E402
from real_time_audio_sync_tpu_torch.ops import banded_dtw as tband  # noqa: E402
from real_time_audio_sync_tpu_torch.ops import wavefront as twf  # noqa: E402
from tests.oracle import oracle_dtw  # noqa: E402

FINAL_RTOL = 1e-6


def _final_atol(m, n):
    return (m + n) * float(np.finfo(np.float32).eps)


def _unit_cols(rng, m, dtype=np.float32):
    x = rng.random((12, m)).astype(dtype)
    return x / np.linalg.norm(x, axis=0)


@pytest.mark.parametrize("m,n", [(1, 1), (1, 7), (5, 5), (23, 31), (64, 48)])
def test_dense_dtw_f64_matches_jax_and_oracle(m, n):
    rng = np.random.default_rng(m * 100 + n)
    a, b = _unit_cols(rng, m, np.float64), _unit_cols(rng, n, np.float64)
    cost, acc, path = tdtw.DTW(a, b, dtype=np.float64, device="cpu")
    for want_cost, want_acc, want_path in (jdtw.DTW(a, b, dtype=np.float64), oracle_dtw(a, b)):
        np.testing.assert_allclose(cost, want_cost, rtol=0, atol=1e-12)
        np.testing.assert_allclose(acc, want_acc, rtol=0, atol=1e-10)
        np.testing.assert_array_equal(path, want_path)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_dense_dtw_ties_follow_argmin_order(dtype):
    a = np.ones((12, 9), dtype) / np.sqrt(12)
    b = np.ones((12, 6), dtype) / np.sqrt(12)
    _, acc, path = tdtw.DTW(a, b, dtype=dtype, device="cpu")
    _, jacc, jpath = jdtw.DTW(a, b, dtype=dtype)
    np.testing.assert_array_equal(acc, jacc)
    np.testing.assert_array_equal(path, jpath)


def test_dtw_device_returns_tensors_in_the_backtrack_contract():
    rng = np.random.default_rng(5)
    a, b = _unit_cols(rng, 17), _unit_cols(rng, 21)
    cost, acc, points, length = tdtw.dtw_device(a, b, device="cpu")
    assert cost.shape == acc.shape == (17, 21) and points.shape == (17 + 21 - 1, 2)
    _, _, jpoints, jlength = jdtw.dtw_device(a, b)
    np.testing.assert_array_equal(points.numpy(), np.asarray(jpoints))
    assert int(length) == int(jlength)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("band", [16, 32, 64, None], ids=["b16", "b32", "b64", "full"])
def test_banded_dtw_matches_jax(seed, band):
    rng = np.random.default_rng(seed)
    m, n = 110 + seed, 140 - seed
    a, b = _unit_cols(rng, m), _unit_cols(rng, n)
    band = n if band is None else band
    try:
        want = jband.dtw_banded(a, b, band=band, return_edge_touch=True)
    except ValueError as e:  # a band too narrow for a valid path raises in both
        with pytest.raises(ValueError, match="widen"):
            tband.dtw_banded(a, b, band=band, return_edge_touch=True, device="cpu")
        assert "widen" in str(e)
        return
    path, final, edge = tband.dtw_banded(a, b, band=band, return_edge_touch=True, device="cpu")
    np.testing.assert_array_equal(path, want[0])
    assert edge == want[2]
    np.testing.assert_allclose(final, want[1], rtol=FINAL_RTOL, atol=_final_atol(m, n))


@pytest.mark.parametrize("seed", range(3))
def test_banded_full_band_equals_dense(seed):
    rng = np.random.default_rng(seed)
    m, n = 110 + seed, 140 - seed
    a, b = _unit_cols(rng, m), _unit_cols(rng, n)
    _, acc, dense_path = tdtw.DTW(a, b, device="cpu")
    path, final = tband.dtw_banded(a, b, band=n, device="cpu")
    np.testing.assert_array_equal(path, dense_path)
    np.testing.assert_allclose(final, acc[-1, -1], rtol=FINAL_RTOL)


def test_dtw_auto_widens_like_jax():
    """The live sequence dwells 5x on the reference's opening, far off the
    resampled diagonal: band 16 touches the edge, and both packages widen
    to the same band and recover the dense path."""
    rng = np.random.default_rng(3)
    ref = _unit_cols(rng, 180)
    warp = np.concatenate([np.repeat(np.arange(30), 5), np.arange(30, 180)])
    live = ref[:, warp] + rng.normal(0, 1e-3, (12, len(warp))).astype(np.float32)
    live /= np.linalg.norm(live, axis=0)
    path, final, band_used = tdtw.dtw_auto(live, ref, band=16, device="cpu")
    jpath, jfinal, jband_used = jdtw.dtw_auto(live, ref, band=16)
    assert band_used == jband_used > 16
    np.testing.assert_array_equal(path, jpath)
    np.testing.assert_allclose(final, jfinal, rtol=FINAL_RTOL, atol=_final_atol(len(warp), 180))
    _, _, dense_path = tdtw.DTW(live, ref, device="cpu")
    np.testing.assert_array_equal(path, dense_path)
    assert tdtw._initial_band(len(warp), 180) == jdtw._initial_band(len(warp), 180)


def test_narrow_band_raises_as_in_jax():
    """Rows of a 10 x 400 pair shift by ~44 frames, a band of 8 cannot link
    them, and the backtrack cannot reach the origin: both raise."""
    rng = np.random.default_rng(11)
    a, b = _unit_cols(rng, 10), _unit_cols(rng, 400)
    with pytest.raises(ValueError, match="widen"):
        jband.dtw_banded(a, b, band=8)
    with pytest.raises(ValueError, match="widen"):
        tband.dtw_banded(a, b, band=8, device="cpu")


def test_narrow_band_on_a_tie_flood_stays_valid_as_in_jax():
    """The live part repeats one reference column 200 times, so most cells
    tie exactly and which tied path wins is set by ulps (path equality is
    ill-posed here): both packages return a valid corner-to-corner path
    and report the edge touch."""
    rng = np.random.default_rng(11)
    ref = _unit_cols(rng, 400)
    live = np.concatenate([np.repeat(ref[:, :1], 200, axis=1), ref[:, :200]], axis=1)
    jpath, _, jedge = jband.dtw_banded(live, ref, band=8, return_edge_touch=True)
    path, _, edge = tband.dtw_banded(live, ref, band=8, return_edge_touch=True, device="cpu")
    assert edge and jedge
    for p in (path, jpath):
        assert tuple(p[0]) == (0, 0) and tuple(p[-1]) == (399, 399)
        d = np.diff(p, axis=0)
        assert (d >= 0).all() and (d <= 1).all() and (d.sum(axis=1) >= 1).all()


@pytest.mark.parametrize("route", ["kwarg", "env"])
def test_dtw_delegates_to_banded_above_the_dense_limit(monkeypatch, route):
    rng = np.random.default_rng(7)
    a, b = _unit_cols(rng, 200), _unit_cols(rng, 220)
    _, _, dense_path = tdtw.DTW(a, b, device="cpu")
    kwargs = {}
    if route == "env":
        monkeypatch.setenv("RTAS_DTW_DENSE_LIMIT_BYTES", "10000")
    else:
        kwargs["max_dense_bytes"] = 10000
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cost, acc, path = tdtw.DTW(a, b, device="cpu", **kwargs)
        jcost, jacc, jpath = jdtw.DTW(a, b, **kwargs)
    assert cost is None and acc is None and jcost is None and jacc is None
    assert sum("delegating" in str(x.message) for x in w) == 2
    np.testing.assert_array_equal(path, jpath)
    np.testing.assert_array_equal(path, dense_path)
    if route == "env":  # an explicit kwarg overrides the env
        cost2, _, path2 = tdtw.DTW(a, b, max_dense_bytes=1 << 40, device="cpu")
        assert cost2 is not None
        np.testing.assert_array_equal(path2, dense_path)


def test_backend_validation():
    rng = np.random.default_rng(3)
    a, b = rng.random((12, 16)).astype(np.float32), rng.random((12, 20)).astype(np.float32)
    with pytest.raises(ValueError, match="unknown backend"):
        tdtw.DTW(a, b, backend="bogus", device="cpu")
    with pytest.raises(ValueError, match="unsupported on this platform"):
        tdtw.DTW(a, b, backend="pallas", device="cpu")
    twf.dp_launches = twf.backtrack_launches = 0
    _, acc_scan, path_scan = tdtw.DTW(a, b, backend="scan", device="cpu")
    _, acc_auto, path_auto = tdtw.DTW(a, b, backend="auto", device="cpu")
    np.testing.assert_array_equal(acc_scan, acc_auto)
    np.testing.assert_array_equal(path_scan, path_auto)
    assert twf.dp_launches == 0 and twf.backtrack_launches == 0  # no kernel on the CPU
