"""The port's corpus alignment (``parallel/corpus.py``: ``pad_pairs`` and
``batched_set_live``) on the CPU, where the banded route runs the set_live
kernel's plain version, against the JAX package's functions (its Pallas
kernel in interpret mode, its dense scan on XLA), on the cases of
tests/test_parallel.py:24,35,343,600.

Tolerance: none.  Paths equal exactly, and so do mean path lengths: the
port takes JAX's arithmetic, the float32 sum times float32(1/B), and on
JAX's long-pair route the float64 mean rounded to float32 (against which
the old port's float32 division was one ulp off on the seed-11 pairs).
The pairs carry feature noise, so no decision rests on an exact tie."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from real_time_audio_sync_tpu.parallel import corpus as jcorpus  # noqa: E402
from real_time_audio_sync_tpu_torch.parallel import batched_set_live, corpus_mesh, pad_pairs  # noqa: E402

from tests.test_online import _make_pair  # noqa: E402

PARAMS = {"c": 8, "max_run_count": 3}


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _pairs(seed: int, n: int = 3, stretch=1.0, step=0.1):
    rng = np.random.default_rng(seed)
    pairs = [_make_pair(rng, n_ref=24 + 4 * i, stretch=stretch + step * i) for i in range(n)]
    return pad_pairs([p[0] for p in pairs], [p[1] for p in pairs])


def _assert_paths(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("pad_multiple", [1, 8])
def test_pad_pairs_equals_jax(pad_multiple):
    """tests/test_parallel.py:24: shapes, dtypes, lengths and contents."""
    rng = np.random.default_rng(0)
    refs = [rng.random((12, n)) for n in (30, 45, 37)]
    lives = [rng.random((12, t)).astype(np.float32) for t in (50, 33, 61)]
    got, want = pad_pairs(refs, lives, pad_multiple), jcorpus.pad_pairs(refs, lives, pad_multiple)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if pad_multiple == 8:
        assert got[0].shape == (3, 12, 48) and got[1].shape == (3, 12, 64)


def test_banded_equals_jax_banded_and_the_port_dense():
    """tests/test_parallel.py:343: the banded route (one set_live launch,
    its plain version here) commits JAX's banded paths and the port's dense
    scan's; the mean path length is a 0-d float32 tensor."""
    r, l, rl, ll = _pairs(11)
    banded, mean_b = batched_set_live(r, l, rl, ll, PARAMS, device="cpu")
    dense, mean_d = batched_set_live(r, l, rl, ll, PARAMS, backend="dense", device="cpu")
    jax_paths, jax_mean = jcorpus.batched_set_live(r, l, rl, ll, PARAMS, backend="banded")
    _assert_paths(banded, jax_paths)
    _assert_paths(dense, jax_paths)
    assert mean_b.dtype == torch.float32 and mean_b.ndim == 0 and mean_b.device.type == "cpu"
    assert float(mean_b) == float(mean_d) == float(jax_mean)
    assert mean_b.item() == np.float32(32.333336)  # 97 × float32(1/3), where 97 / 3 rounds to 32.333332


@pytest.mark.parametrize("backend", ["banded", "dense"])
def test_float64_runs_the_dense_scan_and_equals_jax(backend):
    """tests/test_parallel.py:35: float64 takes the dense scan under either
    backend, as in the JAX package, and equals JAX's float64 dense scan and
    each pair's solo ``set_live``."""
    from real_time_audio_sync_tpu_torch.models import OnlineTimeWarping

    rng = np.random.default_rng(3)
    pairs = [_make_pair(rng, n_ref=40 + 7 * i, stretch=1.2 + 0.1 * i) for i in range(4)]
    params = {"c": 10, "max_run_count": 3}
    r, l, rl, ll = pad_pairs([p[0] for p in pairs], [p[1] for p in pairs])
    got, mean = batched_set_live(r, l, rl, ll, params, dtype=np.float64, backend=backend, device="cpu")
    want, jax_mean = jcorpus.batched_set_live(r, l, rl, ll, params, dtype=np.float64, backend="dense")
    _assert_paths(got, want)
    assert float(mean) == float(jax_mean)
    for (ref, live), g in zip(pairs, got):
        eng = OnlineTimeWarping(ref, params, dtype=np.float64, device="cpu")
        eng.set_live(live)
        np.testing.assert_array_equal(g, eng.path_array)


def test_long_pairs_equal_jax_delegated_route(monkeypatch):
    """tests/test_parallel.py:600: with JAX's long threshold lowered to 0
    every pair takes its delegated long-reference route; the port has one
    route for every length, and its paths equal that route's."""
    import real_time_audio_sync_tpu.ops.pallas_otw as po

    r, l, rl, ll = _pairs(21, n=2, step=0.15)
    monkeypatch.setattr(po, "_SET_LIVE_LONG_N", 0)
    delegated, mean_j = jcorpus.batched_set_live(r, l, rl, ll, PARAMS, backend="banded")
    got, mean = batched_set_live(r, l, rl, ll, PARAMS, device="cpu")
    _assert_paths(got, delegated)
    assert float(mean) == pytest.approx(float(mean_j))


def test_long_route_mean_equals_jax(monkeypatch):
    """tests/test_parallel.py:600, with both packages' long-pair thresholds
    lowered to 0: JAX's long route takes the float64 mean of the lengths,
    and the port's mean is that value rounded to float32 (JAX returns the
    float64 itself under x64)."""
    import real_time_audio_sync_tpu.ops.pallas_otw as po
    from real_time_audio_sync_tpu_torch.parallel import corpus as tcorpus

    r, l, rl, ll = _pairs(11)
    short, short_mean = batched_set_live(r, l, rl, ll, PARAMS, device="cpu")
    monkeypatch.setattr(po, "_SET_LIVE_LONG_N", 0)
    monkeypatch.setattr(tcorpus, "_SET_LIVE_LONG_N", 0)
    want, jax_mean = jcorpus.batched_set_live(r, l, rl, ll, PARAMS, backend="banded")
    got, mean = batched_set_live(r, l, rl, ll, PARAMS, device="cpu")
    _assert_paths(got, want)
    assert mean.dtype == torch.float32 and mean.ndim == 0
    assert mean.item() == np.float32(jax_mean) == np.float32(97 / 3)
    assert short_mean.item() != mean.item()  # the two routes' arithmetic part by an ulp here


def test_mesh_and_unknown_backend_raise():
    r, l, rl, ll = _pairs(5, n=2)
    want, want_mean = batched_set_live(r, l, rl, ll, PARAMS, device="cpu")
    got, mean = batched_set_live(r, l, rl, ll, PARAMS, mesh=corpus_mesh(2, device="cpu"), device="cpu")
    _assert_paths(got, want)
    assert float(mean) == float(want_mean)
    with pytest.raises(ValueError, match="divisible"):
        batched_set_live(*_pairs(5, n=3), PARAMS, mesh=corpus_mesh(8, device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="unknown backend 'sparse'; choose 'banded' or 'dense'"):
        batched_set_live(r, l, rl, ll, PARAMS, backend="sparse", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        jcorpus.batched_set_live(r, l, rl, ll, PARAMS, backend="sparse")
