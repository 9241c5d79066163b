"""The port's whole-pair ``set_live`` (``ops/otw_set_live``) on the CPU,
where it runs its plain version, against the JAX package's Pallas
``pallas_set_live`` / ``pallas_batched_set_live`` in interpret mode and the
XLA engines' ``.set_live``, on the cases of ``tests/test_pallas_otw.py``.

Tolerance: paths equal exactly, and ``(live_ptr, ref_ptr, stopped)``
equal.  The port sums each 12-term cost sequentially over f and the JAX
kernel as a lane tree, so costs may differ by an ulp; the pairs carry
feature noise so that no decision rests on an exact tie.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from real_time_audio_sync_tpu.models import LiveNote, LiveNoteV2, OnlineTimeWarping  # noqa: E402
from real_time_audio_sync_tpu.ops import pallas_otw as jpo  # noqa: E402
from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES  # noqa: E402
from real_time_audio_sync_tpu_torch.ops import otw_set_live as tsl  # noqa: E402

from tests.test_online import _make_pair  # noqa: E402

PARAMS = {"c": 10, "max_run_count": 3}


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _diff(x):
    return np.clip(np.diff(x, axis=1), 0, np.inf)


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.int32
    assert tuple(got[1:]) == tuple(want[1:])


def _port(ref, live, params, engine, **kw):
    return tsl.pallas_set_live(ref, live, params, **ENGINE_OVERRIDES[engine], device="cpu", **kw)


def _stop_pair(rng):
    """A reference rendition followed by 30 unrelated columns: the path
    runs past the reference's end and stops."""
    ref, live = _make_pair(rng, n_ref=32, stretch=1.0)
    extra = rng.random((12, 30))
    extra /= np.linalg.norm(extra, axis=0, keepdims=True)
    return ref, np.concatenate([live, extra], axis=1)


# (id, seed, pair maker, engine, band c, XLA engine class and its kwargs)
SOLO_CASES = [
    ("otw-seed0", 0, lambda rng: _make_pair(rng, n_ref=48, stretch=1.25), "otw", 10, OnlineTimeWarping, {}),
    ("otw-seed1", 1, lambda rng: _make_pair(rng, n_ref=48, stretch=1.25), "otw", 10, OnlineTimeWarping, {}),
    ("livenote", 2, lambda rng: _make_pair(rng, n_ref=40), "livenote", 10, LiveNote, {}),
    ("livenote_v2_diff", 3, lambda rng: tuple(map(_diff, _make_pair(rng, n_ref=40))), "livenote_v2_diff", 10,
     LiveNoteV2, {"chroma_diff": True}),
    ("wide_band_c130", 6, lambda rng: _make_pair(rng, n_ref=150, stretch=1.2), "otw", 130, OnlineTimeWarping, {}),
    ("ref_exhaustion_stop", 4, _stop_pair, "otw", 10, OnlineTimeWarping, {}),
]


@pytest.mark.parametrize("seed,make,engine,c,xla_cls,xla_kw", [case[1:] for case in SOLO_CASES],
                         ids=[case[0] for case in SOLO_CASES])
def test_set_live_matches_jax_kernel_and_xla_engine(seed, make, engine, c, xla_cls, xla_kw):
    ref, live = make(np.random.default_rng(seed))
    params = {"c": c, "max_run_count": 3}
    tsl.launches = 0
    got = _port(ref, live, params, engine)
    assert tsl.launches == 0  # the CPU runs the plain version
    _same(got, jpo.pallas_set_live(ref, live, params, **ENGINE_OVERRIDES[engine]))
    xla = xla_cls(ref, {"search_band_width": c, "max_run_count": 3}, dtype=np.float32, **xla_kw)
    xla.set_live(live)
    np.testing.assert_array_equal(got[0], xla.path_array)
    assert (got[1], got[2]) == (xla.live_ptr, xla.ref_ptr)
    assert got[3] == (got[2] >= ref.shape[1])
    if seed == 4:
        assert got[3]  # the reference ran out: stopped


def test_batched_set_live_matches_solo():
    """Four ragged pairs in one batch == each alone == JAX's batched kernel."""
    rng = np.random.default_rng(5)
    pairs = [_make_pair(rng, n_ref=24 + 6 * i, stretch=1.0 + 0.15 * i) for i in range(4)]
    refs, lives = [r for r, _ in pairs], [l for _, l in pairs]
    batched = tsl.pallas_batched_set_live(refs, lives, PARAMS, device="cpu")
    want = jpo.pallas_batched_set_live(refs, lives, PARAMS, interpret=True)
    assert len(batched) == len(want) == 4
    for (r, l), got, w in zip(pairs, batched, want):
        _same(got, w)
        _same(got, _port(r, l, PARAMS, "otw"))


def test_batched_set_live_shared_reference():
    """Three pairs over one reference: one reference copy in the packed
    batch, and every pair's result equals the solo one."""
    rng = np.random.default_rng(6)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.25)
    ref_rows, live_rows, lens = tsl.pack([torch.from_numpy(ref)] * 3, [torch.from_numpy(live)] * 3, 10)
    assert ref_rows.shape[0] == 1 and live_rows.shape[0] == 3
    assert lens.tolist() == [[live.shape[1], ref.shape[1]]] * 3
    solo = jpo.pallas_set_live(ref, live, PARAMS)
    for got in tsl.pallas_batched_set_live([ref] * 3, [live] * 3, PARAMS, device="cpu"):
        _same(got, solo)


@pytest.mark.parametrize("seed,stretch,engine", [
    (31, 1.25, "otw"),  # live runs out without a stop
    (33, 2.6, "otw"),  # early stop: live much longer than the reference
    (32, 1.25, "livenote"),
    (2, 1.25, "livenote_v2_diff"),  # monotone guard + Euclidean: seeding is what is proven
])
def test_set_live_long_pair_delegation(monkeypatch, seed, stretch, engine):
    """The JAX package sends long pairs to its streaming engine seeded with
    set_live's first point (forced here through its threshold); the port
    runs every pair through the one set_live kernel.  Both routes give the
    port's path and pointers."""
    ref, live = _make_pair(np.random.default_rng(seed), n_ref=48, stretch=stretch)
    got = _port(ref, live, PARAMS, engine)
    _same(got, jpo.pallas_set_live(ref, live, PARAMS, **ENGINE_OVERRIDES[engine]))
    monkeypatch.setattr(jpo, "_SET_LIVE_LONG_N", 0)
    _same(got, jpo.pallas_set_live(ref, live, PARAMS, **ENGINE_OVERRIDES[engine]))


def test_batched_set_live_long_pair_delegation(monkeypatch):
    """JAX's batched route delegates pair by pair above its threshold; the
    port's one batch gives the same per-pair results."""
    rng = np.random.default_rng(7)
    pairs = [_make_pair(rng, n_ref=32 + 8 * i, stretch=1.0 + 0.2 * i) for i in range(3)]
    refs, lives = [r for r, _ in pairs], [l for _, l in pairs]
    batched = tsl.pallas_batched_set_live(refs, lives, PARAMS, device="cpu")
    monkeypatch.setattr(jpo, "_SET_LIVE_LONG_N", 0)
    delegated = jpo.pallas_batched_set_live(refs, lives, PARAMS, interpret=True)
    assert len(batched) == len(delegated) == 3
    for got, want in zip(batched, delegated):
        _same(got, want)


def test_set_live_argument_errors():
    rng = np.random.default_rng(8)
    ref, live = _make_pair(rng, n_ref=8)
    for fn in (jpo.pallas_set_live, lambda r, l, p: tsl.pallas_set_live(r, l, p, device="cpu")):
        with pytest.raises(ValueError, match="shorter than the search band"):
            fn(ref, live, PARAMS)
    ref, live = _make_pair(rng, n_ref=24)
    for fn in (jpo.pallas_batched_set_live, lambda r, l, p: tsl.pallas_batched_set_live(r, l, p, device="cpu")):
        with pytest.raises(ValueError, match="2 refs vs 1 lives"):
            fn([ref, ref], [live], PARAMS)
    with pytest.raises(ValueError, match="feature dim"):
        tsl.pallas_set_live(ref, live[:11], PARAMS, device="cpu")
    with pytest.raises(ValueError, match="feature dim"):
        tsl.pallas_batched_set_live([ref, ref], [live, live[:11]], PARAMS, device="cpu")
    with pytest.raises(KeyError, match="search_band_width"):
        tsl.pallas_set_live(ref, live, {"max_run_count": 3}, device="cpu")
