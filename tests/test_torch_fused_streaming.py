"""The port's fused streaming engine on the CPU (the plain K-insert) against
the JAX package's XLA engines — the standard-layout cases of
tests/test_fused_streaming.py.  Paths must be equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from real_time_audio_sync_tpu.models import LiveNoteV2, OnlineTimeWarping  # noqa: E402
from real_time_audio_sync_tpu_torch.models.fused_streaming import FusedStreamingEngine  # noqa: E402
from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES  # noqa: E402

from tests.test_online import _make_pair, _unit_cols  # noqa: E402

PARAMS = {"c": 10, "max_run_count": 3}


def _engine(ref, params=PARAMS, **kw):
    return FusedStreamingEngine(ref, params, device="cpu", **kw)


def _xla_path(ref, live, params=PARAMS):
    xla = OnlineTimeWarping(ref, params, dtype=np.float32)
    for i in range(live.shape[1]):
        if xla.insert(live[:, i]) == "stop":
            break
    return xla


@pytest.mark.parametrize("seed,block,k_block", [
    (0, 8, 8), (1, 1, 8), (2, 5, 8),
    (3, 1, 1),  # one insert per launch
    (4, 5, 2),  # oversize blocks split across k_block=2 launches
])
def test_fused_streaming_matches_xla_engine(seed, block, k_block):
    rng = np.random.default_rng(seed)
    ref, live = _make_pair(rng, n_ref=48, stretch=1.25)
    xla = _xla_path(ref, live)
    fused = _engine(ref, k_block=k_block)
    for s in range(0, live.shape[1], block):
        fused.insert_block_nowait(live[:, s : s + block])
    fused.flush()
    np.testing.assert_array_equal(fused.path_array, xla.path_array)


def test_fused_streaming_stop_and_freeze():
    rng = np.random.default_rng(4)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.0)
    live = np.concatenate([live, _unit_cols(rng.random((12, 30)) + 0.05)], axis=1)
    xla = _xla_path(ref, live)
    fused = _engine(ref, k_block=8)
    for s in range(0, live.shape[1], 8):
        fused.insert_block_nowait(live[:, s : s + 8])
    assert fused.flush() == "stop"
    assert fused.insert_block_nowait(live[:, :8]) == "stop"  # cached verdict
    np.testing.assert_array_equal(fused.path_array, xla.path_array)
    plen, x, y = fused.last_point
    assert plen == len(fused.path)
    assert (x, y) == tuple(fused.path[-1])


@pytest.mark.parametrize("c,mrc", [(3, 3), (10, 1), (25, 5)])
def test_fused_streaming_config_sweep(c, mrc):
    rng = np.random.default_rng(200 + c + mrc)
    ref, live = _make_pair(rng, n_ref=40, stretch=1.3)
    params = {"c": c, "max_run_count": mrc}
    xla = _xla_path(ref, live, params)
    fused = _engine(ref, params, k_block=8)
    for s in range(0, live.shape[1], 8):
        fused.insert_block_nowait(live[:, s : s + 8])
    fused.flush()
    np.testing.assert_array_equal(fused.path_array, xla.path_array)


def test_fused_streaming_capacity_freeze():
    """Live longer than the 2N capacity (otw_eran.py:50-54 "ran out of
    room"): the port matches the XLA engine, stop flag included."""
    rng = np.random.default_rng(31)
    ref = _unit_cols(rng.random((12, 30)) + 0.05)
    live = _unit_cols(rng.random((12, 75)) + 0.05)
    xla = _xla_path(ref, live)
    fused = _engine(ref, k_block=8)
    for s in range(0, live.shape[1], 8):
        fused.insert_block_nowait(live[:, s : s + 8])
    status = fused.flush()
    np.testing.assert_array_equal(fused.path_array, xla.path_array)
    assert (status == "stop") == bool(np.asarray(xla.state.stopped))


def test_fused_streaming_livenote_v2_variant():
    rng = np.random.default_rng(5)
    ref, live = _make_pair(rng, n_ref=40)
    ref_d = np.clip(np.diff(ref, axis=1), 0, np.inf)
    live_d = np.clip(np.diff(live, axis=1), 0, np.inf)
    xla = LiveNoteV2(ref_d, {"search_band_width": 10, "max_run_count": 3}, chroma_diff=True, dtype=np.float32)
    for i in range(live_d.shape[1]):
        if xla.insert(live_d[:, i]) == "stop":
            break
    fused = _engine(ref_d, cfg_overrides=ENGINE_OVERRIDES["livenote_v2_diff"])
    for s in range(0, live_d.shape[1], 8):
        fused.insert_block_nowait(live_d[:, s : s + 8])
    fused.flush()
    np.testing.assert_array_equal(fused.path_array, xla.path_array)


@pytest.mark.parametrize("max_in_flight", [0, 2, 1000])
def test_adaptive_feed_matches_sync_path(max_in_flight):
    """feed() commits the synchronous per-frame path however frames
    coalesce: 0 forces maximal coalescing (every dispatch held to the
    4*k_block liveness cap), 1000 a dispatch per frame."""
    rng = np.random.default_rng(7)
    ref, live = _make_pair(rng, n_ref=48, stretch=1.25)
    xla = _xla_path(ref, live)
    fused = _engine(ref, k_block=8)
    fused.max_in_flight = max_in_flight
    for i in range(live.shape[1]):
        if fused.feed(live[:, i]) == "stop":
            break
    fused.flush()
    np.testing.assert_array_equal(fused.path_array, xla.path_array)
    if max_in_flight == 0:
        assert max(fused.dispatched_block_sizes, default=1) == 8
    if max_in_flight == 1000:
        assert all(k == 1 for k in fused.dispatched_block_sizes)


def test_feed_never_buffers_when_pipeline_open():
    rng = np.random.default_rng(8)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.0)
    fused = _engine(ref, k_block=8)
    for i in range(20):
        fused.feed(live[:, i])
        assert len(fused._pending) == 0


def test_staleness_accounting():
    """Harvests record how many frames ran ahead of the harvested position;
    a blocking flush brings staleness to zero."""
    rng = np.random.default_rng(9)
    ref, live = _make_pair(rng, n_ref=48, stretch=1.0)
    fused = _engine(ref, k_block=8)
    fused.poll_min_interval = 0.0
    for i in range(live.shape[1]):
        if fused.feed(live[:, i]) == "stop":
            break
    fused.flush()
    assert fused.last_point_age_frames == 0
    assert fused.staleness_log, "harvests must be recorded"
    assert all(0 <= s <= fused._frames_dispatched for s in fused.staleness_log)
    assert fused.staleness_log[-1] == 0


def test_in_flight_probes_are_consistent():
    rng = np.random.default_rng(10)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.0)
    fused = _engine(ref, k_block=4)
    for s in range(0, 16, 4):
        fused.insert_block_nowait(live[:, s : s + 4])
    assert fused.in_flight() == 0  # CPU statuses are ready at once
    assert fused.flush() in (None, "stop")


def test_fused_api_interleaving_fuzz():
    """Random interleavings of feed / insert_nowait / insert_block_nowait /
    poll / last_point under maximum harvest pressure commit the XLA
    engine's synchronous path."""
    rng = np.random.default_rng(51)
    ref, live = _make_pair(rng, n_ref=48, stretch=1.25)
    live = np.concatenate([live, _unit_cols(rng.random((12, 30)) + 0.05)], axis=1).astype(np.float32)
    sync = _xla_path(ref, live)
    eng = _engine(ref, k_block=4)
    eng.poll_min_interval = 0.0
    i, r = 0, None
    while i < live.shape[1] and r != "stop":
        op = int(rng.integers(0, 5))
        if op == 0:
            r = eng.feed(live[:, i]); i += 1
        elif op == 1:
            r = eng.insert_nowait(live[:, i]); i += 1
        elif op == 2:
            k = min(int(rng.integers(1, 6)), live.shape[1] - i)
            r = eng.insert_block_nowait(live[:, i : i + k]); i += k
        elif op == 3:
            r = eng.poll()
        else:
            _ = eng.last_point, eng.last_point_age_frames
            r = None
    eng.flush()
    np.testing.assert_array_equal(eng.path_array, sync.path_array)
    plen, x, y = eng.last_point
    assert plen == len(eng.path)
    assert (x, y) == tuple(eng.path[-1])


def test_block_api_preserves_feed_queue_order():
    """insert_block_nowait after feed() under a saturated pipeline dispatches
    the queued feed frames FIRST."""
    rng = np.random.default_rng(53)
    ref, live = _make_pair(rng, n_ref=48, stretch=1.25)
    live = live.astype(np.float32)
    sync = _xla_path(ref, live)
    eng = _engine(ref, k_block=8)
    eng.max_in_flight = 0  # saturate: feed() only queues
    for i in range(10):
        eng.feed(live[:, i])
    assert eng._pending
    eng.insert_block_nowait(live[:, 10:20])
    assert not eng._pending
    for i in range(20, live.shape[1]):
        eng.insert_nowait(live[:, i])
    eng.flush()
    np.testing.assert_array_equal(eng.path_array, sync.path_array)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_feed_copies_queued_columns(as_tensor):
    """Under saturation a fed column stays queued past the call, so a caller
    reusing one buffer per hop must not change what is queued."""
    rng = np.random.default_rng(41)
    ref, live = _make_pair(rng, n_ref=40, stretch=1.2)
    cut = min(live.shape[1], 4 * 8 - 1)  # below the liveness backstop

    fresh = _engine(ref, k_block=8)
    fresh.max_in_flight = 0
    for i in range(cut):
        fresh.feed(live[:, i])
    fresh.flush()

    reused = _engine(ref, k_block=8)
    reused.max_in_flight = 0
    buf = np.zeros(live.shape[0], np.float32)
    if as_tensor:
        buf = torch.from_numpy(buf)
    for i in range(cut):
        buf[:] = torch.from_numpy(live[:, i].astype(np.float32)) if as_tensor else live[:, i]
        reused.feed(buf)
    buf[:] = -1.0
    reused.flush()
    assert reused.path == fresh.path


def test_seed_origin_point_gives_set_live_path():
    """seed_origin_point + frame-by-frame inserts commit the batch
    set_live path of the XLA engine (otw_eran.py:103-107)."""
    rng = np.random.default_rng(12)
    ref, live = _make_pair(rng, n_ref=40, stretch=1.25)
    xla = OnlineTimeWarping(ref, PARAMS, dtype=np.float32)
    xla.set_live(live)
    eng = _engine(ref, k_block=8)
    eng.seed_origin_point()
    eng.insert_block_nowait(live)
    eng.flush()
    np.testing.assert_array_equal(eng.path_array, xla.path_array)
    with pytest.raises(RuntimeError, match="fresh"):
        eng.seed_origin_point()


def test_engine_contract():
    """The device defaults to the card; the long-reference layout is not
    ported."""
    import inspect

    rng = np.random.default_rng(0)
    ref, _ = _make_pair(rng, n_ref=20)
    assert inspect.signature(FusedStreamingEngine).parameters["device"].default == "cuda"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _engine(ref, long_ref=True)
    with pytest.raises(ValueError, match="shorter than search band"):
        _engine(ref[:, :5])
    assert not _engine(ref, long_ref=None).long_ref


def test_overflow_flag_raises_on_harvest():
    """A status with the overflow bit (a violated column-phase bound) raises
    AssertionError when harvested, as the JAX engines' status polling does."""
    rng = np.random.default_rng(1)
    ref, _ = _make_pair(rng, n_ref=20)
    eng = _engine(ref)
    eng.poll_min_interval = 0.0
    with pytest.raises(AssertionError, match="loop bound"):
        eng._record_status(torch.tensor([2, 5, 3, 4, 0, 0, 0, 0], dtype=torch.int32))
