"""The port's fused streaming engine on the CPU (the plain K-insert) against
the JAX package's engines — the cases of tests/test_fused_streaming.py, in
the standard layout against the XLA engines, and in the long-reference
(delta) layout against both the XLA engines and the JAX long-reference
engine running its Pallas kernel in interpret mode.  Paths must be equal
(tolerance 0: every case shares its features)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import real_time_audio_sync_tpu.models.fused_streaming as jfs  # noqa: E402
import real_time_audio_sync_tpu_torch.models.fused_streaming as tfs  # noqa: E402
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


def test_engine_contract(monkeypatch):
    """The device defaults to the card; ``long_ref=None`` picks the layout by
    the JAX package's rule (n >= _LONG_REF_THRESHOLD) in both packages, and
    ``long_ref`` given explicitly wins."""
    import inspect

    rng = np.random.default_rng(0)
    ref, _ = _make_pair(rng, n_ref=20)
    assert inspect.signature(FusedStreamingEngine).parameters["device"].default == "cuda"
    with pytest.raises(ValueError, match="shorter than search band"):
        _engine(ref[:, :5])
    assert tfs._LONG_REF_THRESHOLD == jfs._LONG_REF_THRESHOLD == 6000
    assert tfs._DELTA_STACK == jfs._DELTA_STACK == 64
    for threshold, want in ((21, False), (20, True), (19, True)):
        monkeypatch.setattr(tfs, "_LONG_REF_THRESHOLD", threshold)
        monkeypatch.setattr(jfs, "_LONG_REF_THRESHOLD", threshold)
        assert _engine(ref, long_ref=None).long_ref is want
        assert jfs.FusedStreamingEngine(ref, PARAMS, interpret=True).long_ref is want
    assert _engine(ref, long_ref=True).long_ref and not _engine(ref, long_ref=False).long_ref
    assert _engine(ref, long_ref=True)._state.path_x is None  # no whole-path buffer in delta mode


def test_engine_takes_the_jax_positional_order():
    """JAX's ``(ref, params, cfg_overrides, k_block, interpret, long_ref)``,
    positional or by keyword; ``interpret`` is accepted and ignored."""
    import inspect

    names = list(inspect.signature(jfs.FusedStreamingEngine).parameters)
    assert list(inspect.signature(FusedStreamingEngine).parameters)[: len(names)] == names
    rng = np.random.default_rng(8)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.1)
    eng = FusedStreamingEngine(ref, PARAMS, None, 8, False, True, device="cpu")
    assert eng.long_ref and eng.k_block == 8
    interp = FusedStreamingEngine(ref, PARAMS, k_block=8, interpret=True, device="cpu")
    assert not interp.long_ref
    for e in (eng, interp):
        e.insert_block_nowait(live)
        e.flush()
    np.testing.assert_array_equal(eng.path_array, interp.path_array)
    np.testing.assert_array_equal(eng.path_array, _xla_path(ref, live).path_array)


@pytest.mark.parametrize("n,want", [(5999, False), (6000, True)])
def test_long_ref_auto_rule_at_the_real_threshold(n, want):
    """The same call builds the same layout in both packages at the edge."""
    ref = _unit_cols(np.random.default_rng(n).random((12, n)) + 0.05).astype(np.float32)
    assert _engine(ref).long_ref is want
    assert jfs.FusedStreamingEngine(ref, PARAMS, interpret=True).long_ref is want


def test_overflow_flag_raises_on_harvest():
    """A status with the overflow bit (a violated column-phase bound) raises
    AssertionError when harvested, as the JAX engines' status polling does."""
    rng = np.random.default_rng(1)
    ref, _ = _make_pair(rng, n_ref=20)
    eng = _engine(ref)
    eng.poll_min_interval = 0.0
    with pytest.raises(AssertionError, match="loop bound"):
        eng._record_status(torch.tensor([2, 5, 3, 4, 0, 0, 0, 0], dtype=torch.int32))


# ---------------------------------------------------------------------------
# Long-reference layout: per-launch path deltas drained to a host path
# ---------------------------------------------------------------------------


def _jax_long(ref, **kw):
    return jfs.FusedStreamingEngine(ref, kw.pop("params", PARAMS), interpret=True, long_ref=True, **kw)


def _run_blocks(eng, live, block):
    for s in range(0, live.shape[1], block):
        eng.insert_block_nowait(live[:, s : s + block])
    return eng.flush()


@pytest.mark.parametrize("seed,block,k_block,stack", [
    (0, 8, 8, 4),   # block streaming + delta folding
    (1, 1, 8, 64),  # per-frame inserts, unfolded drain
    (2, 1, 1, 2),   # one insert per launch
    (3, 5, 2, 3),   # oversize feeds split across launches
])
def test_long_ref_matches_xla_engine_and_jax_kernel(seed, block, k_block, stack, monkeypatch):
    monkeypatch.setattr(tfs, "_DELTA_STACK", stack)
    monkeypatch.setattr(jfs, "_DELTA_STACK", stack)
    rng = np.random.default_rng(seed)
    ref, live = _make_pair(rng, n_ref=48, stretch=1.25)
    xla = _xla_path(ref, live)
    jeng = _jax_long(ref, k_block=k_block)
    _run_blocks(jeng, live, block)

    eng = _engine(ref, k_block=k_block, long_ref=True)
    assert eng.long_ref
    _run_blocks(eng, live, block)
    if len(eng.dispatched_block_sizes) >= stack:
        assert any(not isinstance(d, tuple) for d in eng._deltas)  # folded on the device side
    got = eng.path_array
    assert not eng._deltas  # drained
    np.testing.assert_array_equal(got, xla.path_array)
    np.testing.assert_array_equal(got, jeng.path_array)
    plen, x, y = eng.last_point
    assert plen == len(got) and (x, y) == tuple(got[-1])


def test_long_ref_feed_and_periodic_drains():
    """Adaptive feed through the delta layout with mid-stream path reads,
    which must neither lose nor duplicate committed points."""
    rng = np.random.default_rng(7)
    ref, live = _make_pair(rng, n_ref=48, stretch=1.25)
    xla = _xla_path(ref, live)
    jeng = _jax_long(ref, k_block=8)
    eng = _engine(ref, k_block=8, long_ref=True)
    for i in range(live.shape[1]):
        eng.feed(live[:, i])
        jeng.feed(live[:, i])
        if i % 16 == 0:
            eng.flush()
            jeng.flush()
            mid = eng.path_array  # mid-stream drain
            np.testing.assert_array_equal(mid, jeng.path_array)
            np.testing.assert_array_equal(mid, xla.path_array[: len(mid)])
    for e in (eng, jeng):
        e.flush()
    np.testing.assert_array_equal(eng.path_array, xla.path_array)
    np.testing.assert_array_equal(eng.path_array, jeng.path_array)


def test_long_ref_stop_and_freeze():
    """Past the reference's end the stream stops; post-stop launches are
    frozen no-ops whose rows commit nothing."""
    rng = np.random.default_rng(4)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.0)
    live = np.concatenate([live, _unit_cols(rng.random((12, 30)) + 0.05)], axis=1)
    xla = _xla_path(ref, live)
    jeng = _jax_long(ref, k_block=8)
    assert _run_blocks(jeng, live, 8) == "stop"
    eng = _engine(ref, k_block=8, long_ref=True)
    assert _run_blocks(eng, live, 8) == "stop"
    assert eng.insert_block_nowait(live[:, :8]) == "stop"  # cached verdict
    np.testing.assert_array_equal(eng.path_array, xla.path_array)
    np.testing.assert_array_equal(eng.path_array, jeng.path_array)
    # a frozen launch driven directly: its row repeats plen and commits nothing
    row = torch.empty(eng._delta_len, dtype=torch.int32)
    plen = int(eng._state.scalars[4])
    tfs.otw_insert.insert_block(eng._state, torch.from_numpy(live[:, :8].T.copy()).float(),
                                (eng.cap, eng.n, 8), eng.cfg, eng.k_block, delta=row)
    assert row[0] & 1 and int(row[1]) == plen and not row[8:].any()


def test_long_ref_livenote_v2_variant():
    """The LiveNoteV2 config (monotone guard, Euclidean chroma-diff cost) in
    the delta layout: skipped appends make zero-commit launches, which the
    drain passes over without losing alignment."""
    rng = np.random.default_rng(5)
    ref, live = _make_pair(rng, n_ref=40)
    ref_d = np.clip(np.diff(ref, axis=1), 0, np.inf)
    live_d = np.clip(np.diff(live, axis=1), 0, np.inf)
    xla = LiveNoteV2(ref_d, {"search_band_width": 10, "max_run_count": 3}, chroma_diff=True, dtype=np.float32)
    for i in range(live_d.shape[1]):
        if xla.insert(live_d[:, i]) == "stop":
            break
    over = ENGINE_OVERRIDES["livenote_v2_diff"]
    jeng = _jax_long(ref_d, cfg_overrides=dict(over))
    _run_blocks(jeng, live_d, 8)
    eng = _engine(ref_d, cfg_overrides=over, long_ref=True)
    _run_blocks(eng, live_d, 1)  # one insert per launch: some launches commit nothing
    rows = [np.asarray(torch.cat(d, -1)) for d in eng._deltas if isinstance(d, tuple)]
    plens = [0] + [int(r[1]) for r in rows]
    assert any(a == b for a, b in zip(plens, plens[1:]))  # zero-commit launches happened
    np.testing.assert_array_equal(eng.path_array, xla.path_array)
    np.testing.assert_array_equal(eng.path_array, jeng.path_array)


def test_long_ref_seed_origin_point_gives_set_live_path():
    rng = np.random.default_rng(12)
    ref, live = _make_pair(rng, n_ref=40, stretch=1.25)
    xla = OnlineTimeWarping(ref, PARAMS, dtype=np.float32)
    xla.set_live(live)
    eng = _engine(ref, k_block=8, long_ref=True)
    eng.seed_origin_point()
    eng.insert_block_nowait(live)
    eng.flush()
    np.testing.assert_array_equal(eng.path_array, xla.path_array)


def test_long_ref_api_interleaving_fuzz():
    """The long half of the seeded API fuzz (tests/test_fused_streaming.py
    test_fused_api_interleaving_fuzz[52-True]): random interleavings of
    feed / insert_nowait / insert_block_nowait / poll / last_point /
    mid-stream path reads under maximum harvest pressure commit the XLA
    engine's synchronous path."""
    rng = np.random.default_rng(52)
    ref, live = _make_pair(rng, n_ref=48, stretch=1.25)
    live = np.concatenate([live, _unit_cols(rng.random((12, 30)) + 0.05)], axis=1).astype(np.float32)
    sync = _xla_path(ref, live)
    eng = _engine(ref, k_block=4, long_ref=True)
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
            if rng.integers(0, 2):
                _ = eng.path_array  # mid-stream delta drain
            r = None
    eng.flush()
    np.testing.assert_array_equal(eng.path_array, sync.path_array)
    plen, x, y = eng.last_point
    assert plen == len(eng.path)
    assert (x, y) == tuple(eng.path[-1])


def test_delta_fold_iter_roundtrip():
    """The port's fold_delta_tail + iter_delta_rows give JAX's rows, row for
    row, for solo (1-D) and multi-stream (3, 1, X) components and any fold
    boundary."""
    import jax.numpy as jnp

    rng = np.random.default_rng(40)
    d_pad = 5
    for prefix in ((), (3, 1)):
        launches = [tuple(rng.integers(0, 99, size=(*prefix, w), dtype=np.int32) + 1000 * i
                          for w in (8, d_pad, d_pad)) for i in range(11)]
        jax_deltas, port_deltas = [], []
        for t in launches:
            jax_deltas.append(tuple(jnp.asarray(a) for a in t))
            jfs.fold_delta_tail(jax_deltas, 4)
            port_deltas.append(tuple(torch.from_numpy(a) for a in t))
            tfs.fold_delta_tail(port_deltas, 4)
        assert [isinstance(d, tuple) for d in port_deltas] == [isinstance(d, tuple) for d in jax_deltas]
        assert any(not isinstance(d, tuple) for d in port_deltas)  # folding happened
        got = list(tfs.iter_delta_rows(port_deltas))
        want = list(jfs.iter_delta_rows(jax_deltas))
        assert not port_deltas
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        flat = [row for rows in got for row in rows]
        for row, t in zip(flat, launches):
            np.testing.assert_array_equal(row, np.concatenate(t, axis=-1))


def test_delta_row_overflow_is_sticky(monkeypatch):
    """A launch committing more points than its delta row holds raises the
    sticky overflow bit instead of dropping points silently (with real
    slot counts this cannot happen: a launch commits at most
    k_block·loop_iters points)."""
    from real_time_audio_sync_tpu_torch.ops import otw_insert

    rng = np.random.default_rng(3)
    ref, live = _make_pair(rng, n_ref=30, stretch=1.0)
    monkeypatch.setattr(otw_insert, "delta_slots", lambda cfg, k_block: 1)
    eng = _engine(ref, k_block=8, long_ref=True)
    eng.poll_min_interval = 0.0
    with pytest.raises(AssertionError, match="loop bound"):
        eng.insert_block_nowait(live[:, :8])
        eng.flush()
    assert int(eng._state.scalars[otw_insert.S_OVERFLOW]) == 1


def test_long_ref_state_carries_across_from_jax(monkeypatch):
    """A JAX long-reference engine's mid-stream state (window, sliding live
    window, scalars, host path) carried into the port continues bit-equal,
    and the port's state carried back continues the JAX engine bit-equal."""
    from real_time_audio_sync_tpu_torch.utils.convert import long_state_from_jax, long_state_to_jax

    rng = np.random.default_rng(9)
    ref, live = _make_pair(rng, n_ref=48, stretch=1.25)
    xla = _xla_path(ref, live)
    c, n, f, k = PARAMS["c"], ref.shape[1], ref.shape[0], 8
    jeng = _jax_long(ref, k_block=k)
    cut = (live.shape[1] // 2) // k * k
    _run_blocks(jeng, live[:, :cut], k)
    w, live_win, sc = (np.asarray(a) for a in jeng._state)
    window, live_rows, scalars, path = long_state_from_jax(w, live_win, sc, jeng.path_array, c=c, n=n, f=f)

    eng = _engine(ref, k_block=k, long_ref=True)
    eng._state.window.copy_(window)
    eng._state.live.copy_(live_rows)
    eng._state.scalars.copy_(scalars)
    eng._host_px, eng._host_py, eng._drained_plen = [path[:, 0]], [path[:, 1]], len(path)
    third = cut + (live.shape[1] - cut) // 2 // k * k
    _run_blocks(eng, live[:, cut:third], k)
    np.testing.assert_array_equal(eng.path_array, xla.path_array[: len(eng.path_array)])

    # and back: the JAX engine continues from the port's state
    st = eng._state
    w2, win2, sc2, path2 = long_state_to_jax(st.window, st.live, st.scalars, eng.path_array, c=c, n=n, f=f,
                                             k_block=k)
    import jax.numpy as jnp

    jeng2 = _jax_long(ref, k_block=k)
    jeng2._state = (jnp.asarray(w2), jnp.asarray(win2), jnp.asarray(sc2))
    jeng2._host_px, jeng2._host_py, jeng2._drained_plen = [path2[:, 0]], [path2[:, 1]], len(path2)
    _run_blocks(jeng2, live[:, third:], k)
    _run_blocks(eng, live[:, third:], k)
    np.testing.assert_array_equal(eng.path_array, xla.path_array)
    np.testing.assert_array_equal(jeng2.path_array, xla.path_array)
