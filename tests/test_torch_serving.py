"""The port's multi-stream follower on the CPU (the plain batched K-insert)
against the JAX package's ``FusedMultiStreamFollower`` running its Pallas
kernels in interpret mode, and against the port's solo engine — the cases
of tests/test_parallel.py that take no mesh, in both layouts.  Paths must
be equal (tolerance 0: every case shares its features)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from real_time_audio_sync_tpu.parallel import FusedMultiStreamFollower as JaxFollower  # noqa: E402
from real_time_audio_sync_tpu_torch.models.fused_streaming import FusedStreamingEngine  # noqa: E402
from real_time_audio_sync_tpu_torch.parallel import FusedMultiStreamFollower, corpus_mesh  # noqa: E402
from real_time_audio_sync_tpu_torch.parallel.polling import BatchedStatusPolling  # noqa: E402

from tests.test_online import _make_pair, _unit_cols  # noqa: E402

PARAMS = {"c": 10, "max_run_count": 3}
LAYOUTS = pytest.mark.parametrize("long_ref", [True, False], ids=["windowed", "whole"])


def _port(ref, **kw):
    return FusedMultiStreamFollower(ref, PARAMS, device="cpu", **kw)


def _jax(ref, **kw):
    return JaxFollower(ref, PARAMS, interpret=True, **kw)


def _solo_path(ref, live, k_block=8):
    """The port's solo engine fed frame by frame (test_parallel.py:197)."""
    e = FusedStreamingEngine(ref, PARAMS, k_block=k_block, device="cpu")
    for i in range(live.shape[1]):
        if e.feed(live[:, i]) == "stop":
            break
    e.flush()
    return e.path_array


def _run(follower, schedule):
    for cols, act in schedule:
        follower.feed(cols, act)
    follower.flush()
    return follower.paths()


def _ragged_schedule(lives):
    """One column per stream per hop while it has one (test_parallel.py:208)."""
    b, tmax = len(lives), max(l.shape[1] for l in lives)
    out = []
    for t in range(tmax):
        cols, act = np.zeros((b, 12), np.float32), np.zeros(b, bool)
        for i, l in enumerate(lives):
            if t < l.shape[1]:
                cols[i], act[i] = l[:, t], True
        out.append((cols, act))
    return out


def _skewed_schedule(live):
    """Stream 0 at full rate, stream 1 at half rate (test_parallel.py:261)."""
    out, t2 = [], 0
    for t in range(live.shape[1] * 2):
        cols, act = np.zeros((2, 12), np.float32), np.zeros(2, bool)
        if t < live.shape[1]:
            cols[0], act[0] = live[:, t], True
        if t % 2 == 0 and t2 < live.shape[1]:
            cols[1], act[1] = live[:, t2], True
            t2 += 1
        out.append((cols, act))
    return out


def _assert_paths(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@LAYOUTS
def test_serving_mixed_refs_match_jax_and_solo(long_ref):
    """B streams against different (padded) references, with per-stream stop
    divergence and a mid-stream path read (test_parallel.py:208, :379)."""
    rng = np.random.default_rng(0 if long_ref else 21)
    pairs = [_make_pair(rng, n_ref=32 + 8 * i, stretch=1.0 + 0.2 * i) for i in range(3)]
    refs = [r for r, _ in pairs]
    schedule = _ragged_schedule([l for _, l in pairs])
    port = _port(refs, k_block=8, long_ref=long_ref)
    assert port.long_ref is long_ref and not port.shared_ref
    for t, (cols, act) in enumerate(schedule):
        port.feed(cols, act)
        if t == len(schedule) // 2:
            _ = port.paths()  # a mid-stream drain must not lose or repeat points
    port.flush()
    got = port.paths()
    _assert_paths(got, [_solo_path(r, l) for r, l in pairs])
    jax_f = _jax(refs, k_block=8, long_ref=long_ref)
    _assert_paths(got, _run(jax_f, schedule))
    for i, p in enumerate(got):
        assert tuple(port.last_points[i]) == (len(p), *p[-1])
    np.testing.assert_array_equal(port.last_points, jax_f.last_points)
    np.testing.assert_array_equal(port.stopped, jax_f.stopped)


def test_serving_default_is_windowed_and_equals_whole_buffer():
    """The default layout is the windowed one at every N, and its paths equal
    the whole-buffer layout's (test_parallel.py:234)."""
    rng = np.random.default_rng(33)
    ref, live = _make_pair(rng, n_ref=40, stretch=1.1)
    schedule = [(np.repeat(live[None, :, t], 2, axis=0), None) for t in range(live.shape[1])]
    default = _port(ref, n_streams=2, k_block=8)
    assert default.long_ref and default.shared_ref
    assert default._state.ref.shape[0] == 1  # the shared reference is held once
    whole = _port(ref, n_streams=2, k_block=8, long_ref=False)
    assert not whole.long_ref
    got = _run(default, schedule)
    _assert_paths(got, _run(whole, schedule))
    _assert_paths(got, [_solo_path(ref, live)] * 2)
    _assert_paths(got, _run(_jax(ref, n_streams=2, k_block=8), schedule))


@LAYOUTS
def test_serving_shared_ref_skewed_feeds(long_ref):
    """A half-rate stream on a shared reference: paths do not depend on feed
    skew (test_parallel.py:261, :407)."""
    rng = np.random.default_rng(1 if long_ref else 23)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.2)
    schedule = _skewed_schedule(live)
    got = _run(_port(ref, n_streams=2, k_block=8, long_ref=long_ref), schedule)
    _assert_paths(got, [_solo_path(ref, live)] * 2)
    _assert_paths(got, _run(_jax(ref, n_streams=2, k_block=8, long_ref=long_ref), schedule))


@LAYOUTS
def test_serving_stop_and_freeze(long_ref):
    """A stream whose reference is exhausted freezes, and the stop shows in
    the stopped mask before flush (test_parallel.py:286)."""
    rng = np.random.default_rng(2)
    ref, live = _make_pair(rng, n_ref=24, stretch=1.0)
    long_live = np.concatenate([live, _unit_cols(rng.random((12, 40)) + 0.05)], axis=1)
    port = _port(ref, n_streams=1, k_block=8, long_ref=long_ref)
    port.poll_min_interval = 0.0
    seen_before_flush = False
    fed = 0
    for t in range(long_live.shape[1]):
        fed += 1
        if port.feed(long_live[None, :, t])[0]:
            seen_before_flush = True
            break
    assert seen_before_flush
    assert port.flush()[0]
    got = port.paths()
    _assert_paths(got, [_solo_path(ref, long_live)])
    jax_f = _jax(ref, n_streams=1, k_block=8, long_ref=long_ref)
    _assert_paths(got, _run(jax_f, [(long_live[None, :, t], None) for t in range(fed)]))
    # post-stop feeds are no-ops
    port.feed(long_live[None, :, 0])
    port.flush()
    _assert_paths(port.paths(), got)


def test_serving_folding():
    """Folding every 3 launches on the device keeps the paths exact
    (test_parallel.py:434)."""
    rng = np.random.default_rng(22)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.2)
    schedule = [(np.repeat(live[None, :, t], 2, axis=0), None) for t in range(live.shape[1])]
    port = _port(ref, n_streams=2, k_block=8, long_ref=True)
    port._delta_stack = 3
    got = _run(port, schedule)
    assert len(port.dispatched_block_sizes) >= 3
    _assert_paths(got, [_solo_path(ref, live)] * 2)
    jax_f = _jax(ref, n_streams=2, k_block=8, long_ref=True)
    jax_f._delta_stack = 3
    _assert_paths(got, _run(jax_f, schedule))


@pytest.mark.parametrize("seed,long_ref", [(61, False), (62, True)])
def test_serving_api_interleaving_fuzz(seed, long_ref):
    """Random per-stream feed skew with poll, last_points and mid-stream path
    reads in between, polling on every call (test_parallel.py:508)."""
    rng = np.random.default_rng(seed)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.2)
    port = _port(ref, n_streams=3, k_block=8, long_ref=long_ref)
    port.poll_min_interval = 0.0
    ptrs = [0, 0, 0]
    schedule = []
    while min(ptrs) < live.shape[1]:
        cols, act = np.zeros((3, 12), np.float32), np.zeros(3, bool)
        for i in range(3):
            if ptrs[i] < live.shape[1] and rng.integers(0, 3):
                cols[i], act[i] = live[:, ptrs[i]], True
                ptrs[i] += 1
        schedule.append((cols, act))
        port.feed(cols, act)
        op = int(rng.integers(0, 4))
        if op == 0:
            port.poll()
        elif op == 1:
            _ = port.last_points
        elif op == 2 and rng.integers(0, 4) == 0:
            _ = port.paths()
    port.flush()
    got = port.paths()
    _assert_paths(got, [_solo_path(ref, live)] * 3)
    _assert_paths(got, _run(_jax(ref, n_streams=3, k_block=8, long_ref=long_ref), schedule))


class _Event:
    """A stand-in for ``torch.cuda.Event``: complete once ``done``."""

    def __init__(self, done: bool):
        self.done = done

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        self.done = True


class _Poller(BatchedStatusPolling):
    def __init__(self):
        self._stopped = np.zeros(2, bool)
        self.consumed = 0
        self._init_batched_polling()

    def _consume(self, vec):
        self.consumed += 1
        self._stopped |= (vec[:, 0] & 1).astype(bool)


def _status(stopped: bool):
    vec = torch.zeros((2, 8), dtype=torch.int32)
    vec[:, 0] = int(stopped)
    return vec


def test_batched_polling_keeps_final_status():
    """The final status is never lost (test_parallel.py:543, for the
    event-based poller): a launch still in flight at a poll is consumed by
    the settle, and a completed status held back by the rate limit stays
    in ``_latest_done`` until a poll or the settle reads it."""
    f = _Poller()
    f.poll_min_interval = 0.0
    f._outstanding.append((_status(False), _Event(True)))
    f._poll_status()
    assert f.consumed == 1 and not f._outstanding
    f._outstanding.append((_status(True), _Event(False)))  # the final launch, in flight
    f._poll_status()
    assert f.consumed == 1 and f._in_flight() == 1 and not f._stopped.any()
    f._settle_status()
    assert f._stopped.all() and not f._outstanding

    g = _Poller()
    g.poll_min_interval = 3600.0
    g._last_poll_time = float("inf")  # every poll is rate-limited
    g._outstanding.append((_status(True), _Event(True)))
    g._poll_status()
    assert g.consumed == 0 and g._latest_done is not None  # kept, not dropped
    g._settle_status()
    assert g._stopped.all() and g._latest_done is None


def test_batched_polling_records_cpu_status_at_once():
    f = _Poller()
    status = _status(True)
    f._record_status(status[:, None])  # row-shaped (B, 1, 8), as the delta rows give it
    status.zero_()  # a snapshot, not a view
    assert f._in_flight() == 0
    f.poll_min_interval = 0.0
    f._poll_status()
    assert f._stopped.all()


def test_serving_consume_is_monotone_per_stream():
    """Status rows never move last_points backwards, row by row
    (test_parallel.py:576)."""
    rng = np.random.default_rng(44)
    ref, _ = _make_pair(rng, n_ref=32, stretch=1.0)
    port = _port(ref, n_streams=2, k_block=8)
    newer = np.zeros((2, 8), np.int32)
    newer[0, 1:4] = (5, 9, 7)
    newer[1, 1:4] = (3, 4, 4)
    port._consume(newer)
    older = np.zeros((2, 8), np.int32)
    older[0, 1:4] = (4, 8, 6)  # stale for stream 0 ...
    older[1, 1:4] = (3, 6, 5)  # ... but newer for stream 1 (same plen)
    port._consume(older)
    assert tuple(port._last_points[0]) == (5, 9, 7)
    assert tuple(port._last_points[1]) == (3, 6, 5)
    overflow = np.zeros((2, 8), np.int32)
    overflow[1, 0] = 2
    with pytest.raises(AssertionError, match="loop bound"):
        port._consume(overflow)


@LAYOUTS
def test_serving_feed_copies_queued_columns(long_ref):
    """Queued columns are copied on ingest, not aliased to the caller's
    reused buffer (test_parallel.py:620)."""
    rng = np.random.default_rng(43)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.1)
    cut = min(live.shape[1], 4 * 8 - 1)
    fresh = _port(ref, n_streams=2, k_block=8, long_ref=long_ref)
    fresh.max_in_flight = 0  # saturated: feed() only queues
    for t in range(cut):
        fresh.feed(np.repeat(live[None, :, t], 2, axis=0))
    assert not fresh.dispatched_block_sizes
    fresh.flush()
    reused = _port(ref, n_streams=2, k_block=8, long_ref=long_ref)
    reused.max_in_flight = 0
    buf = np.zeros((2, live.shape[0]), np.float32)
    for t in range(cut):
        buf[:] = live[:, t]
        reused.feed(buf)
    buf[:] = -1.0
    reused.flush()
    _assert_paths(reused.paths(), fresh.paths())
    _assert_paths(fresh.paths(), [_solo_path(ref, live[:, :cut])] * 2)


def test_serving_reset_pending_drops_queued_columns():
    """``_reset_pending`` drops every queued column: a restored state must
    not see frames that predate it."""
    rng = np.random.default_rng(45)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.1)
    port = _port(ref, n_streams=2, k_block=8)
    port.max_in_flight = 0
    for t in range(5):
        port.feed(np.repeat(live[None, :, t], 2, axis=0))
    assert port._pend_n.tolist() == [5, 5]
    port._reset_pending()
    port.flush()
    assert not port.dispatched_block_sizes
    assert all(len(p) == 0 for p in port.paths())
    for t in range(live.shape[1]):
        port.feed(np.repeat(live[None, :, t], 2, axis=0))
    port.flush()
    _assert_paths(port.paths(), [_solo_path(ref, live)] * 2)


def test_serving_feed_past_queue_capacity():
    """Past 4·k_block queued columns a dispatch is forced even with the
    pipeline saturated, and paths stay exact through that boundary
    (test_parallel.py:650)."""
    rng = np.random.default_rng(44)
    ref, live = _make_pair(rng, n_ref=48, stretch=1.0)
    k = 4
    assert live.shape[1] > 5 * k
    schedule = [(np.repeat(live[None, :, t], 2, axis=0), None) for t in range(live.shape[1])]
    port = _port(ref, n_streams=2, k_block=k)
    port.max_in_flight = 0  # only the capacity rule may dispatch
    for cols, act in schedule:
        port.feed(cols, act)
        assert int(port._pend_n.max()) < 4 * k
    port.flush()
    got = port.paths()
    _assert_paths(got, [_solo_path(ref, live, k_block=k)] * 2)
    jax_f = _jax(ref, n_streams=2, k_block=k)
    jax_f.max_in_flight = 0
    _assert_paths(got, _run(jax_f, schedule))


def test_serving_rejects_mesh_and_checks_its_arguments():
    rng = np.random.default_rng(5)
    ref, _ = _make_pair(rng, n_ref=32, stretch=1.0)
    mesh = corpus_mesh(2, device="cpu")
    assert FusedMultiStreamFollower(ref, PARAMS, 2, None, 8, False, mesh, device="cpu").mesh is mesh
    with pytest.raises(ValueError, match="divisible"):
        _port(ref, n_streams=3, mesh=corpus_mesh(8, device="cpu"))
    with pytest.raises(ValueError, match="n_streams"):
        _port(ref)
    with pytest.raises(ValueError, match="n_streams"):
        _port([ref, ref], n_streams=3)
    with pytest.raises(ValueError, match="column batch"):
        _port(ref, n_streams=2).feed(np.zeros((3, 12), np.float32))


def test_serving_positional_signature_is_jax_order():
    """JAX's positional order (ref, params, n_streams, cfg_overrides,
    k_block, interpret, mesh, max_in_flight, long_ref)."""
    rng = np.random.default_rng(6)
    ref, _ = _make_pair(rng, n_ref=32, stretch=1.0)
    f = FusedMultiStreamFollower(ref, PARAMS, 3, {"sentinel": float("inf")}, 4, True, None, 2, False, device="cpu")
    assert (f.b, f.cfg.sentinel, f.k_block, f.max_in_flight, f.long_ref) == (3, float("inf"), 4, 2, False)


def _jax_paths(jax_f):
    return [np.asarray(p) for p in jax_f.paths()]


@LAYOUTS
def test_serving_state_carries_across_from_jax_and_back(long_ref):
    """A JAX follower's mid-stream state carried into the port by
    utils/convert.py continues bit-equal, and the port's state carried back
    continues the JAX follower bit-equal; ragged per-stream references."""
    import jax.numpy as jnp

    from real_time_audio_sync_tpu_torch.utils import convert

    rng = np.random.default_rng(70)
    pairs = [_make_pair(rng, n_ref=32 + 8 * i, stretch=1.0 + 0.15 * i) for i in range(3)]
    refs = [r for r, _ in pairs]
    solo = [_solo_path(r, l) for r, l in pairs]
    schedule = _ragged_schedule([l for _, l in pairs])
    cut, third = len(schedule) // 3, 2 * len(schedule) // 3
    c, f = PARAMS["c"], 12
    lens = [r.shape[1] for r in refs]
    n_max = max(lens)

    jax_f = _jax(refs, k_block=8, long_ref=long_ref)
    _run(jax_f, schedule[:cut])
    port = _port(refs, k_block=8, long_ref=long_ref)
    st = port._state
    if long_ref:
        w, live, sc, host = convert.multi_long_state_from_jax(*(np.asarray(a) for a in jax_f._state),
                                                              _jax_paths(jax_f), c=c, ref_lens=lens, f=f)
        port._reset_host_paths(host)
    else:
        w, live, px, py, sc = convert.multi_otw_state_from_jax(*(np.asarray(a) for a in jax_f._state),
                                                               c=c, n_max=n_max, f=f)
        st.path_x.copy_(px)
        st.path_y.copy_(py)
    st.window.copy_(w)
    st.live.copy_(live)
    st.scalars.copy_(sc)
    _run(port, schedule[cut:third])

    back = _jax(refs, k_block=8, long_ref=long_ref)
    if long_ref:
        w2, win2, sc2, host2 = convert.multi_long_state_to_jax(st.window, st.live, st.scalars, port.paths(), c=c,
                                                               ref_lens=lens, f=f, k_block=8)
        back._state = (jnp.asarray(w2), jnp.asarray(win2), jnp.asarray(sc2))
        for i, p in enumerate(host2):
            back._host_px[i], back._host_py[i] = [p[:, 0]], [p[:, 1]]
            back._drained_plen[i] = len(p)
    else:
        back._state = tuple(jnp.asarray(a) for a in convert.multi_otw_state_to_jax(
            st.window, st.live, st.path_x, st.path_y, st.scalars, c=c, n_max=n_max, f=f))
    _assert_paths(_run(back, schedule[third:]), solo)
    _assert_paths(_run(port, schedule[third:]), solo)


@pytest.mark.parametrize("long_ref", [True, False], ids=["windowed", "whole"])
def test_status_readers_on_other_threads_while_the_feed_runs(long_ref):
    """``stopped`` / ``last_points`` polled from two reader threads while
    the main thread feeds, as the JAX package documents
    (parallel/polling.py:13-18; tests/test_aux.py:398-430 for the solo
    engine), with ``poll_min_interval = 0`` and a short thread switch
    interval so the threads interleave inside the polling sequence: no
    exception in any thread, and the final paths equal a single-threaded
    run's."""
    import sys
    import threading

    ref, live = _make_pair(np.random.default_rng(43), n_ref=80)
    b = 3

    def run(readers: int):
        f = _port(ref, n_streams=b, long_ref=long_ref)
        f.poll_min_interval = 0.0
        errors, done = [], threading.Event()

        def reader():
            try:
                while not done.is_set():
                    _ = f.stopped, f.last_points
            except Exception as e:  # the regression itself
                errors.append(e)

        threads = [threading.Thread(target=reader) for _ in range(readers)]
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for t in threads:
                t.start()
            for i in range(live.shape[1]):
                f.feed(np.repeat(live[None, :, i], b, axis=0))
            f.flush()
        finally:
            done.set()
            for t in threads:
                t.join(10)
            sys.setswitchinterval(switch)
        return errors, f.paths(), f.last_points

    errors, paths, points = run(readers=2)
    assert not errors, errors
    _, want, want_points = run(readers=0)
    for got, w in zip(paths, want):
        np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(points, want_points)
