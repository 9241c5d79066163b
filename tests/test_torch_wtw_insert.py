"""The plain version of the port's streaming WTW kernel
(``ops/wtw_insert.wtw_insert_block_reference``) against the JAX package's
TPU kernel ``_pallas_wtw_insert_block`` run in Pallas interpret mode, launch
by launch on the same numpy-seeded inputs, and the wrapper's own contract.

Tolerance: none.  After every launch the scalars (all but slot 5, the JAX
kernel's live-window base, which the port does not keep), the status
``[flags, plen, lastx, lasty]``, the launch's valid delta entries and the
live rows a window can still read must be EQUAL.  The inputs are random
unit columns, so no two costs tie at the last ulp, where the two kernels'
dot orders (sequential here, the matrix unit's in JAX) could decide
differently."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from real_time_audio_sync_tpu.ops.pallas_wtw import _pallas_wtw_insert_block, _round_up  # noqa: E402
from real_time_audio_sync_tpu.ops.pallas_wtw import wtw_geometry as jax_geometry  # noqa: E402
from real_time_audio_sync_tpu_torch.ops import wtw_insert  # noqa: E402

W = 20
LAUNCHES = 6


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _scenario(seed, w, hop, scenario):
    """(ref (m, 12), live rows, m, n_cap, start (cp, lp, rp)).  Each starts
    mid-stream, so a k_block of 1 runs a window too.  "margin": a window
    falls due on the second column, and the live capacity puts live_ptr at
    n_cap-1-w after it, so the third column appends and stops.
    "capacity": chroma_ptr starts one column short of n_cap, w+3 columns
    ahead of live_ptr: the first column appends the last row and runs a
    window, the second finds no room (the capacity stop, before the
    increment)."""
    rng = np.random.default_rng(seed)
    m = 3 * w + hop
    if scenario == "margin":
        n_cap, cp0, lp0 = w + 1 + hop, w - 2, 0
    else:
        n_cap = 2 * m
        cp0 = n_cap - 1
        lp0 = cp0 - (w + 3)
    ref = _unit(rng.random((m, 12)) + 0.05)
    path = np.clip(np.cumsum(rng.integers(0, 3, n_cap + 64)) // 2, 0, m - 1)
    live = _unit(ref[path] + 0.1 * rng.random((n_cap + 64, 12)))
    return ref, live, m, n_cap, (cp0, lp0, 0)


def _jax_state(ref, live, m, sc0, w, hop, k_block):
    _, _, l_pad, r_win, _, _ = jax_geometry(w, hop, k_block)
    ref_t = np.zeros((_round_up(m + r_win + 8, 8), 128), np.float32)
    ref_t[:m, :12] = ref
    cp, lp, _ = sc0
    win = np.zeros((l_pad, 128), np.float32)
    win[: cp - lp, :12] = live[lp:cp]
    sc = np.zeros(16, np.int32)
    sc[:3] = sc0
    sc[5] = lp  # the window's base
    return jnp.asarray(ref_t), jnp.asarray(win), jnp.asarray(sc)


def _port_state(ref, live, n_cap, sc0):
    st = wtw_insert.new_state(torch.from_numpy(ref.T.copy()), n_cap)
    cp = sc0[0]
    st.live[:cp] = torch.from_numpy(live[:cp])  # frames before live_ptr are never read again
    st.scalars[:3] = torch.tensor(sc0, dtype=torch.int32)
    return st


@pytest.mark.parametrize("scenario", ["margin", "capacity"])
@pytest.mark.parametrize("k_block", [1, 5, 8])
@pytest.mark.parametrize("hop", [10, 30], ids=["hop10", "hop30_exceeds_w"])
def test_plain_equals_jax_kernel_launch_by_launch(hop, k_block, scenario):
    ref, live, m, n_cap, sc0 = _scenario(100 * hop + 10 * k_block + len(scenario), W, hop, scenario)
    ref_t, jwin, jsc = _jax_state(ref, live, m, sc0, W, hop, k_block)
    st = _port_state(ref, live, n_cap, sc0)
    k_pad = _round_up(k_block, 8)
    d_pad = wtw_insert.wtw_geometry(W, hop, k_block)[2]
    pos, stopped_at, windows = sc0[0], None, 0
    for launch in range(LAUNCHES):
        n_valid = k_block if launch % 3 != 1 else max(1, k_block - 2)  # a ragged block now and then
        cols = np.zeros((k_pad, 12), np.float32)
        cols[:k_block] = live[pos : pos + k_block]
        jwin, jsc, jstatus, jdx, jdy = _pallas_wtw_insert_block(
            jnp.asarray(np.array([m, n_cap, n_valid, 0], np.int32)), ref_t, jnp.asarray(cols), jwin, jsc,
            w=W, hop_frames=hop, k_block=k_block, interpret=True)
        row = torch.full((wtw_insert.delta_width(W, hop, k_block),), -7, dtype=torch.int32)
        plen0 = int(st.scalars[wtw_insert.WS_PLEN])
        wtw_insert.wtw_insert_block(st, torch.from_numpy(cols[:k_block].copy()), (m, n_cap, n_valid), W, hop,
                                    k_block, row)
        got_sc, want_sc = st.scalars.numpy(), np.asarray(jsc)
        keep = np.arange(16) != wtw_insert.WS_BASE
        np.testing.assert_array_equal(got_sc[keep], want_sc[keep], err_msg=f"launch {launch}: scalars")
        status, dx, dy = (v.numpy() for v in wtw_insert.delta_views(row))
        np.testing.assert_array_equal(status[:4], np.asarray(jstatus)[:4], err_msg=f"launch {launch}: status")
        assert not status[4:].any()
        n_new = int(status[1]) - plen0
        assert not status[0] & 2 and 0 <= n_new <= d_pad
        np.testing.assert_array_equal(dx[:n_new], np.asarray(jdx)[:n_new], err_msg=f"launch {launch}: dx")
        np.testing.assert_array_equal(dy[:n_new], np.asarray(jdy)[:n_new], err_msg=f"launch {launch}: dy")
        assert not dx[n_new:].any() and not dy[n_new:].any()  # the row's unused slots read 0
        windows += n_new > 0
        cp, lp, base = int(got_sc[0]), int(got_sc[1]), int(want_sc[wtw_insert.WS_BASE])
        if cp > lp:  # a hop past the window can leave live_ptr ahead of the appended frames
            np.testing.assert_array_equal(st.live[lp:cp].numpy(), np.asarray(jwin)[lp - base : cp - base, :12])
        if status[0] & 1 and stopped_at is None:
            stopped_at = launch
        pos = cp
    # each case stops, then runs frozen launches; the JAX status carries it
    assert stopped_at is not None and stopped_at < LAUNCHES - 1 and windows >= 1


def test_frozen_launch_after_stop_changes_nothing():
    ref, live, m, n_cap, sc0 = _scenario(5, W, 10, "margin")
    st = _port_state(ref, live, n_cap, sc0)
    row = torch.empty(wtw_insert.delta_width(W, 10, 8), dtype=torch.int32)
    cols = torch.from_numpy(live[sc0[0] : sc0[0] + 8].copy())
    wtw_insert.wtw_insert_block(st, cols, (m, n_cap, 8), W, 10, 8, row)
    assert int(st.scalars[wtw_insert.WS_FLAGS]) & 1
    before = (st.scalars.clone(), st.live.clone(), row.clone())
    wtw_insert.wtw_insert_block(st, cols, (m, n_cap, 8), W, 10, 8, row)
    assert torch.equal(st.scalars, before[0]) and torch.equal(st.live, before[1])
    assert torch.equal(row[:4], before[2][:4]) and not row[8:].any()  # status kept, no new points


def test_window_cost_is_the_sequential_cosine_cost():
    """The plain cost (the kernel's order) equals a float64 cosine cost to
    float32 rounding, divides by the norms, and gives the reference's
    non-finite values on a zero column; the float64 root rounded to
    float32 is the correctly rounded root (``__fsqrt_rn``)."""
    rng = np.random.default_rng(3)
    x = rng.random((7, 12)).astype(np.float32) * 3
    y = rng.random((5, 12)).astype(np.float32)
    got = wtw_insert.window_cost(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    xd, yd = x.astype(np.float64), y.astype(np.float64)
    want = 1 - (xd @ yd.T) / np.outer(np.linalg.norm(xd, axis=1), np.linalg.norm(yd, axis=1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    x[2] = 0
    got = wtw_insert.window_cost(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert np.isnan(got[2]).all() and np.isfinite(np.delete(got, 2, axis=0)).all()
    s = torch.from_numpy(rng.random(4096).astype(np.float32) * 100)
    want_root = np.sqrt(s.numpy().astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(wtw_insert._sqrt_rn(s).numpy(), want_root)


def test_geometry_matches_jax():
    for w, hop, k in ((20, 10, 8), (100, 50, 8), (128, 64, 32), (20, 30, 1), (4, 10, 8)):
        _, _, _, _, d_pad, maxpts = jax_geometry(w, hop, k)
        n_w, got_maxpts, got_d_pad = wtw_insert.wtw_geometry(w, hop, k)
        assert (got_maxpts, got_d_pad) == (maxpts, d_pad) and n_w == 1 + -(-k // hop)
        assert wtw_insert.delta_width(w, hop, k) == 8 + 2 * d_pad


def test_wrapper_checks_its_arguments():
    ref, live, m, n_cap, sc0 = _scenario(9, W, 10, "capacity")
    st = _port_state(ref, live, n_cap, sc0)
    row = torch.empty(wtw_insert.delta_width(W, 10, 8), dtype=torch.int32)
    cols = torch.from_numpy(live[:8].copy())
    with pytest.raises(ValueError, match="n_valid"):
        wtw_insert.wtw_insert_block(st, cols, (m, n_cap, 9), W, 10, 8, row)
    with pytest.raises(ValueError, match="shape"):
        wtw_insert.wtw_insert_block(st, cols, (m, n_cap, 8), W, 10, 8, row[:-1])
    with pytest.raises(ValueError, match="1..128"):
        wtw_insert.wtw_insert_block(st, cols, (m, n_cap, 8), 129, 10, 8,
                                    torch.empty(wtw_insert.delta_width(129, 10, 8), dtype=torch.int32))
    with pytest.raises(TypeError, match="float32"):
        wtw_insert.wtw_insert_block(st, cols.double(), (m, n_cap, 8), W, 10, 8, row)
    with pytest.raises(ValueError, match="rows"):
        wtw_insert.wtw_insert_block(st, cols, (m + 1, n_cap, 8), W, 10, 8, row)
    before = wtw_insert.launches
    wtw_insert.wtw_insert_block(st, cols, (m, n_cap, 8), W, 10, 8, row)
    assert wtw_insert.launches == before  # CPU tensors run the plain version, uncounted


def _jax_order_cost(x, y):
    """The JAX kernel's cost arithmetic on the port's (w, F) windows
    (pallas_wtw.py:202-216): the dots as one float32 ``dot_general`` over
    128 zero-padded lanes, the norms as 128-lane sums, the same division."""
    from jax import lax

    w = x.shape[0]
    xp = np.zeros((_round_up(w, 8), 128), np.float32)
    yp = np.zeros((128, 128), np.float32)
    xp[:w, :12], yp[:w, :12] = x.numpy(), y.numpy()
    xj, yj = jnp.asarray(xp), jnp.asarray(yp)
    hi = lax.Precision.HIGHEST
    dots = lax.dot_general(xj, yj, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32, precision=hi)
    nx = jnp.sqrt(jnp.sum(xj * xj, axis=1, keepdims=True))
    ny = lax.dot_general(jnp.sqrt(jnp.sum(yj * yj, axis=1, keepdims=True)), jnp.eye(128, dtype=jnp.float32),
                         (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32, precision=hi)
    return torch.from_numpy(np.asarray(1.0 - dots / (nx * ny))[:w, :w].copy())


def test_tie_heavy_audio_differs_only_by_the_cost_reduction_order(tmp_path, monkeypatch):
    """The numerics hazard of pallas_wtw.py:26-36, on shared features (the
    synthetic corpus's jittered pair: chords held for a beat, so window
    cells tie to the last ulp): the port sums each 12-term dot in order,
    the JAX kernel over 128 lanes in the matrix unit's order, and the two
    may take a tie differently.  With the JAX kernel's cost arithmetic put
    in place of the port's, the plain version equals the JAX kernel on
    every launch to the stop, so the DP, backtrack, commit and stop logic
    agree and only the cost's rounding can part them."""
    from real_time_audio_sync_tpu_torch.eval import synthetic
    from real_time_audio_sync_tpu_torch.features.chroma import chroma_from_samples, host_chroma_frames
    from real_time_audio_sync_tpu_torch.utils.wavio import load_wav

    synthetic.build_corpus(str(tmp_path), ["jittered"])
    ref_pcm, _ = load_wav(str(tmp_path / "jittered" / "jittered_00.wav"))
    live_pcm, _ = load_wav(str(tmp_path / "jittered" / "jittered_01.wav"))
    ref = chroma_from_samples(ref_pcm, device="cpu").numpy().T.copy()
    frames = np.lib.stride_tricks.sliding_window_view(live_pcm.astype(np.float32), 4096)[::2048]
    live = host_chroma_frames(np.array(frames)).T.copy()
    w, hop, k = W, 10, 8
    m, n_cap = ref.shape[0], 2 * ref.shape[0]
    ref_t, jwin, jsc = _jax_state(ref, live, m, (0, 0, 0), w, hop, k)
    ports = {"own": _port_state(ref, live, n_cap, (0, 0, 0)), "jax_order": _port_state(ref, live, n_cap, (0, 0, 0))}
    own_parts = None
    for launch in range(len(live) // k):
        cols = live[launch * k : (launch + 1) * k]
        jwin, jsc, jstatus, jdx, jdy = _pallas_wtw_insert_block(
            jnp.asarray(np.array([m, n_cap, k, 0], np.int32)), ref_t, jnp.asarray(cols), jwin, jsc,
            w=w, hop_frames=hop, k_block=k, interpret=True)
        for name, st in ports.items():
            with monkeypatch.context() as mp:
                if name == "jax_order":
                    mp.setattr(wtw_insert, "window_cost", _jax_order_cost)
                row = torch.empty(wtw_insert.delta_width(w, hop, k), dtype=torch.int32)
                plen0 = int(st.scalars[wtw_insert.WS_PLEN])
                wtw_insert.wtw_insert_block(st, torch.from_numpy(cols.copy()), (m, n_cap, k), w, hop, k, row)
            n_new = int(row[1]) - plen0
            same = (np.array_equal(np.delete(st.scalars.numpy(), 5), np.delete(np.asarray(jsc), 5))
                    and np.array_equal(row[8 : 8 + n_new].numpy(), np.asarray(jdx)[:n_new]))
            if name == "jax_order":
                assert same, f"launch {launch}"
            elif not same and own_parts is None:
                own_parts = launch
        if int(jsc[wtw_insert.WS_FLAGS]) & 1:
            break
    assert int(jsc[wtw_insert.WS_FLAGS]) & 1 and int(jsc[wtw_insert.WS_PLEN]) > 100
    print(f"jittered: the port's own cost order first parts from the JAX kernel at launch {own_parts} "
          f"of {launch + 1}")
