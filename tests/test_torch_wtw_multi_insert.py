"""The plain version of the port's B-stream WTW launch
(``ops/wtw_insert.multi_wtw_insert_block_reference``) against the JAX
package's TPU kernel ``_pallas_multi_wtw_insert_block`` run in Pallas
interpret mode, launch by launch on the same numpy-seeded inputs, and
against the solo plain version on each stream alone; and the wrapper's own
contract.

Tolerance: none.  After every launch, for every stream: the scalars (all
but slot 5, the JAX kernel's live-window base, which the port does not
keep), the status ``[flags, plen, lastx, lasty]``, the launch's valid
delta entries and the live rows a window can still read EQUAL the JAX
kernel's, and the row, scalars and live history EQUAL the solo plain
version's.  The inputs are random unit columns, so no two costs tie at the
last ulp, where the two kernels' dot orders could decide differently."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from real_time_audio_sync_tpu.ops.pallas_wtw import _pallas_multi_wtw_insert_block, _round_up  # noqa: E402
from real_time_audio_sync_tpu.ops.pallas_wtw import wtw_geometry as jax_geometry  # noqa: E402
from real_time_audio_sync_tpu_torch.ops import wtw_insert  # noqa: E402

from tests.test_torch_wtw_insert import _port_state, _scenario, _unit  # noqa: E402

W, HOP = 20, 10
LAUNCHES = 10


def _running(seed, m, w=W):
    """A stream mid-way: w-1 columns past live_ptr, so its next column
    makes a window due; the live rows follow the reference with jitter."""
    rng = np.random.default_rng(seed)
    n_cap = 2 * m
    ref = _unit(rng.random((m, 12)) + 0.05)
    path = np.clip(np.cumsum(rng.integers(0, 3, n_cap + 64)) // 2, 0, m - 1)
    live = _unit(ref[path] + 0.1 * rng.random((n_cap + 64, 12)))
    return ref, live, m, n_cap, (w - 1, 0, 0)


def _batch(case, k_block):
    """(streams, shared): each stream (ref, live, m, n_cap, start).
    "ragged": three references of different lengths; "stops": five
    streams, stream 1 reaching its margin stop and stream 3 its capacity
    stop; "shared": one reference, three performances of it."""
    seed = 10 * k_block + len(case)
    if case == "ragged":
        return [_running(seed + i, 3 * W + HOP + 7 * i) for i in range(3)], False
    if case == "stops":
        return [_running(seed, 3 * W + HOP), _scenario(seed + 1, W, HOP, "margin"), _running(seed + 2, 4 * W),
                _scenario(seed + 3, W, HOP, "capacity"), _running(seed + 4, 3 * W + 5)], False
    ref, live, m, n_cap, start = _running(seed, 4 * W)
    rng = np.random.default_rng(seed + 1)
    others = [_unit(ref[np.clip(np.cumsum(rng.integers(0, 3, n_cap + 64)) // 2, 0, m - 1)]
                    + 0.1 * rng.random((n_cap + 64, 12))) for _ in range(2)]
    return [(ref, lv, m, n_cap, start) for lv in [live] + others], True


def _counts(launch, b, k_block):
    """Per-stream column counts 0..k_block, ragged across streams and launches."""
    return (3 * launch + 5 * b + 1) % (k_block + 1)


def _jax_batch(streams, shared, k_block):
    _, _, l_pad, r_win, _, _ = jax_geometry(W, HOP, k_block)
    m_max = max(s[2] for s in streams)
    r_rows = _round_up(m_max + r_win + 8, 8)
    refs = streams[:1] if shared else streams
    ref_t = np.zeros((len(refs), r_rows, 128), np.float32)
    for i, (ref, _, m, _, _) in enumerate(refs):
        ref_t[i, :m, :12] = ref
    win = np.zeros((len(streams), l_pad, 128), np.float32)
    sc = np.zeros((len(streams), 1, 16), np.int32)
    for b, (_, live, _, _, (cp, lp, rp)) in enumerate(streams):
        win[b, : cp - lp, :12] = live[lp:cp]
        sc[b, 0, :3] = cp, lp, rp
        sc[b, 0, 5] = lp  # the window's base
    return jnp.asarray(ref_t), jnp.asarray(win), jnp.asarray(sc)


def _port_batch(streams, shared):
    refs = [torch.from_numpy(s[0].T.copy()) for s in (streams[:1] if shared else streams)]
    st = wtw_insert.new_multi_state(refs * len(streams) if shared else refs, [s[3] for s in streams])
    for b, (_, live, _, _, start) in enumerate(streams):
        st.live[b, : start[0]] = torch.from_numpy(live[: start[0]])
        st.scalars[b, :3] = torch.tensor(start, dtype=torch.int32)
    return st


@pytest.mark.parametrize("k_block", [1, 8])
@pytest.mark.parametrize("case", ["ragged", "stops", "shared"])
def test_batched_plain_equals_jax_kernel_and_solo_launch_by_launch(case, k_block):
    streams, shared = _batch(case, k_block)
    b_n = len(streams)
    ref_t, jwin, jsc = _jax_batch(streams, shared, k_block)
    st = _port_batch(streams, shared)
    assert st.ref.shape[0] == (1 if shared else b_n)
    solos = [_port_state(ref, live, n_cap, start) for ref, live, _, n_cap, start in streams]
    k_pad = _round_up(k_block, 8)
    width = wtw_insert.delta_width(W, HOP, k_block)
    d_pad = wtw_insert.wtw_geometry(W, HOP, k_block)[2]
    windows, stop_launch = np.zeros(b_n, int), [None] * b_n
    for launch in range(LAUNCHES):
        ks = [_counts(launch, b, k_block) for b in range(b_n)]
        cols = np.zeros((b_n, k_pad, 12), np.float32)
        for b, (_, live, _, _, _) in enumerate(streams):
            pos = int(st.scalars[b, wtw_insert.WS_CHROMA])
            cols[b, :k_block] = live[pos : pos + k_block]
        lens = np.array([[s[2], s[3], k] for s, k in zip(streams, ks)], np.int32)
        jlens = np.concatenate([lens, np.zeros((b_n, 1), np.int32)], axis=1)[:, None]
        jwin, jsc, jstatus, jdx, jdy = _pallas_multi_wtw_insert_block(
            jnp.asarray(jlens), ref_t, jnp.asarray(cols), jwin, jsc, w=W, hop_frames=HOP, k_block=k_block,
            shared_ref=shared, interpret=True)
        plen0 = st.scalars[:, wtw_insert.WS_PLEN].clone()
        rows = torch.full((b_n, width), -7, dtype=torch.int32)
        wtw_insert.multi_wtw_insert_block(st, torch.from_numpy(cols[:, :k_block].copy()), torch.from_numpy(lens),
                                          W, HOP, k_block, rows)
        for b in range(b_n):
            what = f"launch {launch}, stream {b}"
            solo_row = torch.empty(width, dtype=torch.int32)
            wtw_insert.wtw_insert_block_reference(solos[b], torch.from_numpy(cols[b, :k_block].copy()),
                                                  tuple(lens[b]), W, HOP, k_block, solo_row)
            assert torch.equal(rows[b], solo_row), what
            assert torch.equal(st.scalars[b], solos[b].scalars), what
            assert torch.equal(st.live[b, : streams[b][3]], solos[b].live), what
            got_sc, want_sc = st.scalars[b].numpy(), np.asarray(jsc)[b, 0]
            keep = np.arange(16) != wtw_insert.WS_BASE
            np.testing.assert_array_equal(got_sc[keep], want_sc[keep], err_msg=f"{what}: scalars")
            status, dx, dy = (v.numpy() for v in wtw_insert.delta_views(rows[b]))
            np.testing.assert_array_equal(status[:4], np.asarray(jstatus)[b, 0, :4], err_msg=f"{what}: status")
            assert not status[4:].any()
            n_new = int(status[1]) - int(plen0[b])
            assert not status[0] & 2 and 0 <= n_new <= d_pad
            np.testing.assert_array_equal(dx[:n_new], np.asarray(jdx)[b, 0, :n_new], err_msg=f"{what}: dx")
            np.testing.assert_array_equal(dy[:n_new], np.asarray(jdy)[b, 0, :n_new], err_msg=f"{what}: dy")
            assert not dx[n_new:].any() and not dy[n_new:].any()  # the row's unused slots read 0
            windows[b] += n_new > 0
            cp, lp, base = int(got_sc[0]), int(got_sc[1]), int(want_sc[wtw_insert.WS_BASE])
            if cp > lp:
                np.testing.assert_array_equal(st.live[b, lp:cp].numpy(), np.asarray(jwin)[b, lp - base : cp - base, :12])
            if status[0] & 1 and stop_launch[b] is None:
                stop_launch[b] = launch
    assert (windows > 0).all()  # every stream ran a window
    if case == "stops":  # the margin and capacity stops, each followed by frozen launches
        assert stop_launch[1] is not None and stop_launch[3] is not None
        assert max(stop_launch[1], stop_launch[3]) < LAUNCHES - 2
        assert int(st.scalars[3, wtw_insert.WS_CHROMA]) == streams[3][3]  # the capacity stop: n_cap appended


def test_batched_wrapper_checks_its_arguments():
    streams, _ = _batch("ragged", 8)
    st = _port_batch(streams, False)
    width = wtw_insert.delta_width(W, HOP, 8)
    rows = torch.empty((3, width), dtype=torch.int32)
    cols = torch.zeros((3, 8, 12))
    lens = torch.tensor([[s[2], s[3], 8] for s in streams], dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        wtw_insert.multi_wtw_insert_block(st, cols, lens[:2], W, HOP, 8, rows)
    with pytest.raises(ValueError, match="shape"):
        wtw_insert.multi_wtw_insert_block(st, cols, lens, W, HOP, 8, rows[:, :-1])
    with pytest.raises(ValueError, match="cols"):
        wtw_insert.multi_wtw_insert_block(st, torch.zeros((3, 9, 12)), lens, W, HOP, 8, rows)
    with pytest.raises(ValueError, match="1..128"):
        wtw_insert.multi_wtw_insert_block(st, cols, lens, 129, HOP, 8,
                                          torch.empty((3, wtw_insert.delta_width(129, HOP, 8)), dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        wtw_insert.multi_wtw_insert_block(st, cols, lens.long(), W, HOP, 8, rows)
    bad = lens.clone()
    bad[1, 0] = st.ref.shape[1] + 1  # a reference length past the stack's rows
    with pytest.raises(ValueError, match="rows"):
        wtw_insert.multi_wtw_insert_block(st, cols, bad, W, HOP, 8, rows)
    with pytest.raises(ValueError, match="one live capacity per reference"):
        wtw_insert.new_multi_state([st.ref[0].T], [])
    before = wtw_insert.multi_launches
    wtw_insert.multi_wtw_insert_block(st, cols, lens, W, HOP, 8, rows)
    assert wtw_insert.multi_launches == before  # CPU tensors run the plain version, uncounted


def test_new_multi_state_stores_a_shared_reference_once():
    rng = np.random.default_rng(4)
    a, b = (torch.from_numpy(_unit(rng.random((n, 12))).T.copy()) for n in (30, 45))
    shared = wtw_insert.new_multi_state([a] * 4, [60] * 4)
    assert shared.ref.shape == (1, 30, 12) and torch.equal(shared.ref[0], a.T)
    mixed = wtw_insert.new_multi_state([a, b, a], [60, 90, 60])
    assert mixed.ref.shape == (3, 45, 12) and mixed.live.shape == (3, 90, 12)
    assert torch.equal(mixed.ref[1], b.T) and not mixed.ref[0, 30:].any()
    assert torch.equal(mixed.stream(2).ref, mixed.ref[2]) and not mixed.scalars.any()
