"""The port's plain K-insert (``ops/otw_insert.insert_block_reference``)
against the JAX Pallas kernel ``_pallas_insert_block`` run in interpret
mode, launch by launch, with state carried through the converters of
``utils/convert.py``; its delta mode against its whole-path mode and
against the JAX long-reference kernel ``_pallas_insert_block_long``; and
the band-width rule that sends wide windows to global memory.

Tolerances: status, scalars, path and live history must be equal.  The
window is held to rtol 1e-6 (atol 1e-7 for cells near zero): the port sums
each 12-term cost sequentially over f while the JAX kernel reduces 128
lanes as a tree, so a cost can differ by an ulp (~6e-8 for unit columns),
and infinities/sentinels must match exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from real_time_audio_sync_tpu.models.fused_streaming import FusedStreamingEngine as JaxEngine  # noqa: E402
from real_time_audio_sync_tpu.ops.pallas_otw import _pallas_insert_block, _pallas_insert_block_long  # noqa: E402
from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES, OnlineConfig  # noqa: E402
from real_time_audio_sync_tpu_torch.ops import otw_insert  # noqa: E402
from real_time_audio_sync_tpu_torch.utils.convert import otw_state_from_jax, otw_state_to_jax  # noqa: E402

from tests.test_online import _make_pair, _unit_cols  # noqa: E402


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _round_up(x, m):
    return -(-x // m) * m


class _Pair:
    """The same stream through the JAX kernel and the port's plain version."""

    def __init__(self, ref, variant, c, mrc, k_block):
        ref = np.asarray(ref, np.float32)
        self.f, self.n = ref.shape
        self.c, self.k_block = c, k_block
        self.cap = 2 * self.n
        self.jax = JaxEngine(ref, {"c": c, "max_run_count": mrc},
                             cfg_overrides=ENGINE_OVERRIDES[variant], k_block=k_block, interpret=True)
        self.jax_state = self.jax._state
        self.cfg = OnlineConfig(c=c, max_run_count=mrc, **ENGINE_OVERRIDES[variant])
        self.port = otw_insert.new_state(torch.from_numpy(ref), self.cfg, self.cap)

    def launch_jax(self, cols):
        k = cols.shape[1]
        block = np.zeros((_round_up(self.k_block, 8), _round_up(self.f, 8)), np.float32)
        block[:k, : self.f] = cols.T
        lens = np.asarray([self.cap, self.n, k, 0], np.int32)
        *state, status = _pallas_insert_block(lens, self.jax.ref_t, block, *self.jax_state,
                                              self.jax.cfg, self.k_block, interpret=True)
        self.jax_state = tuple(state)
        return np.asarray(status)

    def launch_port(self, cols):
        rows = torch.from_numpy(np.ascontiguousarray(cols.T, dtype=np.float32))
        otw_insert.insert_block_reference(self.port, rows, (self.cap, self.n, cols.shape[1]),
                                          self.cfg, self.k_block)

    def jax_as_port(self):
        return otw_state_from_jax(*[np.asarray(a) for a in self.jax_state], c=self.c, n=self.n, f=self.f)

    def assert_equal(self, jax_status):
        w, live, px, py, sc = self.jax_as_port()
        p = self.port
        np.testing.assert_array_equal(p.status.numpy()[:4], jax_status[:4])
        np.testing.assert_array_equal(p.scalars.numpy(), sc.numpy())
        np.testing.assert_array_equal(p.path_x.numpy(), px.numpy())
        np.testing.assert_array_equal(p.path_y.numpy(), py.numpy())
        np.testing.assert_array_equal(p.live.numpy(), live.numpy())
        np.testing.assert_allclose(p.window.numpy(), w.numpy(), rtol=1e-6, atol=1e-7)

    def run(self, live, start=0):
        for s in range(start, live.shape[1], self.k_block):
            cols = live[:, s : s + self.k_block]
            status = self.launch_jax(cols)
            self.launch_port(cols)
            self.assert_equal(status)


def _stream(rng, variant, n_ref):
    """A tempo-warped pair whose live side runs past the reference's end."""
    ref, live = _make_pair(rng, n_ref=n_ref, stretch=1.0)
    live = np.concatenate([live, _unit_cols(rng.random((12, 4)) + 0.05)], axis=1)
    if variant == "livenote_v2_diff":  # Euclidean cost on chroma-diff features
        ref = np.clip(np.diff(ref, axis=1), 0, np.inf)
        live = np.clip(np.diff(live, axis=1), 0, np.inf)
    return ref.astype(np.float32), live.astype(np.float32)


# every variant meets every k_block, every band meets every variant
CASES = [
    ("otw", 3, 3, 1), ("otw", 10, 1, 2), ("otw", 25, 5, 8),
    ("livenote", 3, 3, 8), ("livenote", 10, 1, 1), ("livenote", 25, 5, 2),
    ("livenote_v2", 3, 3, 2), ("livenote_v2", 10, 1, 1), ("livenote_v2", 25, 5, 8),
    ("livenote_v2_diff", 3, 3, 1), ("livenote_v2_diff", 10, 1, 8), ("livenote_v2_diff", 25, 5, 2),
]


@pytest.mark.parametrize("variant,c,mrc,k_block", CASES)
def test_plain_insert_matches_jax_kernel_launch_by_launch(variant, c, mrc, k_block):
    rng = np.random.default_rng(100 + 7 * c + k_block)
    ref, live = _stream(rng, variant, n_ref=c + 15)  # 15 frames past the startup phase
    pair = _Pair(ref, variant, c, mrc, k_block)
    pair.run(live)
    # the live side runs past the reference: stop, then frozen no-op inserts
    assert pair.port.scalars[otw_insert.S_STOPPED] == 1


def test_capacity_freeze_matches_jax_kernel():
    """A live stream stuck on the first reference frame fills the 2N live
    capacity before j reaches the end: t keeps advancing with no further
    evaluation (otw_eran.py:50-54), and the engine does not stop."""
    rng = np.random.default_rng(31)
    ref = _unit_cols(rng.random((12, 12)) ** 4 + 0.01).astype(np.float32)
    live = _unit_cols(ref[:, :1] + 0.01 * rng.random((12, 36))).astype(np.float32)
    pair = _Pair(ref, "otw", 3, 5, 8)
    pair.run(live)
    sc = pair.port.scalars
    assert sc[otw_insert.S_T] >= pair.cap
    assert sc[otw_insert.S_STOPPED] == 0


def test_mid_stream_state_carries_across():
    """Run the JAX kernel alone for half the stream, carry its state into
    the port, continue both side by side; then carry the port's state back
    into the JAX layout and continue the JAX kernel from it."""
    rng = np.random.default_rng(7)
    ref, live = _stream(rng, "livenote_v2", n_ref=24)
    pair = _Pair(ref, "livenote_v2", 10, 3, 4)
    half = 12
    for s in range(0, half, 4):
        pair.launch_jax(live[:, s : s + 4])
    w, lv, px, py, sc = pair.jax_as_port()
    pair.port = otw_insert.OTWState(window=w, ref=pair.port.ref, live=lv, path_x=px, path_y=py,
                                    scalars=sc, status=pair.port.status)
    pair.run(live[:, : half + 8], start=half)
    # port → JAX: the converted state round-trips, and the JAX kernel
    # continues from it in step with the port
    p = pair.port
    pair.jax_state = otw_state_to_jax(p.window, p.live, p.path_x, p.path_y, p.scalars,
                                      c=10, n=pair.n, f=pair.f)
    for got, want in zip(pair.jax_as_port(), (p.window, p.live, p.path_x, p.path_y, p.scalars)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    pair.run(live, start=half + 8)


# ---------------------------------------------------------------------------
# Delta mode (TPU kernel _pallas_insert_block_long)
# ---------------------------------------------------------------------------


def _delta_row(cfg, k_block):
    return torch.full((otw_insert.N_STATUS + 2 * otw_insert.delta_slots(cfg, k_block),), -7, dtype=torch.int32)


@pytest.mark.parametrize("variant,c,mrc,k_block", CASES)
def test_delta_mode_matches_whole_path_mode(variant, c, mrc, k_block):
    """Launch by launch, the delta mode leaves the same window, live history
    and scalars as the whole-path mode, reports the same status, and its row
    holds exactly the points the whole path gained (zeros after them)."""
    rng = np.random.default_rng(300 + 7 * c + k_block)
    ref, live = _stream(rng, variant, n_ref=c + 15)
    cfg = OnlineConfig(c=c, max_run_count=mrc, **ENGINE_OVERRIDES[variant])
    n = ref.shape[1]
    cap = 2 * n
    whole = otw_insert.new_state(torch.from_numpy(ref), cfg, cap)
    delta = otw_insert.new_state(torch.from_numpy(ref), cfg, cap, whole_path=False)
    assert delta.path_x is None and delta.path_y is None
    d_pad = otw_insert.delta_slots(cfg, k_block)
    for s in range(0, live.shape[1], k_block):
        rows = torch.from_numpy(np.ascontiguousarray(live[:, s : s + k_block].T))
        lens = (cap, n, rows.shape[0])
        plen0 = int(whole.scalars[otw_insert.S_PLEN])
        otw_insert.insert_block_reference(whole, rows, lens, cfg, k_block)
        row = _delta_row(cfg, k_block)
        otw_insert.insert_block(delta, rows, lens, cfg, k_block, delta=row)  # CPU tensors: the plain version
        for name in ("window", "live", "scalars"):
            assert torch.equal(getattr(whole, name), getattr(delta, name)), name
        assert torch.equal(row[:8], whole.status)
        got = int(row[1]) - plen0
        assert 0 <= got <= d_pad
        assert torch.equal(row[8 : 8 + got], whole.path_x[plen0 : plen0 + got])
        assert torch.equal(row[8 + d_pad : 8 + d_pad + got], whole.path_y[plen0 : plen0 + got])
        assert not row[8 + got : 8 + d_pad].any() and not row[8 + d_pad + got :].any()
    assert whole.scalars[otw_insert.S_STOPPED] == 1


LONG_CASES = [("otw", 3, 3, 1), ("livenote", 10, 1, 2), ("livenote_v2", 25, 5, 8), ("livenote_v2_diff", 10, 3, 8)]


@pytest.mark.parametrize("variant,c,mrc,k_block", LONG_CASES)
def test_delta_mode_matches_jax_long_kernel_launch_by_launch(variant, c, mrc, k_block):
    """The plain delta mode against the JAX long-reference kernel (interpret
    mode) on one stream: equal status and equal committed points in every
    launch's row."""
    rng = np.random.default_rng(500 + 7 * c + k_block)
    ref, live = _stream(rng, variant, n_ref=c + 15)
    port = _run_long_against_jax(ref, live, variant, c, mrc, k_block)
    assert port.scalars[otw_insert.S_STOPPED] == 1


def _run_long_against_jax(ref, live, variant, c, mrc, k_block):
    """One stream through the plain delta mode and the JAX long-reference
    kernel (interpret mode), k_block columns a launch: equal status, equal
    committed points in every launch's row and equal scalars.  Returns the
    port's state."""
    from real_time_audio_sync_tpu.ops.pallas_otw import _LANES, _SUBLANES, _long_geometry, _round_up as ru

    f, n = ref.shape
    cap = 2 * n
    jeng = JaxEngine(ref, {"c": c, "max_run_count": mrc}, cfg_overrides=ENGINE_OVERRIDES[variant],
                     k_block=k_block, interpret=True, long_ref=True)
    jstate = jeng._state
    _, _, _, jd_pad = _long_geometry(jeng.cfg, c, ru(c + 1, _LANES), k_block)
    cfg = OnlineConfig(c=c, max_run_count=mrc, **ENGINE_OVERRIDES[variant])
    assert otw_insert.delta_slots(cfg, k_block) == jd_pad
    port = otw_insert.new_state(torch.from_numpy(ref), cfg, cap, whole_path=False)
    plen0 = 0
    for s in range(0, live.shape[1], k_block):
        cols = live[:, s : s + k_block]
        k = cols.shape[1]
        block = np.zeros((ru(k_block, _SUBLANES), ru(f, _SUBLANES)), np.float32)
        block[:k, :f] = cols.T
        lens = np.asarray([cap, n, k, 0], np.int32)
        w, lw, sc, status, dx, dy = _pallas_insert_block_long(lens, jeng.ref_t, block, *jstate, jeng.cfg,
                                                              k_block, interpret=True)
        jstate = (w, lw, sc)
        row = _delta_row(cfg, k_block)
        otw_insert.insert_block_reference(port, torch.from_numpy(np.ascontiguousarray(cols.T)), (cap, n, k), cfg,
                                          k_block, delta=row)
        status = np.asarray(status)
        np.testing.assert_array_equal(row[:4].numpy(), status[:4])
        got = int(status[1]) - plen0
        np.testing.assert_array_equal(row[8 : 8 + got].numpy(), np.asarray(dx)[:got])
        np.testing.assert_array_equal(row[8 + jd_pad : 8 + jd_pad + got].numpy(), np.asarray(dy)[:got])
        np.testing.assert_array_equal(port.scalars.numpy()[:11], np.asarray(sc)[:11])
        plen0 = int(status[1])
    return port


# ---------------------------------------------------------------------------
# B streams per launch (TPU kernels _pallas_multi_insert_block(_long))
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("whole_path", [True, False], ids=["whole", "delta"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_stream"])
def test_batched_plain_equals_solo_plain_stream_by_stream(whole_path, shared):
    """The batched plain version on a ragged batch — per-stream counts that
    include 0, references of different lengths (or one shared), a stream
    that stops past its reference's end and one that reaches the
    live-capacity freeze — equals the solo plain version run on each stream
    alone, launch by launch: window, live rows, scalars, status, path
    buffers or delta rows."""
    c, k_block, b = 6, 4, 5
    # max_run_count 5 and a reference of 3c + 30 frames let the stuck stream
    # (3) run out of live capacity before j reaches the end
    cfg = OnlineConfig(c=c, max_run_count=5, **ENGINE_OVERRIDES["livenote_v2"])
    rng = np.random.default_rng(800 + 2 * shared + whole_path)
    if shared:
        ref, _ = _stream(rng, "livenote_v2", n_ref=3 * c + 30)
        refs = [ref] * b
    else:
        refs = [_stream(rng, "livenote_v2", n_ref=3 * c + 30 if i == 3 else c + 6 + 3 * i)[0] for i in range(b)]
    lives = [_make_pair(np.random.default_rng(i), n_ref=r.shape[1], stretch=1.0)[1] for i, r in enumerate(refs)]
    lives[1] = np.concatenate([lives[1], _unit_cols(rng.random((12, 12)) + 0.05)], axis=1)  # stops
    lives[3] = _unit_cols(refs[3][:, :1] + 0.01 * rng.random((12, 2 * refs[3].shape[1] + 6)))  # freezes
    ref_t = [torch.from_numpy(r) for r in refs]
    state = otw_insert.new_multi_state([ref_t[0]] * b if shared else ref_t, cfg, whole_path=whole_path)
    assert state.ref.shape[0] == (1 if shared else b)
    solos = [otw_insert.new_state(r, cfg, 2 * r.shape[1], whole_path=whole_path) for r in ref_t]
    ptr = [0] * b
    width = otw_insert.delta_width(cfg, k_block)
    launch = 0
    while any(p < l.shape[1] for p, l in zip(ptr, lives)):
        ks = np.asarray([0 if (launch + i) % 4 == 0 else min(1 + (launch + i) % k_block, l.shape[1] - p)
                         for i, (p, l) in enumerate(zip(ptr, lives))], np.int32)
        cols = np.zeros((b, k_block, 12), np.float32)
        for i, (p, l) in enumerate(zip(ptr, lives)):
            cols[i, : ks[i]] = l[:, p : p + ks[i]].T
        rows = None if whole_path else torch.full((b, width), -7, dtype=torch.int32)
        otw_insert.multi_insert_block(state, torch.from_numpy(cols), torch.from_numpy(ks), cfg, k_block, rows)
        for i, solo in enumerate(solos):
            row = None if whole_path else torch.full((width,), -5, dtype=torch.int32)
            n = refs[i].shape[1]
            otw_insert.insert_block_reference(solo, torch.from_numpy(cols[i, : ks[i]]), (2 * n, n, int(ks[i])), cfg,
                                              k_block, row)
            view = state.stream(i)
            for name in ("window", "scalars"):
                assert torch.equal(getattr(view, name), getattr(solo, name)), (launch, i, name)
            assert torch.equal(view.live[: c + 2 * n], solo.live) and not view.live[c + 2 * n :].any()
            if whole_path:
                assert torch.equal(view.status, solo.status)
                p_len = solo.path_x.shape[0]
                assert torch.equal(view.path_x[:p_len], solo.path_x) and torch.equal(view.path_y[:p_len], solo.path_y)
            else:
                assert torch.equal(rows[i], row), (launch, i)
            ptr[i] += int(ks[i])
        launch += 1
    sc = state.scalars
    assert sc[1, otw_insert.S_STOPPED] == 1
    assert sc[3, otw_insert.S_T] >= 2 * refs[3].shape[1] and sc[3, otw_insert.S_STOPPED] == 0


def test_batched_wrapper_checks_its_arguments():
    cfg = OnlineConfig(c=4, max_run_count=3, **ENGINE_OVERRIDES["otw"])
    ref = torch.from_numpy(_unit_cols(np.random.default_rng(0).random((12, 10)) + 0.05).astype(np.float32))
    state = otw_insert.new_multi_state([ref, ref[:, :8]], cfg, whole_path=False)
    cols, ks = torch.zeros((2, 4, 12)), torch.ones(2, dtype=torch.int32)
    assert state.lens.tolist() == [[20, 10], [16, 8]]
    with pytest.raises(ValueError, match="path buffers"):
        otw_insert.multi_insert_block(state, cols, ks, cfg, 4)
    with pytest.raises(ValueError, match="delta"):
        otw_insert.multi_insert_block(state, cols, ks, cfg, 4, torch.zeros((2, 5), dtype=torch.int32))
    with pytest.raises(ValueError, match="cols"):
        otw_insert.multi_insert_block(state, torch.zeros((2, 5, 12)), ks, cfg, 4,
                                      torch.zeros((2, otw_insert.delta_width(cfg, 4)), dtype=torch.int32))
    with pytest.raises(ValueError, match="at least one band"):
        otw_insert.new_multi_state([ref[:, :3]], cfg)
    otw_insert.multi_launches = otw_insert.multi_delta_launches = 0
    otw_insert.multi_insert_block(state, cols, ks, cfg, 4,
                                  torch.zeros((2, otw_insert.delta_width(cfg, 4)), dtype=torch.int32))
    assert otw_insert.multi_launches == otw_insert.multi_delta_launches == 0  # the plain version counts nothing


def test_plain_euclidean_cost_is_correctly_rounded():
    """The plain version's Euclidean cost takes a correctly rounded square
    root, as the kernel's ``__fsqrt_rn`` and the card's ``torch.sqrt`` do,
    on every CPU (float32 ``torch.sqrt`` on AVX-512 is not: a card run of
    ``chip_smoke.py`` found the CPU plain version one ulp off the kernel on
    livenote_v2_diff)."""
    g = torch.Generator().manual_seed(0)
    for _ in range(200):
        rows = torch.rand((51, 12), generator=g) * 0.3
        fixed = torch.rand(12, generator=g) * 0.3
        d = (rows - fixed).numpy()
        s = np.zeros(51, np.float32)
        for f in range(12):
            s = (s + d[:, f] * d[:, f]).astype(np.float32)
        np.testing.assert_array_equal(otw_insert._cost(rows, fixed, True).numpy(), np.sqrt(s))


def test_wide_band_route_is_chosen_above_the_shared_memory_limit():
    """The band library decides where the (c+1)² window lives
    (``otw_band_workspace_floats``: 0 while the window and the scratch,
    4·((c+1)² + 4·nt + 4·32) bytes, fit the card's opt-in limit, else
    (c+1)²); the wrapper allocates exactly that, one window per block, asks
    once per device and band, and raises when the limit cannot be read.
    The library here answers as on an H100 (232,448 B): c = 237 fits,
    c = 238 does not; phase 9 of chip_smoke.py checks the real library."""
    h100 = 232448

    class Lib:
        calls = []

        def otw_band_workspace_floats(self, c, index):
            Lib.calls.append((c, index))
            nt = -(-(c + 1) // 32) * 32
            return 0 if 4 * ((c + 1) ** 2 + 4 * nt + 4 * 32) <= h100 else (c + 1) ** 2

    class Broken:
        def otw_band_workspace_floats(self, c, index):
            return -1

    dev = torch.device("cpu", 0)
    saved = dict(otw_insert._WORKSPACE_FLOATS)
    otw_insert._WORKSPACE_FLOATS.clear()
    try:
        for c in (10, 50, 200, 237):
            assert otw_insert.window_workspace(Lib(), c, 3, dev) is None
        for c in (238, 400):
            work = otw_insert.window_workspace(Lib(), c, 3, dev)
            assert work.shape == (3, (c + 1) ** 2) and work.dtype == torch.float32
        assert otw_insert.window_workspace(Lib(), 238, 5, dev).shape == (5, 239 * 239)
        assert Lib.calls == [(c, 0) for c in (10, 50, 200, 237, 238, 400)]
        with pytest.raises(RuntimeError, match="shared-memory limit"):
            otw_insert.window_workspace(Broken(), 60, 1, dev)
    finally:
        otw_insert._WORKSPACE_FLOATS.clear()
        otw_insert._WORKSPACE_FLOATS.update(saved)
