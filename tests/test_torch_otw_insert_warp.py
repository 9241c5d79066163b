"""The K-insert kernel's one-warp design (``csrc/otw_insert.cu``,
``otw_insert_kernel_warp``: bands up to c = 255) on the CPU:

- the plain version (``ops/otw_insert``) against the JAX Pallas kernels in
  interpret mode, launch by launch, at the warp's lane edges (c = 31, 32,
  63, 64) in both modes, for streams fed launches after they stop and after
  the live-capacity freeze, and for a stream with count 0 in a batch;
- a model of the kernel's launch on tensors — the window's ring offsets
  handed from the chain to the copy out, the two feature rings filled at
  the launch's start and advanced by the inserted column and the fetched
  reference row (or, where the rings do not fit, the rows read from
  device memory at the band's base), the first insert's ring slot, the
  row update and the column rounds through one call site — against the
  plain version, launch by launch, with every device row read checked to
  exist;
- the window's route, with a library that answers as an H100.

Tolerances: against JAX, status, scalars, path and live history equal and
the window to rtol 1e-6 (the JAX kernel sums the cost over 128 lanes as a
tree, so a cost can differ by an ulp); the model against the plain version
at tolerance 0 (``torch.equal``): it computes each band line with the
plain version's own functions on the same operands.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from real_time_audio_sync_tpu_torch.models.online_core import COL, ENGINE_OVERRIDES, ROW, OnlineConfig  # noqa: E402
from real_time_audio_sync_tpu_torch.ops import otw_insert  # noqa: E402
from real_time_audio_sync_tpu_torch.ops.otw_insert import (  # noqa: E402
    S_DIR, S_FIRST, S_J, S_LASTX, S_LASTY, S_OVERFLOW, S_PLEN, S_PREV, S_RC, S_STOPPED, S_T)

from tests.test_online import _unit_cols  # noqa: E402
from tests.test_torch_otw_insert import _Pair, _run_long_against_jax, _stream  # noqa: E402


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _cfg(variant, c, mrc=3):
    return OnlineConfig(c=c, max_run_count=mrc, **ENGINE_OVERRIDES[variant])


# ---------------------------------------------------------------------------
# The plain version against the JAX kernels
# ---------------------------------------------------------------------------

# both sides of the lane edges (1 -> 2 and 2 -> 4 band registers a lane),
# each with another variant, so the dot and the Euclidean cost meet both
LANE_EDGES = [("otw", 31, 3), ("livenote_v2_diff", 32, 3), ("livenote", 63, 5), ("livenote_v2", 64, 3)]


@pytest.mark.parametrize("mode", ["whole", "delta"])
@pytest.mark.parametrize("variant,c,mrc", LANE_EDGES)
def test_plain_matches_jax_kernel_at_the_lane_edges(variant, c, mrc, mode):
    rng = np.random.default_rng(1500 + c)
    ref, live = _stream(rng, variant, n_ref=c + 15)
    if mode == "whole":
        pair = _Pair(ref, variant, c, mrc, 8)
        pair.run(live)
        port = pair.port
    else:
        port = _run_long_against_jax(ref, live, variant, c, mrc, 8)
    assert port.scalars[S_STOPPED] == 1


@pytest.mark.parametrize("mode", ["whole", "delta"])
@pytest.mark.parametrize("after", ["stop", "capacity"])
def test_plain_matches_jax_kernel_on_launches_past_a_stop_or_the_freeze(after, mode):
    """Three more launches of k_block 8 after the stream stopped past its
    reference's end (c = 32), or after t reached the 2N live capacity
    (c = 10, max_run_count 5): every one a frozen no-op in both."""
    rng = np.random.default_rng(1600 + (after == "stop"))
    if after == "stop":
        c, mrc, variant = 32, 3, "livenote_v2"
        ref, live = _stream(rng, variant, n_ref=c + 15)
        live = np.concatenate([live, _unit_cols(rng.random((12, 24)) + 0.05).astype(np.float32)], axis=1)
    else:
        c, mrc, variant = 10, 5, "otw"
        ref = _unit_cols(rng.random((12, 3 * c + 6)) ** 4 + 0.01).astype(np.float32)
        live = _unit_cols(ref[:, :1] + 0.01 * rng.random((12, 2 * ref.shape[1] + 24))).astype(np.float32)
    if mode == "whole":
        pair = _Pair(ref, variant, c, mrc, 8)
        pair.run(live)
        sc = pair.port.scalars
    else:
        sc = _run_long_against_jax(ref, live, variant, c, mrc, 8).scalars
    if after == "stop":
        assert sc[S_STOPPED] == 1
    else:
        assert sc[S_T] >= 2 * ref.shape[1] + 16 and sc[S_STOPPED] == 0


def test_count_zero_stream_in_a_batch_matches_jax_kernel():
    """Two streams on one reference in the batched plain version, the
    second given count 0 in every other launch: each stream's state equals
    the JAX kernel's run on it alone, with an empty launch where its count
    is 0."""
    c, k_block = 32, 8
    rng = np.random.default_rng(1700)
    ref, live = _stream(rng, "otw", n_ref=c + 15)
    cfg = _cfg("otw", c)
    pairs = [_Pair(ref, "otw", c, 3, k_block) for _ in range(2)]
    ref_t = torch.from_numpy(ref)
    batch = otw_insert.new_multi_state([ref_t, ref_t], cfg)
    for i, p in enumerate(pairs):
        p.port = batch.stream(i)
    ptr = [0, 0]
    launch = 0
    while min(ptr) < live.shape[1]:
        ks = np.asarray([min(k_block, live.shape[1] - ptr[0]),
                         0 if launch % 2 else min(k_block - 3, live.shape[1] - ptr[1])], np.int32)
        cols = np.zeros((2, k_block, 12), np.float32)
        for i in range(2):
            cols[i, : ks[i]] = live[:, ptr[i] : ptr[i] + ks[i]].T
        otw_insert.multi_insert_block(batch, torch.from_numpy(cols), torch.from_numpy(ks), cfg, k_block)
        for i, p in enumerate(pairs):
            status = p.launch_jax(live[:, ptr[i] : ptr[i] + ks[i]])
            p.assert_equal(status)
            ptr[i] += int(ks[i])
        launch += 1
    assert batch.scalars[0, S_STOPPED] == 1 and batch.scalars[1, S_STOPPED] == 1


# ---------------------------------------------------------------------------
# A model of the one-warp kernel's launch
# ---------------------------------------------------------------------------


class _Rows:
    """The feature rows of one band (``BandRows``): padded rows base..base+c
    of ``rows``, in a ring (``kRing``: slots (head + k) mod (c+1)) or read
    where they lie in device memory.  Every device row it reads must exist:
    ``limit`` is the first row past the stream's."""

    def __init__(self, rows, c, base, limit, ring):
        self.rows, self.L, self.base, self.head, self.limit = rows, c + 1, base, 0, limit
        self.ring = torch.full((c + 1, rows.shape[1]), float("nan")) if ring else None
        self.next = None

    def _read(self, r):
        assert 0 <= r < self.limit, f"row {r} read past the stream's {self.limit} rows"
        return self.rows[r].clone()

    def fill(self):
        for k in range(self.L):
            self.ring[k] = self._read(self.base + k)

    def fetch(self):
        self.next = self._read(self.base + self.L)

    def advance(self):
        if self.ring is not None:
            self.ring[self.head] = self.next
            self.head = (self.head + 1) % self.L
        self.base += 1
        self.next = None

    def band(self):
        """Rows base..base+c, in band order."""
        if self.ring is None:
            return torch.stack([self._read(self.base + k) for k in range(self.L)])
        return self.ring[(self.head + torch.arange(self.L)) % self.L]


def _warp_launch(st, cols, lens, cfg, k_block, delta=None, ring=True):
    """The launch of ``otw_insert_kernel_warp`` on tensors, in place on
    ``st`` (an ``OTWState``), with the band's rows in rings (``ring``) or
    read from device memory; the band's numerics are the plain version's
    (``_cost``, ``_band_step``, ``best_point``, ``append_point``,
    ``set_direction``), its bookkeeping the kernel's."""
    c, L = cfg.c, cfg.c + 1
    live_cap, ref_len, n_valid = lens
    sentinel = float(cfg.sentinel)
    sc = st.scalars.tolist()
    t0, j0 = sc[S_T], sc[S_J]
    updates = n_valid > 0 and sc[S_STOPPED] == 0
    W = st.window.clone()  # at the launch's start the ring offsets are 0
    ring = [0, 0]  # ro, co
    refs = _Rows(st.ref, c, j0, c + ref_len, ring)
    lives = _Rows(st.live, c, t0, c + live_cap, ring)
    if ring and updates:
        refs.fill()
    if ring and updates and t0 + 1 < live_cap:
        lives.fill()
    if delta is None:
        status, path_x, path_y, base = st.status, st.path_x, st.path_y, 0
    else:
        status, path_x, path_y = otw_insert.delta_views(delta, cfg, k_block)
        path_x.zero_()
        path_y.zero_()
        base = sc[S_PLEN]

    def at(a, b):
        return (a + ring[0]) % L, (b + ring[1]) % L

    def window():  # logical (canonical) order
        idx = torch.arange(L)
        return W[(idx + ring[0]) % L][:, (idx + ring[1]) % L]

    def band_update(row, other):
        band, moved = (refs, lives) if row else (lives, refs)
        ring[0 if row else 1] = (ring[0 if row else 1] + 1) % L
        logical = window()
        prev = logical[c - 1] if row else logical[:, c - 1]
        fixed = moved.band()[c]
        cost = otw_insert._cost(band.band(), fixed, cfg.euclidean)
        line = otw_insert._band_step(cost, prev, max(c - other, 1), sentinel if other >= c else float("inf"),
                                     c - other, sentinel)
        for p in range(L):
            W[at(c, p) if row else at(p, c)] = line[p]

    t, j = t0, j0
    rc, prev, plen, lastx, lasty = (sc[s] for s in (S_RC, S_PREV, S_PLEN, S_LASTX, S_LASTY))
    first, stopped, direction, overflow = bool(sc[S_FIRST]), bool(sc[S_STOPPED]), sc[S_DIR], bool(sc[S_OVERFLOW])
    plen0 = plen
    if updates and j + 1 < ref_len:
        refs.fetch()
    for k in range(n_valid):
        if stopped:
            break
        col = cols[k]
        t_new, row = t, False
        if first:
            assert lives.head == 0 and lives.base == 0  # before any advance: live row c is band position c
            st.live[c] = col
            if ring:
                lives.ring[c] = col
            for q in range(L):
                W[at(c, q)] = otw_insert._cost(col[None], st.ref[c], cfg.euclidean)[0] if q == c else sentinel
            first = False
        else:
            t_new = t + 1
            row = t_new < live_cap
        active, d, it = row, direction, 0
        while active:
            if not row and it == cfg.loop_iters:
                break
            if row or d != ROW:
                if row:
                    st.live[t_new + c] = col
                    lives.next = col
                    lives.advance()
                else:
                    j += 1
                    if j >= ref_len:
                        stopped, active = True, False
                        break
                    refs.advance()
                if not row and j + 1 < ref_len:
                    refs.fetch()
                band_update(row, j if row else t_new)
            if row:
                row = False
                continue
            x, y = otw_insert.best_point(window(), t_new, j, c)
            plen, lastx, lasty = otw_insert.append_point(path_x, path_y, x, y, plen, lastx, lasty, cfg, base)
            d, rc, prev = otw_insert.set_direction(x, y, t_new, j, rc, prev, cfg)
            active = d == COL
            it += 1
        direction = d
        overflow = overflow or active
        t = t_new
    if delta is not None and plen - plen0 > path_x.shape[0]:
        overflow = True
    st.window.copy_(window())
    new = dict(zip((S_T, S_J, S_RC, S_PREV, S_PLEN, S_LASTX, S_LASTY, S_FIRST, S_STOPPED, S_DIR, S_OVERFLOW),
                   (t, j, rc, prev, plen, lastx, lasty, int(first), int(stopped), direction, int(overflow))))
    st.scalars.copy_(torch.tensor([new.get(i, v) for i, v in enumerate(sc)], dtype=torch.int32))
    status.copy_(torch.tensor([int(stopped) | (int(overflow) << 1), plen, lastx, lasty, 0, 0, 0, 0],
                              dtype=torch.int32))


def _model_against_plain(ref, live, cfg, k_block, counts, mode, ring=True):
    """One stream through the model (its rows in rings, or read from
    device memory) and the plain version, launch by launch with per-launch
    insert counts from ``counts(launch)`` (0 included): state, status and
    delta rows equal.  Returns the final scalars."""
    n = ref.shape[1]
    cap = 2 * n
    whole = mode == "whole"
    model = otw_insert.new_state(torch.from_numpy(ref), cfg, cap, whole_path=whole)
    plain = otw_insert.new_state(torch.from_numpy(ref), cfg, cap, whole_path=whole)
    rows = torch.from_numpy(np.ascontiguousarray(live.T))
    width = otw_insert.delta_width(cfg, k_block)
    s, launch = 0, 0
    while s < rows.shape[0]:
        k = min(counts(launch), rows.shape[0] - s)
        block = rows[s : s + k_block]  # the kernel reads only the first k
        lens = (cap, n, k)
        d_model = None if whole else torch.full((width,), -7, dtype=torch.int32)
        d_plain = None if whole else torch.full((width,), -5, dtype=torch.int32)
        _warp_launch(model, block, lens, cfg, k_block, d_model, ring)
        otw_insert.insert_block_reference(plain, block, lens, cfg, k_block, d_plain)
        for name in ("window", "live", "scalars", "status", "path_x", "path_y"):
            x, y = getattr(model, name), getattr(plain, name)
            assert (x is None and y is None) or torch.equal(x, y), (launch, name)
        assert whole or torch.equal(d_model, d_plain), launch
        s += k
        launch += 1
    return model.scalars


@pytest.mark.parametrize("rows", ["rings", "device"])
@pytest.mark.parametrize("mode", ["whole", "delta"])
@pytest.mark.parametrize("variant,c,scenario", [
    ("otw", 3, "stop"), ("livenote_v2_diff", 5, "stop"), ("livenote", 10, "stop"), ("livenote_v2", 6, "capacity"),
    ("otw", 4, "capacity"),
])
def test_warp_kernel_model_matches_plain_launch_by_launch(variant, c, scenario, mode, rows):
    """The model of the one-warp kernel, its rows in rings or read from
    device memory (as where the rings do not fit beside a shared window),
    against the plain version over a stream that stops (then takes more
    launches, some of count 0) or one that passes its live capacity (then
    takes more), k_block 8 with counts cycling through 0..8: the kernel
    never reads a device row past the stream's, and every launch leaves the
    plain version's state."""
    rng = np.random.default_rng(1800 + 10 * c + (scenario == "stop"))
    if scenario == "stop":
        ref, live = _stream(rng, variant, n_ref=c + 12)
        live = np.concatenate([live, _unit_cols(rng.random((12, 20)) + 0.05).astype(np.float32)], axis=1)
        cfg = _cfg(variant, c)
    else:
        ref = _unit_cols(rng.random((12, 3 * c + 6)) ** 4 + 0.01).astype(np.float32)
        live = _unit_cols(ref[:, :1] + 0.01 * rng.random((12, 2 * ref.shape[1] + 20))).astype(np.float32)
        cfg = _cfg(variant, c, 5)
    sc = _model_against_plain(ref, live, cfg, 8, lambda launch: (5 * launch + 3) % 9, mode, rows == "rings")
    if scenario == "stop":
        assert sc[S_STOPPED] == 1
    else:
        assert sc[S_T] >= 2 * ref.shape[1] + 8 and sc[S_STOPPED] == 0


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------

H100_OPT_IN = 232448  # bytes of shared memory a block may opt in to


def _band_threads(c):
    return -(-(c + 1) // 32) * 32


def _workspace_floats(c):
    """``otw_band_workspace_floats`` on an H100: 0 while the block kernel's
    window and scratch fit, else (c+1)^2."""
    return 0 if 4 * ((c + 1) ** 2 + 4 * _band_threads(c) + 4 * 32) <= H100_OPT_IN else (c + 1) ** 2


def test_window_route_and_kernel_route_at_the_edges():
    """The window's route is the band library's, unchanged by the one-warp
    kernel: shared up to c = 237, a global workspace from 238, on both
    sides of the kernels' edges (228/229, 255/256), and the wrapper
    allocates exactly that.  The kernel each band runs is the CUDA
    library's choice (``otw_insert_plan``), which only the card can
    answer: phase 2 of chip_smoke.py (``insert_plans``) checks it at these
    edges."""

    class Lib:
        def otw_band_workspace_floats(self, c, index):
            return _workspace_floats(c)

    dev = torch.device("cpu", 0)
    saved = dict(otw_insert._WORKSPACE_FLOATS)
    otw_insert._WORKSPACE_FLOATS.clear()
    try:
        for c in (228, 229, 237):
            assert otw_insert.window_workspace(Lib(), c, 4, dev) is None
        for c in (238, 255, 256):
            assert otw_insert.window_workspace(Lib(), c, 4, dev).shape == (4, (c + 1) ** 2)
    finally:
        otw_insert._WORKSPACE_FLOATS.clear()
        otw_insert._WORKSPACE_FLOATS.update(saved)
