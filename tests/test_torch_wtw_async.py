"""The port's ``AsyncWTW`` (``models/wtw_async.py``: the block step on
tensors; on the CPU the wavefront kernels' plain versions) against the JAX
package's ``AsyncWTW``, the port's host ``WTW`` and ``FusedWTW``, on
numpy-seeded audio (the cases of tests/test_wtw.py:176-296).

Tolerances:

- against the JAX engine in float64 with ``transfer_dtype="chroma"`` (the
  copied host frontend, bit-equal across packages) and the JAX reference
  chroma, on tie-free noise audio: paths, pointers, ``last_point``, the
  stop after ``flush`` and the live chromagram up to ``chroma_ptr`` EQUAL
  (the two packages' window costs sum the 12 terms in different orders,
  which moves no decision on this audio);
- against the port's host ``WTW`` and ``FusedWTW`` on the port's own
  frontend (both extract the live columns in the same fixed tiles), float32
  and float64: EQUAL;
- the port against the JAX package on their own frontends (held chords
  tie, ROADMAP Queue 3 item 8): ``PathScorer`` buckets within 1 point."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from real_time_audio_sync_tpu.eval import corpus as jcorpus  # noqa: E402
from real_time_audio_sync_tpu.models.wtw import SampleFIFO as JaxFIFO  # noqa: E402
from real_time_audio_sync_tpu.models.wtw_async import AsyncWTW as JaxAsyncWTW  # noqa: E402
from real_time_audio_sync_tpu.streaming.runtime import WTWFollower as JaxFollower  # noqa: E402
from real_time_audio_sync_tpu_torch.eval import corpus as tcorpus, synthetic  # noqa: E402
from real_time_audio_sync_tpu_torch.models import WTW, AsyncWTW, FusedWTW  # noqa: E402
from real_time_audio_sync_tpu_torch.models.wtw import SampleFIFO  # noqa: E402
from real_time_audio_sync_tpu_torch.streaming.runtime import WTWFollower  # noqa: E402
from real_time_audio_sync_tpu_torch.utils import convert  # noqa: E402
from real_time_audio_sync_tpu_torch.utils.wavio import load_wav  # noqa: E402

from tests.test_pallas_wtw import WP, _run, _synth  # noqa: E402
from tests.test_torch_wtw import HOP_PAST_W, wtw_pair  # noqa: E402,F401
from tests.test_torch_wtw_runtime import _synchronous_status, noise_pair  # noqa: E402,F401
from tests.test_wtw import WTW_PARAMS  # noqa: E402

W5_HOP1 = {"fft_len": 4096, "hop_size": 2048, "dtw_win_size": 4096 * 5, "dtw_hop_size": 2048}
W130 = {"fft_len": 4096, "hop_size": 2048, "dtw_win_size": 4096 * 65, "dtw_hop_size": 2048 * 20}
#: the buckets of port and JAX paths on their own frontends agree within this
BUCKET_POINTS = 1.0


def _port(ref, params=WP, **kw):
    return AsyncWTW(ref, params, device="cpu", **kw)


def share_reference(port, jax_engine):
    """Give the port engine the JAX engine's reference chroma (each
    package's device frontend makes its own; they differ in the last bits)."""
    port._stepper.ref[0, : port.M] = torch.from_numpy(np.array(jax_engine.chroma_ref).T)
    return port


def _host_pointers(host):
    return host.chroma_ptr, host.live_ptr, host.ref_ptr


def _overlong(seed, ref_s=8, times=2.2):
    """Reference audio and a live take that runs past its end (a stop)."""
    ref, _ = _synth(seed=seed, ref_s=ref_s)
    rng = np.random.default_rng(seed + 100)
    n = int(len(ref) * times)
    live = np.tile(ref, 3)[:n] + rng.standard_normal(n).astype(np.float32) * 0.02
    return ref, live


CASES = {"w20_hop10": WP, "w5_hop1": W5_HOP1, "w4_hop10": HOP_PAST_W}


@pytest.mark.parametrize("overlong", [False, True], ids=["runs_out", "stops"])
@pytest.mark.parametrize("case", list(CASES))
def test_float64_matches_jax_on_shared_features(case, overlong):
    """Both packages' AsyncWTW in float64 on the copied host frontend's
    columns and the JAX reference chroma, fed the same unaligned chunks:
    path, pointers, last point, the stop after flush and the live
    chromagram up to chroma_ptr equal."""
    params = CASES[case]
    if overlong:
        ref, live = _overlong(seed=21)
    else:
        ref, live = _synth(seed=22, ref_s=10, live_s=7)
    ref, live = ref.astype(np.float64), live.astype(np.float64)
    jax_ = JaxAsyncWTW(ref, params, k_block=8, dtype=np.float64, transfer_dtype="chroma")
    port = share_reference(_port(ref, params, k_block=8, dtype=np.float64, transfer_dtype="chroma"), jax_)
    for chunk in np.array_split(live, 97):
        port.insert(chunk)
        jax_.insert(chunk)
    assert port.flush() == jax_.flush() == ("stop" if overlong else None)
    assert len(port.path) > 10
    assert port.path == jax_.path
    assert port.pointers == jax_.pointers
    assert port.last_point == tuple(int(v) for v in jax_.last_point)
    cp = port.pointers[0]
    np.testing.assert_array_equal(port.chroma_live[:, :cp], np.asarray(jax_.chroma_live)[:, :cp])
    if overlong:
        assert port.insert(live[:8192]) == jax_.insert(live[:8192]) == "stop"  # sticky


@pytest.mark.parametrize("params", [WP, HOP_PAST_W, W130], ids=["w20_hop10", "w4_hop10", "w130_hop20"])
@pytest.mark.parametrize("overlong", [False, True], ids=["runs_out", "stops"])
def test_float32_matches_host_and_fused_engines(params, overlong):
    """float32 on the port's own frontend: the path and pointers of the
    host WTW engine and (up to 128-frame windows) of FusedWTW, fed the same
    uneven chunks."""
    ref, live = _overlong(seed=31, ref_s=20, times=2.2) if overlong else _synth(seed=32, ref_s=20, live_s=14)
    chunks = np.array_split(live, 61)
    host = _run(WTW(ref, params, device="cpu"), chunks)
    eng = _run(_port(ref, params, k_block=8), chunks)
    assert len(host.path) > 10
    assert eng.path == host.path
    assert eng.pointers[1:] == _host_pointers(host)[1:]
    if not overlong:
        assert eng.pointers == _host_pointers(host)
    if params is not W130:
        fused = _run(FusedWTW(ref, params, k_block=8, device="cpu"), chunks)
        assert eng.path == fused.path and eng.pointers == fused.pointers


def test_matches_host_path(wtw_pair):
    """tests/test_wtw.py:176-201: the device-resident stepper commits the
    host engine's path and ends at its pointers, a ragged flush tail
    included; last_point is the committed head."""
    ref_path, live = wtw_pair
    for dtype in (np.float64, np.float32):
        host = WTW(ref_path, WTW_PARAMS, dtype=dtype, device="cpu")
        for buf in np.array_split(live, 256):
            if host.insert(buf) == "stop":
                break
        eng = AsyncWTW(ref_path, WTW_PARAMS, k_block=8, dtype=dtype, device="cpu")
        for buf in np.array_split(live, 256):
            if eng.insert(buf) == "stop":
                break
        eng.flush()
        assert len(host.path) > 10
        assert eng.path == host.path
        assert eng.pointers == _host_pointers(host)
        plen, lx, ly = eng.last_point
        assert plen == len(host.path) and (lx, ly) == host.path[-1]


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_block_size_invariance(wtw_pair, dtype):
    """tests/test_wtw.py:204-224: k_block changes only the dispatch
    batching.  The port's tiles of 8 frames keep every column's bits, so
    float32 holds too."""
    ref_path, live = wtw_pair
    paths = []
    for k_block in (1, 5, 16):
        eng = AsyncWTW(ref_path, WTW_PARAMS, k_block=k_block, dtype=dtype, device="cpu")
        for buf in np.array_split(live, 100):
            if eng.insert(buf) == "stop":
                break
        eng.flush()
        paths.append((eng.path, eng.pointers))
    assert len(paths[0][0]) > 10
    assert paths[0] == paths[1] == paths[2]


def test_stop_parity(wtw_pair):
    """tests/test_wtw.py:227-248: overlong live audio; the stop surfaces
    through the status (lazily), stays, and the path and pointers are the
    host engine's."""
    ref_path, live = wtw_pair
    long_live = np.concatenate([live, live, live])
    host = WTW(ref_path, WTW_PARAMS, dtype=np.float64, device="cpu")
    for buf in np.array_split(long_live, 512):
        if host.insert(buf) == "stop":
            break
    eng = AsyncWTW(ref_path, WTW_PARAMS, k_block=8, dtype=np.float64, device="cpu")
    for buf in np.array_split(long_live, 512):
        if eng.insert(buf) == "stop":
            break
    assert eng.flush() == "stop"
    assert eng.insert(np.zeros(8192)) == "stop"
    assert eng.path == host.path
    assert eng.pointers[1:] == (host.live_ptr, host.ref_ptr)


def test_backend_invariance(wtw_pair):
    """tests/test_wtw.py:251-270: every window route commits the same path;
    on the CPU "auto" runs the wrappers' plain versions, "scan" and
    "unroll" the plain versions explicitly, and "pallas" (the kernels)
    raises."""
    ref_path, live = wtw_pair
    results = []
    for backend in ("scan", "unroll", "auto"):
        eng = AsyncWTW(ref_path, WTW_PARAMS, k_block=8, window_backend=backend, dtype=np.float64, device="cpu")
        assert eng.window_backend == backend
        for buf in np.array_split(live, 100):
            if eng.insert(buf) == "stop":
                break
        eng.flush()
        results.append((eng.path, eng.pointers))
    assert results[0] == results[1] == results[2] and len(results[0][0]) > 10
    with pytest.raises(ValueError, match="pallas"):
        AsyncWTW(ref_path, WTW_PARAMS, window_backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="window_backend"):
        AsyncWTW(ref_path, WTW_PARAMS, window_backend="lax", device="cpu")


@pytest.mark.parametrize("hop_mult", [10, 1])
def test_hoisted_matches_cols_impl(wtw_pair, hop_mult):
    """tests/test_wtw.py:273-296: "hoisted" and "cols" (one implementation
    here) give the same path, pointers and last point, hop_frames 1
    included (a window every column), past the stop margin, equal to the
    host engine."""
    params = {"fft_len": 4096, "hop_size": 2048, "dtw_win_size": 4096 * 5, "dtw_hop_size": 2048 * hop_mult}
    ref_path, live = wtw_pair
    long_live = np.concatenate([live, live])
    results = {}
    for impl in ("cols", "hoisted"):
        eng = AsyncWTW(ref_path, params, k_block=8, dtype=np.float64, block_impl=impl, device="cpu")
        assert eng.block_impl == impl
        for buf in np.array_split(long_live, 173):
            if eng.insert(buf) == "stop":
                break
        eng.flush()
        results[impl] = (eng.path, eng.pointers, eng.last_point)
    assert results["hoisted"] == results["cols"]
    host = WTW(ref_path, params, dtype=np.float64, device="cpu")
    for buf in np.array_split(long_live, 173):
        if host.insert(buf) == "stop":
            break
    assert results["hoisted"][0] == host.path
    assert results["hoisted"][1][1:] == (host.live_ptr, host.ref_ptr)
    with pytest.raises(ValueError, match="block_impl"):
        AsyncWTW(ref_path, params, block_impl="scan", device="cpu")


def test_short_reference_rejected_up_front():
    ref, _ = _synth(seed=6, ref_s=6)
    with pytest.raises(ValueError, match="too short"):
        _port(ref[: 2048 * 10])
    with pytest.raises(ValueError, match="too short"):
        _port(ref, W130)


@pytest.mark.parametrize("params", [WP, W5_HOP1, W130], ids=["w20_hop10", "w5_hop1", "w130_hop20"])
def test_host_schedule_is_the_device_state(params):
    """The host's view of chroma_ptr and live_ptr (it schedules the windows
    without a device read) equals the device scalars after every block
    until a stop; after it the device's pointers stay, the host's never
    fall behind them."""
    ref, live = _overlong(seed=41, ref_s=20, times=2.2)
    eng = _port(ref, params, k_block=8)
    stepper = eng._stepper
    checked = 0
    for chunk in np.array_split(live, 83):
        eng.insert(chunk)
        (hc, hl), (dc, dl, _) = (stepper.schedules[0].chroma, stepper.schedules[0].live), eng.pointers
        if int(stepper.sc[0, 4]) & 1:
            assert hc >= dc and hl >= dl
        else:
            assert (hc, hl) == (dc, dl)
            checked += 1
    assert eng.flush() == "stop" and checked > 10


def test_transfer_modes_and_contract():
    """JAX's positional order; int16 spans are path-exact on int16-exact
    audio; "auto" resolves to float32 on the CPU (no link to probe); the
    host chroma payload runs; bad modes and dtypes raise."""
    ref, live = _synth(seed=51, ref_s=10, live_s=7)
    e = AsyncWTW(ref, WP, None, 4, "scan", np.float64, "cols", "int16", device="cpu")
    assert (e.k_block, e.window_backend, e.dtype, e.block_impl, e.transfer_dtype) == (
        4, "scan", np.dtype(np.float64), "cols", "int16")
    assert (e.M, e.N, e.fft_len, e.hop_size) == (e.chroma_ref.shape[1], 2 * e.M, 4096, 2048)
    assert _port(ref, transfer_dtype="auto").transfer_dtype == "float32"
    lq = (np.round(live * 32768.0).clip(-32768, 32767) / 32768.0).astype(np.float32)
    chunks = np.array_split(lq, 23)
    want = _run(_port(ref), chunks)
    got = _run(_port(ref, transfer_dtype="int16"), chunks)
    assert len(want.path) > 10 and got.path == want.path and got.pointers == want.pointers
    host_chroma = _run(_port(ref, transfer_dtype="chroma"), chunks)
    assert len(host_chroma.path) > 10
    with pytest.raises(ValueError, match="transfer_dtype"):
        _port(ref, transfer_dtype="int8")
    with pytest.raises(ValueError, match="dtype"):
        _port(ref, dtype=np.float16)


def _carry(first, second, direction):
    """Carry ``first``'s state (device state and buffered samples) into
    ``second`` through ``utils/convert``."""
    if direction == "jax_to_port":
        px, py, sc = first._state
        state = convert.async_wtw_state_from_jax(first._live_dev, px, py, sc)
        second._stepper.set_state(*state)
        second.buf = SampleFIFO.from_array(first.buf.to_array(), second.dtype)
    else:
        st = first._stepper
        live_dev, px, py, sc = convert.async_wtw_state_to_jax(st.live, st.px, st.py, st.sc)
        second._live_dev = jnp.asarray(live_dev)
        second._state = (jnp.asarray(px), jnp.asarray(py), jnp.asarray(sc))
        second.buf = JaxFIFO.from_array(first.buf.to_array(), second.dtype)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_carries_across_packages(direction):
    """Feed one package's engine part of the audio, carry its state into a
    fresh engine of the other package, and finish there: the path and
    pointers equal one engine fed the whole audio (float64, shared
    features)."""
    ref, live = _overlong(seed=61, ref_s=8)
    ref, live = ref.astype(np.float64), live.astype(np.float64)
    chunks = np.array_split(live, 40)
    kw = {"k_block": 8, "dtype": np.float64, "transfer_dtype": "chroma"}
    whole = JaxAsyncWTW(ref, WP, **kw)
    for c in chunks:
        whole.insert(c)
    whole.flush()
    jax_ = JaxAsyncWTW(ref, WP, **kw)
    port = share_reference(_port(ref, **kw), jax_)
    first, second = (jax_, port) if direction == "jax_to_port" else (port, jax_)
    for c in chunks[:15]:
        first.insert(c)
    first.flush()
    assert len(first.path) > 5
    _carry(first, second, direction)
    for c in chunks[15:]:
        second.insert(c)
    second.flush()
    assert second.path == whole.path
    assert tuple(int(v) for v in second.pointers) == whole.pointers


def test_state_converters_round_trip():
    """JAX layout → port layout → JAX layout is the identity, and the
    port's dropped-write row and column come back as zero."""
    rng = np.random.default_rng(7)
    live_dev = rng.random((12, 30))
    px, py = rng.integers(0, 50, 40).astype(np.int32), rng.integers(0, 50, 40).astype(np.int32)
    sc = rng.integers(0, 9, 8).astype(np.int32)
    state = convert.async_wtw_state_from_jax(live_dev, px, py, sc)
    assert state[0].shape == (1, 31, 12) and state[1].shape == (1, 41) and state[3].shape == (1, 8)
    assert not state[0][0, -1].any() and int(state[1][0, -1]) == 0
    back = convert.async_wtw_state_to_jax(*state)
    for a, b in zip(back, (live_dev, px, py, sc)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_follower_events_and_field_log_match_jax(noise_pair, tmp_path):
    """WTWFollower(engine="wtw_async", transfer_dtype="chroma") fed the same
    2048-sample buffers in both packages, on shared features: the same
    events (from the polled status), the same stop and the same field
    log."""
    ref, live = noise_pair
    params = dict(tcorpus.DEFAULT_WTW_PARAMS)
    port = WTWFollower(ref, live, params, str(tmp_path / "t"), engine="wtw_async", transfer_dtype="chroma",
                       device="cpu")
    jax_ = JaxFollower(ref, live, params, str(tmp_path / "j"), engine="wtw_async", transfer_dtype="chroma")
    share_reference(port.dtw, jax_.dtw)
    for f in (port, jax_):
        _synchronous_status(f.dtw)
        f.start()
    pcm, _ = load_wav(live)
    got, want = [], []
    for s in range(0, len(pcm), 2048):
        got += port.receive_audio(pcm[s : s + 2048])
        want += jax_.receive_audio(pcm[s : s + 2048])
    assert len(got) > 100
    assert [tuple(vars(e).values()) for e in got] == [tuple(vars(e).values()) for e in want]
    logs = port.stop(), jax_.stop()
    assert port.stopped == jax_.stopped
    lines = [open(p).read().splitlines() for p in logs]
    assert lines[0] == lines[1]
    assert port.path == jax_.path


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = tmp_path_factory.mktemp("Songs")
    synthetic.build_corpus(str(root), ("steady", "jittered"))
    return str(root)


@pytest.mark.parametrize("name", ["steady", "jittered"])
def test_align_pair_insert_mode_scores_as_jax(cases, name, monkeypatch):
    """``align_pair(engine="wtw", mode="insert")`` (AsyncWTW, k_block 8) in
    each package on its own frontend: the buckets within a point; the
    port's path is its oracle's."""
    import os
    from collections import OrderedDict

    monkeypatch.setattr(tcorpus, "_FEAT_CACHE", OrderedDict())
    ref, live = (os.path.join(cases, name, f"{name}_0{i}.wav") for i in (0, 1))
    got = tcorpus.align_pair(ref, live, "wtw", device="cpu")
    want = jcorpus.align_pair(ref, live, "wtw")
    assert len(got.path) > 50
    np.testing.assert_array_equal(got.path, tcorpus.align_pair(ref, live, "wtw", mode="oracle", device="cpu").path)
    for t in (1, 3, 5, 10):
        assert abs(got.score.pct_off_beats[t] - want.score.pct_off_beats[t]) <= BUCKET_POINTS, t
