"""The port's WTW engines on the CPU — the host ``WTW`` and ``FusedWTW`` (the
fused kernel's plain version) — against the JAX package's engines and the
Python-faithful oracle, on numpy-seeded audio (the cases of
tests/test_wtw.py and tests/test_pallas_wtw.py).

Tolerances: none.  Where both sides see the same chroma columns — the
oracle fed the port's own column extractor, the JAX and port fused engines
both on the copied host frontend (``transfer_dtype="chroma"``), and the
port's two engines on its device frontend in fixed tiles — committed
paths and pointers must be EQUAL.  (The port's device frontend and JAX's
differ by up to 2.15e-6, which moves near-tie points, so they are compared
by scores in tests/test_torch_wtw_runtime.py.)"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from real_time_audio_sync_tpu.models.fused_wtw import FusedWTW as JaxFusedWTW  # noqa: E402
from real_time_audio_sync_tpu_torch.features.chroma import wav_to_chroma_col  # noqa: E402
from real_time_audio_sync_tpu_torch.models import WTW, FusedWTW  # noqa: E402
from real_time_audio_sync_tpu_torch.models.wtw import SampleFIFO  # noqa: E402
from real_time_audio_sync_tpu_torch.utils import convert  # noqa: E402
from real_time_audio_sync_tpu_torch.utils.wavio import write_wav  # noqa: E402

from tests.oracle import OracleWTW  # noqa: E402
from tests.test_pallas_wtw import WP, _aligned_chunks, _run, _synth  # noqa: E402
from tests.test_wtw import WTW_PARAMS, _synthetic_performance  # noqa: E402

# dtw_hop_size past dtw_win_size: the diagonal fallback advances by more
# than a window (tests/test_pallas_wtw.py:190)
HOP_PAST_W = {"fft_len": 4096, "hop_size": 2048, "dtw_win_size": 4096 * 4, "dtw_hop_size": 2048 * 10}


def _host(ref, params=WP):
    return WTW(ref, params, device="cpu")


def _fused(ref, params=WP, **kw):
    return FusedWTW(ref, params, device="cpu", **kw)


@pytest.fixture(scope="module")
def wtw_pair(tmp_path_factory):
    """tests/test_wtw.py's pair: a chord progression, and the same audio
    8 % slower with noise."""
    ref = _synthetic_performance(seconds=14.0, seed=1)
    idx = np.linspace(0, len(ref) - 1, int(len(ref) * 1.08))
    live = np.interp(idx, np.arange(len(ref)), ref)
    live = live + 0.01 * np.random.default_rng(2).standard_normal(len(live))
    path = str(tmp_path_factory.mktemp("wtw") / "ref.wav")
    write_wav(path, ref)
    return path, live.astype(np.float64)


def test_float64_host_engine_matches_the_oracle_on_shared_features(wtw_pair):
    """tests/test_wtw.py:47-67 with the port's engine: the oracle consumes
    the port's column extractor, so any difference would be in the window
    DTW, the commit or the stop logic."""
    ref_path, live = wtw_pair
    engine = WTW(ref_path, WTW_PARAMS, dtype=np.float64, device="cpu")
    oracle = OracleWTW(
        engine.chroma_ref.numpy(), 4096, 2048, 4096 * 10, 2048 * 10,
        col_fn=lambda sec: wav_to_chroma_col(sec, dtype=np.float64, device="cpu").numpy(),
    )
    for buf in np.array_split(live, 512):
        got = engine.insert(buf.tolist())
        assert got == oracle.insert(buf.tolist())
        if got == "stop":
            break
    assert len(engine.path) > 10
    assert engine.path == [tuple(p) for p in oracle.path]
    assert (engine.chroma_ptr, engine.live_ptr, engine.ref_ptr) == (oracle.chroma_ptr, oracle.live_ptr,
                                                                   oracle.ref_ptr)
    finite = np.isfinite(engine.acc_cost)
    assert finite.any() and np.array_equal(finite, np.isfinite(oracle.acc))


def test_host_engine_array_ingestion_and_no_canvas(wtw_pair):
    """Arrays and lists give the same path, and keep_acc_canvas=False
    changes nothing but the canvas (tests/test_wtw.py:97-115)."""
    ref_path, live = wtw_pair
    a = WTW(ref_path, WTW_PARAMS, dtype=np.float64, device="cpu")
    b = WTW(ref_path, WTW_PARAMS, dtype=np.float64, keep_acc_canvas=False, device="cpu")
    assert b.acc_cost is None
    for buf in np.array_split(live, 256):
        ra, rb = a.insert(buf.tolist()), b.insert(buf)
        assert ra == rb
        if ra == "stop":
            break
    assert a.path == b.path and len(a.path) > 10
    assert np.array_equal(a.chroma_live, b.chroma_live)


def test_sample_fifo_semantics():
    fifo = SampleFIFO(np.float32, capacity=16)
    stream = np.arange(1000, dtype=np.float32)
    rng = np.random.default_rng(3)
    fed, consumed, out = 0, 0, []
    while consumed < 900:
        if fed < len(stream):
            n = int(rng.integers(1, 50))
            fifo.extend(stream[fed : fed + n])
            fed += n
        take = min(len(fifo), int(rng.integers(1, 30)))
        out.append(fifo.view(take).copy())
        fifo.consume(take)
        consumed += take
    got = np.concatenate(out)
    np.testing.assert_array_equal(got, stream[: len(got)])
    rest = fifo.to_array()
    np.testing.assert_array_equal(rest, stream[len(got) : len(got) + len(rest)])
    np.testing.assert_array_equal(SampleFIFO.from_array(rest, np.float32).to_array(), rest)


def share_reference(port, jax_engine):
    """Give the port engine the JAX engine's reference chroma: with the
    live columns from the copied host frontend, both then see the same
    features (each package's device frontend makes the reference, and the
    two differ by up to 2.15e-6)."""
    port._state.ref.copy_(torch.from_numpy(np.array(jax_engine.chroma_ref, np.float32).T))
    return port


@pytest.mark.parametrize("params", [WP, HOP_PAST_W], ids=["w20_hop10", "w4_hop10"])
def test_fused_engine_matches_jax_on_shared_features(params):
    """Both packages' fused engines on shared features (the live columns
    from the copied host frontend, ``transfer_dtype="chroma"``, and the
    JAX reference chroma): the port's plain kernel version against the JAX
    kernel in interpret mode."""
    ref, live = _synth(seed=11, ref_s=14, live_s=9)
    chunks = np.array_split(live, 40)
    jax_ = JaxFusedWTW(ref, params, transfer_dtype="chroma", interpret=True)
    port = share_reference(_fused(ref, params, transfer_dtype="chroma"), jax_)
    _run(port, chunks)
    _run(jax_, chunks)
    assert len(port.path) > 10
    assert port.path == jax_.path
    assert port.pointers == jax_.pointers
    assert port.last_point == tuple(int(v) for v in jax_.last_point)


def test_fused_engine_matches_host_engine_synthetic():
    """tests/test_pallas_wtw.py:48-54 in the port."""
    ref, live = _synth()
    chunks = _aligned_chunks(live)
    host = _run(_host(ref), chunks)
    fused = _run(_fused(ref, k_block=8), chunks)
    assert len(host.path) > 10
    assert fused.path == host.path
    assert fused.pointers == (host.chroma_ptr, host.live_ptr, host.ref_ptr)


@pytest.mark.parametrize("k_block", [1, 5, 32])
def test_fused_engine_k_block_and_feed_invariance(k_block):
    """Any k_block, and a feed in uneven chunks: the port extracts live
    columns in fixed tiles, so each engine sees the same columns however
    the audio arrives (tests/test_pallas_wtw.py:57-63 feeds 8-aligned
    chunks to keep JAX's matmul shapes equal)."""
    ref, live = _synth(seed=3, ref_s=12, live_s=8)
    chunks = np.array_split(live, 37)
    host = _run(_host(ref), chunks)
    fused = _run(_fused(ref, k_block=k_block), chunks)
    assert len(host.path) > 5
    assert fused.path == host.path
    assert fused.pointers == (host.chroma_ptr, host.live_ptr, host.ref_ptr)


def test_fused_engine_stops_on_reference_exhaustion():
    """tests/test_pallas_wtw.py:66-83: the live audio runs three times
    past the reference; both stop, with equal paths and pointers, and
    stay stopped."""
    ref, _ = _synth(seed=1, ref_s=8)
    rng = np.random.default_rng(2)
    live = np.tile(ref, 3) + rng.standard_normal(ref.shape[0] * 3).astype(np.float32) * 0.02
    host, fused = _host(ref), _fused(ref, k_block=8)
    rh = rf = None
    for ch in np.array_split(live, 60):
        if rh != "stop":
            rh = host.insert(ch)
        if rf != "stop":
            rf = fused.insert(ch)
    fused.flush()
    assert rh == "stop" and fused.poll() == "stop"
    assert fused.path == host.path
    assert fused.pointers == (host.chroma_ptr, host.live_ptr, host.ref_ptr)
    assert fused.insert(live[:4096]) == "stop"


def test_fused_engine_hop_exceeds_window():
    """tests/test_pallas_wtw.py:186-206: the diagonal fallback advances by
    hop_frames > w-1 per window."""
    ref, live = _synth(seed=5, ref_s=24, live_s=16)
    chunks = _aligned_chunks(live)
    host = _run(_host(ref, HOP_PAST_W), chunks)
    fused = _run(_fused(ref, HOP_PAST_W, k_block=8), chunks)
    assert len(host.path) > 0
    assert fused.path == host.path
    assert fused.pointers == (host.chroma_ptr, host.live_ptr, host.ref_ptr)


def test_fused_engine_rejects_windows_above_128():
    ref, _ = _synth(seed=4, ref_s=60)
    with pytest.raises(ValueError, match="128-lane"):
        _fused(ref, dict(WP, dtw_win_size=4096 * 80))  # w = 160


def test_fused_engine_contract():
    """float32 only, JAX's positional order, the transfer modes, and a
    reference shorter than one window rejected."""
    ref, live = _synth(seed=6, ref_s=6, live_s=3)
    e = FusedWTW(ref, WP, None, 4, "int16", True, device="cpu")
    assert (e.k_block, e.transfer_dtype, e.interpret, e.dtype) == (4, "int16", True, np.dtype(np.float32))
    assert FusedWTW(ref, WP, device="cpu", transfer_dtype="auto").transfer_dtype == "float32"  # no link on the CPU
    with pytest.raises(ValueError, match="transfer_dtype"):
        _fused(ref, transfer_dtype="bf16")
    with pytest.raises(ValueError, match="too short"):
        _fused(ref[: 2048 * 10])
    # int16 spans are path-exact on int16-exact audio
    lq = (np.round(live * 32768.0).clip(-32768, 32767) / 32768.0).astype(np.float32)
    chunks = _aligned_chunks(np.concatenate([lq, lq]))
    assert _run(_fused(ref, transfer_dtype="int16"), chunks).path == _run(_fused(ref), chunks).path


def _load_port(engine, live, scalars, host_path, buf):
    engine._state.live.copy_(live)
    engine._state.scalars.copy_(scalars)
    engine._host_px, engine._host_py = [host_path[:, 0]], [host_path[:, 1]]
    engine._drained_plen = len(host_path)
    engine.buf = SampleFIFO.from_array(buf, engine.dtype)


def _load_jax(engine, live_win, scalars, host_path, buf):
    engine._live_win, engine._scalars = jnp.asarray(live_win), jnp.asarray(scalars)
    engine._host_px, engine._host_py = [host_path[:, 0]], [host_path[:, 1]]
    engine._drained_plen = len(host_path)
    engine.buf = SampleFIFO.from_array(buf, engine.dtype)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_fused_state_carries_across_packages(direction):
    """Feed one package's engine half the audio, carry its state (live
    chroma, scalars, drained host path, buffered samples) into a fresh
    engine of the other package with ``utils/convert``, and finish both
    there: the path equals one engine fed the whole audio (every engine on
    shared features)."""
    ref, live = _synth(seed=7, ref_s=12, live_s=9)
    chunks = np.array_split(live, 30)
    jax_ = JaxFusedWTW(ref, WP, transfer_dtype="chroma", interpret=True)
    whole = _run(share_reference(_fused(ref, transfer_dtype="chroma"), jax_), chunks)
    port = share_reference(_fused(ref, transfer_dtype="chroma"), jax_)
    first, second = (jax_, port) if direction == "jax_to_port" else (port, jax_)
    _run(first, chunks[:15])
    done = first.path_array
    assert len(done) > 5
    if direction == "jax_to_port":
        live_rows, sc, hp = convert.fused_wtw_state_from_jax(np.asarray(first._live_win), np.asarray(first._scalars),
                                                             done, m=second.M, f=12)
        _load_port(second, live_rows, sc, hp, first.buf.to_array())
    else:
        live_win, sc, hp = convert.fused_wtw_state_to_jax(first._state.live, first._state.scalars, done, w=20,
                                                          hop_frames=10, k_block=8)
        _load_jax(second, live_win, sc, hp, first.buf.to_array())
    _run(second, chunks[15:])
    assert second.path == whole.path
    assert tuple(int(v) for v in second.pointers) == whole.pointers
