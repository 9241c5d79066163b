"""The whole slice on the CPU: PCM buffers → chroma → fused K-insert engine
→ status readout → path → PathScorer, the port's ScoreFollower against the
JAX package's ScoreFollower(fused=True, fused_interpret=True).

The synthetic ``steady`` pair holds each chord for a whole beat, so the DP
meets near-ties: the two frontends' float32 chroma of one hop differ by up
to ~2e-6, and that is enough to move path points when each follower runs
on its own frontend.  So the slice is checked in parts that together
cover it:

- the port's chroma of every hop and of the reference match JAX's to the
  float32 tolerance (atol 1e-5), and the two followers, each on its own
  frontend, score the same beat-accuracy buckets;
- with the JAX frontend's columns fed through the port's follower (its
  framing, engine, status polling, stop and scoring), the path and the
  PathScorer result equal the JAX follower's exactly;
- with the port's frontend columns fed through the JAX follower, its path
  equals the port's own-frontend path exactly.  With the previous part
  this shows that every point the two own-frontend paths differ in comes
  from the chroma difference alone, not from the followers.
"""
import inspect
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from real_time_audio_sync_tpu.features import chroma as jchroma  # noqa: E402
from real_time_audio_sync_tpu.streaming.runtime import ScoreFollower as JaxFollower  # noqa: E402
from real_time_audio_sync_tpu_torch.eval import synthetic  # noqa: E402
from real_time_audio_sync_tpu_torch.eval.logs import parse_field_log  # noqa: E402
from real_time_audio_sync_tpu_torch.eval.scorer import PathScorer  # noqa: E402
from real_time_audio_sync_tpu_torch.features import chroma as tchroma  # noqa: E402
from real_time_audio_sync_tpu_torch.streaming.runtime import HopFramer, ScoreFollower  # noqa: E402
from real_time_audio_sync_tpu_torch.utils.wavio import load_wav  # noqa: E402

PARAMS = {"c": 50, "max_run_count": 3}


@pytest.fixture(scope="module")
def steady(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    synthetic.build_corpus(str(root), ["steady"])
    ref = os.path.join(root, "steady", "steady_00.wav")
    live = os.path.join(root, "steady", "steady_01.wav")
    pcm, _ = load_wav(live)
    return ref, live, [pcm[s : s + 2048] for s in range(0, len(pcm), 2048)]


def _follow(follower, buffers):
    follower.start()
    events = []
    for buf in buffers:
        events += follower.receive_audio(buf)
    follower.stop()
    return events


def _jax_follow(ref, engine, buffers):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        f = JaxFollower(ref, engine, PARAMS, fused=True, fused_interpret=True)
        f.engine.max_in_flight = 0  # coalesce launches (same path, fewer interpreted launches)
        _follow(f, buffers)
    return np.asarray(f.path)


def test_chroma_of_every_hop_matches_jax(steady):
    ref, _, buffers = steady
    np.testing.assert_allclose(tchroma.wav_to_chroma(ref, device="cpu").numpy(), jchroma.wav_to_chroma(ref),
                               rtol=0, atol=1e-5)
    framer = HopFramer()
    windows = np.stack([w for buf in buffers for w in framer.push(buf)])
    for w in windows:  # one hop per call, as the follower computes them
        got = tchroma.chroma_frames(torch.from_numpy(w[None]))
        want = np.asarray(jchroma.chroma_frames(jnp.asarray(w[None])))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("engine", ["otw", "livenote_v2"])
def test_follower_matches_jax_follower(steady, engine, monkeypatch, tmp_path):
    ref, live, buffers = steady
    scorer = PathScorer.for_pair(ref, live)
    jax_path = _jax_follow(ref, engine, buffers)
    jax_score = scorer.score([tuple(p) for p in jax_path])

    # each follower on its own frontend: the same beat-accuracy buckets
    own = ScoreFollower(ref, engine, PARAMS, fused=True, device="cpu")
    events = _follow(own, buffers)
    own_score = scorer.score(own.path)
    assert own_score.count == jax_score.count
    assert own_score.pct_off_beats == jax_score.pct_off_beats
    assert own_score.pct_off_secs == jax_score.pct_off_secs
    assert any(e.beat is not None for e in events)  # beat readout from the reference CSV

    # the JAX frontend's columns through the port's follower: equal paths
    monkeypatch.setattr(tchroma, "wav_to_chroma",
                        lambda path, dtype=torch.float32, *, device: torch.from_numpy(np.array(jchroma.wav_to_chroma(path))))
    monkeypatch.setattr(tchroma, "chroma_frames",
                        lambda frames: torch.from_numpy(np.array(jchroma.chroma_frames(jnp.asarray(frames.numpy())))))
    shared = ScoreFollower(ref, engine, PARAMS, log_dir=str(tmp_path), fused=True, device="cpu")
    _follow(shared, buffers)
    np.testing.assert_array_equal(np.asarray(shared.path), jax_path)
    assert scorer.score(shared.path) == jax_score
    log = parse_field_log(shared._log_path)
    assert log.path == shared.path
    assert log.params() == {"fft_len": 4096, "hop_size": 2048, "search_band_width": 50, "max_run_count": 3}

    # the port's frontend columns through the JAX follower: equal paths
    monkeypatch.undo()
    monkeypatch.setattr(jchroma, "wav_to_chroma",
                        lambda path, dtype=np.float32: tchroma.wav_to_chroma(path, device="cpu").numpy())
    monkeypatch.setattr(jchroma, "chroma_frames",
                        lambda frames, *a, **k: jnp.asarray(tchroma.chroma_frames(torch.from_numpy(np.array(frames))).numpy()))
    np.testing.assert_array_equal(_jax_follow(ref, engine, buffers), np.asarray(own.path))


def test_follower_contract(steady):
    """Every mode of the JAX follower runs: the tensor engine in the sync
    (default), use_blocks and pipelined modes, and the fused engine, which
    implies pipelined, with either flag, as in JAX.  Each non-fused mode,
    in float64, follows the first 40 hops to the JAX follower's path in the
    same mode, each package on its own frontend."""
    from real_time_audio_sync_tpu_torch.models import FusedStreamingEngine, OnlineTimeWarping

    ref, _, buffers = steady
    modes = [  # (positional args after params, fused, pipelined, engine class)
        ((), False, False, OnlineTimeWarping),
        ((None, np.float64), False, False, OnlineTimeWarping),
        ((None, np.float64, True), False, False, OnlineTimeWarping),
        ((None, np.float64, False, True), False, True, OnlineTimeWarping),
        ((None, np.float32, True, False, True), True, True, FusedStreamingEngine),
        ((None, np.float32, False, True, True), True, True, FusedStreamingEngine),
    ]
    for args, fused, pipelined, cls in modes:
        port = ScoreFollower(ref, "otw", PARAMS, *args, device="cpu")
        assert isinstance(port.engine, cls) and (port.fused, port.pipelined) == (fused, pipelined)
        _follow(port, buffers[:40])
        assert len(port.path) > 0
        if args and not fused:
            want = JaxFollower(ref, "otw", PARAMS, *args)
            _follow(want, buffers[:40])
            assert port.path == [tuple(p) for p in want.path], args
    with pytest.raises(ValueError, match="unknown follower engine"):
        ScoreFollower(ref, "livenote_v2_diff", PARAMS, fused=True, device="cpu")
    with pytest.raises(ValueError, match="unknown follower engine"):
        ScoreFollower(ref, "livenote_v2_diff", PARAMS, device="cpu")
    # the card unless the caller asks for the CPU
    assert inspect.signature(ScoreFollower).parameters["device"].default == "cuda"


def test_follower_takes_the_jax_positional_order(steady):
    """``(ref_wav, engine, params, log_dir, dtype, use_blocks, pipelined,
    fused, fused_interpret)`` as in the JAX package; ``fused_interpret`` is
    accepted and ignored."""
    ref, _, buffers = steady
    jax_names = list(inspect.signature(JaxFollower).parameters)
    port_params = inspect.signature(ScoreFollower).parameters
    assert list(port_params)[: len(jax_names)] == jax_names
    assert port_params["device"].kind is inspect.Parameter.KEYWORD_ONLY
    for name in jax_names:
        assert port_params[name].default == inspect.signature(JaxFollower).parameters[name].default, name
    a = ScoreFollower(ref, "otw", PARAMS, None, np.float32, False, False, True, True, device="cpu")
    b = ScoreFollower(ref, "otw", PARAMS, fused=True, device="cpu")
    assert not a.engine.long_ref
    _follow(a, buffers[:40])
    _follow(b, buffers[:40])
    assert a.path == b.path and len(a.path) > 0


@pytest.mark.parametrize("engine", ["otw", "livenote_v2"])
def test_long_reference_follower_matches_jax_follower(steady, engine, monkeypatch):
    """With the long-reference threshold lowered below the reference's
    length, both followers pick the delta layout by themselves; fed the same
    (JAX frontend) columns, the port's path equals the JAX follower's."""
    import real_time_audio_sync_tpu.models.fused_streaming as jfs
    import real_time_audio_sync_tpu_torch.models.fused_streaming as tfs

    ref, _, buffers = steady
    monkeypatch.setattr(jfs, "_LONG_REF_THRESHOLD", 64)
    monkeypatch.setattr(tfs, "_LONG_REF_THRESHOLD", 64)
    monkeypatch.setattr(jfs, "_DELTA_STACK", 8)
    monkeypatch.setattr(tfs, "_DELTA_STACK", 8)
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        jf = JaxFollower(ref, engine, PARAMS, fused=True, fused_interpret=True)
        assert jf.engine.long_ref and jf.engine.n >= 64
        jf.engine.max_in_flight = 0  # coalesce launches (same path, fewer interpreted launches)
        _follow(jf, buffers)
    monkeypatch.setattr(tchroma, "wav_to_chroma",
                        lambda path, dtype=torch.float32, *, device: torch.from_numpy(np.array(jchroma.wav_to_chroma(path))))
    monkeypatch.setattr(tchroma, "chroma_frames",
                        lambda frames: torch.from_numpy(np.array(jchroma.chroma_frames(jnp.asarray(frames.numpy())))))
    port = ScoreFollower(ref, engine, PARAMS, fused=True, device="cpu")
    assert port.engine.long_ref
    _follow(port, buffers)
    assert len(port.path) > 0
    np.testing.assert_array_equal(np.asarray(port.path), np.asarray(jf.path))
