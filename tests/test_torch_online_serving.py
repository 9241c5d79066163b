"""What runs the port's online tensor engines, on the CPU, against the JAX
package: ``MultiStreamFollower`` (``parallel/serving.py``), the
non-fused ``ScoreFollower`` modes (``streaming/runtime.py``), and the
insert mode of ``align_pair`` / ``CorpusRunner`` (``eval/corpus.py``),
which is again their default, as in the JAX package.

Both packages are fed the same features (the JAX frontend's chroma,
monkeypatched into the port): the two frontends differ in the last
float32 bits, and the synthetic pieces hold each chord for a beat, so
such bits move path points.  For the same reason the cosine-cost engines
are compared in float64: in float32 the two packages sum a cell's cost in
different orders, and on held chords that ulp decides ties (24-55 points
of a pair move).  Tolerance 0 everywhere: paths, "stop", pointers and
scores are equal.  The Euclidean-cost default (``livenote_v2_diff``) is
compared in float32 too, where it agrees on every case.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from real_time_audio_sync_tpu.eval import corpus as jcorpus  # noqa: E402
from real_time_audio_sync_tpu.features import chroma as jchroma  # noqa: E402
from real_time_audio_sync_tpu.parallel.serving import MultiStreamFollower as JMulti  # noqa: E402
from real_time_audio_sync_tpu.streaming.runtime import ScoreFollower as JFollower  # noqa: E402
from real_time_audio_sync_tpu_torch import MultiStreamFollower, OnlineTimeWarping  # noqa: E402
from real_time_audio_sync_tpu_torch.parallel import corpus_mesh  # noqa: E402
from real_time_audio_sync_tpu_torch.eval import corpus as tcorpus, synthetic  # noqa: E402
from real_time_audio_sync_tpu_torch.features import chroma as tchroma  # noqa: E402
from real_time_audio_sync_tpu_torch.ops import otw_insert, otw_set_live  # noqa: E402
from real_time_audio_sync_tpu_torch.streaming.runtime import ScoreFollower  # noqa: E402
from real_time_audio_sync_tpu_torch.utils import convert  # noqa: E402
from real_time_audio_sync_tpu_torch.utils.wavio import load_wav  # noqa: E402
from tests.test_online import _make_pair  # noqa: E402

PAIRS = ("steady", "dropout", "noisy", "jittered")
PARAMS = {"c": 10, "max_run_count": 3}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = tmp_path_factory.mktemp("Songs")
    synthetic.build_corpus(str(root), PAIRS)
    return str(root)


def _pair(root, name):
    return os.path.join(root, name, f"{name}_00.wav"), os.path.join(root, name, f"{name}_01.wav")


def _np_dtype(dtype):
    return torch.empty(0, dtype=tchroma.torch_dtype(dtype)).numpy().dtype


@pytest.fixture
def jax_features(monkeypatch):
    """The port's corpus runner and follower on the JAX frontend's features,
    with a fresh extraction memo."""
    from collections import OrderedDict

    monkeypatch.setattr(tcorpus, "_FEAT_CACHE", OrderedDict())
    for module in (tcorpus, tchroma):
        monkeypatch.setattr(module, "wav_to_chroma", lambda path, dtype=np.float32, *, device: torch.from_numpy(
            np.array(jchroma.wav_to_chroma(path, dtype=_np_dtype(dtype)))))
    monkeypatch.setattr(tcorpus, "wav_to_chroma_diff", lambda path, dtype=np.float32, *, device: torch.from_numpy(
        np.array(jchroma.wav_to_chroma_diff(path, dtype=_np_dtype(dtype)))))
    monkeypatch.setattr(tchroma, "chroma_frames", lambda frames, *args: torch.from_numpy(
        np.array(jchroma.chroma_frames(jnp.asarray(frames.numpy()), *args))))


def _same_result(got, want):
    np.testing.assert_array_equal(got.path, want.path)
    assert (got.score.count, got.score.pct_off_beats, got.score.pct_off_secs) == (
        want.score.count, want.score.pct_off_beats, want.score.pct_off_secs)
    assert (got.ref_wav, got.live_wav, got.engine) == (want.ref_wav, want.live_wav, want.engine)


@pytest.mark.parametrize("name", PAIRS)
def test_default_align_pair_is_jaxs(cases, name, jax_features):
    """``align_pair(ref, live)`` defaults to livenote_v2_diff in the insert
    mode, as the JAX package's does, and gives its result."""
    ref, live = _pair(cases, name)
    want = jcorpus.align_pair(ref, live)
    assert want.engine == "livenote_v2_diff"
    otw_insert.launches = otw_set_live.launches = 0
    _same_result(tcorpus.align_pair(ref, live, device="cpu"), want)
    assert otw_insert.launches == otw_set_live.launches == 0  # the tensor engine, no kernel


@pytest.mark.parametrize("engine", ["otw", "livenote", "livenote_v2", "livenote_v2_diff"])
@pytest.mark.parametrize("name", ["steady", "jittered"])
def test_align_pair_insert_matches_jax_float64(cases, engine, name, jax_features):
    ref, live = _pair(cases, name)
    _same_result(tcorpus.align_pair(ref, live, engine, dtype=np.float64, device="cpu"),
                 jcorpus.align_pair(ref, live, engine, dtype=np.float64))


def test_corpus_runner_default_is_jaxs(cases, jax_features):
    """``CorpusRunner(root)`` streams livenote_v2_diff through every pair,
    as the JAX runner does, with its results and mean error."""
    got = tcorpus.CorpusRunner(cases, device="cpu").evaluate(verbose=False)
    want = jcorpus.CorpusRunner(cases).evaluate(verbose=False)
    assert len(got.results) == len(want.results) == len(PAIRS)
    for g, w in zip(got.results, want.results):
        _same_result(g, w)
    assert got.mean_error == want.mean_error and got.skipped == want.skipped


def test_cli_defaults_are_jaxs(cases, jax_features, capsys):
    """``--corpus`` without ``--engine`` sweeps livenote_v2_diff, as the JAX
    CLI does; ``--ref/--live`` without it runs every engine, as the JAX CLI
    does: each line the JAX CLI's line for that engine, and "wtw"'s
    buckets (AsyncWTW in the insert mode, on the JAX frontend's features
    in tiles of 8 frames where JAX extracts a block's frames in one
    product) within a point of JAX's.  On the parent the default was the
    engines without "wtw"."""
    from real_time_audio_sync_tpu.eval.__main__ import main as jmain
    from real_time_audio_sync_tpu_torch.eval.__main__ import main as tmain

    assert tmain(["--corpus", cases, "--dtype", "float64", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jmain(["--corpus", cases, "--dtype", "float64"]) == 0
    assert got.splitlines() == capsys.readouterr().out.splitlines() and "[livenote_v2_diff]" in got
    ref, live = _pair(cases, "steady")
    assert tmain(["--ref", ref, "--live", live, "--dtype", "float64", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0].strip() for line in lines] == list(tcorpus.ENGINES) == list(jcorpus.ENGINES)
    assert jmain(["--ref", ref, "--live", live, "--dtype", "float64"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert lines[:-1] == want[:-1] and len(want) == len(lines)
    got_wtw, want_wtw = (dict(re.findall(r"(>\d+b)=\s*([\d.]+)%", line)) for line in (lines[-1], want[-1]))
    assert len(got_wtw) == len(want_wtw) == 4
    for bucket, pct in got_wtw.items():
        assert abs(float(pct) - float(want_wtw[bucket])) <= 1.0, (lines[-1], want[-1])


@pytest.fixture(scope="module")
def steady_buffers(cases):
    ref, live = _pair(cases, "steady")
    pcm, _ = load_wav(live)
    return ref, [pcm[s : s + 2048] for s in range(0, len(pcm), 2048)]


def _follow(follower, buffers):
    follower.start()
    events = []
    for buf in buffers:
        events += follower.receive_audio(buf)
    follower.stop()
    return events


MODES = {"sync": {}, "use_blocks": {"use_blocks": True}, "pipelined": {"pipelined": True}}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("engine", ["otw", "livenote_v2"])
def test_non_fused_follower_matches_jax(steady_buffers, mode, engine, jax_features, tmp_path):
    """``ScoreFollower(fused=False)`` in the sync, use_blocks and pipelined
    modes, float64: the path and the synchronous modes' per-hop score
    positions equal the JAX follower's in the same mode, and stopping
    writes the field log."""
    ref, buffers = steady_buffers
    kw = dict(MODES[mode], dtype=np.float64)
    want = JFollower(ref, engine, PARAMS, **kw)
    want_events = _follow(want, buffers)
    got = ScoreFollower(ref, engine, PARAMS, log_dir=str(tmp_path), **kw, device="cpu")
    assert not got.fused and got.pipelined == (mode == "pipelined") and got.engine.dtype == np.float64
    otw_insert.launches = 0
    got_events = _follow(got, buffers)
    assert otw_insert.launches == 0
    assert got.path == [tuple(p) for p in want.path] and len(got.path) > 50
    if mode != "pipelined":  # the synchronous modes report every hop's exact position
        assert [(e.live_frame, e.ref_frame, e.beat, e.stopped) for e in got_events] == [
            (e.live_frame, e.ref_frame, e.beat, e.stopped) for e in want_events]
    assert got.stopped == want.stopped
    assert os.path.exists(got._log_path)


def test_multistream_matches_jax_and_solo():
    """B = 4 streams on mixed-length references (zero-padded to the
    longest), with ``active`` masks that skip hops: each stream's path,
    stop flag and pointers equal JAX's ``MultiStreamFollower`` after every
    hop, and each stream equals its solo engine."""
    rng = np.random.default_rng(7)
    pairs = [_make_pair(rng, n_ref=30 + 9 * i, stretch=1.1 + 0.15 * i) for i in range(4)]
    refs, lives = [p[0] for p in pairs], [p[1] for p in pairs]
    got = MultiStreamFollower(refs, PARAMS, dtype=np.float64, device="cpu")
    want = JMulti(refs, PARAMS, dtype=np.float64)
    fed = [[] for _ in pairs]
    ptr = [0] * 4
    for step in range(max(live.shape[1] for live in lives) + 20):
        cols, active = np.zeros((4, 12)), np.zeros(4, bool)
        for k, live in enumerate(lives):
            if ptr[k] < live.shape[1] and (step + k) % 5:  # every fifth hop a stream has no frame
                cols[k], active[k] = live[:, ptr[k]], True
                fed[k].append(ptr[k])
                ptr[k] += 1
        np.testing.assert_array_equal(got.insert(cols, active), want.insert(cols, active))
        for a, b in zip(got.pointers(), want.pointers()):
            np.testing.assert_array_equal(a, b)
    for k, (ref, live) in enumerate(pairs):
        np.testing.assert_array_equal(got.paths()[k], want.paths()[k])
        solo = OnlineTimeWarping(ref, PARAMS, dtype=np.float64, device="cpu")
        for i in fed[k]:
            if solo.insert(live[:, i]) == "stop":
                break
        np.testing.assert_array_equal(got.paths()[k], solo.path_array)
    # the batched state carries to the JAX layout and back
    arrays = convert.multi_online_state_to_jax(got.states)
    for a, w in zip(arrays, want.states):
        assert a.shape == np.shape(w)
    back = convert.multi_online_state_from_jax(arrays)
    assert all(torch.equal(a, b) for a, b in zip(back, got.states))


def test_multistream_contract():
    refs = [_make_pair(np.random.default_rng(1), n_ref=n)[0] for n in (20, 30)]
    mesh = corpus_mesh(2, device="cpu")
    assert MultiStreamFollower(refs, PARAMS, mesh=mesh, device="cpu").mesh is mesh
    with pytest.raises(ValueError, match="divisible"):
        MultiStreamFollower(refs + refs[:1], PARAMS, mesh=corpus_mesh(8, device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="one band wide"):
        MultiStreamFollower([refs[0][:, :5], refs[1]], PARAMS, device="cpu")
    ms = MultiStreamFollower(refs, PARAMS, device="cpu")
    with pytest.raises(ValueError, match="expected 2 stream columns"):
        ms.insert(np.zeros((3, 12)))
    np.testing.assert_array_equal(ms.ref_lens, [20, 30])
    assert ms.refs.shape == (2, 12, 30) and ms.states.acc.shape == (2, 60, 30) and ms.mesh is None


@pytest.mark.parametrize("variant", ["otw", "livenote", "livenote_v2", "livenote_v2_diff"])
@pytest.mark.parametrize("name", ["steady", "dropout", "jittered"])
def test_tensor_engine_equals_the_kernels_plain_versions_on_held_chords(cases, name, variant):
    """float32 on the port's own frontend, where held chords tie DP cells to
    the last bit: streaming through the tensor engine gives the fused
    K-insert engine's plain path (kernel #1's), and its set_live the
    set_live kernel's plain path (kernel #2's), at tolerance 0 — the three
    share their cost and chain arithmetic."""
    from real_time_audio_sync_tpu_torch.models import FusedStreamingEngine
    from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES, BandedOnlineEngine

    ref_wav, live_wav = _pair(cases, name)
    kind = "chroma_diff" if variant == "livenote_v2_diff" else "chroma"
    ref = tcorpus._cached_chroma(ref_wav, np.float32, "cpu", kind)
    live = tcorpus._cached_chroma(live_wav, np.float32, "cpu", kind)
    band = {"c": 50, "max_run_count": 3}
    fused = FusedStreamingEngine(ref, band, ENGINE_OVERRIDES[variant], k_block=8, device="cpu")
    fused.insert_block_nowait(live)
    fused.flush()
    engine = BandedOnlineEngine(ref, band, dict(ENGINE_OVERRIDES[variant]), device="cpu")
    np.testing.assert_array_equal(np.asarray(tcorpus._streaming_path(engine, live)), fused.path_array)
    batch = BandedOnlineEngine(ref, band, dict(ENGINE_OVERRIDES[variant]), device="cpu")
    batch.set_live(live)
    want = otw_set_live.pallas_set_live(ref, live, band, **ENGINE_OVERRIDES[variant], device="cpu")[0]
    np.testing.assert_array_equal(batch.path_array, np.asarray(want))
    assert len(want) > 90
