"""The port's WTW surface around the engines on the CPU — ``WTWFollower``,
``align_pair(engine="wtw")``, ``WTWOfflineEvaluator``, the raw-audio memo
and ``parallel/transfer.py`` — against the JAX package's, on synthetic
corpus pairs rendered from their seeds.

Tolerances:

- the followers on shared features (the copied host frontend's live
  columns, ``transfer_dtype="chroma"``, and the JAX reference chroma):
  events and field-log lines EQUAL;
- ``align_pair(mode="fused")`` against ``mode="oracle")`` in the port: paths
  EQUAL (both extract the live columns in the same fixed tiles);
- the port against the JAX package, each on its own device frontend: the
  chromas differ by up to 2.15e-6 (PERF.md), which moves near-tie window
  decisions, so the ``PathScorer`` buckets must agree within 1 percentage
  point;
- the evaluator's and the transfer model's arithmetic: EQUAL on the same
  inputs."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from real_time_audio_sync_tpu.eval import corpus as jcorpus  # noqa: E402
from real_time_audio_sync_tpu.eval.wtw_offline import WTWOfflineEvaluator as JaxEvaluator  # noqa: E402
from real_time_audio_sync_tpu.parallel import transfer as jtransfer  # noqa: E402
from real_time_audio_sync_tpu.streaming.runtime import WTWFollower as JaxFollower  # noqa: E402
from real_time_audio_sync_tpu_torch.eval import corpus as tcorpus, synthetic  # noqa: E402
from real_time_audio_sync_tpu_torch.eval.wtw_offline import WTWOfflineEvaluator  # noqa: E402
from real_time_audio_sync_tpu_torch.parallel import transfer  # noqa: E402
from real_time_audio_sync_tpu_torch.streaming.runtime import WTWFollower  # noqa: E402
from real_time_audio_sync_tpu_torch.utils.wavio import load_wav, write_wav  # noqa: E402

from tests.test_pallas_wtw import _synth  # noqa: E402
from tests.test_torch_wtw import share_reference  # noqa: E402

PAIRS = ("steady", "dropout", "jittered")
#: the buckets of port and JAX paths on their own frontends agree within this
BUCKET_POINTS = 1.0


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = tmp_path_factory.mktemp("Songs")
    synthetic.build_corpus(str(root), PAIRS)
    return str(root)


def _pair(root, name):
    d = os.path.join(root, name)
    return os.path.join(d, f"{name}_00.wav"), os.path.join(d, f"{name}_01.wav")


@pytest.fixture(autouse=True)
def fresh_memo(monkeypatch):
    from collections import OrderedDict

    monkeypatch.setattr(tcorpus, "_FEAT_CACHE", OrderedDict())


def _synchronous_status(engine):
    """Read the newest status after every insert, so the follow events
    do not depend on when an asynchronous status read lands."""
    insert = engine.insert

    def insert_then_read(buf):
        out = insert(buf)
        engine.poll(block=True)
        return out

    engine.insert = insert_then_read
    return engine


@pytest.fixture(scope="module")
def noise_pair(tmp_path_factory):
    """tests/test_pallas_wtw.py's noise audio as a recorded pair with beat
    CSVs (a beat every half second; the live take is the reference's first
    12 s with noise, so the same beats)."""
    ref, live = _synth(seed=12, ref_s=20, live_s=12)
    d = tmp_path_factory.mktemp("noise")
    paths = []
    for name, x in (("noise_00", ref), ("noise_01", live)):
        write_wav(str(d / f"{name}.wav"), x)
        beats = np.arange(0, len(x) / 22050, 0.5)
        (d / f"{name}.csv").write_text("".join(f"{t},{i + 1}\n" for i, t in enumerate(beats)))
        paths.append(str(d / f"{name}.wav"))
    return paths


def test_fused_follower_events_and_field_log_match_jax(noise_pair, tmp_path):
    """WTWFollower(engine="wtw_fused", transfer_dtype="chroma") fed the
    same 2048-sample buffers in both packages, on shared features (the
    copied host frontend's live columns, the JAX reference chroma): the
    same events, the same stop, the same field log (header, path,
    accuracy summary)."""
    ref, live = noise_pair
    params = dict(tcorpus.DEFAULT_WTW_PARAMS)
    port = WTWFollower(ref, live, params, str(tmp_path / "t"), engine="wtw_fused", transfer_dtype="chroma",
                       device="cpu")
    jax_ = JaxFollower(ref, live, params, str(tmp_path / "j"), engine="wtw_fused", transfer_dtype="chroma",
                       interpret=True)
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
    assert got[-1].beat is not None
    logs = port.stop(), jax_.stop()
    assert port.stopped == jax_.stopped
    lines = [open(p).read().splitlines() for p in logs]
    assert lines[0] == lines[1]
    assert any(line.startswith("Percent incorrect (within 3 beats):") for line in lines[0])
    assert port.path == jax_.path


def test_host_follower_reads_its_path(cases):
    """engine="wtw": each event is the newest committed point; the
    unported engine and bad arguments raise."""
    ref, live = _pair(cases, "steady")
    f = WTWFollower(ref, live, tcorpus.DEFAULT_WTW_PARAMS, device="cpu")
    f.start()
    pcm, _ = load_wav(live)
    events = []
    for s in range(0, 60 * 2048, 2048):
        events += f.receive_audio(pcm[s : s + 2048])
        if events:
            assert (events[-1].live_frame, events[-1].ref_frame) == f.path[-1]
    assert events and f.stop() is None
    # engine="wtw_async": the position from the polled status, the path the host engine's
    a = WTWFollower(ref, live, tcorpus.DEFAULT_WTW_PARAMS, engine="wtw_async", device="cpu")
    a.start()
    a.dtw.poll_min_interval = 0.0
    async_events = []
    for s in range(0, 60 * 2048, 2048):
        async_events += a.receive_audio(pcm[s : s + 2048])
        if async_events:
            assert (async_events[-1].live_frame, async_events[-1].ref_frame) == a.dtw.path[-1]
    assert async_events and a.stop() is None
    assert a.path == f.path
    with pytest.raises(ValueError, match="transfer_dtype"):
        WTWFollower(ref, engine="wtw", transfer_dtype="int16", device="cpu")
    with pytest.raises(ValueError, match="float32-only"):
        WTWFollower(ref, engine="wtw_fused", dtype=np.float64, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        WTWFollower(ref, engine="otw", device="cpu")


@pytest.mark.parametrize("name", PAIRS)
def test_align_pair_fused_equals_oracle_and_scores_as_jax(cases, name):
    ref, live = _pair(cases, name)
    fused = tcorpus.align_pair(ref, live, "wtw", mode="fused", device="cpu")
    oracle = tcorpus.align_pair(ref, live, "wtw", mode="oracle", device="cpu")
    assert len(fused.path) > 50
    np.testing.assert_array_equal(fused.path, oracle.path)
    want = jcorpus.align_pair(ref, live, "wtw", mode="fused")
    for t in (1, 3, 5, 10):
        assert abs(fused.score.pct_off_beats[t] - want.score.pct_off_beats[t]) <= BUCKET_POINTS, t
    print(f"{name}: port {len(fused.path)} points, JAX {len(want.path)}; "
          f"pct_off_beats port {fused.score.pct_off_beats} JAX {want.score.pct_off_beats}")


def test_wtw_modes_that_wait_raise(cases):
    """The modes that waited for AsyncWTW run: the insert mode, and the
    fused mode above the fused kernel's 128-frame windows, each equal to
    ``mode="oracle"``; ``CorpusRunner(engine="wtw", mode="insert")`` runs
    the pairs in turn, each equal to its ``align_pair``; "wtw" is among
    ``run_simple``'s default engines."""
    ref, live = _pair(cases, "steady")
    insert = tcorpus.align_pair(ref, live, "wtw", mode="insert", device="cpu")
    oracle = tcorpus.align_pair(ref, live, "wtw", mode="oracle", device="cpu")
    assert len(insert.path) > 50
    np.testing.assert_array_equal(insert.path, oracle.path)
    wide = dict(tcorpus.DEFAULT_WTW_PARAMS, dtw_win_size=4096 * 65, dtw_hop_size=2048 * 20)  # w = 130
    jref, jlive = _pair(cases, "jittered")
    fused = tcorpus.align_pair(jref, jlive, "wtw", wide, mode="fused", device="cpu")
    assert len(fused.path) > 50
    np.testing.assert_array_equal(fused.path, tcorpus.align_pair(jref, jlive, "wtw", wide, mode="oracle",
                                                                 device="cpu").path)
    report = tcorpus.CorpusRunner(cases, "wtw", mode="insert", device="cpu").evaluate(verbose=False)
    assert len(report.results) == len(PAIRS)
    for r in report.results:
        np.testing.assert_array_equal(r.path, tcorpus.align_pair(r.ref_wav, r.live_wav, "wtw", device="cpu").path)
    assert "wtw" in tcorpus.ENGINES


def test_raw_audio_memo_has_its_own_cap(cases, monkeypatch):
    """Kind "audio" entries are host samples, evicted oldest-first past
    their own cap without evicting the feature entries (the JAX package's
    eval/corpus.py:32-63)."""
    monkeypatch.setattr(tcorpus, "_FEAT_CACHE_AUDIO_MAX", 2)
    wavs = [w for name in PAIRS for w in _pair(cases, name)]
    chroma = tcorpus._cached_chroma(wavs[0], np.float32, "cpu")
    audio = tcorpus._cached("audio", wavs[0], np.float64, "cpu")
    np.testing.assert_array_equal(audio, load_wav(wavs[0])[0])
    assert audio.dtype == np.float64 and tcorpus._cached("audio", wavs[0], np.float64, "cuda") is audio
    for w in wavs[1:4]:
        tcorpus._cached("audio", w, np.float64, "cpu")
    kinds = [k[2] for k in tcorpus._FEAT_CACHE]
    assert kinds.count("audio") == 2 and kinds.count("chroma") == 1
    assert [k[0] for k in tcorpus._FEAT_CACHE if k[2] == "audio"] == [os.path.abspath(w) for w in wavs[2:4]]
    assert tcorpus._cached_chroma(wavs[0], np.float32, "cpu") is chroma


def test_offline_evaluator_scores_as_jax(cases):
    """The port's evaluator streams np.array_split chunks through its host
    WTW; its error arithmetic on that path equals the JAX evaluator's."""
    ref, live = _pair(cases, "dropout")
    ev = WTWOfflineEvaluator(ref, live, device="cpu")
    err = ev.evaluate()
    assert err.count == len(ev.sync_ests) > 50
    jev = JaxEvaluator(ref, live)
    jev.sync_ests = ev.sync_ests
    want = jev.get_error()
    assert (err.squared_beat_error, err.pct_off_beats, err.count) == (
        want.squared_beat_error, want.pct_off_beats, want.count)


# (streams, link, host µs a frame, workers) → each of the three outcomes
PROBES = [
    (1, (25e9, 20e-6), 3.0, 1),  # direct attach: the exact spans
    (256, (50e6, 5e-3), 100.0, 1),  # a 50 MB/s link, a slow host FFT: int16 spans
    (256, (2e6, 5e-3), 5.0, 4),  # a 2 MB/s link, a fast host FFT: host chroma
]


def test_transfer_mode_choice_matches_jax():
    """The crossover model on injected probe values (nothing is probed:
    a timing probe is what makes a JAX serving test unsteady)."""
    seen = []
    for n_streams, link, host_us, workers in PROBES:
        got = transfer.choose_transfer_mode(n_streams, 8, 4096, 2048, link=transfer.LinkProbe(*link),
                                            host_fft_us=host_us, workers=workers)
        want = jtransfer.choose_transfer_mode(n_streams, 8, 4096, 2048, link=jtransfer.LinkProbe(*link),
                                              host_fft_us=host_us, workers=workers)
        assert got == want
        seen.append(got)
    assert seen == ["float32", "int16", "chroma"]


def test_transfer_mode_resolution(monkeypatch):
    assert transfer.resolve_transfer_mode("int16", 1, 8, 4096, 2048) == "int16"
    monkeypatch.setenv("RTAS_TRANSFER_MODE", "chroma")
    assert transfer.resolve_transfer_mode("auto", 1, 8, 4096, 2048) == "chroma"
    monkeypatch.setenv("RTAS_TRANSFER_MODE", "bf16")
    with pytest.raises(ValueError, match="RTAS_TRANSFER_MODE"):
        transfer.resolve_transfer_mode("auto", 1, 8, 4096, 2048)
    monkeypatch.delenv("RTAS_TRANSFER_MODE")
    assert transfer.resolve_transfer_mode("auto", 1, 8, 4096, 2048, device="cpu") == "float32"
    with pytest.raises(ValueError, match="not a CUDA device"):
        transfer.probe_link_bandwidth(device="cpu")
    assert transfer.probe_host_fft_us(n_frames=16) > 0
