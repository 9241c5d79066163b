"""The jax-free modules the port copies from the JAX package (config, wav
IO, buffer combining, ground truth, scorer, field logs, the synthetic
corpus) behave exactly as their originals."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from real_time_audio_sync_tpu import config as jconfig  # noqa: E402
from real_time_audio_sync_tpu.eval import ground_truth as jgt, logs as jlogs, scorer as jscorer, synthetic as jsyn  # noqa: E402
from real_time_audio_sync_tpu.streaming import writer as jwriter  # noqa: E402
from real_time_audio_sync_tpu.utils import wavio as jwavio  # noqa: E402
from real_time_audio_sync_tpu_torch import config as tconfig  # noqa: E402
from real_time_audio_sync_tpu_torch.eval import ground_truth as tgt, logs as tlogs, scorer as tscorer, synthetic as tsyn  # noqa: E402
from real_time_audio_sync_tpu_torch.streaming import writer as twriter  # noqa: E402
from real_time_audio_sync_tpu_torch.utils import wavio as twavio  # noqa: E402


def test_config_constants_and_params():
    for name in ("FFT_LEN", "HOP_SIZE", "FS", "FRAME_PERIOD_SEC"):
        assert getattr(tconfig, name) == getattr(jconfig, name)
    for params in ({"c": 50, "max_run_count": 3}, {"search_band_width": 20, "max_run_count": 1}):
        assert tconfig.OTWParams.from_any(params) == tconfig.OTWParams(**vars(jconfig.OTWParams.from_any(params)))
    with pytest.raises(ValueError):
        tconfig.WTWParams(dtw_hop_size=1024)


def test_synthetic_corpus_and_wav_io(tmp_path):
    """The same seeds render the same pieces, written to byte-identical
    files that both loaders read back identically."""
    tsyn.build_corpus(str(tmp_path / "t"), ["dropout"])
    jsyn.build_corpus(str(tmp_path / "j"), ["dropout"])
    for name in ("dropout_00.wav", "dropout_01.wav", "dropout_00.csv", "dropout_01.csv"):
        assert (tmp_path / "t" / "dropout" / name).read_bytes() == (tmp_path / "j" / "dropout" / name).read_bytes()
    wav = str(tmp_path / "t" / "dropout" / "dropout_01.wav")
    got, sr = twavio.load_wav(wav)
    want, jsr = jwavio.load_wav(wav)
    assert sr == jsr
    np.testing.assert_array_equal(got, want)
    bufs = [got[:100], got[100:2048], np.zeros(0, np.float32)]
    np.testing.assert_array_equal(twriter.combine_buffers(bufs), jwriter.combine_buffers(bufs))


def test_ground_truth_scorer_and_field_log(tmp_path):
    tsyn.build_corpus(str(tmp_path), ["steady"])
    ref = str(tmp_path / "steady" / "steady_00.wav")
    live = str(tmp_path / "steady" / "steady_01.wav")
    t_gt, j_gt = tgt.GroundTruth.for_recording(ref), jgt.GroundTruth.for_recording(ref)
    assert (t_gt.times, t_gt.beats, t_gt.labels) == (j_gt.times, j_gt.beats, j_gt.labels)
    for frame in (0, 3.5, 40, 154, 500):
        assert tgt.get_beat(frame, t_gt.times, t_gt.beats) == jgt.get_beat(frame, j_gt.times, j_gt.beats)
        assert tgt.get_beat_wtw(frame, t_gt.times, t_gt.beats) == jgt.get_beat_wtw(frame, j_gt.times, j_gt.beats)
        assert tgt.get_beat_and_label(frame, t_gt) == jgt.get_beat_and_label(frame, j_gt)

    rng = np.random.default_rng(3)
    path = [(int(i), int(max(0, i + d))) for i, d in zip(range(140), rng.integers(-8, 9, 140))]
    got = tscorer.PathScorer.for_pair(ref, live).score(path)
    want = jscorer.PathScorer.for_pair(ref, live).score(path)
    assert (got.count, got.squared_beat_error, got.pct_off_beats, got.pct_off_secs) == (
        want.count, want.squared_beat_error, want.pct_off_beats, want.pct_off_secs)

    header = [("fft_len", 4096), ("hop_size", 2048), ("search_band_width", 50), ("max_run_count", 3)]
    tlogs.write_field_log(str(tmp_path / "t.txt"), ref, header, path, summary=["Percent incorrect (within 1 beat):4.5%"])
    jlogs.write_field_log(str(tmp_path / "j.txt"), ref, header, path, summary=["Percent incorrect (within 1 beat):4.5%"])
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    log = tlogs.parse_field_log(str(tmp_path / "t.txt"))
    assert log.path == path and log.params() == dict(header)
    assert tlogs.parse_summary_percentages(log.summary) == [4.5]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("t", [1, 8, 300])
def test_host_chroma_frontend_is_bit_equal(dtype, t):
    """``features/chroma.host_chroma_frames`` (the WTW engines' chroma
    transfer) gives the JAX package's bits on the same frames, for any
    worker count (the copy of ``features/chroma.py:70-292``)."""
    from real_time_audio_sync_tpu.features import chroma as jchroma
    from real_time_audio_sync_tpu_torch.features import chroma as tchroma

    frames = (np.random.default_rng(t).standard_normal((t, 4096)) * 0.1).astype(dtype)
    want = jchroma.host_chroma_frames(frames.copy())
    for workers in (None, 3):
        got = tchroma.host_chroma_frames(frames.copy(), workers=workers)
        assert got.dtype == want.dtype and got.shape == (12, t)
        np.testing.assert_array_equal(got, want)
    silent = np.zeros((2, 4096), dtype)
    np.testing.assert_array_equal(tchroma.host_chroma_frames(silent), jchroma.host_chroma_frames(silent))


def test_host_worker_resolution(monkeypatch):
    import warnings

    from real_time_audio_sync_tpu.features import chroma as jchroma
    from real_time_audio_sync_tpu_torch.features import chroma as tchroma

    for env, arg in ((None, None), ("4", None), ("4", 2), ("x", None), ("0", None)):
        if env is None:
            monkeypatch.delenv("RTAS_HOST_FFT_WORKERS", raising=False)
        else:
            monkeypatch.setenv("RTAS_HOST_FFT_WORKERS", env)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the malformed value warns in both
            assert tchroma.resolve_host_workers(arg) == jchroma.resolve_host_workers(arg)
    hann, fb = tchroma.host_frontend_constants()
    jhann, jfb = jchroma.host_frontend_constants()
    np.testing.assert_array_equal(hann, jhann)
    np.testing.assert_array_equal(fb, jfb)
