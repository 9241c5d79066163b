"""The port's pair and corpus runners (``eval/corpus.py``) and their CLI
(``eval/__main__.py``) on the CPU — ``engine="dtw"`` and the online
engines' ``mode="fused"`` — against the JAX package's, on synthetic
``CASES`` pairs rendered from their seeds.  The online engines' insert
mode, the runners' default, is held in ``test_torch_online_serving.py``.

Each package on its own float32 frontend: the two chromas of a recording
differ by float32 rounding, and the synthetic pieces hold each chord for a
beat, so many DP cells tie exactly and those ulps move path points on most
pairs.
So the slice is checked in parts:

- the JAX frontend's chroma fed to both runners gives equal paths and
  scores (the DTW, the path readout and the scoring agree exactly);
- each package on its own float64 frontend gives equal paths (the second
  witness: the float32 differences come from the chroma alone);
- each on its own float32 frontend, the chromas agree within 1e-5 and the
  points that moved are counted and printed (``-s``).

The fused online engines are held the same way: fed the JAX frontend's
chroma (or chroma-diff) the port's path equals JAX ``pallas_set_live``'s
exactly; each on its own frontend both meet the synthetic corpus's bound
(``tests/test_synthetic_corpus.py``: at most 10 % of points more than 3
beats off).  JAX's set_live runs in the Pallas interpreter here, ~6 s a
pair, so each engine takes one of the cases (``FUSED_CASES``).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from real_time_audio_sync_tpu.eval import corpus as jcorpus  # noqa: E402
from real_time_audio_sync_tpu.eval.__main__ import main as jmain  # noqa: E402
from real_time_audio_sync_tpu.features import chroma as jchroma  # noqa: E402
from real_time_audio_sync_tpu_torch.eval import corpus as tcorpus, synthetic  # noqa: E402
from real_time_audio_sync_tpu_torch.eval.__main__ import main as tmain  # noqa: E402
from real_time_audio_sync_tpu_torch.eval.logs import write_field_log  # noqa: E402
from real_time_audio_sync_tpu_torch.features import chroma as tchroma  # noqa: E402
from real_time_audio_sync_tpu_torch.ops import otw_set_live as tsl, wavefront as twf  # noqa: E402

PAIRS = ("steady", "dropout", "noisy", "jittered")
ONLINE = ("otw", "livenote", "livenote_v2", "livenote_v2_diff")


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = tmp_path_factory.mktemp("Songs")
    synthetic.build_corpus(str(root), PAIRS)
    return str(root)


@pytest.fixture(autouse=True)
def fresh_memo(monkeypatch):
    """Each test extracts anew (monkeypatched frontends must not leak
    through the extraction memo)."""
    from collections import OrderedDict

    monkeypatch.setattr(tcorpus, "_FEAT_CACHE", OrderedDict())


def _pair(root, name):
    return os.path.join(root, name, f"{name}_00.wav"), os.path.join(root, name, f"{name}_01.wav")


def _fields(score):
    return score.count, score.squared_beat_error, score.pct_off_beats, score.pct_off_secs


def _same_result(got, want):
    np.testing.assert_array_equal(got.path, want.path)
    assert _fields(got.score) == _fields(want.score)
    assert (got.ref_wav, got.live_wav, got.engine) == (want.ref_wav, want.live_wav, want.engine)


@pytest.mark.parametrize("name", PAIRS)
def test_align_pair_dtw_on_the_jax_chroma_matches_jax(cases, name, monkeypatch):
    ref, live = _pair(cases, name)
    want = jcorpus.align_pair(ref, live, "dtw")
    monkeypatch.setattr(tcorpus, "wav_to_chroma",
                        lambda path, dtype, *, device: torch.from_numpy(np.array(jchroma.wav_to_chroma(path))))
    twf.dp_launches = twf.backtrack_launches = 0
    _same_result(tcorpus.align_pair(ref, live, "dtw", device="cpu"), want)
    assert twf.dp_launches == twf.backtrack_launches == 0  # the CPU runs the plain versions


@pytest.mark.parametrize("name", PAIRS)
def test_align_pair_dtw_on_own_frontends(cases, name):
    ref, live = _pair(cases, name)
    # float64 frontends: equal paths
    _same_result(tcorpus.align_pair(ref, live, "dtw", dtype=np.float64, device="cpu"),
                 jcorpus.align_pair(ref, live, "dtw", dtype=np.float64))
    # float32 frontends: chroma within 1e-5; count the points that moved
    for wav in (ref, live):
        np.testing.assert_allclose(tchroma.wav_to_chroma(wav, device="cpu").numpy(),
                                   np.asarray(jchroma.wav_to_chroma(wav)), rtol=0, atol=1e-5)
    got = tcorpus.align_pair(ref, live, "dtw", device="cpu")
    want = jcorpus.align_pair(ref, live, "dtw")
    moved = set(map(tuple, got.path)) ^ set(map(tuple, want.path))
    print(f"{name}: float32 own frontends: {len(moved)} points in one path only "
          f"(port {len(got.path)}, JAX {len(want.path)} points)")
    for p in (got.path, want.path):
        assert tuple(p[0]) == (0, 0) and (np.diff(p, axis=0) >= 0).all()


def test_align_pair_argument_checks_and_unported_engines(cases):
    ref, live = _pair(cases, "steady")
    with pytest.raises(ValueError, match="unknown engine"):
        tcorpus.align_pair(ref, live, "nope", device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        tcorpus.align_pair(ref, live, "dtw", mode="bogus", device="cpu")
    with pytest.raises(ValueError, match="oracle"):
        tcorpus.align_pair(ref, live, "dtw", mode="oracle", device="cpu")
    with pytest.raises(ValueError, match="no fused backend"):
        tcorpus.align_pair(ref, live, "dtw", mode="fused", device="cpu")
    with pytest.raises(ValueError, match="float32"):
        tcorpus.align_pair(ref, live, "otw", mode="fused", dtype=np.float64, device="cpu")
    # WTW's insert mode runs AsyncWTW: the host oracle's path, from the same tiled columns
    insert = tcorpus.align_pair(ref, live, "wtw", mode="insert", device="cpu")
    np.testing.assert_array_equal(insert.path, tcorpus.align_pair(ref, live, "wtw", mode="oracle", device="cpu").path)
    assert insert.engine == "wtw" and len(insert.path) > 50
    # the online engines' insert mode runs: in float64, each package on its
    # own frontend, the JAX package's results
    for engine in ("otw", "livenote_v2_diff"):
        _same_result(tcorpus.align_pair(ref, live, engine, dtype=np.float64, device="cpu"),
                     jcorpus.align_pair(ref, live, engine, dtype=np.float64))
    report = tcorpus.CorpusRunner(cases, "livenote_v2_diff", device="cpu").evaluate(verbose=False)
    assert [r.engine for r in report.results] == ["livenote_v2_diff"] * len(PAIRS)
    # the defaults: every engine, as in the JAX package; livenote_v2_diff for a pair
    got = tcorpus.run_simple(ref, live, verbose=False, device="cpu")
    assert list(got) == list(tcorpus.ENGINES) == list(jcorpus.ENGINES) == ["dtw", *ONLINE, "wtw"]
    _same_result(got["wtw"], insert)
    _same_result(got["livenote_v2_diff"], tcorpus.align_pair(ref, live, device="cpu"))
    _same_result(got["dtw"], tcorpus.align_pair(ref, live, "dtw", device="cpu"))
    # the online engines' fused mode is ported, and WTW's fused mode
    fused = tcorpus.align_pair(ref, live, "livenote_v2", mode="fused", device="cpu")
    assert fused.engine == "livenote_v2" and tuple(fused.path[0]) == (0, 0) and fused.score.count > 20
    wtw = tcorpus.align_pair(ref, live, "wtw", mode="fused", device="cpu")
    assert wtw.engine == "wtw" and tuple(wtw.path[0]) == (0, 0) and wtw.score.count > 20


# each engine on a case the synthetic corpus's bound holds for (the
# adversarial cases break some engines: livenote_v2_diff under noise,
# otw/livenote through a dropout)
FUSED_CASES = (("otw", "steady"), ("livenote", "jittered"), ("livenote_v2", "noisy"),
               ("livenote_v2_diff", "dropout"))


@pytest.mark.parametrize("engine,name", FUSED_CASES)
def test_align_pair_fused_matches_jax(cases, engine, name, monkeypatch, capsys):
    ref, live = _pair(cases, name)
    want = jcorpus.align_pair(ref, live, engine, mode="fused")  # JAX frontend + Pallas set_live (interpret)
    # each on its own frontend: both within the synthetic corpus's bound
    tsl.launches = 0
    got = tcorpus.align_pair(ref, live, engine, mode="fused", device="cpu")
    assert tsl.launches == 0  # the CPU runs the plain version
    moved = set(map(tuple, got.path)) ^ set(map(tuple, want.path))
    with capsys.disabled():
        print(f"\n{engine} on {name}: own frontends: {len(moved)} points in one path only "
              f"(port {len(got.path)}, JAX {len(want.path)} points)")
    for r in (got, want):
        assert r.score.count > 20 and r.score.pct_off_beats[3] <= 10.0, (r.engine, r.score.pct_off_beats)
    # fed the JAX frontend's features, the port's path is JAX's
    kind = "chroma_diff" if engine == "livenote_v2_diff" else "chroma"
    jax_features = lambda path, dtype, *, device: torch.from_numpy(np.array(jcorpus._cached(kind, path, np.float32)))  # noqa: E731
    monkeypatch.setattr(tcorpus, "wav_to_chroma_diff" if kind == "chroma_diff" else "wav_to_chroma", jax_features)
    tcorpus._FEAT_CACHE.clear()
    _same_result(tcorpus.align_pair(ref, live, engine, mode="fused", device="cpu"), want)


def test_align_pair_takes_params_in_the_jax_position(cases):
    """align_pair(ref, live, engine, params, dtype, mode) as the JAX package
    orders them: the band given positionally is the one used."""
    ref, live = _pair(cases, "steady")
    band = {"c": 10, "max_run_count": 3}
    got = tcorpus.align_pair(ref, live, "otw", band, np.float32, "fused", device="cpu")
    want = tsl.pallas_set_live(tcorpus._cached_chroma(ref, np.float32, "cpu"),
                               tcorpus._cached_chroma(live, np.float32, "cpu"), band, device="cpu")
    np.testing.assert_array_equal(got.path, want[0])
    default = tcorpus.align_pair(ref, live, "otw", mode="fused", device="cpu")  # c = 50
    assert not np.array_equal(got.path, default.path)


def test_wav_to_chroma_diff_matches_jax(cases):
    ref, _ = _pair(cases, "dropout")
    got = tchroma.wav_to_chroma_diff(ref, device="cpu")
    want = np.asarray(jchroma.wav_to_chroma_diff(ref))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert (got >= 0).all()


@pytest.fixture(scope="module")
def two_piece_corpus(tmp_path_factory):
    """Two pieces (one pair each) and a third whose audio is missing."""
    root = tmp_path_factory.mktemp("Songs")
    synthetic.build_corpus(str(root), ["steady", "noisy"])
    gone = root / "gamma"
    gone.mkdir()
    for idx in (0, 1):
        (gone / f"gamma_{idx:02d}.csv").write_text("0.000000,1\n0.500000,2\n")
    return str(root)


def test_corpus_runner_matches_jax(two_piece_corpus, capsys):
    got = tcorpus.CorpusRunner(two_piece_corpus, "dtw", dtype=np.float64, device="cpu").evaluate()
    got_out = capsys.readouterr().out
    want = jcorpus.CorpusRunner(two_piece_corpus, "dtw", dtype=np.float64).evaluate()
    want_out = capsys.readouterr().out
    assert tcorpus.corpus_pairs(two_piece_corpus) == jcorpus.corpus_pairs(two_piece_corpus)
    assert got.skipped == want.skipped and len(got.skipped) == 1
    assert len(got.results) == len(want.results) == 2
    for g, w in zip(got.results, want.results):
        _same_result(g, w)
    assert got.mean_error == want.mean_error
    assert got_out == want_out


@pytest.mark.parametrize("engine", ONLINE)
def test_corpus_runner_fused_batched_equals_solo(two_piece_corpus, engine):
    """A fused sweep of two present pairs is one batched set_live; each
    pair's path equals solo align_pair(mode="fused")."""
    tsl.launches = 0
    report = tcorpus.CorpusRunner(two_piece_corpus, engine, mode="fused", device="cpu").evaluate(verbose=False)
    assert tsl.launches == 0
    assert len(report.results) == 2 and len(report.skipped) == 1
    for r in report.results:
        solo = tcorpus.align_pair(r.ref_wav, r.live_wav, engine, mode="fused", device="cpu")
        _same_result(r, solo)
    assert np.isfinite(report.mean_error)


def test_corpus_runner_fused_params_and_float64(two_piece_corpus):
    band = {"c": 10, "max_run_count": 3}
    report = tcorpus.CorpusRunner(two_piece_corpus, "otw", band, np.float32, "fused", device="cpu").evaluate(
        verbose=False)
    for r in report.results:
        _same_result(r, tcorpus.align_pair(r.ref_wav, r.live_wav, "otw", band, mode="fused", device="cpu"))
    for runner in (tcorpus.CorpusRunner(two_piece_corpus, "otw", dtype=np.float64, mode="fused", device="cpu"),
                   tcorpus.CorpusRunner(two_piece_corpus, "otw", None, np.float64, "fused", device="cpu")):
        with pytest.raises(ValueError, match="float32"):  # the batched path
            runner.evaluate(verbose=False)
    ref, live = _pair(two_piece_corpus, "steady")
    with pytest.raises(ValueError, match="float32"):  # the solo path
        tcorpus.align_pair(ref, live, "livenote_v2_diff", None, np.float64, "fused", device="cpu")


def _same_buckets(got: str, want: str, points: float = 1.0) -> None:
    """Two CLI outputs of one pair: the same lines, each percentage within
    ``points`` (a WTW path on each package's own frontend)."""
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w) and g
    for a, b in zip(g, w):
        assert a.split(":")[0] == b.split(":")[0]
        assert abs(float(a.split(":")[1].split("%")[0]) - float(b.split(":")[1].split("%")[0])) <= points, (a, b)


def test_cli_matches_jax(two_piece_corpus, tmp_path, capsys):
    ref, live = _pair(two_piece_corpus, "steady")
    rng = np.random.default_rng(3)
    path = [(int(i), int(max(0, i + d))) for i, d in zip(range(140), rng.integers(-8, 9, 140))]
    log = str(tmp_path / "field.txt")
    header = [("fft_len", 4096), ("hop_size", 2048), ("search_band_width", 50), ("max_run_count", 3)]
    write_field_log(log, ref, header, path)
    runs = [
        ["--score-log", log, "--ref-csv", ref[:-4] + ".csv", "--live-csv", live[:-4] + ".csv"],
        ["--ref", ref, "--live", live, "--engine", "dtw", "--dtype", "float64"],
        ["--corpus", two_piece_corpus, "--engine", "dtw", "--dtype", "float64"],
    ]
    for args in runs:
        assert tmain(args + ["--device", "cpu"]) == 0
        got = capsys.readouterr().out
        assert jmain(args) == 0
        want = capsys.readouterr().out
        assert got.splitlines() == want.splitlines() and got.strip(), args
    # without --engine a sweep streams livenote_v2_diff, the JAX CLI's default
    args = ["--corpus", two_piece_corpus, "--dtype", "float64"]
    assert tmain(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jmain(args) == 0
    assert got.splitlines() == capsys.readouterr().out.splitlines() and "[livenote_v2_diff]" in got
    # --engine wtw streams through AsyncWTW; each package on its own frontend, the buckets agree
    assert tmain(["--ref", ref, "--live", live, "--engine", "wtw", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jmain(["--ref", ref, "--live", live, "--engine", "wtw"]) == 0
    want = capsys.readouterr().out
    _same_buckets(got, want)
    # an online engine's fused sweep: the runner's own report
    assert tmain(["--corpus", two_piece_corpus, "--engine", "otw", "--mode", "fused", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    tcorpus.CorpusRunner(two_piece_corpus, "otw", mode="fused", device="cpu").evaluate()
    assert got == capsys.readouterr().out and "mean error" in got


def test_feature_memo_keys_on_kind(cases):
    """Chroma and chroma-diff of one recording are two memo entries."""
    ref, _ = _pair(cases, "noisy")
    chroma = tcorpus._cached_chroma(ref, np.float32, "cpu")
    diff = tcorpus._cached_chroma(ref, np.float32, "cpu", "chroma_diff")
    assert diff.shape == (12, chroma.shape[1] - 1)
    np.testing.assert_array_equal(diff.numpy(), tchroma.wav_to_chroma_diff(ref, device="cpu").numpy())
    assert tcorpus._cached_chroma(ref, np.float32, "cpu") is chroma
    assert tcorpus._cached_chroma(ref, np.float32, "cpu", "chroma_diff") is diff
    assert sorted(k[2] for k in tcorpus._FEAT_CACHE) == ["chroma", "chroma_diff"]


def test_chroma_memo_is_an_lru(cases, monkeypatch):
    """The chroma memo returns the same tensor on a hit, keys on dtype,
    and evicts the least recently used entry at capacity."""
    ref, live = _pair(cases, "steady")
    chroma = tcorpus._cached_chroma(ref, np.float32, "cpu")
    assert chroma.dtype == torch.float32 and chroma.shape[0] == 12
    np.testing.assert_array_equal(chroma.numpy(), tchroma.wav_to_chroma(ref, device="cpu").numpy())
    assert tcorpus._cached_chroma(ref, np.float32, "cpu") is chroma
    assert tcorpus._cached_chroma(ref, np.float64, "cpu").dtype == torch.float64  # dtype is part of the key

    monkeypatch.setattr(tcorpus, "_FEAT_CACHE_MAX", 2)
    tcorpus._FEAT_CACHE.clear()
    first = tcorpus._cached_chroma(ref, np.float32, "cpu")
    tcorpus._cached_chroma(live, np.float32, "cpu")
    assert tcorpus._cached_chroma(ref, np.float32, "cpu") is first  # refreshes ref: live is now the oldest
    tcorpus._cached_chroma(ref, np.float64, "cpu")
    assert len(tcorpus._FEAT_CACHE) == 2
    assert [k[0] for k in tcorpus._FEAT_CACHE] == [os.path.abspath(ref)] * 2
    assert tcorpus._cached_chroma(ref, np.float32, "cpu") is first
