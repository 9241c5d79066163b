"""The port's multi-stream WTW engine (``parallel/wtw_serving.FusedMultiStreamWTW``,
the kernel's plain version on the CPU) and the batched WTW corpus sweep
(``CorpusRunner(engine="wtw", mode="fused")``) against solo port engines and
the JAX package's ``FusedMultiStreamWTW`` (its Pallas grid kernel in
interpret mode), on numpy-seeded audio and the synthetic corpus.

Tolerances: none wherever both sides see the same chroma columns — each
stream against a solo port ``FusedWTW`` or ``align_pair`` (the same device
frontend, each stream's frames extracted in the same fixed tiles), and the
port against the JAX engine on the copied host frontend
(``transfer_dtype="chroma"``) with shared reference chromas: paths and
pointers EQUAL.  The port's and JAX's device frontends differ by up to
2.15e-6, which moves near-tie window decisions, so the sweep is held to the
JAX runner's ``PathScorer`` buckets within 1 percentage point."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from real_time_audio_sync_tpu.eval import corpus as jcorpus  # noqa: E402
from real_time_audio_sync_tpu.features.chroma import chroma_from_samples as jax_chroma  # noqa: E402
from real_time_audio_sync_tpu.parallel.wtw_serving import FusedMultiStreamWTW as JaxMulti  # noqa: E402
from real_time_audio_sync_tpu_torch.eval import corpus as tcorpus, synthetic  # noqa: E402
from real_time_audio_sync_tpu_torch.features.chroma import chroma_frames_tiled, chroma_spans_tiled, frame_span  # noqa: E402
from real_time_audio_sync_tpu_torch.models import FusedWTW  # noqa: E402
from real_time_audio_sync_tpu_torch.models.wtw import SampleFIFO  # noqa: E402
from real_time_audio_sync_tpu_torch.parallel import FusedMultiStreamWTW, MultiStreamWTW, corpus_mesh  # noqa: E402
from real_time_audio_sync_tpu_torch.utils import convert  # noqa: E402

from tests.test_pallas_wtw import WP, _aligned_chunks, _run, _synth  # noqa: E402

PAIRS = ("steady", "dropout", "jittered")
#: the buckets of port and JAX paths on their own frontends agree within this
BUCKET_POINTS = 1.0


def _multi(refs, **kw):
    kw.setdefault("transfer_dtype", "float32")
    return FusedMultiStreamWTW(refs, WP, device="cpu", **kw)


def _solo(ref, chunks, **kw):
    kw.setdefault("transfer_dtype", "float32")
    return _run(FusedWTW(ref, WP, k_block=8, device="cpu", **kw), chunks)


def _feed(ms, feeds):
    """Insert feed i of every stream in turn (``None`` past a stream's end), then flush."""
    for t in range(max(len(f) for f in feeds)):
        ms.insert([f[t] if t < len(f) else None for f in feeds])
    ms.flush()
    return ms


def _two_refs():
    ref_a, live_a = _synth(seed=0, ref_s=20, live_s=10)
    ref_b, _ = _synth(seed=5, ref_s=16)
    live_b = ref_b[: 22050 * 10] + np.random.default_rng(6).standard_normal(22050 * 10).astype(np.float32) * 0.03
    return (ref_a, live_a), (ref_b, live_b)


def test_mixed_references_equal_solo_streams():
    """tests/test_pallas_wtw.py:140 with the port: two references of
    different lengths (stacked, each stream stops on its own length) and a
    third stream sharing the first's; each stream's path and pointers equal
    a solo ``FusedWTW``'s."""
    (ref_a, live_a), (ref_b, live_b) = _two_refs()
    feeds = [_aligned_chunks(live_a), _aligned_chunks(live_b), np.array_split(live_a[: 22050 * 7], 23)]
    ms = _feed(_multi([ref_a, ref_b, ref_a]), feeds)
    assert ms._state.ref.shape[0] == 3 and ms.ms[0] == ms.ms[2] > ms.ms[1]
    paths, pointers = ms.paths(), ms.pointers()
    for i, (ref, feed) in enumerate(zip([ref_a, ref_b, ref_a], feeds)):
        solo = _solo(ref, feed)
        assert len(solo.path) > 20
        assert paths[i] == solo.path, i
        assert pointers[i] == solo.pointers, i


def test_feed_skew_leaves_every_stream_equal_to_solo():
    """Stream 0 fed 8-column-aligned chunks, stream 1 the same audio in
    skewed chunks: both equal a solo engine on their own feed (JAX's test
    allows stream 1 to differ, tests/test_pallas_wtw.py:160-178; the port
    extracts every stream's frames in fixed tiles, so it need not)."""
    ref, live = _synth(seed=7, ref_s=20, live_s=10)
    chunks = _aligned_chunks(live)
    cat = np.concatenate(chunks)
    skewed, pos = [], 0
    for i in range(len(chunks)):
        take = min(len(cat) - pos, 5000 + (i % 3) * 7000)
        skewed.append(cat[pos : pos + take])
        pos += take
    skewed.append(cat[pos:])
    ms = _feed(_multi([ref, ref]), [chunks, skewed])
    assert ms._state.ref.shape[0] == 1  # one reference, stored once
    solo = _solo(ref, chunks)
    assert ms.paths() == [solo.path, _solo(ref, skewed).path] and ms.paths()[1] == solo.path
    assert ms.pointers() == [solo.pointers] * 2


def test_frontend_columns_equal_each_stream_alone():
    """``chroma_spans_tiled``: stream b's columns equal, bit for bit, the
    solo engines' extraction of its span, whatever the other streams hold;
    streams left out read zero."""
    rng = np.random.default_rng(3)
    spans = torch.from_numpy(rng.standard_normal((4, 7 * 2048 + 4096)).astype(np.float32))
    got = chroma_spans_tiled(spans, 8, 4096, 2048, 22050)
    part = chroma_spans_tiled(spans, 8, 4096, 2048, 22050, streams=[1, 3])
    for b in range(4):
        want = chroma_frames_tiled(frame_span(spans[b], 8, 4096, 2048), 4096, 22050).T
        assert torch.equal(got[b], want)
        assert torch.equal(part[b], want) if b in (1, 3) else not part[b].any()


def test_port_equals_jax_on_shared_features():
    """Both packages' engines on the copied host frontend
    (``transfer_dtype="chroma"``, which packs the valid frames of every
    stream into one extraction in both) and on the same reference chromas:
    path for path and pointer for pointer, with mixed references and a
    ragged feed."""
    (ref_a, live_a), (ref_b, live_b) = _two_refs()
    chromas = [np.asarray(jax_chroma(r)) for r in (ref_a, ref_b)]
    feeds = [np.array_split(live_a, 31), np.array_split(live_b[: 22050 * 8], 19)]
    port = _feed(_multi([ref_a, ref_b], transfer_dtype="chroma", ref_chromas=chromas), feeds)
    jax_ = _feed(JaxMulti([ref_a, ref_b], WP, k_block=8, transfer_dtype="chroma", ref_chromas=chromas,
                          interpret=True), feeds)
    assert all(len(p) > 20 for p in port.paths())
    assert port.paths() == jax_.paths()
    assert port.pointers() == jax_.pointers()


def test_int16_spans_give_the_float32_path():
    ref, live = _synth(seed=6, ref_s=14, live_s=9)
    lq = (np.round(live * 32768.0).clip(-32768, 32767) / 32768.0).astype(np.float32)  # int16-exact audio
    feeds = [np.array_split(lq, 17), np.array_split(lq[22050:], 11)]
    want = _feed(_multi([ref, ref]), feeds).paths()
    assert _feed(_multi([ref, ref], transfer_dtype="int16"), feeds).paths() == want


def test_contract_and_what_raises():
    """JAX's positional order and attributes; ``mesh=`` takes a mesh and 3
    streams on 8 entries raise "divisible"; windows above 128 frames, no
    stream, a ``ref_chromas`` count that does not match, a
    reference shorter than a window and a bad transfer mode raise."""
    ref, _ = _synth(seed=6, ref_s=8)
    short, _ = _synth(seed=6, ref_s=1)
    ms = FusedMultiStreamWTW([ref, ref], WP, 4, None, "int16", None, True, device="cpu")
    assert (ms.k_block, ms.transfer_dtype, ms.interpret, ms.mesh, ms.b, ms.f) == (4, "int16", True, None, 2, 12)
    assert ms.dtype == np.float32 and list(ms.n_caps) == list(2 * ms.ms) and len(ms.bufs) == 2
    assert _multi([ref], transfer_dtype="auto").transfer_dtype == "float32"  # no link to probe on the CPU
    mesh = corpus_mesh(2, device="cpu")
    assert _multi([ref, ref], mesh=mesh).mesh is mesh
    with pytest.raises(ValueError, match="divisible"):
        _multi([ref] * 3, mesh=corpus_mesh(8, device="cpu"))
    with pytest.raises(ValueError, match="use MultiStreamWTW"):
        FusedMultiStreamWTW([ref], dict(WP, dtw_win_size=4096 * 80), device="cpu")
    with pytest.raises(ValueError, match="at least one stream"):
        _multi([])
    chroma = np.asarray(jax_chroma(ref))
    with pytest.raises(ValueError, match="ref_chromas has 2 entries for 3 streams"):
        _multi([ref] * 3, ref_chromas=[chroma, chroma])
    assert _multi([ref] * 3, ref_chromas=[chroma])._state.ref.shape[0] == 1  # one entry: shared
    with pytest.raises(ValueError, match="stream 1: reference too short"):
        _multi([ref, short])
    with pytest.raises(ValueError, match="transfer_dtype"):
        _multi([ref], transfer_dtype="bf16")
    with pytest.raises(ValueError, match="expected 2 buffers"):
        ms.insert([None])


def _load_port(ms, live, scalars, host_paths, bufs):
    ms._state.live.copy_(live)
    ms._state.scalars.copy_(scalars)
    ms._reset_host_paths(host_paths)
    ms.bufs = [SampleFIFO.from_array(b, ms.dtype) for b in bufs]


def _load_jax(ms, live_win, scalars, host_paths, bufs):
    ms._live_win, ms._scalars = jnp.asarray(live_win), jnp.asarray(scalars)
    ms._host_px = [[p[:, 0]] for p in host_paths]
    ms._host_py = [[p[:, 1]] for p in host_paths]
    ms._drained_plen = np.asarray([len(p) for p in host_paths], np.int64)
    ms.bufs = [SampleFIFO.from_array(b, ms.dtype) for b in bufs]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_carries_across_packages_mid_stream(direction):
    """Feed one package's engine the first half of two streams' audio (mixed
    references), carry its state — live chroma, scalars, drained host
    paths, buffered samples — into a fresh engine of the other package with
    ``utils/convert``, and finish there: the paths equal one engine fed
    the whole audio (both on shared features)."""
    (ref_a, live_a), (ref_b, live_b) = _two_refs()
    refs = [ref_a[: 22050 * 12], ref_b[: 22050 * 12]]
    chromas = [np.asarray(jax_chroma(r)) for r in refs]
    feeds = [np.array_split(live_a[: 22050 * 9], 30), np.array_split(live_b[: 22050 * 8], 30)]

    def port():
        return _multi(refs, transfer_dtype="chroma", ref_chromas=chromas)

    def jax_():
        return JaxMulti(refs, WP, k_block=8, transfer_dtype="chroma", ref_chromas=chromas, interpret=True)

    whole = _feed(port(), feeds)
    first, second = (jax_(), port()) if direction == "jax_to_port" else (port(), jax_())
    for t in range(15):
        first.insert([f[t] for f in feeds])
    done = [np.asarray(p, np.int32).reshape(-1, 2) for p in first.paths()]
    assert all(len(p) > 5 for p in done)
    bufs = [b.to_array() for b in first.bufs]
    if direction == "jax_to_port":
        live, sc, hp = convert.multi_fused_wtw_state_from_jax(np.asarray(first._live_win), np.asarray(first._scalars),
                                                              done, ms=first.ms, f=12)
        _load_port(second, live, sc, hp, bufs)
    else:
        live_win, sc, hp = convert.multi_fused_wtw_state_to_jax(first._state.live, first._state.scalars, done, w=20,
                                                                hop_frames=10, k_block=8)
        _load_jax(second, live_win, sc, hp, bufs)
    _feed(second, [f[15:] for f in feeds])
    assert second.paths() == whole.paths()
    assert [tuple(int(v) for v in p) for p in second.pointers()] == whole.pointers()


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = tmp_path_factory.mktemp("Songs")
    synthetic.build_corpus(str(root), PAIRS)
    return str(root)


def test_corpus_sweep_is_one_multi_stream_run_equal_to_solo_pairs(cases, monkeypatch):
    """``CorpusRunner(engine="wtw", mode="fused")`` over the three synthetic
    pairs runs one ``FusedMultiStreamWTW``; every pair's path equals solo
    ``align_pair(engine="wtw", mode="fused")``, and its buckets are within
    ``BUCKET_POINTS`` of the JAX runner's."""
    from collections import OrderedDict

    monkeypatch.setattr(tcorpus, "_FEAT_CACHE", OrderedDict())
    monkeypatch.setenv("RTAS_TRANSFER_MODE", "float32")  # the JAX runner's "auto", pinned: no timing probe
    runs = []
    monkeypatch.setattr(FusedMultiStreamWTW, "flush",
                        lambda self, _f=FusedMultiStreamWTW.flush: runs.append(self.b) or _f(self))
    report = tcorpus.CorpusRunner(cases, "wtw", mode="fused", device="cpu").evaluate(verbose=False)
    assert runs == [len(PAIRS)] and len(report.results) == len(PAIRS)
    want = jcorpus.CorpusRunner(cases, "wtw", mode="fused").evaluate(verbose=False)
    for r, j in zip(report.results, want.results):
        assert os.path.basename(r.live_wav) == os.path.basename(j.live_wav)
        solo = tcorpus.align_pair(r.ref_wav, r.live_wav, "wtw", mode="fused", device="cpu")
        assert len(r.path) > 50
        np.testing.assert_array_equal(r.path, solo.path)
        for t in (1, 3, 5, 10):
            assert abs(r.score.pct_off_beats[t] - j.score.pct_off_beats[t]) <= BUCKET_POINTS, (r.live_wav, t)
    # above the fused kernel's 128-frame windows the sweep is one MultiStreamWTW run, each pair its
    # solo align_pair (AsyncWTW)
    wide = dict(tcorpus.DEFAULT_WTW_PARAMS, dtw_win_size=4096 * 65)  # w = 130
    wide_runs = []
    monkeypatch.setattr(MultiStreamWTW, "flush", lambda self, _f=MultiStreamWTW.flush: wide_runs.append(self.b) or _f(self))
    report = tcorpus.CorpusRunner(cases, "wtw", wide, mode="fused", device="cpu").evaluate(verbose=False)
    assert wide_runs == [len(PAIRS)] and runs == [len(PAIRS)]
    assert sum(len(r.path) for r in report.results) > 50
    for r in report.results:
        np.testing.assert_array_equal(r.path, tcorpus.align_pair(r.ref_wav, r.live_wav, "wtw", wide, mode="fused",
                                                                 device="cpu").path)
