"""The port's ``MultiStreamWTW`` (``parallel/wtw_serving.py``: B
``AsyncWTW`` block steps advanced together, each window slot one batched
call of the wavefront DP and backtrack) on the CPU against solo port
``AsyncWTW`` engines and the JAX package's ``MultiStreamWTW``, on
numpy-seeded audio (the cases of tests/test_wtw_serving.py that need no
Chopin wavs).

Tolerances: none.  Float64 throughout but where a transfer contract is the
subject; against the JAX engine on shared features (``transfer_dtype=
"chroma"``, the copied host frontend, and the JAX reference chroma through
``ref_chromas``) on tie-free noise audio, paths and pointers EQUAL; every
stream EQUAL to its solo engine fed the same chunks."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from real_time_audio_sync_tpu.parallel.wtw_serving import MultiStreamWTW as JaxMulti  # noqa: E402
from real_time_audio_sync_tpu_torch.models import AsyncWTW  # noqa: E402
from real_time_audio_sync_tpu_torch.models.wtw import SampleFIFO  # noqa: E402
from real_time_audio_sync_tpu_torch.models.wtw_async import host_chroma_block  # noqa: E402
from real_time_audio_sync_tpu_torch.ops import wavefront  # noqa: E402
from real_time_audio_sync_tpu_torch.parallel import MultiStreamWTW, corpus_mesh  # noqa: E402
from real_time_audio_sync_tpu_torch.utils import convert  # noqa: E402

P3 = {"fft_len": 4096, "hop_size": 2048, "dtw_win_size": 4096 * 3, "dtw_hop_size": 2048 * 3}
P10 = {"fft_len": 4096, "hop_size": 2048, "dtw_win_size": 4096 * 10, "dtw_hop_size": 2048 * 10}
LIVE_APP = {"fft_len": 4096, "hop_size": 2048, "dtw_win_size": 4096 * 50, "dtw_hop_size": 2048 * 50}


def _noise(seed, seconds, n=3):
    """Noise references of different lengths and live takes: each its
    reference's first 60-100 % with noise."""
    rng = np.random.default_rng(seed)
    refs = [(0.2 * rng.standard_normal(int(22050 * (seconds + i)))).astype(np.float64) for i in range(n)]
    lives = [(r + 0.02 * rng.standard_normal(len(r)))[: int(len(r) * rng.uniform(0.6, 1.0))] for r in refs]
    return refs, lives


def _multi(refs, params=P3, **kw):
    kw.setdefault("transfer_dtype", "float32")
    kw.setdefault("dtype", np.float64)
    return MultiStreamWTW(refs, params, device="cpu", **kw)


def _feed(ms, feeds):
    """Insert chunk t of every stream in turn (``None`` past a stream's end), then flush."""
    for t in range(max(len(f) for f in feeds)):
        ms.insert([f[t] if t < len(f) else None for f in feeds])
    ms.flush()
    return ms


def _solo(ref, chunks, params=P3, **kw):
    kw.setdefault("dtype", np.float64)
    eng = AsyncWTW(ref, params, device="cpu", **kw)
    for c in chunks:
        if eng.insert(c) == "stop":
            break
    eng.flush()
    return eng


def test_matches_solo_engines_mixed_refs_skewed_feeds():
    """tests/test_wtw_serving.py:18-48: mixed references and unaligned
    per-stream cadences; every stream's path and pointers are a solo
    AsyncWTW's on the same audio."""
    refs, lives = _noise(3, 6)
    refs = [refs[0], refs[1], refs[0]]
    feeds = [np.array_split(lv, ch) for lv, ch in zip((lives[0], lives[1], lives[2][: len(refs[0])]), (50, 19, 31))]
    ms = _feed(_multi(refs, P10, k_block=8), feeds)
    assert not ms._shared_ref and ms._stepper.ref.shape[0] == 2  # two distinct references, stored once each
    for i in range(3):
        solo = _solo(refs[i], feeds[i], P10, k_block=8)
        assert len(solo.path) > 10
        assert ms.paths()[i] == solo.path
        assert ms.pointers()[i] == solo.pointers


@pytest.mark.parametrize("seed", [71, 72])
def test_api_interleaving_fuzz(seed):
    """tests/test_wtw_serving.py:253-316: random per-stream buffer sizes
    (None = no new audio), reads under maximum harvest pressure, and one
    mid-stream carry of the whole state through the JAX layout into a
    fresh engine (``utils/convert``'s ``multi_async_wtw_state_*``, with the
    buffered samples): paths and pointers equal solo engines fed the same
    chunks."""
    rng = np.random.default_rng(seed)
    refs, lives = _noise(seed, 3)
    ms = _multi(refs, k_block=4)
    ms.poll_min_interval = 0.0
    fed: list = [[] for _ in refs]
    ptrs = [0] * len(refs)
    carry_at = int(rng.integers(5, 15))
    step = 0
    while any(p < len(lv) for p, lv in zip(ptrs, lives)):
        bufs = []
        for i, lv in enumerate(lives):
            if ptrs[i] < len(lv) and rng.integers(0, 3):
                n = int(rng.integers(500, 8000))
                bufs.append(lv[ptrs[i] : ptrs[i] + n])
                fed[i].append(bufs[-1])
                ptrs[i] += n
            else:
                bufs.append(None)
        ms.insert(bufs)
        op = int(rng.integers(0, 5))
        if op == 0:
            _ = ms.stopped
        elif op == 1:
            _ = ms.pointers()
        elif op == 2 and rng.integers(0, 4) == 0:
            _ = ms.paths()
        step += 1
        if step == carry_at:
            ms.flush()
            st = ms._stepper
            jax_state = convert.multi_async_wtw_state_to_jax(st.live, st.px, st.py, st.sc)
            buffered = [b.to_array() for b in ms.bufs]
            ms = _multi(refs, k_block=4)
            ms.poll_min_interval = 0.0
            ms._stepper.set_state(*convert.multi_async_wtw_state_from_jax(*jax_state))
            ms.bufs = [SampleFIFO.from_array(b, ms.dtype) for b in buffered]
    ms.flush()
    for i in range(len(refs)):
        solo = _solo(refs[i], fed[i], k_block=4)
        assert ms.paths()[i] == solo.path
        assert ms.pointers()[i] == solo.pointers


def test_a_stream_without_columns_is_left_alone():
    """A slow stream whose last window put it at its reference margin and
    that has no column in the blocks the other streams dispatch: nothing
    happens to it until its next column, which counts and stops it, as in
    a solo engine (its chroma_ptr included)."""
    rng = np.random.default_rng(4)
    ref_a, ref_b = (0.2 * rng.standard_normal(22050 * s) for s in (3, 20))
    live_a = np.concatenate([ref_a, ref_a]) + 0.02 * rng.standard_normal(2 * len(ref_a))
    live_b = ref_b + 0.02 * rng.standard_normal(len(ref_b))
    hops_a = [live_a[s : s + 2048] for s in range(0, len(live_a), 2048)]
    hops_b = [live_b[s : s + 2048] for s in range(0, len(live_b), 2048)]
    feed_a = [hops_a[t // 7] if t % 7 == 0 and t // 7 < len(hops_a) else None for t in range(len(hops_b))]
    ms = _feed(_multi([ref_a, ref_b], k_block=4), [feed_a, hops_b])
    for i, chunks in enumerate(([a for a in feed_a if a is not None], hops_b)):
        solo = _solo((ref_a, ref_b)[i], chunks, k_block=4)
        assert solo.flush() == "stop" and ms.stopped[i]
        assert ms.paths()[i] == solo.path and len(solo.path) > 10
        assert ms.pointers()[i] == solo.pointers


def test_matches_jax_on_shared_features():
    """The port's and the JAX package's MultiStreamWTW on the copied host
    frontend's columns and the JAX reference chroma (``ref_chromas``), fed
    the same skewed chunks: paths, pointers and stop masks equal."""
    from real_time_audio_sync_tpu.features.chroma import chroma_from_samples as jax_chroma

    refs, lives = _noise(5, 4)
    chromas = [np.asarray(jax_chroma(r, dtype=np.float64)) for r in refs]
    lives[1] = np.concatenate([lives[1], refs[1], refs[1]])  # runs past its reference: a stop
    kw = {"k_block": 8, "dtype": np.float64, "transfer_dtype": "chroma", "ref_chromas": chromas}
    port, jax_ = _multi(refs, **kw), JaxMulti(refs, P3, **kw)
    feeds = [np.array_split(lv, n) for lv, n in zip(lives, (17, 40, 9))]
    for ms in (port, jax_):
        _feed(ms, feeds)
    assert sum(len(p) for p in port.paths()) > 30
    assert port.paths() == jax_.paths()
    assert port.pointers() == [tuple(int(v) for v in p) for p in jax_.pointers()]
    assert list(port.stopped) == list(jax_.stopped) == [False, True, False]


def test_validation_and_contract():
    """tests/test_wtw_serving.py:84-92 and :319-327: ``mesh=`` takes a mesh
    and 3 streams on 8 entries raise "divisible"; a wrong buffer count, no stream, a ``ref_chromas`` count that does
    not match, a short reference and a bad transfer mode raise; JAX's
    attributes."""
    refs, _ = _noise(6, 3, n=1)
    ms = _multi(refs, dtype=np.float32)
    assert (ms.b, ms.k_block, ms.mesh, ms.dtype, ms.transfer_dtype) == (1, 8, None, np.dtype(np.float32), "float32")
    assert list(ms.n_caps) == list(2 * ms.ms) and len(ms.bufs) == 1
    assert _multi(refs, transfer_dtype="auto").transfer_dtype == "float32"  # no link to probe on the CPU
    mesh = corpus_mesh(1, device="cpu")
    assert _multi(refs, mesh=mesh).mesh is mesh
    with pytest.raises(ValueError, match="divisible"):
        _multi(refs * 3, mesh=corpus_mesh(8, device="cpu"))
    with pytest.raises(ValueError, match="expected 1 buffers"):
        ms.insert([np.zeros(100), np.zeros(100)])
    with pytest.raises(ValueError, match="at least one stream"):
        _multi([])
    with pytest.raises(ValueError, match="entries for"):
        _multi(refs * 3, ref_chromas=[np.zeros((12, 50))] * 2)
    with pytest.raises(ValueError, match="stream 1:"):
        _multi([refs[0], refs[0][:4096]])
    with pytest.raises(ValueError, match="transfer_dtype"):
        _multi(refs, transfer_dtype="int8")


def test_stop_surfaces_before_flush():
    """tests/test_wtw_serving.py:95-117: a stream's stop reaches the stopped
    mask through the dispatch-time status reads, before flush."""
    refs, lives = _noise(8, 3, n=1)
    long_live = np.concatenate([lives[0], refs[0], refs[0], refs[0]])
    ms = _multi(refs, k_block=8)
    ms.poll_min_interval = 0.0
    seen = False
    for b in np.array_split(long_live, 64):
        if ms.insert([b])[0]:
            seen = True
            break
    assert seen and ms.flush()[0]


def test_live_app_window_size():
    """tests/test_wtw_serving.py:120-139: serving at the live app's w = 100
    (one window slot a block): both streams equal a solo engine."""
    refs, lives = _noise(9, 30, n=1)
    chunks = np.array_split(lives[0], 32)
    ms = _feed(_multi([refs[0], refs[0]], LIVE_APP), [chunks, chunks])
    solo = _solo(refs[0], chunks, LIVE_APP)
    assert len(solo.path) > 100
    assert ms.paths() == [solo.path, solo.path]
    assert ms.pointers() == [solo.pointers, solo.pointers]


def test_int16_transfer_matches_float32_exact_source():
    """tests/test_wtw_serving.py:143-173: int16 spans are path-exact on
    int16-exact audio, solo and multi-stream."""
    rng = np.random.default_rng(13)
    ref_i16 = rng.integers(-20000, 20000, int(3.0 * 22050)).astype(np.int16)
    live_i16 = (0.9 * ref_i16[: int(2.5 * 22050)]).astype(np.int16)
    ref, live = ref_i16 / 32768.0, live_i16 / 32768.0
    chunks = np.array_split(live, 16)
    a = _solo(ref, chunks, k_block=4)
    b = _solo(ref, chunks, k_block=4, transfer_dtype="int16")
    assert len(a.path) > 10 and a.path == b.path and a.pointers == b.pointers
    ms_f = _feed(_multi([ref, ref], k_block=4), [chunks, chunks])
    ms_i = _feed(_multi([ref, ref], k_block=4, transfer_dtype="int16"), [chunks, chunks])
    assert ms_f.paths() == ms_i.paths() == [a.path, a.path]


def test_chroma_transfer_matches_solo_chroma_engine():
    """tests/test_wtw_serving.py:176-206: the multi-stream chroma mode is
    bit-consistent with the solo chroma engine (same host extraction, same
    windows)."""
    rng = np.random.default_rng(5)
    n = int(5.0 * 22050)
    t = np.arange(n) / 22050
    ref = (0.3 * np.sin(2 * np.pi * 440 * t * (1 + 0.01 * np.sin(t))) + 0.05 * rng.standard_normal(n)).astype(
        np.float32)
    live = (0.3 * np.sin(2 * np.pi * 440 * t * 1.02) + 0.05 * rng.standard_normal(n)).astype(np.float32)
    chunks = np.array_split(live, 16)
    b = _solo(ref, chunks, k_block=4, dtype=np.float32, transfer_dtype="chroma")
    ms = _feed(_multi([ref, ref], k_block=4, dtype=np.float32, transfer_dtype="chroma"), [chunks, chunks])
    assert len(b.path) > 10
    assert ms.paths() == [b.path, b.path]
    assert ms.pointers() == [b.pointers, b.pointers]


def test_chroma_spans_ragged_packing_contract():
    """tests/test_wtw_serving.py:209-250: the host chroma payload extracts
    only the valid frames; each stream's first k columns are the solo
    extractor's, the rest zero, and exactly k hops are consumed."""
    rng = np.random.default_rng(17)
    wav = (0.2 * rng.standard_normal(22050 * 3)).astype(np.float32)
    ms = _multi([wav, wav, wav], k_block=4, dtype=np.float32, transfer_dtype="chroma")
    n_for = lambda k: (k - 1) * 2048 + 4096  # noqa: E731
    ms.bufs[0].extend(wav[: n_for(4)].copy())
    ms.bufs[1].extend(wav[: n_for(2)].copy())
    solo = [SampleFIFO(np.float32) for _ in range(2)]
    solo[0].extend(wav[: n_for(4)].copy())
    solo[1].extend(wav[: n_for(2)].copy())
    want0 = host_chroma_block(solo[0], 4, 4, 2048, 4096, np.float32)
    want1 = host_chroma_block(solo[1], 2, 4, 2048, 4096, np.float32)
    out = ms._spans(np.array([4, 2, 0]))
    assert out.shape == (3, 12, 4)
    np.testing.assert_array_equal(out[0], want0)
    np.testing.assert_array_equal(out[1, :, :2], want1[:, :2])
    assert (out[1, :, 2:] == 0).all() and (out[2] == 0).all()
    assert len(ms.bufs[0]) == n_for(4) - 4 * 2048 and len(ms.bufs[1]) == n_for(2) - 2 * 2048


def test_shared_ref_mode_matches_stacked():
    """tests/test_wtw_serving.py:330-354: B streams on one recording store
    its chromagram once; distinct array objects are two references; paths,
    pointers and stop masks are equal."""
    refs, lives = _noise(10, 5, n=1)
    rub, live = refs[0], lives[0]
    shared = _multi([rub, rub], P10)
    stacked = _multi([rub, rub.copy()], P10)
    assert shared._shared_ref and shared._stepper.ref.shape[0] == 1
    assert not stacked._shared_ref and stacked._stepper.ref.shape[0] == 2
    for ms in (shared, stacked):
        for b in np.array_split(live, 23):
            ms.insert([b, b[: len(b) // 2]])
        ms.flush()
    assert shared.paths() == stacked.paths()
    assert shared.pointers() == stacked.pointers()
    assert (shared.stopped == stacked.stopped).all()
    assert len(shared.paths()[0]) > 10


def test_precomputed_ref_chromas_match_extraction():
    """tests/test_wtw_serving.py:357-387: ``ref_chromas`` skips the
    reference extraction; shared and per-stream forms give the extracting
    constructor's paths."""
    from real_time_audio_sync_tpu_torch.features.chroma import chroma_from_samples

    refs, lives = _noise(11, 5, n=1)
    rub, live = refs[0], lives[0]
    chroma = chroma_from_samples(rub, dtype=torch.float64, device="cpu").numpy()
    baseline = _multi([rub, rub], P10)
    pre_shared = _multi([rub, rub], P10, ref_chromas=[chroma])
    pre_stacked = _multi([rub, rub], P10, ref_chromas=[chroma, chroma.copy()])
    assert pre_shared._shared_ref and not pre_stacked._shared_ref
    for ms in (baseline, pre_shared, pre_stacked):
        for b in np.array_split(live, 17):
            ms.insert([b, b[: len(b) // 2]])
        ms.flush()
    assert pre_shared.paths() == baseline.paths() == pre_stacked.paths()
    assert pre_shared.pointers() == baseline.pointers()
    assert len(baseline.paths()[0]) > 10


def test_each_window_slot_is_one_batched_call(monkeypatch):
    """Streams fed in step come due in the same window slot: each slot is
    one call of the DP and one of the backtrack over the due streams'
    windows (B at a time), never a call a stream."""
    calls = []
    dp, bt = wavefront.wavefront_dp, wavefront.backtrack

    def counting_dp(cost, spec=wavefront.DTW_SPEC, unroll=False):
        calls.append(("dp", tuple(cost.shape)))
        return dp(cost, spec)

    def counting_bt(back, spec=wavefront.DTW_SPEC, unroll=False):
        calls.append(("bt", tuple(back.shape)))
        return bt(back, spec)

    monkeypatch.setattr(wavefront, "wavefront_dp", counting_dp)
    monkeypatch.setattr(wavefront, "backtrack", counting_bt)
    refs, lives = _noise(12, 6, n=1)
    chunks = np.array_split(lives[0], 20)
    ms = _feed(_multi([refs[0]] * 4, P10), [chunks] * 4)
    windows = [shape for kind, shape in calls if kind == "dp"]
    assert windows and all(shape == (4, 20, 20) for shape in windows)
    assert [shape for kind, shape in calls if kind == "bt"] == windows
    assert len(ms.paths()[0]) == len(_solo(refs[0], chunks, P10).path) > 10


def test_multi_state_converters_round_trip():
    rng = np.random.default_rng(8)
    live_dev = rng.random((3, 12, 30))
    px, py = (rng.integers(0, 50, (3, 40)).astype(np.int32) for _ in range(2))
    sc = rng.integers(0, 9, (3, 8)).astype(np.int32)
    state = convert.multi_async_wtw_state_from_jax(live_dev, px, py, sc)
    assert state[0].shape == (3, 31, 12) and state[1].shape == (3, 41)
    back = convert.multi_async_wtw_state_to_jax(*state)
    for a, b in zip(back, (live_dev, px, py, sc)):
        np.testing.assert_array_equal(a, b)
