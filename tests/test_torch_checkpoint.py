"""The port's checkpoint/resume (``utils/checkpoint.py``) on the CPU,
against the JAX package's (tests/test_aux.py:35-433,
tests/test_fused_streaming.py:280, tests/test_parallel.py:469).

For every engine: a port checkpoint resumes in a port engine, a JAX
checkpoint in a port engine, and a port checkpoint in a JAX engine, each
to the path (and pointers) of an uninterrupted run of the package that
saved; and a port checkpoint holds exactly the JAX one's keys, with its
shapes and dtypes.  Both packages see the same features: the same feature
columns for the band engines, and for the WTW engines the JAX reference
chroma with live columns from the host frontend (the JAX package's bits;
``transfer_dtype="chroma"``, or both packages' column extractors replaced
by it for the host ``WTW``), on tie-free inputs.  Tolerance: none — paths
and pointers equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import real_time_audio_sync_tpu.models.wtw as jax_wtw_module  # noqa: E402
import real_time_audio_sync_tpu.utils.checkpoint as jck  # noqa: E402
import real_time_audio_sync_tpu_torch.models.wtw as port_wtw_module  # noqa: E402
import real_time_audio_sync_tpu_torch.utils.checkpoint as tck  # noqa: E402
from real_time_audio_sync_tpu import models as jmodels  # noqa: E402
from real_time_audio_sync_tpu.models.fused_streaming import FusedStreamingEngine as JaxFused  # noqa: E402
from real_time_audio_sync_tpu.models.fused_wtw import FusedWTW as JaxFusedWTW  # noqa: E402
from real_time_audio_sync_tpu.models.wtw_async import AsyncWTW as JaxAsyncWTW  # noqa: E402
from real_time_audio_sync_tpu.parallel import FusedMultiStreamFollower as JaxFMS  # noqa: E402
from real_time_audio_sync_tpu.parallel import MultiStreamWTW as JaxMultiWTW  # noqa: E402
from real_time_audio_sync_tpu_torch import models as tmodels  # noqa: E402
from real_time_audio_sync_tpu_torch.features.chroma import host_chroma_frames  # noqa: E402
from real_time_audio_sync_tpu_torch.models import AsyncWTW, FusedStreamingEngine, FusedWTW  # noqa: E402
from real_time_audio_sync_tpu_torch.parallel import FusedMultiStreamFollower, MultiStreamWTW  # noqa: E402

from tests.test_online import _make_pair  # noqa: E402
from tests.test_wtw import WTW_PARAMS, _synthetic_performance  # noqa: E402

BAND = {"c": 10, "max_run_count": 3}
SMALL_BAND = {"c": 8, "max_run_count": 3}
# the JAX package's save and load of each engine, and the port's
SAVE_LOAD = {
    "online": ("save_state", "load_state"),
    "fused": ("save_fused_state", "load_fused_state"),
    "multi": ("save_multi_stream_state", "load_multi_stream_state"),
    "multi_wtw": ("save_multi_wtw_state", "load_multi_wtw_state"),
    "async_wtw": ("save_async_wtw_state", "load_async_wtw_state"),
    "fused_wtw": ("save_fused_wtw_state", "load_fused_wtw_state"),
    "wtw": ("save_wtw_state", "load_wtw_state"),
}
PACKAGES = {"port": tck, "jax": jck}


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _host_columns(dtype):
    """Both packages' host ``WTW`` column extractor replaced by the host
    frontend, so the two engines see the same live columns."""
    def port(frames, n_fft, fs):
        return torch.from_numpy(host_chroma_frames(frames.numpy(), n_fft, fs))

    def jax(frames):
        return jnp.asarray(host_chroma_frames(np.asarray(frames, dtype)))

    return port, jax


class Case:
    """One engine: how each package builds it, feeds it a span of its input
    (``lo``..``hi`` of ``n`` steps) and reads its result: (every stream's
    path, the pointers where the engine has them)."""

    def __init__(self, kind, make, feed, result, n, half):
        self.kind, self.make, self.feed, self.result, self.n, self.half = kind, make, feed, result, n, half


def _online_case(name):
    ref, live = _make_pair(np.random.default_rng(17))
    params = BAND if name != "livenote" else {"search_band_width": 10, "max_run_count": 3}

    def make(pkg):
        mod = tmodels if pkg == "port" else jmodels
        cls = getattr(mod, {"otw": "OnlineTimeWarping", "livenote": "LiveNote", "livenote_v2": "LiveNoteV2"}[name])
        return cls(ref, params, dtype=np.float64, device="cpu") if pkg == "port" else cls(ref, params,
                                                                                         dtype=np.float64)

    def feed(eng, lo, hi):
        for i in range(lo, hi):
            if eng.insert(live[:, i]) == "stop":
                break

    def result(eng):
        return [[tuple(int(v) for v in p) for p in eng.path]], (int(eng.live_ptr), int(eng.ref_ptr))

    return Case("online", make, feed, result, live.shape[1], live.shape[1] // 2)


def _fused_case(long_ref):
    ref, live = _make_pair(np.random.default_rng(18))
    n = live.shape[1]

    def make(pkg):
        if pkg == "port":
            return FusedStreamingEngine(ref, BAND, k_block=8, long_ref=long_ref, device="cpu")
        return JaxFused(ref, BAND, k_block=8, interpret=True, long_ref=long_ref)

    def feed(eng, lo, hi):
        for s in range(lo, hi, 8):
            eng.insert_block_nowait(live[:, s : min(s + 8, hi)])

    def result(eng):
        eng.flush()
        return [np.asarray(eng.path_array).tolist()], None

    return Case("fused", make, feed, result, n, (n // 2 // 8) * 8)


def _multi_case(long_ref):
    rng = np.random.default_rng(7)
    pairs = [_make_pair(rng, n_ref=30 + 5 * i, stretch=1.15) for i in range(2)]
    refs = [r for r, _ in pairs]
    lives = [l for _, l in pairs]
    tmax = max(l.shape[1] for l in lives)

    def make(pkg):
        if pkg == "port":
            return FusedMultiStreamFollower(refs, BAND, k_block=8, max_in_flight=0, long_ref=long_ref, device="cpu")
        # max_in_flight=0: columns coalesce into k_block launches (the
        # JAX kernel is slow in interpret mode; a block is k inserts)
        return JaxFMS(refs, BAND, k_block=8, interpret=True, max_in_flight=0, long_ref=long_ref)

    def feed(fms, lo, hi):
        for t in range(lo, hi):
            cols = np.zeros((2, 12), np.float32)
            act = np.zeros(2, bool)
            for i, l in enumerate(lives):
                if t < l.shape[1]:
                    cols[i], act[i] = l[:, t], True
            fms.feed(cols, act)

    def result(fms):
        fms.flush()
        return [np.asarray(p).tolist() for p in fms.paths()], None

    return Case("multi", make, feed, result, tmax, tmax // 2)


def _wtw_audio(seconds, seed, stretch, n_chunks):
    ref = _synthetic_performance(seconds=seconds, seed=seed)
    idx = np.linspace(0, len(ref) - 1, int(len(ref) * stretch))
    live = np.interp(idx, np.arange(len(ref)), ref)
    return ref, np.array_split(live, n_chunks)


def _wtw_result(eng):
    eng.flush()
    return [[tuple(int(v) for v in p) for p in eng.path]], tuple(int(v) for v in eng.pointers)


def _multi_wtw_case():
    ref, chunks = _wtw_audio(6.0, 11, 1.07, 61)
    jax_ref = JaxAsyncWTW(ref, WTW_PARAMS, dtype=np.float64).chroma_ref

    def make(pkg):
        cls, kw = (MultiStreamWTW, {"device": "cpu"}) if pkg == "port" else (JaxMultiWTW, {})
        return cls([ref, ref], WTW_PARAMS, k_block=8, dtype=np.float64, transfer_dtype="chroma",
                   ref_chromas=[jax_ref], **kw)

    def feed(ms, lo, hi):
        for buf in chunks[lo:hi]:
            ms.insert([buf, buf])

    def result(ms):
        ms.flush()
        return [np.asarray(p).tolist() for p in ms.paths()], [tuple(int(v) for v in p) for p in ms.pointers()]

    return Case("multi_wtw", make, feed, result, len(chunks), len(chunks) // 2)


def _async_wtw_case():
    ref, chunks = _wtw_audio(6.0, 3, 1.05, 87)
    jax_ref = JaxAsyncWTW(ref, WTW_PARAMS, dtype=np.float64).chroma_ref

    def make(pkg):
        if pkg == "jax":
            return JaxAsyncWTW(ref, WTW_PARAMS, k_block=8, dtype=np.float64, transfer_dtype="chroma")
        eng = AsyncWTW(ref, WTW_PARAMS, k_block=8, dtype=np.float64, transfer_dtype="chroma", device="cpu")
        eng._stepper.ref[0, : eng.M] = torch.from_numpy(np.array(jax_ref).T)
        return eng

    def feed(eng, lo, hi):
        for buf in chunks[lo:hi]:
            if eng.insert(buf) == "stop":
                break

    return Case("async_wtw", make, feed, _wtw_result, len(chunks), len(chunks) // 2)


def _fused_wtw_case():
    ref, chunks = _wtw_audio(6.0, 3, 1.05, 47)
    chunks = [c.astype(np.float32) for c in chunks]
    jax_ref = JaxFusedWTW(ref, WTW_PARAMS, interpret=True).chroma_ref

    def make(pkg):
        if pkg == "jax":
            return JaxFusedWTW(ref, WTW_PARAMS, k_block=8, transfer_dtype="chroma", interpret=True)
        eng = FusedWTW(ref, WTW_PARAMS, k_block=8, transfer_dtype="chroma", device="cpu")
        eng._state.ref.copy_(torch.from_numpy(np.array(jax_ref, np.float32).T))
        return eng

    def feed(eng, lo, hi):
        for buf in chunks[lo:hi]:
            if eng.insert(buf) == "stop":
                break

    return Case("fused_wtw", make, feed, _wtw_result, len(chunks), len(chunks) // 2)


def _host_wtw_case():
    ref, chunks = _wtw_audio(6.0, 3, 1.05, 128)
    jax_ref = jax_wtw_module.WTW(ref, WTW_PARAMS, dtype=np.float64).chroma_ref

    def make(pkg):
        if pkg == "jax":
            return jax_wtw_module.WTW(ref, WTW_PARAMS, dtype=np.float64)
        eng = port_wtw_module.WTW(ref, WTW_PARAMS, dtype=np.float64, device="cpu")
        eng.chroma_ref = torch.from_numpy(np.array(jax_ref))
        return eng

    def feed(eng, lo, hi):
        for buf in chunks[lo:hi]:
            if eng.insert(buf.tolist()) == "stop":
                break

    def result(eng):
        return [[tuple(int(v) for v in p) for p in eng.path]], (eng.chroma_ptr, eng.live_ptr, eng.ref_ptr)

    return Case("wtw", make, feed, result, len(chunks), len(chunks) // 2)


CASES = {
    "otw": lambda: _online_case("otw"),
    "livenote": lambda: _online_case("livenote"),
    "livenote_v2": lambda: _online_case("livenote_v2"),
    "fused": lambda: _fused_case(False),
    "fused_long_ref": lambda: _fused_case(True),
    "multi_windowed": lambda: _multi_case(True),
    "multi_whole": lambda: _multi_case(False),
    "multi_wtw": _multi_wtw_case,
    "async_wtw": _async_wtw_case,
    "fused_wtw": _fused_wtw_case,
    "wtw": _host_wtw_case,
}


@pytest.fixture
def case(request, monkeypatch):
    if request.param == "wtw":
        port, jax = _host_columns(np.float64)
        monkeypatch.setattr(port_wtw_module, "chroma_frames_tiled", port)
        monkeypatch.setattr(jax_wtw_module, "chroma_frames", jax)
    return CASES[request.param]()


# each package's uninterrupted run of each case, computed once
_WHOLE: dict = {}


def _save(pkg, c, eng, path):
    getattr(PACKAGES[pkg], SAVE_LOAD[c.kind][0])(eng, path)


def _load(pkg, c, eng, path):
    getattr(PACKAGES[pkg], SAVE_LOAD[c.kind][1])(eng, path)


@pytest.mark.parametrize("case", list(CASES), indirect=True)
@pytest.mark.parametrize("direction", ["port_to_port", "jax_to_port", "port_to_jax"])
def test_resume_equals_the_uninterrupted_run(case, direction, tmp_path, request):
    """Half a run, save, load into a fresh engine (of the other package
    across packages), run the rest: the result equals an uninterrupted run
    of the saving package."""
    saver, loader = direction.split("_to_")
    key = (request.node.callspec.params["case"], saver)
    if key not in _WHOLE:
        whole = case.make(saver)
        case.feed(whole, 0, case.n)
        _WHOLE[key] = case.result(whole)
    want = _WHOLE[key]
    first = case.make(saver)
    case.feed(first, 0, case.half)
    ckpt = str(tmp_path / "state.npz")
    _save(saver, case, first, ckpt)
    resumed = case.make(loader)
    _load(loader, case, resumed, ckpt)
    case.feed(resumed, case.half, case.n)
    got = case.result(resumed)
    assert got == want
    assert min(len(p) for p in got[0]) > 5


@pytest.mark.parametrize("case", list(CASES), indirect=True)
def test_port_checkpoint_holds_the_jax_keys(case, tmp_path):
    """The same half run saved by each package: the same keys, each with
    the same shape and dtype, and the same reference in the same layout."""
    files = {}
    for pkg in ("port", "jax"):
        eng = case.make(pkg)
        case.feed(eng, 0, case.half)
        files[pkg] = str(tmp_path / f"{pkg}.npz")
        _save(pkg, case, eng, files[pkg])
    port, jax = np.load(files["port"]), np.load(files["jax"])
    assert sorted(port.files) == sorted(jax.files)
    for key in jax.files:
        assert (port[key].shape, port[key].dtype) == (jax[key].shape, jax[key].dtype), key
    for key in {"ref", "ref_t", "ref_dev", "chroma_ref"} & set(jax.files):
        np.testing.assert_array_equal(port[key], jax[key])


# -- rejections (tests/test_aux.py:97,360,376 and the other checks) -------------


def _saved(tmp_path, pkg, kind, eng):
    path = str(tmp_path / f"{kind}.npz")
    getattr(PACKAGES[pkg], SAVE_LOAD[kind][0])(eng, path)
    return path


def _online(cls="OnlineTimeWarping", params=SMALL_BAND, seed=31, pkg="port"):
    ref, live = _make_pair(np.random.default_rng(seed), n_ref=24)
    mod = tmodels if pkg == "port" else jmodels
    eng = getattr(mod, cls)(ref, params, device="cpu") if pkg == "port" else getattr(mod, cls)(ref, params)
    eng.insert(live[:, 0])
    return eng


def _fused(k_block=4, long_ref=False):
    ref, live = _make_pair(np.random.default_rng(33), n_ref=24)
    eng = FusedStreamingEngine(ref, SMALL_BAND, k_block=k_block, long_ref=long_ref, device="cpu")
    eng.insert_block_nowait(live[:, :4])
    return eng


def _fms(k_block=8, long_ref=None):
    rng = np.random.default_rng(7)
    refs = [_make_pair(rng, n_ref=30 + 5 * i)[0] for i in range(2)]
    return FusedMultiStreamFollower(refs, BAND, k_block=k_block, long_ref=long_ref, device="cpu")


_WTW_REF = _synthetic_performance(seconds=6.0, seed=3)
_WIDE = {**WTW_PARAMS, "dtw_win_size": 4096 * 5}


REJECTIONS = {
    # name: (kind, saved engine, engine loaded into, message)
    "online_reference": ("online", lambda: _online("LiveNote", {"search_band_width": 10, "max_run_count": 3}, 18),
                         lambda: _online("LiveNote", {"search_band_width": 10, "max_run_count": 3}, 19),
                         "different reference"),
    "online_c": ("online", lambda: _online(params={"c": 10, "max_run_count": 3}),
                 lambda: _online(params=SMALL_BAND), "checkpoint c 10"),
    "online_max_run_count": ("online", lambda: _online(params={"c": 10, "max_run_count": 3}),
                             lambda: _online(params={"c": 10, "max_run_count": 2}), "max_run_count"),
    "fused_k_block": ("fused", lambda: _fused(4), lambda: _fused(8), "k_block"),
    "fused_long_ref": ("fused", lambda: _fused(4), lambda: _fused(4, long_ref=True), "long_ref"),
    # the windowed layout's reference rows depend on k_block: its ref_t differs first
    "multi_k_block": ("multi", lambda: _fms(8), lambda: _fms(4), "k_block|different reference"),
    "multi_long_ref": ("multi", lambda: _fms(8), lambda: _fms(8, long_ref=False), "long_ref"),
    "multi_wtw_transfer": ("multi_wtw", lambda: MultiStreamWTW([_WTW_REF] * 2, WTW_PARAMS, dtype=np.float64,
                                                               transfer_dtype="float32", device="cpu"),
                           lambda: MultiStreamWTW([_WTW_REF] * 2, WTW_PARAMS, dtype=np.float64,
                                                  transfer_dtype="int16", device="cpu"), "transfer_dtype"),
    "multi_wtw_dtype": ("multi_wtw", lambda: MultiStreamWTW([_WTW_REF] * 2, WTW_PARAMS, transfer_dtype="float32",
                                                            device="cpu"),
                        lambda: MultiStreamWTW([_WTW_REF] * 2, WTW_PARAMS, dtype=np.float64,
                                               transfer_dtype="float32", device="cpu"), "dtype|different reference"),
    "async_wtw_window": ("async_wtw", lambda: AsyncWTW(_WTW_REF, WTW_PARAMS, device="cpu"),
                         lambda: AsyncWTW(_WTW_REF, _WIDE, device="cpu"), "dtw_win_size|shape"),
    "async_wtw_dtype": ("async_wtw", lambda: AsyncWTW(_WTW_REF, WTW_PARAMS, device="cpu"),
                        lambda: AsyncWTW(_WTW_REF, WTW_PARAMS, dtype=np.float64, device="cpu"), "dtype|reference"),
    "async_wtw_k_block": ("async_wtw", lambda: AsyncWTW(_WTW_REF, WTW_PARAMS, device="cpu"),
                          lambda: AsyncWTW(_WTW_REF, WTW_PARAMS, k_block=4, device="cpu"), "k_block"),
    "fused_wtw_window": ("fused_wtw", lambda: FusedWTW(_WTW_REF, WTW_PARAMS, device="cpu"),
                         lambda: FusedWTW(_WTW_REF, _WIDE, device="cpu"), "dtw_win_size|shape"),
    "fused_wtw_k_block": ("fused_wtw", lambda: FusedWTW(_WTW_REF, WTW_PARAMS, device="cpu"),
                          lambda: FusedWTW(_WTW_REF, WTW_PARAMS, k_block=4, device="cpu"), "k_block"),
    "fused_wtw_transfer": ("fused_wtw", lambda: FusedWTW(_WTW_REF, WTW_PARAMS, device="cpu"),
                           lambda: FusedWTW(_WTW_REF, WTW_PARAMS, transfer_dtype="chroma", device="cpu"),
                           "transfer"),
    "wtw_reference": ("wtw", lambda: port_wtw_module.WTW(_WTW_REF, WTW_PARAMS, device="cpu"),
                      lambda: port_wtw_module.WTW(_synthetic_performance(seconds=6.0, seed=4), WTW_PARAMS,
                                                  device="cpu"), "different reference"),
}


@pytest.mark.parametrize("name", list(REJECTIONS))
def test_mismatched_engine_is_rejected(name, tmp_path):
    kind, saved, target, match = REJECTIONS[name]
    path = _saved(tmp_path, "port", kind, saved())
    with pytest.raises(ValueError, match=match):
        getattr(tck, SAVE_LOAD[kind][1])(target(), path)


def test_jax_checkpoint_with_another_band_is_rejected(tmp_path):
    """A JAX checkpoint goes through the same checks: c 10 into c 8."""
    path = _saved(tmp_path, "jax", "online", _online(params={"c": 10, "max_run_count": 3}, pkg="jax"))
    with pytest.raises(ValueError, match="checkpoint c 10"):
        tck.load_state(_online(params=SMALL_BAND), path)


@pytest.mark.parametrize("kind", ["online", "fused_wtw"])
def test_field_of_another_shape_is_rejected(kind, tmp_path):
    eng = _online() if kind == "online" else FusedWTW(_WTW_REF, WTW_PARAMS, device="cpu")
    path = _saved(tmp_path, "port", kind, eng)
    data = dict(np.load(path))
    field = "live" if kind == "online" else "live_win"
    data[field] = data[field][:-1]
    np.savez(path, **data)
    with pytest.raises(ValueError, match=f"checkpoint field '{field}' has shape"):
        getattr(tck, SAVE_LOAD[kind][1])(eng, path)


# -- resets (tests/test_aux.py:294,325) -----------------------------------------


def test_load_state_resets_polling_and_stop(tmp_path):
    """Restoring clears pre-restore polling state and carries the sticky
    stop flag."""
    ref, live = _make_pair(np.random.default_rng(23), n_ref=30)
    done = tmodels.OnlineTimeWarping(ref, SMALL_BAND, device="cpu")
    r = None
    for i in range(4 * live.shape[1]):  # repeat columns until the reference runs out
        r = done.insert(live[:, i % live.shape[1]])
        if r == "stop":
            break
    assert r == "stop" and done._stopped_cached
    ckpt = str(tmp_path / "stopped.npz")
    tck.save_state(done, ckpt)

    used = tmodels.OnlineTimeWarping(ref, SMALL_BAND, device="cpu")
    used.poll_min_interval = 1e9  # keep dispatched statuses un-harvested
    for i in range(5):
        used.insert_nowait(live[:, i])
    assert used._outstanding or used._latest_done is not None
    tck.load_state(used, ckpt)
    assert used._outstanding == [] and used._latest_done is None
    assert used._stopped_cached and used.poll_min_interval == 1e9
    assert used.insert(live[:, 0]) == "stop"  # frozen, reference exhausted
    assert used.path == done.path


def test_load_state_restores_batch_mode(tmp_path):
    """``.path`` is an array after set_live and a list after streaming: it
    follows the mode the snapshot was taken in, and a tuned
    ``poll_min_interval`` survives the restore."""
    ref, live = _make_pair(np.random.default_rng(29), n_ref=24)
    batch = tmodels.OnlineTimeWarping(ref, SMALL_BAND, device="cpu")
    batch.set_live(live)
    ck_batch = str(tmp_path / "batch.npz")
    tck.save_state(batch, ck_batch)
    stream = tmodels.OnlineTimeWarping(ref, SMALL_BAND, device="cpu")
    for i in range(4):
        stream.insert(live[:, i])
    ck_stream = str(tmp_path / "stream.npz")
    tck.save_state(stream, ck_stream)

    target = tmodels.OnlineTimeWarping(ref, SMALL_BAND, device="cpu")
    for i in range(4):
        target.insert(live[:, i])
    target.poll_min_interval = 0.123
    tck.load_state(target, ck_batch)
    assert isinstance(target.path, np.ndarray)
    np.testing.assert_array_equal(target.path, batch.path)
    assert target.poll_min_interval == 0.123
    target2 = tmodels.OnlineTimeWarping(ref, SMALL_BAND, device="cpu")
    target2.set_live(live)
    tck.load_state(target2, ck_stream)
    assert isinstance(target2.path, list) and target2.path == stream.path


@pytest.mark.parametrize("long_ref", [False, True], ids=["standard", "long_ref"])
def test_fused_load_drops_queued_columns_and_keeps_the_stop(long_ref, tmp_path):
    """A fused engine's load drops feed()'s queued columns and in-flight
    status reads; a stopped snapshot restores stopped, and its later
    launches are refused."""
    ref, live = _make_pair(np.random.default_rng(41), n_ref=24)
    done = FusedStreamingEngine(ref, SMALL_BAND, k_block=4, long_ref=long_ref, device="cpu")
    looped = np.tile(live, 3)  # the live columns again and again, until the reference runs out
    for s in range(0, looped.shape[1], 4):
        done.insert_block_nowait(looped[:, s : s + 4])
    assert done.flush() == "stop"
    ckpt = str(tmp_path / "fused.npz")
    tck.save_fused_state(done, ckpt)

    busy = FusedStreamingEngine(ref, SMALL_BAND, k_block=4, long_ref=long_ref, device="cpu")
    busy.max_in_flight = 0  # saturated: feed() only queues
    busy.poll_min_interval = 1e9
    for i in range(3):
        busy.feed(live[:, i])
    assert busy._pending
    tck.load_fused_state(busy, ckpt)
    assert busy._pending == [] and busy._outstanding == [] and busy.poll_min_interval == 1e9
    assert busy._stopped_cached and busy.insert_block_nowait(live[:, :4]) == "stop"
    np.testing.assert_array_equal(busy.path_array, done.path_array)


def test_multi_stream_load_drops_queued_columns(tmp_path):
    fms = _fms()
    rng = np.random.default_rng(8)
    fms.feed(rng.random((2, 12)).astype(np.float32))
    fms.flush()
    ckpt = _saved(tmp_path, "port", "multi", fms)
    busy = _fms()
    busy.max_in_flight = 0
    for _ in range(3):
        busy.feed(rng.random((2, 12)).astype(np.float32))
    assert busy._pend_n.any()
    tck.load_multi_stream_state(busy, ckpt)
    assert not busy._pend_n.any() and busy._outstanding == [] and busy._latest_done is None
    assert [p.tolist() for p in busy.paths()] == [p.tolist() for p in fms.paths()]
