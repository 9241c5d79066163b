"""The port's WTW servers on a mesh (``FusedMultiStreamWTW(mesh=)``,
``MultiStreamWTW(mesh=)``) on the CPU eight times, against the port's
unsharded runs and the JAX package's servers sharded over its 8 virtual CPU
devices (tests/conftest.py): the cases of tests/test_pallas_wtw.py:181 and
tests/test_wtw_serving.py:53,84, the latter two on numpy-seeded audio in
place of the absent Chopin wavs.

Tolerance: none.  Each port run on its own device frontend equals the
unsharded run and solo engines fed the same chunks (every stream's frames
in the solo engines' tiles); against JAX both packages read the copied host
frontend's columns (``transfer_dtype="chroma"``) and the JAX reference
chroma (``ref_chromas``): paths, pointers and stop masks EQUAL."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from real_time_audio_sync_tpu.features.chroma import chroma_from_samples as jax_chroma  # noqa: E402
from real_time_audio_sync_tpu.parallel import corpus as jcorpus, wtw_serving as jwtw  # noqa: E402
from real_time_audio_sync_tpu_torch.models import AsyncWTW, FusedWTW  # noqa: E402
from real_time_audio_sync_tpu_torch.parallel import FusedMultiStreamWTW, MultiStreamWTW, corpus_mesh  # noqa: E402
from real_time_audio_sync_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from real_time_audio_sync_tpu_torch.utils import checkpoint  # noqa: E402

from tests.test_pallas_wtw import WP, _aligned_chunks, _run, _synth  # noqa: E402

P3 = {"fft_len": 4096, "hop_size": 2048, "dtw_win_size": 4096 * 3, "dtw_hop_size": 2048 * 3}
P10 = {"fft_len": 4096, "hop_size": 2048, "dtw_win_size": 4096 * 10, "dtw_hop_size": 2048 * 10}


def _cpu_mesh(n=8):
    return corpus_mesh(n, device="cpu")


def _feed(ms, feeds):
    """Insert chunk t of every stream in turn (``None`` past a stream's end), then flush."""
    for t in range(max(len(f) for f in feeds)):
        ms.insert([f[t] if t < len(f) else None for f in feeds])
    ms.flush()
    return ms


def _jax_pointers(ms):
    return [tuple(int(v) for v in p) for p in ms.pointers()]


def test_fused_multi_wtw_on_mesh():
    """tests/test_pallas_wtw.py:181: 8 streams on one reference over 8
    entries, one kernel launch a shard (the plain version here), the
    reference held once: every path == the unsharded run's == a solo
    ``FusedWTW``'s; on the shared host features == JAX's engine sharded
    over its 8 devices."""
    ref, live = _synth(seed=8, ref_s=16, live_s=8)
    chunks = _aligned_chunks(live)
    solo = _run(FusedWTW(ref, WP, k_block=8, transfer_dtype="float32", device="cpu"), chunks)
    kw = {"k_block": 8, "transfer_dtype": "float32"}
    sharded = _feed(FusedMultiStreamWTW([ref] * 8, WP, mesh=_cpu_mesh(), device="cpu", **kw), [chunks] * 8)
    plain = _feed(FusedMultiStreamWTW([ref] * 8, WP, device="cpu", **kw), [chunks] * 8)
    assert len({id(sh.state.ref) for sh in sharded._shards}) == 1 and sharded._state.ref.shape[0] == 1
    assert len(solo.path) > 50
    assert sharded.paths() == plain.paths() == [solo.path] * 8
    assert sharded.pointers() == plain.pointers() == [solo.pointers] * 8

    chroma = np.asarray(jax_chroma(ref))
    kw = {"k_block": 8, "transfer_dtype": "chroma", "ref_chromas": [chroma]}
    port = _feed(FusedMultiStreamWTW([ref] * 8, WP, mesh=_cpu_mesh(), device="cpu", **kw), [chunks] * 8)
    mesh = JaxMesh(np.asarray(jax.devices()[:8]).reshape(8), ("s",))
    jax_ms = _feed(jwtw.FusedMultiStreamWTW([ref] * 8, WP, interpret=True, mesh=mesh, **kw), [chunks] * 8)
    assert port.paths() == jax_ms.paths() and len(port.paths()[0]) > 50
    assert port.pointers() == _jax_pointers(jax_ms)
    assert list(port.stopped) == list(jax_ms.stopped)


def test_fused_multi_wtw_mixed_refs_on_a_2d_mesh():
    """Mixed references padded to the batch's longest in every shard, on a
    2 × 2 mesh with ragged feeds: == the unsharded run, stream for
    stream."""
    ref_a, live_a = _synth(seed=0, ref_s=12, live_s=8)
    ref_b, live_b = _synth(seed=5, ref_s=9, live_s=6)
    refs = [ref_a, ref_b, ref_b, ref_a]
    feeds = [_aligned_chunks(live_a), np.array_split(live_b, 13), _aligned_chunks(live_b),
             np.array_split(live_a[: 22050 * 5], 7)]
    grid = Mesh(np.asarray(["cpu"] * 4, dtype=object).reshape(2, 2), ("x", "y"))
    kw = {"k_block": 8, "transfer_dtype": "float32"}
    sharded = _feed(FusedMultiStreamWTW(refs, WP, mesh=grid, device="cpu", **kw), feeds)
    plain = _feed(FusedMultiStreamWTW(refs, WP, device="cpu", **kw), feeds)
    assert sharded.mesh is grid and all(len(p) > 10 for p in plain.paths())
    assert sharded.paths() == plain.paths()
    assert sharded.pointers() == plain.pointers()
    assert torch.equal(sharded._state.live, plain._state.live)  # the batch's rows, gathered in order


def _two_refs():
    """Two references of different lengths and a live take of each (noise
    audio: no tie decides a window)."""
    rng = np.random.default_rng(31)
    refs = [(0.2 * rng.standard_normal(int(22050 * s))).astype(np.float64) for s in (9, 7)]
    lives = [(r + 0.02 * rng.standard_normal(len(r)))[: int(len(r) * 0.7)] for r in refs]
    return refs, lives


def test_multistream_wtw_sharded_over_mesh():
    """tests/test_wtw_serving.py:53: 8 streams on two references
    alternating, float64, over 8 entries: every path == an unsharded
    single-stream engine's on its reference; on the shared host features
    == JAX's engine sharded over its 8 devices."""
    (ref_a, ref_b), (live, _) = _two_refs()
    refs = [ref_a, ref_b] * 4
    chunks = np.array_split(live, 32)
    kw = {"k_block": 8, "dtype": np.float64, "transfer_dtype": "float32"}
    ms = _feed(MultiStreamWTW(refs, P10, mesh=_cpu_mesh(), device="cpu", **kw), [chunks] * 8)
    assert not ms._shared_ref and ms._stepper.ref.shape[0] == 2
    assert len({id(sh.state.ref) for sh in ms._shards}) == 1  # the references once a device
    want = {id(r): _feed(MultiStreamWTW([r], P10, device="cpu", **kw), [chunks]).paths()[0] for r in (ref_a, ref_b)}
    assert all(len(p) > 30 for p in want.values())
    assert ms.paths() == [want[id(r)] for r in refs]

    chromas = [np.asarray(jax_chroma(r, dtype=np.float64)) for r in refs]
    kw = {"k_block": 8, "dtype": np.float64, "transfer_dtype": "chroma", "ref_chromas": chromas}
    port = _feed(MultiStreamWTW(refs, P10, mesh=_cpu_mesh(), device="cpu", **kw), [chunks] * 8)
    plain = _feed(MultiStreamWTW(refs, P10, device="cpu", **kw), [chunks] * 8)
    jax_ms = _feed(jwtw.MultiStreamWTW(refs, P10, mesh=jcorpus.corpus_mesh(), **kw), [chunks] * 8)
    assert port.paths() == plain.paths() == jax_ms.paths()
    assert port.pointers() == plain.pointers() == _jax_pointers(jax_ms)
    assert list(port.stopped) == list(jax_ms.stopped)


def test_multistream_wtw_validation():
    """tests/test_wtw_serving.py:84: 3 streams on 8 entries raise JAX's
    "divisible" message, word for word; a wrong buffer count raises."""
    (ref_a, _), _ = _two_refs()
    with pytest.raises(ValueError, match="divisible") as jax_err:
        jwtw.MultiStreamWTW([ref_a] * 3, P10, mesh=jcorpus.corpus_mesh())
    with pytest.raises(ValueError) as port_err:
        MultiStreamWTW([ref_a] * 3, P10, mesh=_cpu_mesh(), device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="divisible"):
        FusedMultiStreamWTW([ref_a] * 3, WP, mesh=_cpu_mesh(), device="cpu")
    ms = MultiStreamWTW([ref_a], P10, dtype=np.float64, mesh=_cpu_mesh(1), device="cpu")
    with pytest.raises(ValueError, match="expected 1 buffers"):
        ms.insert([np.zeros(100), np.zeros(100)])


def test_multistream_wtw_checkpoint_reshards(tmp_path):
    """``save_multi_wtw_state``/``load_multi_wtw_state`` across meshes: a
    4-shard engine's file (equal, key for key, to the unsharded engine's
    at the same point) loads into an unsharded engine, whose file loads
    into a 2-shard one, whose file loads into the JAX package's engine
    (shared features): each resumes to the uninterrupted paths."""
    refs, lives = _two_refs()
    refs, lives = refs * 2, lives * 2
    chromas = [np.asarray(jax_chroma(r, dtype=np.float64)) for r in refs]
    kw = {"k_block": 4, "dtype": np.float64, "transfer_dtype": "chroma", "ref_chromas": chromas}
    feeds = [np.array_split(lv, 12 + 3 * i) for i, lv in enumerate(lives)]
    n = max(len(f) for f in feeds)
    t1, t2, t3 = n // 3, 2 * n // 3, n - 2

    def feed(ms, lo, hi):
        for t in range(lo, hi):
            ms.insert([f[t] if t < len(f) else None for f in feeds])

    def finish(ms, lo):
        feed(ms, lo, n)
        ms.flush()
        return ms.paths(), [tuple(int(v) for v in p) for p in ms.pointers()]

    def port(mesh=None):
        return MultiStreamWTW(refs, P3, mesh=mesh, device="cpu", **kw)

    whole = port()
    feed(whole, 0, t1)
    checkpoint.save_multi_wtw_state(whole, str(tmp_path / "plain.npz"))
    want = finish(whole, t1)
    assert all(len(p) > 10 for p in want[0])

    four = port(_cpu_mesh(4))
    feed(four, 0, t1)
    checkpoint.save_multi_wtw_state(four, str(tmp_path / "four.npz"))
    saved, plain_saved = np.load(tmp_path / "four.npz"), np.load(tmp_path / "plain.npz")
    assert sorted(saved.files) == sorted(plain_saved.files)
    for k in saved.files:
        np.testing.assert_array_equal(saved[k], plain_saved[k])
    assert finish(four, t1) == want

    none = port()
    checkpoint.load_multi_wtw_state(none, str(tmp_path / "four.npz"))
    feed(none, t1, t2)
    checkpoint.save_multi_wtw_state(none, str(tmp_path / "none.npz"))
    assert finish(none, t2) == want

    two = port(_cpu_mesh(2))
    checkpoint.load_multi_wtw_state(two, str(tmp_path / "none.npz"))
    feed(two, t2, t3)
    checkpoint.save_multi_wtw_state(two, str(tmp_path / "two.npz"))
    assert finish(two, t3) == want

    from real_time_audio_sync_tpu.utils import checkpoint as jcheckpoint

    jax_ms = jwtw.MultiStreamWTW(refs, P3, **kw)
    jcheckpoint.load_multi_wtw_state(jax_ms, str(tmp_path / "two.npz"))
    assert finish(jax_ms, t3) == want


def test_async_engine_on_a_one_entry_mesh_equals_solo():
    """``corpus_mesh(1)``: one shard of every stream is the unsharded
    engine; a stream equals a solo ``AsyncWTW`` fed the same chunks."""
    (ref_a, _), (live, _) = _two_refs()
    chunks = np.array_split(live, 9)
    ms = _feed(MultiStreamWTW([ref_a], P3, k_block=8, dtype=np.float64, transfer_dtype="float32",
                              mesh=_cpu_mesh(1), device="cpu"), [chunks])
    solo = AsyncWTW(ref_a, P3, k_block=8, dtype=np.float64, device="cpu")
    for c in chunks:
        solo.insert(c)
    solo.flush()
    assert ms.paths() == [solo.path] and ms.pointers() == [solo.pointers]
