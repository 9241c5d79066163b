"""The port's ``mesh=`` (``parallel/mesh.py``, ``corpus_mesh``,
``sharded_chroma_frames``, and the sharded ``batched_set_live``,
``MultiStreamFollower`` and ``FusedMultiStreamFollower``) on a mesh of the
CPU eight times (and a 2 × 4 one), against the port's unsharded run and the
JAX package's run of the same case on its 8 virtual CPU devices
(tests/conftest.py), case by case the mesh tests of
tests/test_parallel.py:56,73,121,160,180,324,359,452, at their sizes.

Tolerance: none, but for the chromagram: paths, stop masks, pointers and
mean path lengths EQUAL; the sharded float64 chromagram to JAX's own
``rtol=1e-12, atol=1e-14`` against the port's unsharded one, and to
tests/test_torch_chroma.py's tolerances across the packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from real_time_audio_sync_tpu.features.chroma import chroma_frames as jax_chroma_frames  # noqa: E402
from real_time_audio_sync_tpu.parallel import corpus as jcorpus, serving as jserving  # noqa: E402
from real_time_audio_sync_tpu_torch.features.chroma import chroma_frames  # noqa: E402
from real_time_audio_sync_tpu_torch.parallel import (  # noqa: E402
    FusedMultiStreamFollower,
    MultiStreamFollower,
    batched_set_live,
    corpus_mesh,
    pad_pairs,
    sharded_chroma_frames,
)
from real_time_audio_sync_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from real_time_audio_sync_tpu_torch.parallel.serving import (  # noqa: E402
    batch_axis_sharding_put,
    require_batch_divisible,
)
from real_time_audio_sync_tpu_torch.utils import checkpoint  # noqa: E402

from tests.test_online import _make_pair  # noqa: E402

PARAMS = {"c": 10, "max_run_count": 3}


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _cpu_mesh(n=8):
    return corpus_mesh(n, device="cpu")


def _assert_paths(got, *wants):
    for want in wants:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


# -- the mesh itself -----------------------------------------------------------


def test_mesh_and_batch_axis_put():
    """JAX's attributes; shard i of a batch is rows [i·B/n, (i+1)·B/n) on
    ``devices.flat[i]`` over every axis of a 2-D mesh; repeated entries
    stand for virtual devices."""
    mesh = Mesh(np.asarray(["cpu"] * 8, dtype=object).reshape(2, 4), ("x", "y"))
    assert mesh.axis_names == ("x", "y") and mesh.shape == {"x": 2, "y": 4} and mesh.size == 8
    assert mesh.devices.shape == (2, 4) and all(d == torch.device("cpu") for d in mesh.devices.flat)
    x = np.arange(16 * 3).reshape(16, 3)
    parts = batch_axis_sharding_put(mesh)(x)
    assert len(parts) == 8
    for i, p in enumerate(parts):
        np.testing.assert_array_equal(p.numpy(), x[2 * i : 2 * i + 2])
    assert parts[0].data_ptr() != torch.from_numpy(x).data_ptr()  # each shard its own copy
    with pytest.raises(ValueError, match="divisible"):
        batch_axis_sharding_put(mesh)(x[:12])
    cm = _cpu_mesh(3)
    assert cm.axis_names == ("data",) and cm.shape == {"data": 3} and _cpu_mesh().size == 8
    assert corpus_mesh(device="cpu").size == 1


def test_mesh_rejects_mixed_device_types_and_absent_cards():
    """Every entry has one device type; a CUDA entry (or a default
    ``corpus_mesh``, which asks for the card) raises on a machine without
    one, and nothing falls back to the CPU."""
    import inspect

    with pytest.raises(ValueError, match="one device type"):
        Mesh(np.asarray(["cpu", "meta"], dtype=object), ("data",))
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.asarray(["cpu"] * 4, dtype=object).reshape(2, 2), ("data",))
    assert inspect.signature(corpus_mesh).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            corpus_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Mesh(np.asarray(["cuda"], dtype=object), ("data",))


def test_batch_that_does_not_divide_raises_jax_message():
    """tests/test_parallel.py:180: 3 streams on 8 devices; the message is
    JAX's, word for word, from every entry point."""
    rng = np.random.default_rng(12)
    refs = [_make_pair(rng, n_ref=30)[0] for _ in range(3)]
    with pytest.raises(ValueError, match="divisible") as jax_err:
        jserving.MultiStreamFollower(refs, PARAMS, mesh=jcorpus.corpus_mesh())
    with pytest.raises(ValueError) as port_err:
        MultiStreamFollower(refs, PARAMS, mesh=_cpu_mesh(), device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="divisible"):
        require_batch_divisible(Mesh(np.asarray(["cpu"] * 8, dtype=object).reshape(2, 4), ("x", "y")), 12)
    with pytest.raises(ValueError, match="divisible"):
        FusedMultiStreamFollower(refs[0], PARAMS, n_streams=3, mesh=_cpu_mesh(), device="cpu")
    r, l, rl, ll = pad_pairs(refs, refs)
    with pytest.raises(ValueError, match="divisible"):
        batched_set_live(r, l, rl, ll, PARAMS, mesh=_cpu_mesh(), device="cpu")


# -- batched_set_live ----------------------------------------------------------


def test_batched_sharded_over_mesh():
    """tests/test_parallel.py:56: float64 (the dense scan a shard) over 8
    entries == unsharded == JAX's sharded run; the mean too."""
    rng = np.random.default_rng(4)
    pairs = [_make_pair(rng, n_ref=40, stretch=1.25) for _ in range(8)]
    r, l, rl, ll = pad_pairs([p[0] for p in pairs], [p[1] for p in pairs])
    plain, plain_mean = batched_set_live(r, l, rl, ll, PARAMS, dtype=np.float64, device="cpu")
    sharded, mean = batched_set_live(r, l, rl, ll, PARAMS, mesh=_cpu_mesh(), dtype=np.float64, device="cpu")
    jax_paths, jax_mean = jcorpus.batched_set_live(r, l, rl, ll, PARAMS, mesh=jcorpus.corpus_mesh(), dtype=np.float64)
    _assert_paths(sharded, plain, jax_paths)
    assert mean.dtype == torch.float32 and mean.ndim == 0
    assert mean.item() == plain_mean.item() == np.float32(jax_mean)


def test_batched_set_live_banded_sharded_over_mesh():
    """tests/test_parallel.py:359: the banded route, one launch a shard
    (the set_live kernel's plain version here), on 8 and on 2 entries ==
    unsharded == JAX's kernel sharded over its 8 devices; the mean is
    JAX's, bit for bit."""
    rng = np.random.default_rng(12)
    pairs = [_make_pair(rng, n_ref=24, stretch=1.2) for _ in range(8)]
    r, l, rl, ll = pad_pairs([p[0] for p in pairs], [p[1] for p in pairs])
    params = {"c": 8, "max_run_count": 3}
    solo, solo_mean = batched_set_live(r, l, rl, ll, params, device="cpu")
    jax_paths, jax_mean = jcorpus.batched_set_live(r, l, rl, ll, params, mesh=jcorpus.corpus_mesh(), backend="banded")
    for n in (8, 2):
        sharded, mean = batched_set_live(r, l, rl, ll, params, mesh=_cpu_mesh(n), device="cpu")
        _assert_paths(sharded, solo, jax_paths)
        assert mean.item() == solo_mean.item() == np.float32(jax_mean) > 0


# -- sharded_chroma_frames -----------------------------------------------------


@pytest.mark.parametrize("np_dtype,atol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_sharded_chroma_matches_single_device(np_dtype, atol):
    """tests/test_parallel.py:73: the frames axis over 8 entries, the
    chromagram gathered onto the first, == ``chroma_frames`` on all of
    them (JAX's tolerance in float64) and JAX's sharded frontend (the
    cross-package tolerance of tests/test_torch_chroma.py)."""
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((16, 4096))
    sharded = sharded_chroma_frames(frames, _cpu_mesh(), dtype=np_dtype)
    single = chroma_frames(torch.from_numpy(frames.astype(np_dtype)))
    assert sharded.shape == (12, 16) and sharded.dtype == single.dtype
    if np_dtype == np.float64:
        np.testing.assert_allclose(sharded.numpy(), single.numpy(), rtol=1e-12, atol=1e-14)
    else:
        np.testing.assert_array_equal(sharded.numpy(), torch.cat([chroma_frames(
            torch.from_numpy(frames[i : i + 2].astype(np_dtype))) for i in range(0, 16, 2)], dim=1).numpy())
    jax_sharded = np.asarray(jcorpus.sharded_chroma_frames(frames, jcorpus.corpus_mesh(), dtype=np_dtype))
    np.testing.assert_allclose(sharded.numpy(), jax_sharded, rtol=0, atol=atol)
    np.testing.assert_allclose(single.numpy(), np.asarray(jax_chroma_frames(jnp.asarray(frames, np_dtype))),
                               rtol=0, atol=atol)


def test_sharded_chroma_raises_where_jax_raises():
    """JAX's ``P("data", None)`` put: a frame count that the data axis
    does not divide, and a mesh without a ``data`` axis, raise; a 2-D mesh
    with one shards over ``data`` and replicates over the other."""
    rng = np.random.default_rng(6)
    frames = rng.standard_normal((15, 4096))
    with pytest.raises(ValueError, match="divisible by 8"):
        jcorpus.sharded_chroma_frames(frames, jcorpus.corpus_mesh())
    with pytest.raises(ValueError, match="divisible"):
        sharded_chroma_frames(frames, _cpu_mesh())
    grid = Mesh(np.asarray(["cpu"] * 8, dtype=object).reshape(2, 4), ("x", "y"))
    with pytest.raises(ValueError, match="'data'"):
        sharded_chroma_frames(frames[:8], grid)
    two = Mesh(np.asarray(["cpu"] * 8, dtype=object).reshape(2, 4), ("data", "y"))
    got = sharded_chroma_frames(frames[:6], two, dtype=np.float64)
    want = jcorpus.sharded_chroma_frames(frames[:6], JaxMesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "y")),
                                         dtype=np.float64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


# -- MultiStreamFollower -------------------------------------------------------


def _pairs_feed(lives, b):
    for step in range(max(l.shape[1] for l in lives)):
        cols, active = np.zeros((b, 12)), np.zeros(b, bool)
        for k, live in enumerate(lives):
            if step < live.shape[1]:
                cols[k], active[k] = live[:, step], True
        yield cols, active


def test_multistream_sharded_over_mesh_matches_solo():
    """tests/test_parallel.py:121: 8 streams on 8 entries, one stream a
    shard, float64: paths, stop masks and pointers == unsharded == JAX's
    sharded follower."""
    rng = np.random.default_rng(11)
    pairs = [_make_pair(rng, n_ref=28 + 3 * i, stretch=1.1 + 0.05 * i) for i in range(8)]
    refs, lives = [p[0] for p in pairs], [p[1] for p in pairs]
    sharded = MultiStreamFollower(refs, PARAMS, dtype=np.float64, mesh=_cpu_mesh(), device="cpu")
    plain = MultiStreamFollower(refs, PARAMS, dtype=np.float64, device="cpu")
    jax_ms = jserving.MultiStreamFollower(refs, PARAMS, dtype=np.float64, mesh=jcorpus.corpus_mesh())
    assert len(sharded._shards) == 8 and all(sh.state.online.acc.shape[0] == 1 for sh in sharded._shards)
    for cols, active in _pairs_feed(lives, 8):
        got = sharded.insert(cols, active)
        np.testing.assert_array_equal(got, plain.insert(cols, active))
        np.testing.assert_array_equal(got, jax_ms.insert(cols, active))
    _assert_paths(sharded.paths(), plain.paths(), jax_ms.paths())
    for a, b, c in zip(sharded.pointers(), plain.pointers(), jax_ms.pointers()):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert sharded.states.acc.shape == plain.states.acc.shape  # the batch's padded shapes, gathered
    assert all(torch.equal(a, b) for a, b in zip(sharded.states, plain.states))
    assert torch.equal(sharded.refs, plain.refs)


def test_multistream_multi_axis_mesh_shards_fully():
    """tests/test_parallel.py:160: a 2 × 4 mesh splits the batch over all
    8 entries (one stream a shard, not 4× replication); pointers after 10
    steps equal JAX's on its 2 × 4 mesh and the unsharded run."""
    rng = np.random.default_rng(13)
    refs = [_make_pair(rng, n_ref=24)[0] for _ in range(8)]
    lives = [_make_pair(rng, n_ref=24)[1] for _ in range(8)]
    grid = Mesh(np.asarray(["cpu"] * 8, dtype=object).reshape(2, 4), ("x", "y"))
    ms = MultiStreamFollower(refs, PARAMS, mesh=grid, device="cpu")
    plain = MultiStreamFollower(refs, PARAMS, device="cpu")
    jax_ms = jserving.MultiStreamFollower(refs, PARAMS, mesh=JaxMesh(np.asarray(jax.devices()).reshape(2, 4),
                                                                     ("x", "y")))
    assert ms.mesh is grid and [sh.state.online.acc.shape[0] for sh in ms._shards] == [1] * 8
    for step in range(10):
        cols = np.stack([lv[:, step] for lv in lives])
        for f in (ms, plain, jax_ms):
            f.insert(cols)
    t_ptrs, j_ptrs = ms.pointers()
    assert (t_ptrs == 9).all()
    for got, want in ((ms.pointers(), plain.pointers()), (ms.pointers(), jax_ms.pointers())):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    _assert_paths(ms.paths(), plain.paths(), jax_ms.paths())


# -- FusedMultiStreamFollower --------------------------------------------------


def _fused_run(follower, live, b):
    for t in range(live.shape[1]):
        follower.feed(np.repeat(live[None, :, t], b, axis=0))
    follower.flush()
    return follower.paths()


def _jax_plain_run(refs, lives, mesh):
    """JAX's run of a fused-follower case through its plain reference of
    kernels #5/#6: the vmapped XLA insert step of its
    ``MultiStreamFollower``, sharded over ``mesh`` (its Pallas grid in
    interpret mode over 8 virtual devices takes minutes a case here)."""
    jax_ms = jserving.MultiStreamFollower(refs, PARAMS, mesh=mesh)
    for cols, active in _pairs_feed(lives, len(refs)):
        jax_ms.insert(cols, active)
    return jax_ms


@pytest.mark.parametrize("seed,long_ref", [(3, None), (23, True), (3, False)], ids=["default", "windowed", "whole"])
def test_fused_multistream_sharded_over_mesh_matches_solo(seed, long_ref):
    """tests/test_parallel.py:324 (the default layout) and :452 (the
    windowed one, named), and the whole-buffer layout: 8 streams on a
    shared reference over 8 entries, one K-insert launch a shard (the
    plain version here), the reference held once == unsharded == JAX's
    sharded run; stop masks and score positions too."""
    rng = np.random.default_rng(seed)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.1)
    kw = {"n_streams": 8, "k_block": 8, "long_ref": long_ref}
    sharded = FusedMultiStreamFollower(ref, PARAMS, mesh=_cpu_mesh(), device="cpu", **kw)
    plain = FusedMultiStreamFollower(ref, PARAMS, device="cpu", **kw)
    assert len(sharded._shards) == 8 and len({id(sh.state.ref) for sh in sharded._shards}) == 1  # held once
    got = _fused_run(sharded, live, 8)
    jax_ms = _jax_plain_run([ref] * 8, [live] * 8, jcorpus.corpus_mesh())
    _assert_paths(got, _fused_run(plain, live, 8), jax_ms.paths())
    assert sharded.dispatched_block_sizes == plain.dispatched_block_sizes
    np.testing.assert_array_equal(sharded.stopped, plain.stopped)
    np.testing.assert_array_equal(sharded.stopped, jax_ms.stopped)
    np.testing.assert_array_equal(sharded.last_points, plain.last_points)


def test_fused_multistream_mixed_refs_on_a_2d_mesh():
    """Mixed references (padded to the batch's longest in every shard,
    each stream stopping on its own length) on a 2 × 2 mesh with a ragged
    feed: == unsharded == JAX's run on its 2 × 2 mesh."""
    rng = np.random.default_rng(21)
    pairs = [_make_pair(rng, n_ref=32 + 8 * i, stretch=1.0 + 0.2 * i) for i in range(4)]
    refs, lives = [r for r, _ in pairs], [l for _, l in pairs]
    grid = Mesh(np.asarray(["cpu"] * 4, dtype=object).reshape(2, 2), ("x", "y"))
    sharded = FusedMultiStreamFollower(refs, PARAMS, k_block=8, mesh=grid, device="cpu")
    plain = FusedMultiStreamFollower(refs, PARAMS, k_block=8, device="cpu")
    assert all(sh.state.ref.shape[1] == plain._state.ref.shape[1] for sh in sharded._shards)
    for cols, act in _pairs_feed(lives, 4):
        for f in (sharded, plain):
            f.feed(cols.astype(np.float32), act)
    for f in (sharded, plain):
        f.flush()
    jax_ms = _jax_plain_run(refs, lives, JaxMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("x", "y")))
    _assert_paths(sharded.paths(), plain.paths(), jax_ms.paths())
    np.testing.assert_array_equal(sharded.stopped, plain.stopped)
    assert torch.equal(sharded._state.scalars, plain._state.scalars)  # gathered in stream order


@pytest.mark.parametrize("long_ref", [True, False], ids=["windowed", "whole"])
def test_checkpoint_reshards_across_meshes_and_into_jax(tmp_path, long_ref):
    """A file saved by a 4-shard follower loads into an unsharded one,
    whose file loads into a 2-shard one, whose file loads into the JAX
    package's follower (its kernel in interpret mode): each resumes to the
    uninterrupted path.  The 4-shard file equals the unsharded follower's
    file at the same point, key for key."""
    from real_time_audio_sync_tpu.utils import checkpoint as jcheckpoint

    rng = np.random.default_rng(24)
    ref, live = _make_pair(rng, n_ref=32, stretch=1.2)
    kw = {"n_streams": 4, "k_block": 8, "long_ref": long_ref}
    n = live.shape[1]
    t1, t2, t3 = n // 3, 2 * n // 3, n - 5

    def feed(f, lo, hi):
        for t in range(lo, hi):
            f.feed(np.repeat(live[None, :, t], 4, axis=0))

    def finish(f, lo):
        feed(f, lo, n)
        f.flush()
        return [np.asarray(p) for p in f.paths()]

    whole = FusedMultiStreamFollower(ref, PARAMS, device="cpu", **kw)
    feed(whole, 0, t1)
    checkpoint.save_multi_stream_state(whole, str(tmp_path / "plain.npz"))
    want = finish(whole, t1)

    four = FusedMultiStreamFollower(ref, PARAMS, mesh=_cpu_mesh(4), device="cpu", **kw)
    feed(four, 0, t1)
    checkpoint.save_multi_stream_state(four, str(tmp_path / "four.npz"))
    saved, plain_saved = np.load(tmp_path / "four.npz"), np.load(tmp_path / "plain.npz")
    assert sorted(saved.files) == sorted(plain_saved.files)
    for k in saved.files:
        np.testing.assert_array_equal(saved[k], plain_saved[k])
    _assert_paths(finish(four, t1), want)

    none = FusedMultiStreamFollower(ref, PARAMS, device="cpu", **kw)
    checkpoint.load_multi_stream_state(none, str(tmp_path / "four.npz"))
    feed(none, t1, t2)
    checkpoint.save_multi_stream_state(none, str(tmp_path / "none.npz"))
    _assert_paths(finish(none, t2), want)

    two = FusedMultiStreamFollower(ref, PARAMS, mesh=_cpu_mesh(2), device="cpu", **kw)
    checkpoint.load_multi_stream_state(two, str(tmp_path / "none.npz"))
    feed(two, t2, t3)
    checkpoint.save_multi_stream_state(two, str(tmp_path / "two.npz"))
    _assert_paths(finish(two, t3), want)

    jax_f = jserving.FusedMultiStreamFollower(ref, PARAMS, interpret=True, **kw)
    jcheckpoint.load_multi_stream_state(jax_f, str(tmp_path / "two.npz"))
    _assert_paths(finish(jax_f, t3), want)


@pytest.mark.parametrize("tiles,n_shards", [(2, 2), (4, 4)], ids=["two_tensors_2_shards", "one_tensor_4_shards"])
def test_checkpoint_of_repeated_reference_tensors_is_mesh_free(tmp_path, tiles, n_shards):
    """A list that holds one float32 tensor object for several streams (a
    shard then holds it as one row): the sharded file equals the unsharded
    follower's file key for key, its reference rows as the unsharded state
    holds them, and loads into an unsharded follower that resumes to the
    uninterrupted path."""
    rng = np.random.default_rng(25)
    pairs = [_make_pair(rng, n_ref=32 + 8 * i, stretch=1.1) for i in range(4 // tiles)]
    tensors = [torch.as_tensor(r, dtype=torch.float32) for r, _ in pairs]
    refs = [t for t in tensors for _ in range(tiles)]
    lives = [pairs[i // tiles][1] for i in range(4)]
    feed = list(_pairs_feed(lives, 4))
    half = len(feed) // 2

    def run(f, lo, hi):
        for cols, act in feed[lo:hi]:
            f.feed(cols.astype(np.float32), act)

    kw = {"k_block": 8, "device": "cpu"}
    plain = FusedMultiStreamFollower(refs, PARAMS, **kw)
    sharded = FusedMultiStreamFollower(refs, PARAMS, mesh=_cpu_mesh(n_shards), **kw)
    assert sharded._state.ref.shape[0] == plain._state.ref.shape[0] == (1 if tiles == 4 else 4)
    for f, name in ((plain, "plain"), (sharded, "sharded")):
        run(f, 0, half)
        checkpoint.save_multi_stream_state(f, str(tmp_path / f"{name}.npz"))
    saved, plain_saved = np.load(tmp_path / "sharded.npz"), np.load(tmp_path / "plain.npz")
    assert sorted(saved.files) == sorted(plain_saved.files)
    for k in saved.files:
        np.testing.assert_array_equal(saved[k], plain_saved[k])
    run(plain, half, len(feed))
    plain.flush()
    resumed = FusedMultiStreamFollower(refs, PARAMS, **kw)
    checkpoint.load_multi_stream_state(resumed, str(tmp_path / "sharded.npz"))
    run(resumed, half, len(feed))
    resumed.flush()
    _assert_paths(resumed.paths(), plain.paths())
