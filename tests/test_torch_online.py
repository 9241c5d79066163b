"""The port's online engines on tensors (``models/online_core.py``,
``otw.py``, ``livenote.py``, ``livenote_v2.py``) against the JAX
package's engines and the naive oracle (``tests/oracle.py``), on the CPU.

Inputs come from the JAX tests' tie-free generator (``_make_pair``:
a tempo-warped rendition of a random reference with feature noise, so no
two DP cells tie).  Tolerances:

- float64: paths, ``live_ptr``, ``ref_ptr`` and every insert's "stop"
  verdict equal the JAX engine's and the oracle's, with and without
  ``exact_chain``; ``acc_cost`` is within rtol/atol 1e-12 of theirs on
  computed cells (the two packages sum a cell's cost in different orders)
  and holds the sentinel exactly where they do;
- float32: the port's path equals the fused K-insert engine's plain
  version (``FusedStreamingEngine`` on the CPU) at tolerance 0, since the
  two share their cost and chain arithmetic.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from real_time_audio_sync_tpu.models import LiveNote as JLiveNote  # noqa: E402
from real_time_audio_sync_tpu.models import LiveNoteV2 as JLiveNoteV2  # noqa: E402
from real_time_audio_sync_tpu.models import OnlineTimeWarping as JOTW  # noqa: E402
from real_time_audio_sync_tpu.models import online_core as jcore  # noqa: E402
from real_time_audio_sync_tpu_torch import LiveNote, LiveNoteV2, OnlineTimeWarping  # noqa: E402
from real_time_audio_sync_tpu_torch.models import online_core as tcore  # noqa: E402
from real_time_audio_sync_tpu_torch.models.fused_streaming import FusedStreamingEngine  # noqa: E402
from real_time_audio_sync_tpu_torch.utils import convert  # noqa: E402
from tests.oracle import OracleOTW  # noqa: E402
from tests.test_online import _make_pair, _unit_cols  # noqa: E402

ENGINES = [
    ("otw", JOTW, OnlineTimeWarping, {"c": 10, "max_run_count": 3}),
    ("livenote", JLiveNote, LiveNote, {"search_band_width": 10, "max_run_count": 3}),
    ("livenote_v2", JLiveNoteV2, LiveNoteV2, {"search_band_width": 10, "max_run_count": 3}),
]
IDS = [e[0] for e in ENGINES]
SENTINEL = {"otw": 1e10, "livenote": np.inf, "livenote_v2": np.inf}


def _port(cls, ref, params, **kw):
    return cls(ref, params, device="cpu", **kw)


def _stream(engine, live):
    """Insert frame by frame until "stop"; the verdicts, in order."""
    out = []
    for i in range(live.shape[1]):
        out.append(engine.insert(live[:, i]))
        if out[-1] == "stop":
            break
    return out


def _acc_close(got, want, sentinel):
    """Computed cells within 1e-12; sentinel cells exactly where want's."""
    np.testing.assert_array_equal(got == sentinel, want == sentinel)
    computed = want != sentinel
    np.testing.assert_allclose(got[computed], want[computed], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name,jcls,tcls,params", ENGINES, ids=IDS)
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("exact", [True, False])
def test_insert_matches_jax_and_oracle(name, jcls, tcls, params, seed, exact):
    ref, live = _make_pair(np.random.default_rng(seed))
    port = _port(tcls, ref, params, dtype=np.float64, exact_chain=exact)
    jax_eng = jcls(ref, params, dtype=np.float64, exact_chain=exact)
    oracle = OracleOTW(ref, 10, 3, variant=name)
    verdicts = _stream(port, live)
    assert verdicts == _stream(jax_eng, live) == _stream(oracle, live)
    assert port.path == [tuple(p) for p in jax_eng.path] == [tuple(p) for p in oracle.path]
    assert (port.live_ptr, port.ref_ptr) == (jax_eng.live_ptr, jax_eng.ref_ptr) == (oracle.t, oracle.j)
    _acc_close(port.acc_cost, np.asarray(jax_eng.acc_cost), SENTINEL[name])


@pytest.mark.parametrize("name,jcls,tcls,params", ENGINES, ids=IDS)
def test_acc_matches_oracle(name, jcls, tcls, params):
    ref, live = _make_pair(np.random.default_rng(42), n_ref=40)
    port = _port(tcls, ref, params, dtype=np.float64, exact_chain=True)
    oracle = OracleOTW(ref, 10, 3, variant=name)
    for i in range(live.shape[1]):
        stop = port.insert(live[:, i])
        oracle.insert(live[:, i])
        if stop == "stop":
            break
    _acc_close(port.acc_cost, oracle.acc, SENTINEL[name])


@pytest.mark.parametrize("name,jcls,tcls,params", ENGINES, ids=IDS)
@pytest.mark.parametrize("seed", [3, 4])
def test_set_live_matches_jax_and_oracle(name, jcls, tcls, params, seed):
    ref, live = _make_pair(np.random.default_rng(seed))
    port = _port(tcls, ref, params, dtype=np.float64)
    jax_eng = jcls(ref, params, dtype=np.float64)
    out = port.set_live(live)
    jax_eng.set_live(live)
    want = OracleOTW(ref, 10, 3, variant=name).set_live(live)
    np.testing.assert_array_equal(port.path_array, np.asarray(want))
    np.testing.assert_array_equal(port.path_array, jax_eng.path_array)
    assert (port.live_ptr, port.ref_ptr) == (jax_eng.live_ptr, jax_eng.ref_ptr)
    if name == "otw":  # set_live returns None and the path is an array (otw_eran.py:142)
        assert out is None and isinstance(port.path, np.ndarray)
    else:
        assert out == port.path


@pytest.mark.parametrize("name,jcls,tcls,params", ENGINES, ids=IDS)
def test_set_live_after_inserts(name, jcls, tcls, params):
    """OnlineTimeWarping resets pointers, direction and path but keeps the
    cost matrix (otw_eran.py:92-97); LiveNote and V2 continue from the
    current frontier (livenote.py:102-108)."""
    ref, live = _make_pair(np.random.default_rng(17))
    port = _port(tcls, ref, params, dtype=np.float64, exact_chain=True)
    jax_eng = jcls(ref, params, dtype=np.float64, exact_chain=True)
    oracle = OracleOTW(ref, 10, 3, variant=name)
    for i in range(12):
        for e in (port, jax_eng, oracle):
            e.insert(live[:, i])
    port.set_live(live)
    jax_eng.set_live(live)
    want = np.asarray(oracle.set_live(live))
    np.testing.assert_array_equal(port.path_array, want)
    np.testing.assert_array_equal(port.path_array, jax_eng.path_array)
    assert (port.live_ptr, port.ref_ptr) == (oracle.t, oracle.j)


@pytest.mark.parametrize("c,mrc", [(3, 3), (10, 1), (25, 5), (10, 2)])
def test_config_sweep_matches_oracle(c, mrc):
    """Band widths and slope constraints at their edges: c = 3 (heavily
    clamped bands), max_run_count = 1 (the direction alternates)."""
    ref, live = _make_pair(np.random.default_rng(100 + c + mrc), n_ref=40)
    port = OnlineTimeWarping(ref, {"c": c, "max_run_count": mrc}, dtype=np.float64, device="cpu")
    oracle = OracleOTW(ref, c, mrc, variant="otw")
    assert _stream(port, live) == _stream(oracle, live)
    assert port.path == [tuple(p) for p in oracle.path]


def test_v2_euclidean_matches_jax_and_oracle():
    ref, live = _make_pair(np.random.default_rng(11))
    ref_d, live_d = np.clip(np.diff(ref, axis=1), 0, np.inf), np.clip(np.diff(live, axis=1), 0, np.inf)
    params = {"search_band_width": 10, "max_run_count": 3}
    port = LiveNoteV2(ref_d, params, chroma_diff=True, dtype=np.float64, device="cpu")
    jax_eng = JLiveNoteV2(ref_d, params, chroma_diff=True, dtype=np.float64)
    oracle = OracleOTW(ref_d, 10, 3, variant="livenote_v2", euclidean=True)
    assert _stream(port, live_d) == _stream(jax_eng, live_d) == _stream(oracle, live_d)
    assert port.path == [tuple(p) for p in oracle.path] == [tuple(p) for p in jax_eng.path]
    assert port.chroma_diff and port.cfg.euclidean


@pytest.mark.parametrize("block", [1, 7, 32])
def test_insert_block_equals_sequential_inserts(block):
    ref, live = _make_pair(np.random.default_rng(21))
    seq = OnlineTimeWarping(ref, {"c": 10, "max_run_count": 3}, dtype=np.float64, device="cpu")
    blk = OnlineTimeWarping(ref, {"c": 10, "max_run_count": 3}, dtype=np.float64, device="cpu")
    _stream(seq, live)
    for s in range(0, live.shape[1], block):
        if blk.insert_block(live[:, s : s + block]) == "stop":
            break
    assert blk.path == seq.path  # a block may overshoot past the stop: the extra inserts freeze
    assert torch.equal(blk.state.acc, seq.state.acc)


@pytest.mark.parametrize("name,jcls,tcls,params", ENGINES, ids=IDS)
def test_pipelined_inserts_match_sync(name, jcls, tcls, params):
    """insert_nowait + poll/flush commits the synchronous path; "stop"
    surfaces by flush at the latest, and later inserts freeze."""
    rng = np.random.default_rng(23)
    ref, live = _make_pair(rng, n_ref=30, stretch=1.0)
    live = np.concatenate([live, _unit_cols(rng.random((12, 25)) + 0.05)], axis=1)
    sync = _port(tcls, ref, params, dtype=np.float64)
    _stream(sync, live)
    pipe = _port(tcls, ref, params, dtype=np.float64)
    for i in range(live.shape[1]):
        pipe.insert_nowait(live[:, i])
        pipe.poll()
    assert pipe.flush() == "stop"
    assert pipe.insert_nowait(live[:, 0]) == "stop"  # the cached verdict
    assert pipe.path == sync.path
    plen, x, y = pipe.last_point  # the path's tail, without reading the path
    assert plen == len(pipe.path) and (x, y) == pipe.path[-1]
    blocks = _port(tcls, ref, params, dtype=np.float64)
    for s in range(0, live.shape[1], 5):
        blocks.insert_block_nowait(live[:, s : s + 5])
    assert blocks.flush() == "stop" and blocks.path == sync.path


def test_stop_is_sticky_and_graceful():
    rng = np.random.default_rng(5)
    ref, live = _make_pair(rng, n_ref=30, stretch=1.0)
    live = np.concatenate([live, _unit_cols(rng.random((12, 25)) + 0.05)], axis=1)
    engine = OnlineTimeWarping(ref, {"c": 10, "max_run_count": 3}, dtype=np.float64, device="cpu")
    assert _stream(engine, live)[-1] == "stop"
    path, acc = engine.path, engine.acc_cost.copy()
    for i in range(3):  # further inserts are no-ops returning "stop" (the reference would crash)
        assert engine.insert(live[:, i]) == "stop"
    assert engine.path == path and np.array_equal(engine.acc_cost, acc)


def test_first_insert_only_evaluates_origin():
    rng = np.random.default_rng(6)
    ref, _ = _make_pair(rng, n_ref=30)
    engine = LiveNote(ref, {"search_band_width": 10, "max_run_count": 3}, dtype=np.float64, device="cpu")
    assert engine.insert(_unit_cols(rng.random((12, 1)))[:, 0]) is None
    acc = engine.acc_cost
    assert np.isfinite(acc[0, 0]) and np.isinf(acc).sum() == acc.size - 1
    assert engine.path == []


def test_guards_raise():
    """A band wider than the reference, and an hour-scale reference whose
    dense accumulator could exist on no card (8 GB), raise as in JAX."""
    ref = _unit_cols(np.random.default_rng(6).random((12, 5)))
    with pytest.raises(ValueError, match="shorter than search band"):
        OnlineTimeWarping(ref, {"c": 10, "max_run_count": 3}, device="cpu")
    with pytest.raises(ValueError, match="FusedStreamingEngine"):
        tcore.init_state(torch.zeros((1, 12, 40_000)), tcore.OnlineConfig(50, 3, **tcore.ENGINE_OVERRIDES["otw"]),
                         torch.float32)


FUSED_VARIANTS = ["otw", "livenote", "livenote_v2", "livenote_v2_diff"]


@pytest.mark.parametrize("variant", FUSED_VARIANTS)
@pytest.mark.parametrize("c", [10, 50])
def test_non_fused_path_equals_fused_plain_version(variant, c):
    """float32: the tensor engine's path equals the fused K-insert engine's
    plain version on the CPU at tolerance 0 (the two share the cost and
    chain arithmetic, ``ops/band.py``)."""
    rng = np.random.default_rng(c)
    ref, live = _make_pair(rng, n_ref=120, stretch=1.2)
    if variant == "livenote_v2_diff":
        ref, live = np.clip(np.diff(ref, axis=1), 0, None), np.clip(np.diff(live, axis=1), 0, None)
    over = tcore.ENGINE_OVERRIDES[variant]
    fused = FusedStreamingEngine(ref.astype(np.float32), {"c": c, "max_run_count": 3}, over, k_block=8, device="cpu")
    fused.insert_block_nowait(live.astype(np.float32))
    fused.flush()
    engine = tcore.BandedOnlineEngine(ref, {"c": c, "max_run_count": 3}, dict(over), device="cpu")
    for i in range(live.shape[1]):
        engine.insert_nowait(live[:, i])
    engine.flush()
    assert len(engine.path_array) > 50
    np.testing.assert_array_equal(engine.path_array, fused.path_array)


@pytest.mark.parametrize("name,jcls,tcls,params", ENGINES, ids=IDS)
def test_state_carried_across_packages_continues_the_path(name, jcls, tcls, params):
    """A JAX engine's state carried into the port (``online_state_from_jax``)
    continues to the JAX engine's path, and the port's carried back
    (``online_state_to_jax``) continues to the port's."""
    ref, live = _make_pair(np.random.default_rng(31))
    jax_eng = jcls(ref, params, dtype=np.float64)
    for i in range(20):
        jax_eng.insert(live[:, i])
    port = _port(tcls, ref, params, dtype=np.float64)
    port.state = convert.online_state_from_jax(jax_eng.state)
    assert [x.shape[0] for x in port.state] == [1] * 14
    for i in range(20, 45):
        assert port.insert(live[:, i]) == jax_eng.insert(live[:, i])
    assert port.path == [tuple(p) for p in jax_eng.path]

    back = jcls(ref, params, dtype=np.float64)
    arrays = convert.online_state_to_jax(port.state)
    for a, want in zip(arrays, jax_eng.state):
        assert a.shape == np.shape(want) and a.dtype == np.asarray(want).dtype
    back.state = jcore.OnlineState(*(jnp.asarray(a) for a in arrays))
    _stream(port, live[:, 45:])
    _stream(back, live[:, 45:])
    assert [tuple(p) for p in back.path] == port.path


def test_entry_points_take_the_jax_signatures():
    """The engines' parameters are the JAX engines', in order, with a
    keyword-only ``device`` defaulting to the card."""
    import inspect

    for _, jcls, tcls, _ in ENGINES:
        jax_params = list(inspect.signature(jcls).parameters)
        port_params = inspect.signature(tcls).parameters
        assert list(port_params)[: len(jax_params)] == jax_params
        assert port_params["device"].kind is inspect.Parameter.KEYWORD_ONLY
        assert port_params["device"].default == "cuda"
