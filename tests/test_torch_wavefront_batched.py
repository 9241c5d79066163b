"""The wavefront DP and backtrack over a leading batch axis
(``ops/wavefront.py``; on the CPU their plain PyTorch versions): a (B, M, N)
batch against B solo calls and against the JAX package's ``wavefront_dp``
and ``backtrack`` vmapped over the batch, on the same numpy costs.

Tolerance: zero.  A batch does each cell's multiply, add and strict
compare exactly as a solo call does, so ``acc``, ``back``, ``points`` and
``length`` are equal: in float64, and in float32 on tie-free (uniform
random) costs and on an all-ones tie case."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from real_time_audio_sync_tpu.ops import wavefront as jwf  # noqa: E402
from real_time_audio_sync_tpu_torch.ops import wavefront as twf  # noqa: E402

SPECS = {"dtw": (jwf.DTW_SPEC, twf.DTW_SPEC), "wtw": (jwf.WTW_SPEC, twf.WTW_SPEC)}
# (B, M, N): one window; the live app's windows at a serving batch (cut to
# 4); strip and chunk edges (64 rows, 32 columns); thin matrices
BATCHES = [(1, 20, 20), (4, 100, 100), (3, 65, 33), (5, 1, 7), (2, 7, 1), (3, 64, 65)]


def _costs(shape, dtype, ties: bool = False):
    if ties:
        return np.ones(shape, dtype)
    return np.random.default_rng(sum(shape)).random(shape).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("shape", BATCHES, ids=[f"{b}x{m}x{n}" for b, m, n in BATCHES])
def test_batch_equals_solo_calls_and_jax_vmapped(shape, spec, dtype):
    jspec, tspec = SPECS[spec]
    cost = _costs(shape, dtype)
    acc, back = twf.wavefront_dp(torch.from_numpy(cost), tspec)
    assert acc.shape == shape and back.shape == shape and back.dtype == torch.int8
    pts, length = twf.backtrack(back, tspec)
    assert pts.shape == (shape[0], shape[1] + shape[2] - 1, 2) and length.shape == (shape[0],)
    assert pts.dtype == length.dtype == torch.int32
    for i in range(shape[0]):
        a1, b1 = twf.wavefront_dp(torch.from_numpy(cost[i]), tspec)
        p1, l1 = twf.backtrack(b1, tspec)
        assert torch.equal(acc[i], a1) and torch.equal(back[i], b1)
        assert torch.equal(pts[i], p1) and int(length[i]) == int(l1)
    acc_j, back_j = jax.vmap(lambda c: jwf.wavefront_dp(c, jspec))(jnp.asarray(cost))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))
    np.testing.assert_array_equal(back.numpy(), np.asarray(back_j))
    pts_j, len_j = jax.vmap(lambda b: jwf.backtrack(b, jspec))(back_j)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(pts_j))  # frozen repeats included
    np.testing.assert_array_equal(length.numpy(), np.asarray(len_j))


@pytest.mark.parametrize("spec", list(SPECS))
def test_batch_of_tied_and_infinite_costs(spec):
    """All-ones costs (every cell a tie: the first candidate wins) beside a
    cost with infinite cells, in one batch: each matrix as if alone, and
    JAX's."""
    jspec, tspec = SPECS[spec]
    cost = np.concatenate([_costs((1, 12, 9), np.float32, ties=True), _costs((1, 12, 9), np.float32)])
    cost[1, 3:5, 2:7] = np.inf
    acc, back = twf.wavefront_dp(torch.from_numpy(cost), tspec)
    pts, length = twf.backtrack(back, tspec)
    acc_j, back_j = jax.vmap(lambda c: jwf.wavefront_dp(c, jspec))(jnp.asarray(cost))
    pts_j, len_j = jax.vmap(lambda b: jwf.backtrack(b, jspec))(back_j)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))
    np.testing.assert_array_equal(back.numpy(), np.asarray(back_j))
    np.testing.assert_array_equal(pts.numpy(), np.asarray(pts_j))
    np.testing.assert_array_equal(length.numpy(), np.asarray(len_j))
    for i in range(2):
        p1, l1 = twf.backtrack_reference(back[i], tspec)
        assert torch.equal(pts[i], p1) and int(length[i]) == int(l1)


def test_cpu_batches_run_the_plain_versions_and_count_nothing():
    """On a CPU tensor a batch runs the plain versions; no launch is
    counted in either counter."""
    twf.dp_launches = twf.backtrack_launches = twf.dp_batched_launches = twf.backtrack_batched_launches = 0
    cost = torch.from_numpy(_costs((3, 9, 11), np.float64))
    acc, back = twf.wavefront_dp(cost, twf.WTW_SPEC)
    ref_acc, ref_back = twf.wavefront_dp_reference(cost, twf.WTW_SPEC)
    assert torch.equal(acc, ref_acc) and torch.equal(back, ref_back)
    pts, ln = twf.backtrack(back, twf.WTW_SPEC)
    ref_pts, ref_ln = twf.backtrack_reference(back, twf.WTW_SPEC)
    assert torch.equal(pts, ref_pts) and torch.equal(ln, ref_ln)
    assert (twf.dp_launches, twf.backtrack_launches, twf.dp_batched_launches, twf.backtrack_batched_launches) == (
        0, 0, 0, 0)


def test_bad_shapes_raise():
    """Four axes, an empty batch or matrix and a device with no kernel
    raise."""
    with pytest.raises(ValueError, match="batch"):
        twf.wavefront_dp(torch.ones((2, 2, 3, 4)))
    for shape in ((0, 4, 5), (2, 0, 4)):
        with pytest.raises(ValueError, match="non-empty"):
            twf.wavefront_dp(torch.ones(shape))
    with pytest.raises(ValueError, match="non-empty"):
        twf.backtrack(torch.zeros((2, 3, 0), dtype=torch.int8))
    with pytest.raises(ValueError, match="no wavefront kernel"):
        twf.wavefront_dp(torch.ones((2, 3, 4), device="meta"))
    with pytest.raises(ValueError, match="no backtrack kernel"):
        twf.backtrack(torch.zeros((2, 3, 4), dtype=torch.int8, device="meta"))


def test_batched_launch_signature_and_workspace_in_the_source():
    """The library's C entry points take the batch after the three data
    pointers, and the DP's workspace holds one set of edge rows a matrix:
    ``16 + B·(strips − 1)·N·8`` bytes (twice that in float64).  Read from
    ``csrc/wavefront.cu`` and ``ops/_build.py``, since no kernel runs
    here."""
    import pathlib
    import re

    from real_time_audio_sync_tpu_torch.ops import _build

    src = (pathlib.Path(twf.__file__).resolve().parent.parent / "csrc" / "wavefront.cu").read_text()
    for name in ("wavefront_dp", "wavefront_backtrack"):
        m = re.search(rf'extern "C" int {name}\(void\* \w+, void\* \w+, void\* \w+, long long batch,', src)
        assert m, name
        args, _ = _build.SIGNATURES["wavefront"][name]
        assert args[3] is _build._L and args[4] is _build._L and args[5] is _build._L
    assert "return 16 + batch * (strips - 1) * n * 8 * (is_double ? 2 : 1);" in src
    assert _build.SIGNATURES["wavefront"]["wavefront_dp_workspace_bytes"][0][:3] == [_build._L] * 3
