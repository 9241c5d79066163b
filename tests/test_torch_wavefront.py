"""The port's wavefront DP and backtrack (``ops/wavefront.py``; on the CPU
their plain PyTorch versions) against the JAX package's scan versions and
its Pallas kernels in interpret mode, on the same numpy costs.

Tolerance: zero.  Each cell is the same one multiply and one add per
candidate in the cost's dtype, compared with strict ``<``, so ``acc``,
``back``, ``points`` and ``length`` are equal exactly.  The Pallas DP
kernel computes in float32 whatever the input dtype
(``pallas_wavefront.py:308``), so it is compared at float32 only; the
Pallas backtrack reads codes and is compared at both dtypes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from real_time_audio_sync_tpu.ops import wavefront as jwf  # noqa: E402
from real_time_audio_sync_tpu.ops.pallas_wavefront import backtrack_pallas, wavefront_dp_pallas  # noqa: E402
from real_time_audio_sync_tpu_torch.ops import wavefront as twf  # noqa: E402

SHAPES = [(1, 1), (1, 7), (7, 1), (5, 7), (33, 20), (40, 65), (64, 48)]
SPECS = {"dtw": (jwf.DTW_SPEC, twf.DTW_SPEC), "wtw": (jwf.WTW_SPEC, twf.WTW_SPEC)}


def _cost(shape, dtype, ties: bool):
    if ties:
        return np.ones(shape, dtype)
    return np.random.default_rng(sum(shape)).random(shape).astype(dtype)


CASES = [(s, False) for s in SHAPES] + [((12, 9), True)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("shape,ties", CASES, ids=[f"{m}x{n}{'-ties' if t else ''}" for (m, n), t in CASES])
def test_dp_and_backtrack_match_jax(shape, ties, spec, dtype):
    jspec, tspec = SPECS[spec]
    cost = _cost(shape, dtype, ties)
    acc_j, back_j = jwf.wavefront_dp(jnp.asarray(cost), jspec)
    acc_t, back_t = twf.wavefront_dp(torch.from_numpy(cost), tspec)
    assert acc_t.dtype == torch.from_numpy(cost).dtype and back_t.dtype == torch.int8
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    np.testing.assert_array_equal(back_t.numpy(), np.asarray(back_j))
    if dtype == np.float32:
        acc_p, back_p = wavefront_dp_pallas(jnp.asarray(cost), jspec, interpret=True)
        np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_p))
        np.testing.assert_array_equal(back_t.numpy(), np.asarray(back_p))

    pts_t, len_t = twf.backtrack(back_t, tspec)
    for pts_j, len_j in (jwf.backtrack(back_j, jspec), backtrack_pallas(back_j, jspec, interpret=True)):
        np.testing.assert_array_equal(pts_t.numpy(), np.asarray(pts_j))  # frozen repeats included
        assert int(len_t) == int(len_j)
    assert pts_t.dtype == torch.int32 and pts_t.shape == (shape[0] + shape[1] - 1, 2)


def test_cpu_tensors_run_the_plain_versions():
    """On a CPU tensor the wrappers are the plain versions, and no kernel
    launch is counted."""
    twf.dp_launches = twf.backtrack_launches = 0
    cost = torch.from_numpy(_cost((9, 11), np.float32, False))
    acc, back = twf.wavefront_dp(cost)
    ref_acc, ref_back = twf.wavefront_dp_reference(cost)
    assert torch.equal(acc, ref_acc) and torch.equal(back, ref_back)
    pts, ln = twf.backtrack(back)
    ref_pts, ref_ln = twf.backtrack_reference(back)
    assert torch.equal(pts, ref_pts) and int(ln) == int(ref_ln)
    assert twf.dp_launches == 0 and twf.backtrack_launches == 0


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        twf.wavefront_dp(torch.ones((3, 4), dtype=torch.float16))
    with pytest.raises(ValueError, match="non-empty"):
        twf.wavefront_dp(torch.ones((0, 4)))
    with pytest.raises(TypeError):
        twf.backtrack(torch.zeros((3, 4), dtype=torch.int32))
    bad = twf.StepSpec(steps=((0, -1), (0, -1), (-1, -1)), weights=(1.0, 1.0, 2.0), codes=(0, 1, 2), corner_code=2)
    with pytest.raises(ValueError, match="steps"):
        twf.wavefront_dp(torch.ones((3, 4)), bad)


def test_unroll_is_accepted_and_changes_nothing():
    """JAX's ``unroll=`` (a tracing switch, models/wtw_async.py passes it)
    is accepted by both wrappers and leaves the result as it was."""
    import inspect

    for fn, jfn in ((twf.wavefront_dp, jwf.wavefront_dp), (twf.backtrack, jwf.backtrack)):
        assert list(inspect.signature(fn).parameters) == list(inspect.signature(jfn).parameters)
    cost = torch.from_numpy(_cost((9, 11), np.float32, False))
    acc, back = twf.wavefront_dp(cost, twf.WTW_SPEC, unroll=True)
    ref_acc, ref_back = twf.wavefront_dp(cost, twf.WTW_SPEC)
    assert torch.equal(acc, ref_acc) and torch.equal(back, ref_back)
    pts, ln = twf.backtrack(back, twf.WTW_SPEC, True)
    ref_pts, ref_ln = twf.backtrack(back, twf.WTW_SPEC)
    assert torch.equal(pts, ref_pts) and int(ln) == int(ref_ln)
