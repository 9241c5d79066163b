"""The port's chroma frontend against the JAX package's.

Tolerances: float64 to atol 1e-12 (both compute the same matmuls; only the
summation order of the 4096-term products differs); float32 to atol 1e-5
(CPU float32 matmuls of the two libraries agree to about 1e-6,
docs/PARITY.md).  The filterbank is bit-identical."""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from real_time_audio_sync_tpu.features import chroma as jchroma  # noqa: E402
from real_time_audio_sync_tpu_torch.features import chroma as tchroma  # noqa: E402
from real_time_audio_sync_tpu_torch.features.filterbank import chroma_filterbank  # noqa: E402
from real_time_audio_sync_tpu_torch.utils.wavio import write_wav  # noqa: E402

_GOLDEN = pathlib.Path(__file__).parent / "golden"
DTYPES = [(np.float64, torch.float64, 1e-12), (np.float32, torch.float32, 1e-5)]


@pytest.fixture(scope="module")
def random_wav():
    rng = np.random.default_rng(0)
    return rng.standard_normal(22050 * 2 + 777) * 0.1


def test_filterbank_bit_equal_to_golden():
    np.testing.assert_array_equal(chroma_filterbank(22050, 4096), np.load(_GOLDEN / "chromafb_22050_4096.npy"))


@pytest.mark.parametrize("np_dtype,t_dtype,atol", DTYPES)
def test_chroma_frames_matches_jax(random_wav, np_dtype, t_dtype, atol):
    frames = np.stack([random_wav[i * 2048 : i * 2048 + 4096] for i in range(9)]).astype(np_dtype)
    want = np.asarray(jchroma.chroma_frames(jnp.asarray(frames)))
    got = tchroma.chroma_frames(torch.from_numpy(frames))
    assert got.dtype == t_dtype and tuple(got.shape) == (12, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("np_dtype,t_dtype,atol", DTYPES)
def test_chroma_pipeline_matches_jax(random_wav, np_dtype, t_dtype, atol):
    wav = random_wav.astype(np_dtype)
    want = np.asarray(jchroma.chroma_pipeline(jnp.asarray(wav)))
    got = tchroma.chroma_pipeline(torch.from_numpy(wav))
    assert got.dtype == t_dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    assert tchroma.num_frames(len(wav)) == got.shape[1]


def test_wav_to_chroma_matches_jax(tmp_path, random_wav):
    path = str(tmp_path / "x.wav")
    write_wav(path, random_wav)
    want = jchroma.wav_to_chroma(path)
    got = tchroma.wav_to_chroma(path, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_frontend_matches_frozen_chroma_columns():
    """A C-major chord + noise (seed in the artifact) through the port's
    frontend reproduces the frozen reference-pipeline columns."""
    data = np.load(_GOLDEN / "chroma_columns_cmaj.npz")
    rng = np.random.default_rng(int(data["wav_seed"]))
    t = np.arange(22050 * 2) / 22050.0
    wav = (0.4 * np.sin(2 * np.pi * 261.63 * t)
           + 0.3 * np.sin(2 * np.pi * 329.63 * t)
           + 0.2 * np.sin(2 * np.pi * 392.0 * t)
           + 0.05 * rng.standard_normal(t.shape))
    ours = tchroma.chroma_from_samples(wav, dtype=torch.float64, device="cpu")[:, :8]
    np.testing.assert_allclose(ours.numpy(), data["chroma"], rtol=1e-8, atol=1e-10)


def test_silence_gives_zero_columns():
    cols = tchroma.chroma_from_samples(np.zeros(22050), device="cpu")
    assert not torch.isnan(cols).any()
    assert torch.count_nonzero(cols) == 0
    col = tchroma.wav_to_chroma_col(np.zeros(4096), device="cpu")
    assert tuple(col.shape) == (12,) and torch.count_nonzero(col) == 0


def test_input_checks():
    with pytest.raises(ValueError, match="4096"):
        tchroma.wav_to_chroma_col(np.zeros(4000), device="cpu")
    with pytest.raises(TypeError, match="1-D"):
        tchroma.chroma_from_samples(np.zeros((2, 5000)), device="cpu")
    assert tuple(tchroma.chroma_from_samples(np.zeros(100), device="cpu").shape) == (12, 0)


def test_wav_to_chroma_col_matches_jax(random_wav):
    buf = random_wav[:4096].astype(np.float32)
    np.testing.assert_allclose(
        tchroma.wav_to_chroma_col(buf, device="cpu").numpy(), jchroma.wav_to_chroma_col(buf), rtol=0, atol=1e-5)


def test_importing_the_port_turns_tf32_off():
    """TF32 flips DP ties, so the package sets full-float32 matmuls once,
    at import, for the process (numerics.py)."""
    import real_time_audio_sync_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


SPELLINGS = [
    (np.float32, np.float32), ("float32", np.float32), (torch.float32, np.float32), (np.dtype("float32"), np.float32),
    (np.float64, np.float64), ("float64", np.float64), (torch.float64, np.float64),
]


@pytest.mark.parametrize("spelling,np_dtype", SPELLINGS, ids=[str(s) for s, _ in SPELLINGS])
def test_every_dtype_spelling_matches_jax(tmp_path, random_wav, spelling, np_dtype):
    """The chroma entry points take the JAX package's dtype spellings — numpy
    types, names and torch dtypes — and give JAX's output in that dtype."""
    atol = 1e-12 if np_dtype is np.float64 else 1e-5
    want_t = torch.float64 if np_dtype is np.float64 else torch.float32
    path = str(tmp_path / "x.wav")
    write_wav(path, random_wav)
    wav = random_wav.astype(np_dtype)
    cases = [
        (tchroma.chroma_from_samples(wav, spelling, device="cpu"), jchroma.chroma_from_samples(wav, np_dtype)),
        (tchroma.wav_to_chroma(path, spelling, device="cpu"), jchroma.wav_to_chroma(path, np_dtype)),
        (tchroma.wav_to_chroma_diff(path, spelling, device="cpu"), jchroma.wav_to_chroma_diff(path, np_dtype)),
        (tchroma.chroma_diff_from_samples(wav, spelling, device="cpu"),
         jchroma.chroma_diff_from_samples(wav, np_dtype)),
        (tchroma.wav_to_chroma_col(wav[:4096], spelling, device="cpu"), jchroma.wav_to_chroma_col(wav[:4096], np_dtype)),
    ]
    for got, want in cases:
        assert got.dtype == want_t
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("bucket", [True, False])
def test_bucket_is_accepted_and_changes_nothing(random_wav, bucket):
    """JAX's chroma_from_samples buckets lengths to spare compiles; the port
    takes the keyword (by name and in JAX's position) and gives the same
    columns either way."""
    wav = random_wav.astype(np.float32)
    want = jchroma.chroma_from_samples(wav, np.float32, True, bucket)
    by_name = tchroma.chroma_from_samples(wav, np.float32, bucket=bucket, device="cpu")
    positional = tchroma.chroma_from_samples(wav, np.float32, True, bucket, device="cpu")
    assert torch.equal(by_name, positional)
    assert torch.equal(by_name, tchroma.chroma_from_samples(wav, device="cpu"))
    np.testing.assert_allclose(by_name.numpy(), want, rtol=0, atol=1e-5)


def test_top_level_exports_the_chroma_entry_points():
    import real_time_audio_sync_tpu as jax_pkg
    import real_time_audio_sync_tpu_torch as port

    for name in ("wav_to_chroma", "wav_to_chroma_col", "wav_to_chroma_diff"):
        assert getattr(port, name) is getattr(tchroma, name)
        assert hasattr(jax_pkg, name)
