"""The port's native host runtime (``native/bindings.py``: the lock-free ring
buffer and the PCM16 wav decoder of ``native/rtas_runtime.cpp``) and the
native branch of ``utils/wavio.load_wav``, against the JAX package's, on
the cases of tests/test_native.py:12-93, with wavs the tests write.
Tolerance: none — streams and decoded samples equal bit for bit."""

import os
import subprocess
import sys
import threading
import wave

import numpy as np
import pytest

from real_time_audio_sync_tpu.native import native_decode_wav as jax_decode
from real_time_audio_sync_tpu.utils import wavio as jwavio
from real_time_audio_sync_tpu_torch.native import NativeRingBuffer, bindings, native_available, native_decode_wav
from real_time_audio_sync_tpu_torch.streaming.sources import SimulatedMic, ThreadedSource
from real_time_audio_sync_tpu_torch.utils import wavio as twavio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pcm16_wav(path, frames: int, channels: int, seed: int = 0) -> np.ndarray:
    """A random PCM16 wav at 22 050 Hz; returns its int16 samples (frames,
    channels)."""
    pcm = np.random.default_rng(seed).integers(-32768, 32768, (frames, channels), dtype=np.int16)
    with wave.open(str(path), "w") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes(pcm.tobytes())
    return pcm


def test_native_library_builds():
    assert native_available(), "g++ build of native/rtas_runtime.cpp failed"
    assert os.path.exists(bindings._LIB_PATH)


def test_ring_buffer_basics():
    ring = NativeRingBuffer(1024)
    assert ring.native
    assert ring.capacity == 1024
    data = np.arange(100, dtype=np.float32)
    assert ring.push(data) == 100
    assert ring.readable() == 100
    np.testing.assert_array_equal(ring.pop(60), data[:60])
    np.testing.assert_array_equal(ring.pop(100), data[60:])  # short read
    assert ring.readable() == 0


@pytest.mark.parametrize("native", [True, False], ids=["native", "python_fallback"])
def test_ring_buffer_wraps_and_rejects_overflow(native, monkeypatch):
    """Both the native ring and the pure-Python fallback (no compiler)."""
    if not native:
        monkeypatch.setattr(bindings, "_lib", None)
        monkeypatch.setattr(bindings, "_build_failed", True)
    ring = NativeRingBuffer(64)
    assert ring.native == native and ring.capacity == 64
    for round_ in range(10):  # force wraparound
        data = np.random.default_rng(round_).standard_normal(40).astype(np.float32)
        assert ring.push(data) == 40
        np.testing.assert_array_equal(ring.pop(40), data)
    assert ring.push(np.zeros(200, np.float32)) == 64  # accepts only what fits


def test_ring_buffer_threaded_integrity():
    """SPSC stress: one producer, one consumer, bit-exact stream."""
    ring = NativeRingBuffer(4096)
    n = 200_000
    src = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    received = []

    def produce():
        off = 0
        while off < n:
            off += ring.push(src[off : off + 1000])

    t = threading.Thread(target=produce)
    t.start()
    got = 0
    while got < n:
        chunk = ring.pop(777)
        got += chunk.size
        if chunk.size:
            received.append(chunk)
    t.join()
    np.testing.assert_array_equal(np.concatenate(received), src)


@pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
def test_native_decode_equals_python_decode_and_jax(channels, tmp_path):
    path = tmp_path / "pcm.wav"
    pcm = _pcm16_wav(path, 200_000, channels, seed=channels)
    samples, sr = native_decode_wav(str(path))
    assert sr == 22050
    expect = (pcm.astype(np.float32) / 32768.0).mean(axis=1)
    np.testing.assert_allclose(samples, expect, atol=1e-7)
    want, jsr = jax_decode(str(path))
    assert jsr == sr and samples.dtype == want.dtype
    np.testing.assert_array_equal(samples, want)


@pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
def test_load_wav_equals_jax_bit_for_bit(channels, tmp_path):
    """``load_wav`` takes the native branch for plain PCM16 and gives the JAX
    package's samples; without the native library the Python branch gives
    the same samples."""
    path = str(tmp_path / "pcm.wav")
    _pcm16_wav(path, 200_000, channels, seed=10 + channels)
    got, sr = twavio.load_wav(path)
    want, jsr = jwavio.load_wav(path)
    assert sr == jsr == 22050 and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    saved = (bindings._lib, bindings._build_failed)
    try:
        bindings._lib, bindings._build_failed = None, True
        assert native_decode_wav(path) is None
        python, _ = twavio.load_wav(path)
    finally:
        bindings._lib, bindings._build_failed = saved
    np.testing.assert_array_equal(python, got)


def test_threaded_source_preserves_stream(tmp_path):
    path = str(tmp_path / "live.wav")
    _pcm16_wav(path, 60_000, 2, seed=5)
    samples, _ = twavio.load_wav(path)
    got = np.concatenate(list(ThreadedSource(SimulatedMic(path, buffer_size=600))))
    np.testing.assert_array_equal(got, samples)


def test_native_decoder_rejects_non_wav(tmp_path):
    bad = tmp_path / "not_a_wav.wav"
    bad.write_bytes(b"definitely not RIFF data")
    assert native_decode_wav(str(bad)) is None


def test_build_honours_rtas_native_dir_and_leaves_no_temporary(tmp_path):
    """``RTAS_NATIVE_DIR`` moves the build as in the JAX package; the
    library is written under a temporary name and renamed into place."""
    code = ("from real_time_audio_sync_tpu_torch.native import bindings as b; "
            "print(b.native_available(), b._LIB_PATH)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "RTAS_NATIVE_DIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    ok, lib = out.stdout.split()
    assert ok == "True" and lib == str(tmp_path / "librtas_runtime_torch.so")
    assert sorted(os.listdir(tmp_path)) == ["librtas_runtime_torch.so"]
