"""Wav loading with ``librosa.load`` parity, without librosa.

The reference loads every recording through ``librosa.load(path)`` (e.g.
chroma.py:27, wtw.py:23) which (a) decodes PCM to float, (b) averages
channels to mono and (c) resamples to the default 22 050 Hz.  The surviving
corpus audio is already 22 050 Hz stereo PCM16, so in practice only (a)+(b)
apply; resampling is provided for other inputs via polyphase filtering.
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np

TARGET_SR = 22050


def _decode_pcm(raw: bytes, sampwidth: int, n_channels: int) -> np.ndarray:
    """Decode interleaved PCM bytes to float32 in [-1, 1)."""
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:  # unsigned 8-bit
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:  # 24-bit packed
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        data = vals.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported PCM sample width: {sampwidth}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels)
    return data


def load_wav(path: str, target_sr: int | None = TARGET_SR, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Load a wav file as float32, optionally mono-averaged and resampled.

    Returns ``(samples, sample_rate)``.  Matches ``librosa.load(path)``
    semantics for the corpus files: int16 PCM scaled by 1/32768, channels
    averaged, already at 22 050 Hz.
    """
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    data = _decode_pcm(raw, sampwidth, n_channels)
    if mono and data.ndim == 2:
        data = data.mean(axis=1)
    if target_sr is not None and sr != target_sr:
        from scipy.signal import resample_poly  # lazy: only for non-22.05k input

        from math import gcd

        g = gcd(int(target_sr), int(sr))
        data = resample_poly(data, target_sr // g, sr // g).astype(np.float32)
        sr = target_sr
    return np.ascontiguousarray(data, dtype=np.float32), sr


def write_wav(path: str, samples: np.ndarray, sr: int = TARGET_SR, num_channels: int = 1) -> None:
    """Write float samples as int16 PCM (scale 2**15 — ims/writer.py:71-78)."""
    buf = (np.asarray(samples) * (2 ** 15)).astype(np.int16)
    with wave.open(path, "w") as f:
        f.setnchannels(num_channels)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(buf.tobytes())
