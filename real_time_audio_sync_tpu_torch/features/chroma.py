"""Chroma feature frontend on PyTorch tensors.

Reference semantics (chroma.py): a hop-loop STFT — Hann window, centered
via an ``fft_len/2`` left zero-pad (chroma.py:49), final partial frame
truncated (chroma.py:54) — then one-sided power spectrum, chroma
filterbank projection and per-frame L2 normalization (chroma.py:67-75).

As in the JAX package, framing is a reshape (hop = fft_len/2 → two
half-frame blocks per frame) and the real DFT is two dense matmuls against
precomputed cos/sin factors, followed by the filterbank matmul — plain
``torch.matmul`` in float32 with TF32 off (:mod:`..numerics`).  Results
live on the device of the input tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from real_time_audio_sync_tpu_torch.config import FFT_LEN, FS, HOP_SIZE
from real_time_audio_sync_tpu_torch.features.filterbank import chroma_filterbank
from real_time_audio_sync_tpu_torch.utils.wavio import load_wav

_CONST_CACHE: dict = {}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from any spelling the JAX package's entry points take:
    a torch dtype, a numpy dtype or scalar type (``np.float32``), or a
    name (``"float32"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def hann_window(n: int) -> np.ndarray:
    """Symmetric Hann window, ``np.hanning`` parity (chroma.py:39,60)."""
    if n == 1:
        return np.ones(1)
    k = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / (n - 1))


def frontend_constants(n_fft: int = FFT_LEN, fs: int = FS, dtype=torch.float32, *, device="cuda"):
    """(hann, dft_cos, dft_sin, filterbank_T) as tensors on ``device``.

    ``rfft(x)[k] = x·cos_k − i·(x·sin_k)``; the factors are computed in
    float64 and cast once, exactly as the JAX package does, and cached per
    (n_fft, fs, dtype, device)."""
    device = torch.device(device)
    key = (n_fft, fs, dtype, device)
    if key not in _CONST_CACHE:
        n = np.arange(n_fft, dtype=np.float64)[:, None]
        k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
        ang = 2.0 * np.pi * n * k / n_fft
        host = (
            hann_window(n_fft),
            np.cos(ang),
            np.sin(ang),
            np.ascontiguousarray(chroma_filterbank(fs, n_fft).T),
        )
        _CONST_CACHE[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype) for a in host
        )
    return _CONST_CACHE[key]


def num_frames(n_samples: int, n_fft: int = FFT_LEN, hop: int = HOP_SIZE) -> int:
    """Frame count of the reference STFT (chroma.py:49-54): the wav is
    left-padded with ``n_fft/2`` zeros, then ``int(((N - L)/H) + 1)`` hops
    (Python-2 floor division, preserved)."""
    padded = n_samples + n_fft // 2
    return max(0, (padded - n_fft) // hop + 1)


def chroma_frames(frames: torch.Tensor, n_fft: int = FFT_LEN, fs: int = FS, normalize: bool = True) -> torch.Tensor:
    """(T, n_fft) audio frames → (12, T) chroma on the frames' device:
    ``hann → rDFT → |·|² → chromafb → L2-normalize`` (chroma.py:35-42,
    67-75), batched over frames."""
    win, dft_cos, dft_sin, fb_t = frontend_constants(n_fft, fs, frames.dtype, device=frames.device)
    wf = frames * win
    re = wf @ dft_cos
    im = wf @ dft_sin
    power = re * re + im * im  # (T, K)
    raw = power @ fb_t  # (T, 12)
    if normalize:
        norm = torch.sqrt(torch.sum(raw * raw, dim=1, keepdim=True))
        tiny = torch.finfo(frames.dtype).tiny
        raw = raw / torch.where(norm < tiny, torch.ones_like(norm), norm)
    return raw.T


def frame_span(x: torch.Tensor, t: int, n_fft: int, hop: int) -> torch.Tensor:
    """Frame a contiguous sample span into (t, n_fft) hop windows — frame i
    is ``x[i·hop : i·hop+n_fft]``.  When ``n_fft == 2·hop`` each frame is
    two consecutive half-frame blocks (a reshape + concat); otherwise a
    strided view."""
    if n_fft == 2 * hop:
        blocks = x[: (t + 1) * hop].reshape(t + 1, hop)
        return torch.cat([blocks[:-1], blocks[1:]], dim=1)
    return x.unfold(0, n_fft, hop)[:t]


def chroma_pipeline(wav: torch.Tensor, n_fft: int = FFT_LEN, hop: int = HOP_SIZE, fs: int = FS, normalize: bool = True) -> torch.Tensor:
    """Full wav → (12, T) chroma pipeline on the wav's device."""
    t = num_frames(wav.shape[0], n_fft, hop)
    if t <= 0:
        return torch.zeros((12, 0), dtype=wav.dtype, device=wav.device)
    x = torch.cat([torch.zeros(n_fft // 2, dtype=wav.dtype, device=wav.device), wav])
    return chroma_frames(frame_span(x, t, n_fft, hop), n_fft, fs, normalize)


def chroma_from_samples(wav, dtype=torch.float32, normalize: bool = True, bucket: bool = True, *,
                        device="cuda") -> torch.Tensor:
    """22.05 kHz mono samples (numpy or tensor) → (12, T) chroma on
    ``device``.  ``bucket`` is the JAX package's power-of-two length
    bucketing, which spares it a compile per length; the port compiles
    nothing per shape, so it is accepted and ignored."""
    wav_t = torch.as_tensor(wav)
    if wav_t.ndim != 1:
        raise TypeError(
            f"chroma_from_samples expects 1-D mono samples, got shape "
            f"{tuple(wav_t.shape)}; average stereo to mono first (load_wav does), "
            f"and note a (12, T) chroma array is features, not samples")
    return chroma_pipeline(wav_t.to(device=device, dtype=torch_dtype(dtype)), normalize=normalize)


def wav_to_chroma(path_to_wav: str, dtype=torch.float32, *, device="cuda") -> torch.Tensor:
    """Reference ``wav_to_chroma`` (chroma.py:25-33): load → STFT → chroma."""
    wav, fs = load_wav(path_to_wav)
    if fs != FS:
        raise ValueError(f"{path_to_wav}: sample rate {fs}, expected {FS}")
    return chroma_from_samples(wav, dtype, device=device)


def _half_wave_diff(chroma: torch.Tensor) -> torch.Tensor:
    """Half-wave-rectified temporal difference (chroma.py:77-90)."""
    return torch.clamp(torch.diff(chroma, dim=1), min=0)


def wav_to_chroma_diff(path_to_wav: str, dtype=torch.float32, *, device="cuda") -> torch.Tensor:
    """Reference ``wav_to_chroma_diff`` (chroma.py:77-90): (12, T-1)
    half-wave-rectified temporal difference of the normalized chroma, on
    ``device`` — LiveNoteV2's Euclidean-cost features."""
    return _half_wave_diff(wav_to_chroma(path_to_wav, dtype, device=device))


def chroma_diff_from_samples(wav, dtype=torch.float32, *, device="cuda") -> torch.Tensor:
    """22.05 kHz mono samples → (12, T-1) chroma-diff on ``device``."""
    return _half_wave_diff(chroma_from_samples(wav, dtype, device=device))


def wav_to_chroma_col(wav_buf, dtype=torch.float32, *, device="cuda") -> torch.Tensor:
    """Reference ``wav_to_chroma_col`` (chroma.py:35-42): one fft_len-sample
    buffer → one 12-dim chroma column."""
    buf = torch.as_tensor(wav_buf)
    if buf.shape[-1] != FFT_LEN:
        raise ValueError(f"wav_to_chroma_col takes {FFT_LEN} samples, got {buf.shape[-1]}")
    frames = buf.to(device=device, dtype=torch_dtype(dtype)).reshape(1, FFT_LEN)
    return chroma_frames(frames)[:, 0]
