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

The host frontend (:func:`host_chroma_frames`, numpy and scipy only) is a
copy of the JAX package's (``features/chroma.py:70-292``): the WTW engines'
``transfer_dtype="chroma"`` extracts columns on the host with it and ships
12 floats a column instead of the raw samples.  It gives the JAX package's
bits on the same frames (``tests/test_torch_copies.py``).
"""

from __future__ import annotations

import os
import threading

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


_HOST_CONST_CACHE: dict = {}


def host_frontend_constants(n_fft: int = FFT_LEN, fs: int = FS, dtype=np.float32):
    """(hann, filterbank_T) as host numpy arrays — the host twin of
    :func:`frontend_constants`; the DFT runs as an FFT on the host, so no
    DFT factors are made."""
    key = (n_fft, fs, np.dtype(dtype).name)
    if key not in _HOST_CONST_CACHE:
        _HOST_CONST_CACHE[key] = (
            hann_window(n_fft).astype(dtype),
            np.ascontiguousarray(chroma_filterbank(fs, n_fft).T).astype(dtype),
        )
    return _HOST_CONST_CACHE[key]


_HOST_FB2_CACHE: dict = {}


def _host_fb_interleaved(n_fft: int, fs: int) -> np.ndarray:
    """(2K, 12) float32 filterbank with each row doubled, matching the
    re, im interleaving of a complex64 buffer viewed as float32, so
    ``v² @ fb2`` projects the power spectrum straight from the squared
    components (the float32 path of :func:`host_chroma_frames`)."""
    key = (n_fft, fs)
    if key not in _HOST_FB2_CACHE:
        _, fb_t = host_frontend_constants(n_fft, fs, np.float32)
        _HOST_FB2_CACHE[key] = np.ascontiguousarray(np.repeat(fb_t, 2, axis=0))
    return _HOST_FB2_CACHE[key]


#: worker threads of the float32 host extraction: an explicit argument,
#: else this environment variable, else one
_WORKERS_ENV = "RTAS_HOST_FFT_WORKERS"
_POOL = None
_POOL_SIZE = 0
_POOL_LOCK = threading.Lock()


def _host_pool(workers: int):
    """The shared thread pool, grown (never shrunk) under a lock.  An old
    pool is not shut down on a resize: a caller that took it just before
    the swap may still submit to it."""
    global _POOL, _POOL_SIZE
    with _POOL_LOCK:
        if _POOL is None or workers > _POOL_SIZE:
            import concurrent.futures

            _POOL = concurrent.futures.ThreadPoolExecutor(max_workers=workers, thread_name_prefix="rtas-hostfft")
            _POOL_SIZE = workers
        return _POOL


def resolve_host_workers(workers=None) -> int:
    """Worker count: the explicit argument, else ``RTAS_HOST_FFT_WORKERS``,
    else 1; a malformed variable warns and gives 1."""
    if workers is not None:
        return max(1, int(workers))
    env = os.environ.get(_WORKERS_ENV)
    if not env:
        return 1
    try:
        return max(1, int(env))
    except ValueError:
        import warnings

        warnings.warn(f"ignoring malformed {_WORKERS_ENV}={env!r} (expected an integer); running single-threaded")
        return 1


def host_chroma_frames(frames: np.ndarray, n_fft: int = FFT_LEN, fs: int = FS, normalize: bool = True,
                       overwrite_frames: bool = False, workers=None) -> np.ndarray:
    """(T, n_fft) raw frames → (12, T) chroma, on the host.

    The pipeline of :func:`chroma_frames` (window → real DFT → power →
    filterbank → L2 normalise) with the DFT as an FFT on the host; host and
    card differ in low-order float32 bits (about 1e-6).  Float32 frames go
    through ``scipy.fft`` in cache-blocked chunks of about 1 MB (window,
    FFT, square the complex64 buffer in place as float32 pairs, project
    through :func:`_host_fb_interleaved`), optionally over ``workers``
    threads that take the same chunks, so the result does not depend on
    the worker count.  Float64 frames keep ``np.fft.rfft`` and the explicit
    power spectrum.  ``overwrite_frames`` lets the float64 window multiply
    run in place (never for overlapping strided views)."""
    dtype = np.dtype(frames.dtype)
    win, fb_t = host_frontend_constants(n_fft, fs, dtype)
    if dtype == np.float32:
        from scipy import fft as sfft

        t = frames.shape[0]
        chunk = max(1, min(t or 1, (1 << 20) // (4 * n_fft)))  # ~1 MB
        fbi = _host_fb_interleaved(n_fft, fs)
        raw = np.empty((t, 12), np.float32)
        n_workers = min(resolve_host_workers(workers), max(1, -(-t // chunk)))

        def sweep(lo: int, hi: int, buf: np.ndarray, fft_workers: int) -> None:
            for i in range(lo, hi, chunk):
                j = min(i + chunk, t)
                b = buf[: j - i]
                np.multiply(frames[i:j], win, out=b)
                spec = sfft.rfft(b, axis=1, overwrite_x=True, workers=fft_workers)
                v = spec.view(np.float32)  # (chunk, 2K) re, im pairs
                np.multiply(v, v, out=v)
                np.matmul(v, fbi, out=raw[i:j])

        if n_workers <= 1:  # the FFT's own threads split the rows
            sweep(0, t, np.empty((chunk, n_fft), np.float32), os.cpu_count() or 1)
        else:  # whole chunks per worker: the same chunk boundaries, the same bits
            n_chunks = -(-t // chunk)
            per = -(-n_chunks // n_workers)
            pool = _host_pool(n_workers)
            futs = [pool.submit(sweep, w * per * chunk, min((w + 1) * per * chunk, t),
                                np.empty((chunk, n_fft), np.float32), 1)
                    for w in range(n_workers) if w * per * chunk < t]
            for f in futs:
                f.result()
    else:
        if overwrite_frames and frames.flags.writeable:
            wf = np.multiply(frames, win, out=frames)
        else:
            wf = frames * win[None, :]
        spec = np.fft.rfft(wf, axis=1)
        power = spec.real.astype(dtype) ** 2 + spec.imag.astype(dtype) ** 2
        raw = power @ fb_t  # (T, 12)
    if normalize:
        norm = np.sqrt(np.sum(raw * raw, axis=1, keepdims=True))
        tiny = np.finfo(dtype).tiny
        raw = raw / np.where(norm < tiny, np.ones_like(norm), norm)
    return np.ascontiguousarray(raw.T)


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


#: frames of one tile of :func:`chroma_frames_tiled`
CHROMA_TILE = 8


def chroma_frames_tiled(frames: torch.Tensor, n_fft: int = FFT_LEN, fs: int = FS) -> torch.Tensor:
    """:func:`chroma_frames` over tiles of exactly ``CHROMA_TILE`` frames (the
    last one zero-padded), so that a frame's column does not depend on how
    many frames were extracted with it.  A float32 matrix product rounds
    according to its shape (one frame alone takes a matrix-vector path, for
    instance, and its column can differ in the last bits from the same
    frame's column in a batch); in products of one shape each row is the
    same sequence of operations on its own frame.  The WTW engines extract
    their live columns this way, so the host engine, fed a few samples at a
    time, and the fused engine, a block of ``k_block`` columns at a time,
    see the same columns."""
    t = frames.shape[0]
    pad = -t % CHROMA_TILE
    if pad:
        frames = torch.cat([frames, frames.new_zeros((pad, frames.shape[1]))])
    cols = [chroma_frames(frames[i : i + CHROMA_TILE], n_fft, fs) for i in range(0, t + pad, CHROMA_TILE)]
    return torch.cat(cols, dim=1)[:, :t]


def frame_span(x: torch.Tensor, t: int, n_fft: int, hop: int) -> torch.Tensor:
    """Frame a contiguous sample span into (t, n_fft) hop windows — frame i
    is ``x[i·hop : i·hop+n_fft]``.  When ``n_fft == 2·hop`` each frame is
    two consecutive half-frame blocks (a reshape + concat); otherwise a
    strided view."""
    if n_fft == 2 * hop:
        blocks = x[: (t + 1) * hop].reshape(t + 1, hop)
        return torch.cat([blocks[:-1], blocks[1:]], dim=1)
    return x.unfold(0, n_fft, hop)[:t]


def chroma_spans_tiled(spans: torch.Tensor, t: int, n_fft: int = FFT_LEN, hop: int = HOP_SIZE, fs: int = FS,
                       streams=None) -> torch.Tensor:
    """(B, span) sample spans of B streams → (B, t, 12) live columns: each
    stream's span framed by :func:`frame_span` and extracted by
    :func:`chroma_frames_tiled` on that stream alone, so stream b's columns
    are bit for bit what a solo engine extracts from the same span.
    ``streams``: the streams to extract (default all); the other streams'
    rows are zero.

    One product batched over every stream's tiles would keep each row's
    bits only if the matrix library ran every batch entry as the same
    8-row product; the per-stream form keeps them by construction."""
    out = spans.new_zeros((spans.shape[0], t, 12))
    for b in range(spans.shape[0]) if streams is None else streams:
        out[b] = chroma_frames_tiled(frame_span(spans[b], t, n_fft, hop), n_fft, fs).T
    return out


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
