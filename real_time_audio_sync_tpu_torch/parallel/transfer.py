"""Transfer-mode choice for the WTW engines (the JAX package's
``parallel/transfer.py``).

The WTW engines ship one of three payloads host → card per dispatch:

- ``"float32"`` — raw sample spans, exact, 4 B a sample;
- ``"int16"``   — quantized sample spans, half the bytes, bit-exact only
  for PCM16-derived mono audio;
- ``"chroma"``  — 12-dim chroma columns extracted on the host
  (:func:`~real_time_audio_sync_tpu_torch.features.chroma.host_chroma_frames`),
  ~96× fewer bytes than an 8-hop float32 span, for host FFT time.

``transfer_dtype="auto"`` probes the link and the host FFT once per
process and picks by the crossover model below; ``RTAS_TRANSFER_MODE``
forces a mode without probing.  Estimated wall per dispatch of ``B``
streams × ``k`` hop columns:

    t(mode) = rtt + bytes(mode) / link_bw + host_us(mode) · B·k / workers

with ``host_us("chroma")`` the measured host cost a frame and zero for the
span modes.  Float32 is chosen whenever it is within ``EXACT_MARGIN`` (25 %)
of the fastest mode; otherwise the faster of int16 and chroma.

The link probe times pinned host → card copies with CUDA events (the JAX
package times ``jax.device_put``).  A CPU engine has no link to spare, so
its ``"auto"`` resolves to ``"float32"`` without probing.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

MODES = ("float32", "int16", "chroma")
EXACT_MARGIN = 1.25
_ENV_FORCE = "RTAS_TRANSFER_MODE"


class LinkProbe(NamedTuple):
    bytes_per_s: float
    rtt_s: float


def probe_link_bandwidth(nbytes: int = 1 << 21, repeats: int = 3, *, device="cuda") -> LinkProbe:
    """Effective host → card bandwidth and round-trip latency.  ``rtt`` is
    the host wall of copying a tiny pinned buffer to the card and back (the
    fixed cost every dispatch pays); the bandwidth is ``nbytes`` of pinned
    memory over its copy's CUDA-event time."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the link probe times host-to-card copies; {device} is not a CUDA device")
    tiny = torch.zeros(8, dtype=torch.float32).pin_memory()
    big = torch.zeros(nbytes // 4, dtype=torch.float32).pin_memory()
    dev_big = torch.empty_like(big, device=device)
    tiny.to(device).cpu()  # warm the copy path once
    rtts, bigs = [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(repeats):
        t0 = time.perf_counter()
        tiny.to(device, non_blocking=True).cpu()
        rtts.append(time.perf_counter() - t0)
        start.record()
        dev_big.copy_(big, non_blocking=True)
        end.record()
        end.synchronize()
        bigs.append(start.elapsed_time(end) / 1e3)
    return LinkProbe(bytes_per_s=nbytes / max(float(np.median(bigs)), 1e-9), rtt_s=float(np.median(rtts)))


def probe_host_fft_us(n_frames: int = 256, fft_len: int = 4096, fs: int = 22050) -> float:
    """Host chroma extraction cost on this host, µs a frame (the
    ``host_chroma_frames`` path that chroma transfer dispatches through)."""
    from real_time_audio_sync_tpu_torch.features.chroma import host_chroma_frames

    frames = np.random.default_rng(0).standard_normal((n_frames, fft_len)).astype(np.float32) * 0.1
    host_chroma_frames(frames[:8], n_fft=fft_len, fs=fs)  # warm the constants
    t0 = time.perf_counter()
    host_chroma_frames(frames, n_fft=fft_len, fs=fs)
    return (time.perf_counter() - t0) / n_frames * 1e6


def choose_transfer_mode(n_streams: int, k_block: int, fft_len: int, hop_size: int, *, link: LinkProbe,
                         host_fft_us: float, workers: int = 1) -> str:
    """The fastest mode under the crossover model, preferring the exact
    float32 spans within ``EXACT_MARGIN`` of the best — a pure function of
    the probe values."""
    span_samples = fft_len + (k_block - 1) * hop_size
    bytes_of = {
        "float32": n_streams * span_samples * 4,
        "int16": n_streams * span_samples * 2,
        "chroma": n_streams * 12 * k_block * 4,
    }
    host_s = {
        "float32": 0.0,
        "int16": 0.0,
        "chroma": n_streams * k_block * host_fft_us / max(1, workers) / 1e6,
    }
    t = {m: link.rtt_s + bytes_of[m] / link.bytes_per_s + host_s[m] for m in MODES}
    best = min(t.values())
    if t["float32"] <= EXACT_MARGIN * best:
        return "float32"  # exactness is (nearly) free
    return "int16" if t["int16"] <= t["chroma"] else "chroma"


_PROBE_CACHE: dict = {}


def resolve_transfer_mode(transfer_dtype: str, n_streams: int, k_block: int, fft_len: int, hop_size: int,
                          workers: Optional[int] = None, *, device="cuda") -> str:
    """``"auto"`` resolved to a mode (explicit modes pass through).  The
    probes run once per process and card and are cached;
    ``RTAS_TRANSFER_MODE`` forces a mode without probing."""
    if transfer_dtype != "auto":
        return transfer_dtype
    forced = os.environ.get(_ENV_FORCE)
    if forced:
        if forced not in MODES:
            raise ValueError(f"{_ENV_FORCE}={forced!r} is not one of {MODES}")
        return forced
    device = torch.device(device)
    if device.type != "cuda":
        return "float32"
    link_key = ("link", str(device))
    if link_key not in _PROBE_CACHE:
        _PROBE_CACHE[link_key] = probe_link_bandwidth(device=device)
    # the host FFT's cost scales with the transform size
    host_key = ("host_us", int(fft_len))
    if host_key not in _PROBE_CACHE:
        _PROBE_CACHE[host_key] = probe_host_fft_us(fft_len=fft_len)
    if workers is None:
        from real_time_audio_sync_tpu_torch.features.chroma import resolve_host_workers

        workers = resolve_host_workers()
    return choose_transfer_mode(n_streams, k_block, fft_len, hop_size, link=_PROBE_CACHE[link_key],
                                host_fft_us=_PROBE_CACHE[host_key], workers=workers)
