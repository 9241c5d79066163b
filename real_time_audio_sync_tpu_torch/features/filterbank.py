"""12-bin chroma filterbank, derived in-repo (no librosa runtime dependency).

The reference frontend builds its filterbank with
``librosa.filters.chroma(22050, 4096)`` (chroma.py:69, wtw.py:39).  That
filterbank is the classic Dan Ellis *chromafb* construction: place a wrapped
Gaussian on the chromatic pitch-class axis for every FFT bin, L2-normalize
per FFT bin, apply a Gaussian octave-weighting envelope centred on octave 5,
and rotate so row 0 is pitch-class C.  We re-derive it here from that
published formulation so the TPU frontend carries no librosa dependency;
numerical parity with the reference is exercised end-to-end by the
beat-accuracy tests on the in-repo Chopin recordings.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def hz_to_octaves(freq_hz: np.ndarray, tuning: float = 0.0, bins_per_octave: int = 12) -> np.ndarray:
    """Octave number of a frequency, with A440/16 (≈27.5 Hz, A0) at octave 0."""
    a440 = 440.0 * 2.0 ** (tuning / bins_per_octave)
    return np.log2(freq_hz / (a440 / 16.0))


@lru_cache(maxsize=8)
def chroma_filterbank(
    sr: int = 22050,
    n_fft: int = 4096,
    n_chroma: int = 12,
    tuning: float = 0.0,
    center_octave: float = 5.0,
    octave_width: float = 2.0,
    base_c: bool = True,
) -> np.ndarray:
    """Return the (n_chroma, 1 + n_fft//2) chroma filterbank, float64.

    Applied to a one-sided power spectrum it yields raw (unnormalized) chroma,
    exactly as the reference does at chroma.py:70.
    """
    # Pitch-class coordinate (in fractional chroma bins) of every FFT bin.
    # Bin 0 (DC) has no pitch; it is assigned a synthetic coordinate 1.5
    # octaves below bin 1 so its weight vanishes.
    fft_freqs = np.linspace(0.0, float(sr), n_fft, endpoint=False)[1:]
    pitch = n_chroma * hz_to_octaves(fft_freqs, tuning, n_chroma)
    pitch = np.concatenate(([pitch[0] - 1.5 * n_chroma], pitch))

    # Per-bin Gaussian width: the local FFT-bin spacing measured in chroma
    # bins, floored at one chroma bin.
    widths = np.concatenate((np.maximum(np.diff(pitch), 1.0), [1.0]))

    # Wrapped distance from each FFT bin's pitch coordinate to each of the
    # n_chroma pitch classes, folded into [-n_chroma/2, n_chroma/2).
    dist = pitch[None, :] - np.arange(n_chroma, dtype=np.float64)[:, None]
    half = round(n_chroma / 2.0)
    dist = np.mod(dist + half + 10 * n_chroma, n_chroma) - half

    weights = np.exp(-0.5 * (2.0 * dist / widths[None, :]) ** 2)

    # L2-normalize each FFT-bin column.
    norms = np.sqrt(np.sum(weights ** 2, axis=0))
    norms[norms < np.finfo(np.float64).tiny] = 1.0
    weights = weights / norms[None, :]

    # Gaussian octave envelope: emphasize content near ``center_octave``.
    weights = weights * np.exp(
        -0.5 * (((pitch / n_chroma - center_octave) / octave_width) ** 2)
    )[None, :]

    if base_c:  # rotate so row 0 is C rather than A
        weights = np.roll(weights, -3 * (n_chroma // 12), axis=0)

    out = np.ascontiguousarray(weights[:, : n_fft // 2 + 1])
    out.setflags(write=False)
    return out
