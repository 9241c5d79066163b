"""Synthetic corpus generator with exact beat ground truth.

The reference corpus' audio is absent from the mount (SURVEY.md §2 C16:
``.MISSING_LARGE_BLOBS``), so accuracy evidence beyond the one surviving
Chopin pair comes from synthesized pieces whose beat annotations are exact
by construction.  This module renders chord-chart performances under the
ADVERSARIAL conditions where the DTW variants actually diverge — tempo
ramps, rubato, dropouts, silence spans, noise, detune — and lays them out
in the reference's ``Songs/<piece>/<rec>.{wav,csv}`` corpus format
(tests.py:211-227 pairing rules apply unchanged).

Every case pairs recording ``_00`` (the straight rendition — the
"reference" side of the i<j pair) with ``_01`` (the adversarial live
performance of the same chart).  Ground-truth CSVs carry the exact beat
onset times of each rendition (the format of e.g. Songs/bach/bach_01.csv).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

FS = 22050


def _chart(seed: int, n_beats: int) -> List[np.ndarray]:
    """A deterministic chord chart: one 3-note chord per beat."""
    rng = np.random.default_rng(seed)
    return [rng.choice(12, size=3, replace=False) for _ in range(n_beats)]


@dataclass
class Rendition:
    """How one recording of a chart is performed."""

    tempo: float = 100.0  # base bpm
    #: multiplicative tempo curve over beat index in [0, 1]: 1.0 = steady,
    #: e.g. ``lambda u: 1 + 0.3 * u`` is a linear accelerando to +30%
    tempo_curve: Callable[[float], float] = lambda u: 1.0
    jitter: float = 0.0  # uniform per-beat tempo jitter fraction
    detune_cents: float = 0.0  # pitch offset of every partial
    noise_snr_db: Optional[float] = None  # additive white noise
    #: beats rendered as silence while time still passes (a tacet — the
    #: performer stops, the score does not)
    silent_beats: Sequence[int] = field(default_factory=tuple)
    #: amplitude curve over the piece in [0, 1] (dynamics; chroma is
    #: L2-normalized per frame so alignment should be invariant)
    amp_curve: Callable[[float], float] = lambda u: 1.0
    seed: int = 0


def render(chart: Sequence[np.ndarray], r: Rendition, fs: int = FS) -> Tuple[np.ndarray, List[float]]:
    """Render a chart under a :class:`Rendition`; returns (wav, beat_times)."""
    rng = np.random.default_rng(r.seed)
    n_beats = len(chart)
    freqs = 220.0 * 2 ** ((np.arange(12) + r.detune_cents / 100.0) / 12)
    samples, beat_times = [], [0.0]
    for b, chord in enumerate(chart):
        u = b / max(n_beats - 1, 1)
        tempo = r.tempo * r.tempo_curve(u)
        if r.jitter:
            tempo *= 1 + rng.uniform(-r.jitter, r.jitter)
        dur = 60.0 / tempo
        t = np.arange(int(dur * fs)) / fs
        if b in r.silent_beats:
            seg = np.zeros_like(t)
        else:
            seg = sum(np.sin(2 * np.pi * freqs[k] * t) for k in chord)
            env = np.minimum(1.0, 10 * t) * np.minimum(1.0, np.maximum(10 * (dur - t), 0))
            seg = seg * env * 0.2 * r.amp_curve(u)
        samples.append(seg)
        beat_times.append(beat_times[-1] + dur)
    wav = np.concatenate(samples)
    if r.noise_snr_db is not None:
        sig_pow = float(np.mean(wav**2)) or 1e-12
        noise_pow = sig_pow / 10 ** (r.noise_snr_db / 10)
        wav = wav + rng.standard_normal(wav.shape) * np.sqrt(noise_pow)
    return wav.astype(np.float64), beat_times[:-1]


#: The adversarial case registry: piece name → (chart seed, n_beats,
#: reference rendition, live rendition).  Ten pairs spanning the failure
#: modes that differentiate the engines (reference metric regime:
#: tests.py:199-262).
CASES: Dict[str, Tuple[int, int, Rendition, Rendition]] = {
    # baseline: steady tempi 12% apart (the classic regime)
    "steady": (101, 24, Rendition(tempo=100), Rendition(tempo=112, seed=1)),
    # live accelerates 30% over the piece — stresses the slope constraint
    "ramp_up": (102, 32, Rendition(tempo=100),
                Rendition(tempo=90, tempo_curve=lambda u: 1 + 0.3 * u, seed=2)),
    # live slows 25% — the band must not race ahead
    "ramp_down": (103, 32, Rendition(tempo=100),
                  Rendition(tempo=115, tempo_curve=lambda u: 1 - 0.25 * u, seed=3)),
    # sinusoidal rubato ±15% at two cycles per piece
    "rubato": (104, 32, Rendition(tempo=100),
               Rendition(tempo=100, tempo_curve=lambda u: 1 + 0.15 * np.sin(4 * np.pi * u), seed=4)),
    # performer drops out for 3 beats mid-piece (time passes, no audio)
    "dropout": (105, 28, Rendition(tempo=100),
                Rendition(tempo=105, silent_beats=(12, 13, 14), seed=5)),
    # silence spans on BOTH sides (tacet in the score itself)
    "tacet_both": (106, 28, Rendition(tempo=100, silent_beats=(10, 11)),
                   Rendition(tempo=108, silent_beats=(10, 11), seed=6)),
    # noisy stage recording: 5 dB SNR
    "noisy": (107, 24, Rendition(tempo=100),
              Rendition(tempo=110, noise_snr_db=5.0, seed=7)),
    # detuned instrument (+35 cents) + mild noise — chroma bins smear
    "detuned": (108, 24, Rendition(tempo=100),
                Rendition(tempo=108, detune_cents=35.0, noise_snr_db=15.0, seed=8)),
    # strong dynamics (pp → ff crescendo); L2-normalized chroma should
    # make alignment invariant
    "crescendo": (109, 24, Rendition(tempo=100),
                  Rendition(tempo=110, amp_curve=lambda u: 0.05 + 0.95 * u, seed=9)),
    # longer piece with per-beat jitter (the round-2 regime, kept)
    "jittered": (110, 48, Rendition(tempo=100, jitter=0.08),
                 Rendition(tempo=112, jitter=0.08, seed=10)),
}


#: Full-scale corpus registry (round-4 verdict item 6): the reference's
#: headline regime is ``test_all`` over 8 pieces × 2–3 recordings with
#: 11,464 beat annotations (tests.py:199-262, Songs/**) — multi-minute
#: works whose audio is absent from the mount.  These 8 synthetic pieces
#: reproduce that SHAPE: 2–3 renditions each, 420–620 beats per rendition
#: (~4–6 minutes at their tempi), realistic performance variation (tempo
#: offsets, light rubato, per-beat jitter, dynamics, mild noise) rather
#: than the adversarial registry's stress cases.  Total: 20 recordings,
#: ~11.3k exact beat annotations, ~100 minutes of audio.
FULL_PIECES: Dict[str, Tuple[int, int, List[Rendition]]] = {
    # name: (chart seed, n_beats, renditions — recording _00 is first)
    "sonata_allegro": (201, 560, [
        Rendition(tempo=116),
        Rendition(tempo=126, jitter=0.04, seed=21),
        Rendition(tempo=108, tempo_curve=lambda u: 1 + 0.06 * u, seed=22),
    ]),
    "sym_andante": (202, 420, [
        Rendition(tempo=84),
        Rendition(tempo=90, tempo_curve=lambda u: 1 + 0.1 * np.sin(2 * np.pi * u), jitter=0.03, seed=23),
    ]),
    "concerto_rondo": (203, 620, [
        Rendition(tempo=132),
        Rendition(tempo=140, jitter=0.05, seed=24),
        Rendition(tempo=124, amp_curve=lambda u: 0.4 + 0.6 * u, seed=25),
    ]),
    "nocturne": (204, 440, [
        Rendition(tempo=92, tempo_curve=lambda u: 1 + 0.08 * np.sin(4 * np.pi * u)),
        Rendition(tempo=88, tempo_curve=lambda u: 1 - 0.05 * np.sin(4 * np.pi * u), jitter=0.04, seed=26),
    ]),
    "fugue": (205, 540, [
        Rendition(tempo=104),
        Rendition(tempo=112, seed=27),
        Rendition(tempo=100, jitter=0.06, noise_snr_db=18.0, seed=28),
    ]),
    "scherzo": (206, 600, [
        Rendition(tempo=144, jitter=0.03),
        Rendition(tempo=152, jitter=0.05, seed=29),
    ]),
    "adagio_tacet": (207, 430, [
        Rendition(tempo=76, silent_beats=(200, 201, 202)),
        Rendition(tempo=82, silent_beats=(200, 201, 202), jitter=0.03, seed=30),
        Rendition(tempo=72, silent_beats=(200, 201, 202), noise_snr_db=14.0, seed=31),
    ]),
    "finale_presto": (208, 560, [
        Rendition(tempo=150, tempo_curve=lambda u: 1 + 0.12 * u),
        Rendition(tempo=158, jitter=0.04, seed=32),
        Rendition(tempo=146, tempo_curve=lambda u: 1 + 0.08 * u, jitter=0.03, seed=33),
    ]),
}


def build_full_corpus(root: str, pieces: Optional[Sequence[str]] = None,
                      fs: int = FS, verbose: bool = False) -> List[str]:
    """Materialize the full-scale corpus under ``root`` in the reference's
    ``Songs/<piece>/<piece>_NN.{wav,csv}`` layout; idempotent (existing
    complete piece directories are kept).  Returns the piece names."""
    from real_time_audio_sync_tpu_torch.utils.wavio import write_wav

    names = list(pieces) if pieces is not None else list(FULL_PIECES)
    for name in names:
        seed, n_beats, rends = FULL_PIECES[name]
        chart = _chart(seed, n_beats)
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        for idx, rend in enumerate(rends):
            base = os.path.join(d, f"{name}_{idx:02d}")
            if os.path.exists(base + ".wav") and os.path.exists(base + ".csv"):
                continue
            wav, beat_times = render(chart, rend, fs)
            write_wav(base + ".wav", wav)
            with open(base + ".csv", "w", newline="") as f:
                w = csv.writer(f)
                for beat, t_sec in enumerate(beat_times, start=1):
                    w.writerow([f"{t_sec:.6f}", beat])
            if verbose:
                print(f"  {base}.wav: {len(wav)/fs/60:.1f} min, "
                      f"{len(beat_times)} beats", flush=True)
    return names


def build_corpus(root: str, cases: Optional[Sequence[str]] = None, fs: int = FS) -> List[str]:
    """Materialize the case corpus under ``root`` in the reference's
    ``Songs/<piece>/`` layout; returns the piece names written."""
    from real_time_audio_sync_tpu_torch.utils.wavio import write_wav

    names = list(cases) if cases is not None else list(CASES)
    for name in names:
        seed, n_beats, ref_r, live_r = CASES[name]
        chart = _chart(seed, n_beats)
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        for idx, rend in ((0, ref_r), (1, live_r)):
            wav, beat_times = render(chart, rend, fs)
            base = os.path.join(d, f"{name}_{idx:02d}")
            write_wav(base + ".wav", wav)
            with open(base + ".csv", "w", newline="") as f:
                w = csv.writer(f)
                for beat, t_sec in enumerate(beat_times, start=1):
                    w.writerow([f"{t_sec:.6f}", beat])
    return names
