"""Pair and corpus evaluation runners (reference tests.py:143-262,
test_simple.py:94-198; the JAX package's ``eval/corpus.py:31-473``).

``align_pair`` extracts the features of both recordings on ``device``,
aligns them with the chosen engine and scores the path against beat
ground truth.  ``CorpusRunner`` mirrors ``test_all``: walk the corpus
directory, form all i<j recording pairs per piece (skipping ``_20b``
excerpts, tests.py:216), evaluate each pair, average the headline metric
(% of path points >3 s off), and cross-check the recorded BSO field path
when one is given (tests.py:245-251).  Pairs with missing audio are
reported and skipped.

Ported so far: ``engine="dtw"`` (offline DTW, the wavefront kernels on a
CUDA device); the online engines (otw, livenote, livenote_v2,
livenote_v2_diff) in ``mode="insert"`` (frame-by-frame streaming through
the tensor engines, the default, as in the JAX package) and
``mode="fused"`` (whole-pair set_live, the set_live kernel on a CUDA
device; a corpus sweep of two or more pairs is one batched launch); and
``engine="wtw"`` in its three modes: "insert" (``AsyncWTW``, the block step
on the device, each due window through the wavefront kernels), "fused"
(the fused WTW kernel up to 128-frame windows, ``AsyncWTW`` above; a corpus
sweep of two or more pairs is one ``FusedMultiStreamWTW`` run, one launch a
block for every pair, or one ``MultiStreamWTW`` run above 128 frames) and
"oracle" (the host ``WTW``).
"""

from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from real_time_audio_sync_tpu_torch.eval.ground_truth import GroundTruth
from real_time_audio_sync_tpu_torch.eval.logs import path_from_field_log
from real_time_audio_sync_tpu_torch.eval.scorer import PathScorer, ScoreResult
from real_time_audio_sync_tpu_torch.features.chroma import wav_to_chroma, wav_to_chroma_diff
from real_time_audio_sync_tpu_torch.models.dtw import _DENSE_BYTES_PER_CELL, _dense_limit_bytes, dtw_auto, dtw_device
from real_time_audio_sync_tpu_torch.models.online_core import ENGINE_OVERRIDES
from real_time_audio_sync_tpu_torch.ops.otw_set_live import pallas_batched_set_live, pallas_set_live
from real_time_audio_sync_tpu_torch.utils.wavio import load_wav

DEFAULT_PARAMS = {"search_band_width": 50, "max_run_count": 3}  # tests.py:140
DEFAULT_WTW_PARAMS = {  # tests.py:174
    "fft_len": 4096,
    "hop_size": 2048,
    "dtw_win_size": 4096 * 10,
    "dtw_hop_size": 2048 * 10,
}

ENGINES = ("dtw", "otw", "livenote", "livenote_v2", "livenote_v2_diff", "wtw")

# Feature memo for corpus sweeps: each recording appears in up to |recs|−1
# pairs of a sweep and in every engine of it.  Keyed by (path, mtime, kind,
# dtype, device), kind "chroma" or "chroma_diff" (tensors on the device) or
# "audio" (the raw samples WTW streams, a host array); LRU oldest-first
# eviction, with the 8-30 MB raw-audio entries capped apart from the
# ~200 KB feature entries (the JAX package's eval/corpus.py:32-63).
_FEAT_CACHE: "OrderedDict[tuple, object]" = OrderedDict()
_FEAT_CACHE_MAX = 64
_FEAT_CACHE_AUDIO_MAX = 12  # raw-audio entries only


def _cache_insert(key: tuple, value) -> None:
    if key[2] == "audio":
        audio_keys = [k for k in _FEAT_CACHE if k[2] == "audio"]
        for k in audio_keys[: max(0, len(audio_keys) + 1 - _FEAT_CACHE_AUDIO_MAX)]:
            del _FEAT_CACHE[k]
    while len(_FEAT_CACHE) >= _FEAT_CACHE_MAX:
        _FEAT_CACHE.popitem(last=False)  # oldest-first
    _FEAT_CACHE[key] = value


def _cached(kind: str, path: str, dtype, device):
    """``path``'s memoised features: the (12, T) chroma or (12, T-1)
    chroma-diff tensor on ``device``, or for kind "audio" its 22.05 kHz
    samples as a host array (``device`` unused)."""
    device = "host" if kind == "audio" else torch.device(device)
    key = (os.path.abspath(path), os.path.getmtime(path), kind, np.dtype(dtype).name, str(device))
    if key in _FEAT_CACHE:
        _FEAT_CACHE.move_to_end(key)  # refresh recency
        return _FEAT_CACHE[key]
    if kind == "audio":
        wav, fs = load_wav(path)
        assert fs == 22050
        value = np.asarray(wav, dtype)
    else:
        extract = {"chroma": wav_to_chroma, "chroma_diff": wav_to_chroma_diff}[kind]
        value = extract(path, dtype=torch.from_numpy(np.zeros(0, dtype)).dtype, device=device)
    _cache_insert(key, value)
    return value


def _cached_chroma(path: str, dtype, device, kind: str = "chroma") -> torch.Tensor:
    """The (12, T) chroma, or (12, T-1) chroma-diff, tensor of ``path`` on
    ``device``, memoised."""
    return _cached(kind, path, dtype, device)


def _feature_kind(engine: str) -> str:
    """livenote_v2_diff aligns chroma-diff (tests.py:156), the rest chroma."""
    return "chroma_diff" if engine == "livenote_v2_diff" else "chroma"


@dataclasses.dataclass
class PairResult:
    ref_wav: str
    live_wav: str
    engine: str
    path: np.ndarray
    score: ScoreResult


def _streaming_path(engine, live_seq) -> List[Tuple[int, int]]:
    """Frame-by-frame streaming (the reference harness regime,
    tests.py:160-163) of the (F, T) ``live_seq``, through the pipelined
    surface when the engine has one: ``insert_nowait`` and a lazy stop
    never wait for the card, and post-stop inserts are frozen no-ops, so
    the committed path is the synchronous ``insert``'s."""
    nowait = getattr(engine, "insert_nowait", None)
    if nowait is not None and hasattr(engine, "flush"):
        for i in range(live_seq.shape[1]):
            if nowait(live_seq[:, i]) == "stop":
                break
        engine.flush()
    else:
        for i in range(live_seq.shape[1]):
            if engine.insert(live_seq[:, i]) == "stop":
                break
    return engine.path


def _online_engine(engine: str, ref_seq, params, dtype, device):
    """The tensor engine of an online ``engine`` name on ``ref_seq``."""
    from real_time_audio_sync_tpu_torch.models import LiveNote, LiveNoteV2, OnlineTimeWarping

    if engine == "otw":
        return OnlineTimeWarping(ref_seq, params, dtype=dtype, device=device)
    if engine == "livenote":
        return LiveNote(ref_seq, params, dtype=dtype, device=device)
    # livenote_v2_diff: Euclidean cost on chroma-diff (tests.py:156)
    return LiveNoteV2(ref_seq, params, chroma_diff=engine == "livenote_v2_diff", dtype=dtype, device=device)


def align_pair(
    ref_wav: str,
    live_wav: str,
    engine: str = "livenote_v2_diff",
    params: Optional[dict] = None,
    dtype=np.float32,
    mode: str = "insert",
    *,
    device="cuda",
) -> PairResult:
    """Align one recording pair with the chosen engine on ``device`` and
    score it.

    ``engine="dtw"`` extracts both chromas, runs the dense offline DTW
    (``models/dtw.dtw_device``; the banded ``dtw_auto`` above the dense
    byte budget) and fetches only the backtracked path.  An online engine
    (the default, ``"livenote_v2_diff"``, on chroma-diff features) in
    ``mode="insert"`` (the default) streams the live features frame by
    frame through its tensor engine (``_streaming_path``, band ``params``
    or :data:`DEFAULT_PARAMS`, in ``dtype``); ``mode="fused"`` aligns the
    whole pair with
    :func:`~real_time_audio_sync_tpu_torch.ops.otw_set_live.pallas_set_live`
    (chroma-diff features for ``livenote_v2_diff``), band ``params`` or
    :data:`DEFAULT_PARAMS` — the fast path for corpus sweeps; set_live's
    direction-first loop can commit slightly different best points than
    streaming insert, as in the reference.  ``engine="wtw"`` streams the
    live recording's samples in ``np.array_split(live, 4096)`` chunks (the
    harness's quirk, tests.py:186) through :class:`AsyncWTW` (``mode=
    "insert"``, k_block 8, in ``dtype``), :class:`FusedWTW` (``mode=
    "fused"``, k_block 8; ``AsyncWTW`` above 128-frame windows) or the host
    :class:`WTW` (``mode="oracle"``, the parity oracle), with ``params`` or
    :data:`DEFAULT_WTW_PARAMS`.  Argument checks are the JAX package's."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    if mode not in ("insert", "fused", "oracle"):
        raise ValueError(f"unknown mode {mode!r}; choose 'insert', 'fused' or 'oracle'")
    if mode == "oracle" and engine != "wtw":
        raise ValueError("mode='oracle' selects the host-side WTW parity loop; "
                         f"{engine!r} has no separate oracle mode (use 'insert')")
    if mode == "fused":
        if engine not in ENGINE_OVERRIDES and engine != "wtw":
            raise ValueError(f"mode='fused' applies to the online engines and wtw; {engine!r} has no fused backend")
        if np.dtype(dtype) != np.float32:
            raise ValueError("mode='fused' runs the float32 device backends; use dtype=float32 "
                             "(the insert mode supports float64)")
    if engine == "wtw":
        path = _wtw_path(ref_wav, live_wav, params or DEFAULT_WTW_PARAMS, dtype, mode, device)
        score = PathScorer.for_pair(ref_wav, live_wav).score(path)
        return PairResult(ref_wav, live_wav, engine, np.asarray(path), score)
    kind = _feature_kind(engine)
    ref_seq = _cached_chroma(ref_wav, dtype, device, kind)
    live_seq = _cached_chroma(live_wav, dtype, device, kind)
    m, n = live_seq.shape[1], ref_seq.shape[1]
    if engine != "dtw" and mode == "fused":
        path, _, _, _ = pallas_set_live(ref_seq, live_seq, params or DEFAULT_PARAMS, **ENGINE_OVERRIDES[engine],
                                        device=device)
    elif engine != "dtw":
        path = _streaming_path(_online_engine(engine, ref_seq, params or DEFAULT_PARAMS, dtype, device), live_seq)
    elif m * n * _DENSE_BYTES_PER_CELL > _dense_limit_bytes():
        # hour-scale pairs: the same delegation as the public DTW()
        path, _, _ = dtw_auto(live_seq, ref_seq, device=device)
    else:
        _, _, points, length = dtw_device(live_seq, ref_seq, device=device)
        path = points[: int(length)].flip(0).cpu().numpy()
    score = PathScorer.for_pair(ref_wav, live_wav).score(path)
    return PairResult(ref_wav, live_wav, engine, np.asarray(path), score)


def _wtw_path(ref_wav: str, live_wav: str, params, dtype, mode: str, device):
    """The committed WTW path of one pair (the JAX package's
    eval/corpus.py:137-170): the live samples in 4096 chunks through the
    engine of ``mode``."""
    from real_time_audio_sync_tpu_torch.config import WTWParams
    from real_time_audio_sync_tpu_torch.models import WTW, AsyncWTW, FusedWTW
    from real_time_audio_sync_tpu_torch.ops.wtw_insert import MAX_W

    wp = WTWParams.from_any(params)
    if mode == "oracle":
        wtw = WTW(ref_wav, params, dtype=dtype, device=device)
    elif mode == "fused" and wp.dtw_win_size // wp.hop_size <= MAX_W:
        wtw = FusedWTW(ref_wav, params, k_block=8, device=device)
    else:  # the insert mode, and the fused mode above the fused kernel's windows
        wtw = AsyncWTW(ref_wav, params, k_block=8, dtype=dtype, device=device)
    live = _cached("audio", live_wav, np.float64, device)
    for buf in np.array_split(live, 4096):  # tests.py:186
        if wtw.insert(buf) == "stop":
            break
    if mode != "oracle":
        wtw.flush()
    return wtw.path


def corpus_pairs(recordings_dir: str) -> List[Tuple[str, str]]:
    """All i<j recording pairs per piece directory (tests.py:211-227),
    skipping ``_20b`` excerpts."""
    pairs = []
    root = recordings_dir.rstrip("/")
    for d in sorted(os.listdir(root)):
        piece_dir = os.path.join(root, d)
        if not os.path.isdir(piece_dir):
            continue
        recs: List[str] = []
        for f in sorted(os.listdir(piece_dir)):
            stem = f[:-4]
            if f.startswith(d) and stem not in recs and not stem.endswith("_20b"):
                recs.append(stem)
        for i in range(len(recs)):
            for j in range(i + 1, len(recs)):
                pairs.append(
                    (os.path.join(piece_dir, recs[i] + ".wav"), os.path.join(piece_dir, recs[j] + ".wav"))
                )
    return pairs


@dataclasses.dataclass
class CorpusReport:
    results: List[PairResult]
    skipped: List[Tuple[str, str]]  # pairs with missing audio
    field_check: Optional[ScoreResult] = None

    @property
    def mean_error(self) -> float:
        """Mean % of path points >3 s off (tests.py:256-262)."""
        errors = [r.score.pct_off_3s for r in self.results]
        if self.field_check is not None:
            errors.append(self.field_check.pct_off_3s)
        return float(np.mean(errors)) if errors else float("nan")


class CorpusRunner:
    """``test_all`` parity (tests.py:199-262), on ``device``: every present
    pair through :func:`align_pair` in turn — or, in ``mode="fused"`` with
    two or more pairs, all of them at once: an online engine through one
    batched set_live launch, WTW as the streams of one
    :class:`~real_time_audio_sync_tpu_torch.parallel.FusedMultiStreamWTW`
    (:class:`~real_time_audio_sync_tpu_torch.parallel.MultiStreamWTW` above
    128-frame windows).  WTW's insert mode runs the pairs in turn through
    ``AsyncWTW``."""

    def __init__(self, recordings_dir: str, engine: str = "livenote_v2_diff", params: Optional[dict] = None,
                 dtype=np.float32, mode: str = "insert", *, device="cuda"):
        self.recordings_dir = recordings_dir
        self.engine = engine
        self.params = params
        self.dtype = dtype
        self.mode = mode  # "insert" (reference regime) | "fused" (fast sweeps)
        self.device = device

    def evaluate(self, field_log: Optional[str] = None, verbose: bool = True) -> CorpusReport:
        results: List[PairResult] = []
        skipped: List[Tuple[str, str]] = []
        present: List[Tuple[str, str]] = []
        for ref_wav, live_wav in corpus_pairs(self.recordings_dir):
            if os.path.exists(ref_wav) and os.path.exists(live_wav):
                present.append((ref_wav, live_wav))
            else:
                skipped.append((ref_wav, live_wav))

        if self.engine == "wtw" and self.mode == "fused" and len(present) > 1:
            # the whole sweep as ONE multi-stream run: every pair a stream,
            # one launch a block for all; per-pair paths equal solo
            # align_pair's (tested)
            results = self._evaluate_wtw_batched(present, verbose)
        elif self.engine in ENGINE_OVERRIDES and self.mode == "fused" and len(present) > 1:
            # online engines: the whole sweep in ONE launch, a grid over
            # pairs; per-pair paths equal solo align_pair's (tested)
            results = self._evaluate_online_batched(present, verbose)
        else:
            for ref_wav, live_wav in present:
                result = align_pair(ref_wav, live_wav, self.engine, self.params, self.dtype, mode=self.mode,
                                    device=self.device)
                results.append(result)
                if verbose:
                    self._print_result(result)

        # recorded-field-path cross-check (tests.py:245-251)
        field_check = None
        if field_log and os.path.exists(field_log):
            bso_ref = os.path.join(self.recordings_dir, "bso", "bso_01.wav")
            bso_live = os.path.join(self.recordings_dir, "bso", "bso_02.wav")
            if os.path.exists(bso_ref[:-4] + ".csv") and os.path.exists(bso_live[:-4] + ".csv"):
                scorer = PathScorer(
                    GroundTruth.from_csv(bso_ref[:-4] + ".csv"),
                    GroundTruth.from_csv(bso_live[:-4] + ".csv"),
                )
                field_check = scorer.score(path_from_field_log(field_log))
                if verbose:
                    print(f"field-log cross-check: >3s={field_check.pct_off_3s:.2f}%")

        report = CorpusReport(results, skipped, field_check)
        if verbose:
            if skipped:
                print(f"skipped {len(skipped)} pairs with missing audio")
            print(f"mean error (% points >3 s off): {report.mean_error:.3f}")
        return report

    def _print_result(self, result: PairResult) -> None:
        s = result.score
        print(
            f"{os.path.basename(result.ref_wav)} vs {os.path.basename(result.live_wav)} "
            f"[{self.engine}]: >1b={s.pct_off_beats[1]:.2f}% "
            f">3b={s.pct_off_beats[3]:.2f}% >3s={s.pct_off_3s:.2f}%"
        )

    def _evaluate_online_batched(self, pairs: List[Tuple[str, str]], verbose: bool) -> List[PairResult]:
        """All pairs through :func:`pallas_batched_set_live` at once (one
        launch on the card); per-pair paths equal solo
        :func:`align_pair` ``(mode="fused")``."""
        if np.dtype(self.dtype) != np.float32:
            raise ValueError("mode='fused' runs the float32 device backends")
        kind = _feature_kind(self.engine)
        refs = [_cached_chroma(ref_wav, np.float32, self.device, kind) for ref_wav, _ in pairs]
        lives = [_cached_chroma(live_wav, np.float32, self.device, kind) for _, live_wav in pairs]
        aligned = pallas_batched_set_live(refs, lives, self.params or DEFAULT_PARAMS,
                                          **ENGINE_OVERRIDES[self.engine], device=self.device)
        results = []
        for (ref_wav, live_wav), (path, _, _, _) in zip(pairs, aligned):
            result = PairResult(ref_wav, live_wav, self.engine, path, PathScorer.for_pair(ref_wav, live_wav).score(path))
            results.append(result)
            if verbose:
                self._print_result(result)
        return results

    def _evaluate_wtw_batched(self, pairs: List[Tuple[str, str]], verbose: bool) -> List[PairResult]:
        """All pairs through one :class:`FusedMultiStreamWTW` (k_block 8; a
        :class:`MultiStreamWTW` above 128-frame windows, JAX
        eval/corpus.py:420-431) on their references, each stream fed its
        live recording in the harness's ``np.array_split(live, 4096)``
        chunks (tests.py:186), ``None`` once they run out; per-pair paths
        equal solo :func:`align_pair` ``(engine="wtw", mode="fused")``."""
        from real_time_audio_sync_tpu_torch.config import WTWParams
        from real_time_audio_sync_tpu_torch.ops.wtw_insert import MAX_W
        from real_time_audio_sync_tpu_torch.parallel import FusedMultiStreamWTW, MultiStreamWTW

        if np.dtype(self.dtype) != np.float32:
            raise ValueError("mode='fused' runs the float32 device backends")
        p = self.params or DEFAULT_WTW_PARAMS
        wp = WTWParams.from_any(p)
        if wp.dtw_win_size // wp.hop_size <= MAX_W:
            ms = FusedMultiStreamWTW([r for r, _ in pairs], p, k_block=8, transfer_dtype="float32",
                                     device=self.device)
        else:
            ms = MultiStreamWTW([r for r, _ in pairs], p, k_block=8, transfer_dtype="float32", device=self.device)
        chunks = [np.array_split(_cached("audio", live_wav, np.float64, self.device), 4096) for _, live_wav in pairs]
        for t in range(max(len(c) for c in chunks)):
            ms.insert([c[t] if t < len(c) else None for c in chunks])
        ms.flush()
        results = []
        for (ref_wav, live_wav), path in zip(pairs, ms.paths()):
            result = PairResult(ref_wav, live_wav, self.engine, np.asarray(path),
                                PathScorer.for_pair(ref_wav, live_wav).score(path))
            results.append(result)
            if verbose:
                self._print_result(result)
        return results


def run_simple(ref_wav: str, live_wav: str, engines: Sequence[str] = ENGINES, dtype=np.float32,
               verbose: bool = True, *, device="cuda") -> Dict[str, PairResult]:
    """The test_simple.py:94-198 smoke run: each engine (by default every
    one, :data:`ENGINES`, as in the JAX package) on one pair in the insert
    mode, with bucket accuracies."""
    out = {}
    for engine in engines:
        result = align_pair(ref_wav, live_wav, engine, dtype=dtype, device=device)
        out[engine] = result
        if verbose:
            s = result.score
            print(
                f"{engine:>16}: >1b={s.pct_off_beats[1]:6.2f}%  >3b={s.pct_off_beats[3]:5.2f}%  "
                f">5b={s.pct_off_beats[5]:5.2f}%  >10b={s.pct_off_beats[10]:5.2f}%  "
                f"sq_err={s.squared_beat_error:10.1f}  n={s.count}"
            )
    return out
