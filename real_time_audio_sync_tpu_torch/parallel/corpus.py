"""Corpus alignment: a batch of song pairs aligned in one call (the JAX
package's ``parallel/corpus.py``).

Alignment of different pairs is embarrassingly parallel.
:func:`pad_pairs` zero-pads ragged feature sequences to common shapes
with their true lengths beside them, and :func:`batched_set_live` aligns
the batch in one call: by default through the whole-pair set_live kernel
over a grid of pairs (``ops/otw_set_live.pallas_batched_set_live``, TPU
kernel ``_pallas_batched_set_live``, one launch for the batch), or through
the online engine's batched dense scan (``backend="dense"``, and float64).

The JAX package's ``mesh=`` (the pair axis sharded over chips),
``corpus_mesh`` and ``sharded_chroma_frames`` have no counterpart on one
card yet (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from real_time_audio_sync_tpu_torch.config import OTWParams
from real_time_audio_sync_tpu_torch.features.chroma import torch_dtype
from real_time_audio_sync_tpu_torch.models.online_core import OnlineConfig, init_state, set_live_scan_body
from real_time_audio_sync_tpu_torch.ops.otw_set_live import pallas_batched_set_live


def pad_pairs(
    refs: Sequence[np.ndarray],
    lives: Sequence[np.ndarray],
    pad_multiple: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Zero-pad (F, Nᵢ)/(F, Tᵢ) feature sequences to common shapes.

    Returns ``(refs (B,F,N), lives (B,F,T), ref_lens (B,), live_lens (B,))``,
    numpy, the lengths int32.  True lengths feed the engines' stop
    conditions, so padding never changes alignment results."""
    def _round(x):
        return -(-x // pad_multiple) * pad_multiple

    f = refs[0].shape[0]
    n = _round(max(r.shape[1] for r in refs))
    t = _round(max(l.shape[1] for l in lives))
    b = len(refs)
    refs_out = np.zeros((b, f, n), refs[0].dtype)
    lives_out = np.zeros((b, f, t), lives[0].dtype)
    for i, (r, l) in enumerate(zip(refs, lives)):
        refs_out[i, :, : r.shape[1]] = r
        lives_out[i, :, : l.shape[1]] = l
    return (
        refs_out,
        lives_out,
        np.asarray([r.shape[1] for r in refs], np.int32),
        np.asarray([l.shape[1] for l in lives], np.int32),
    )


def batched_set_live(
    refs,
    lives,
    ref_lens,
    live_lens,
    params,
    mesh=None,
    dtype=np.float32,
    sentinel: float = 1e10,
    run_count_init: int = 1,
    monotone_path: bool = False,
    euclidean: bool = False,
    backend: str = "banded",
    *,
    device="cuda",
) -> Tuple[List[np.ndarray], torch.Tensor]:
    """Align a batch of padded pairs (:func:`pad_pairs`' layout) on
    ``device``.  Returns (per-pair (Lᵢ, 2) int32 paths, the mean path
    length as a 0-d float32 tensor on ``device``).

    ``backend="banded"`` (default) in float32: the whole-pair set_live
    kernel on each pair's true lengths, one launch for the batch (its plain
    version on the CPU).  ``backend="dense"``, and float64 under
    ``"banded"``: the online engine's batched scan carrying the dense
    (2N, N) accumulator a pair (at most 8 GB a pair).  Committed paths are
    identical."""
    if backend not in ("banded", "dense"):
        raise ValueError(f"unknown backend {backend!r}; choose 'banded' or 'dense'")
    if mesh is not None:
        raise NotImplementedError("mesh=: pair sharding over several cards is not ported yet "
                                  "(ROADMAP Queue 1 item 9)")
    device = torch.device(device)
    p = OTWParams.from_any(params)
    ref_lens = [int(n) for n in np.asarray(ref_lens)]
    live_lens = [int(t) for t in np.asarray(live_lens)]
    if backend == "banded" and np.dtype(dtype) == np.float32:
        out = pallas_batched_set_live(
            [refs[i][:, :n] for i, n in enumerate(ref_lens)],
            [lives[i][:, :t] for i, t in enumerate(live_lens)],
            p, monotone_path=monotone_path, euclidean=euclidean, sentinel=sentinel,
            run_count_init=run_count_init, device=device)
        paths = [o[0] for o in out]
        return paths, torch.tensor([len(q) for q in paths], dtype=torch.float32, device=device).mean()

    cfg = OnlineConfig(c=p.c, max_run_count=p.max_run_count, sentinel=sentinel, run_count_init=run_count_init,
                       monotone_path=monotone_path, euclidean=euclidean)
    dt = torch_dtype(dtype)
    refs = torch.as_tensor(np.asarray(refs)).to(device=device, dtype=dt)
    lives = torch.as_tensor(np.asarray(lives)).to(device=device, dtype=dt)
    out = set_live_scan_body(init_state(refs, cfg, dt), lives, refs, cfg,
                             live_len=torch.tensor(live_lens, dtype=torch.int64, device=device),
                             ref_len=torch.tensor(ref_lens, dtype=torch.int64, device=device))
    path, plen = out.path.cpu().numpy().astype(np.int32), out.path_len.cpu().numpy()
    return [path[i, : plen[i]] for i in range(len(plen))], out.path_len.to(torch.float32).mean()
