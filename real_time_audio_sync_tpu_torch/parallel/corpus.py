"""Corpus alignment: a batch of song pairs aligned in one call (the JAX
package's ``parallel/corpus.py``).

Alignment of different pairs is embarrassingly parallel.
:func:`pad_pairs` zero-pads ragged feature sequences to common shapes
with their true lengths beside them, and :func:`batched_set_live` aligns
the batch in one call: by default through the whole-pair set_live kernel
over a grid of pairs (``ops/otw_set_live.pallas_batched_set_live``, TPU
kernel ``_pallas_batched_set_live``, one launch for the batch), or through
the online engine's batched dense scan (``backend="dense"``, and float64).

With ``mesh=`` (:func:`corpus_mesh`, or any :class:`~real_time_audio_sync_tpu_torch.
parallel.mesh.Mesh`) the pair axis is split over the mesh's entries, one
launch (or one batched scan) a shard on its entry's device, with no
exchange between shards; the mean path length is the one reduction over
every shard's lengths.  :func:`sharded_chroma_frames` splits the frames
axis of the feature frontend the same way and gathers the chromagram.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from real_time_audio_sync_tpu_torch.config import OTWParams
from real_time_audio_sync_tpu_torch.features.chroma import chroma_frames, torch_dtype
from real_time_audio_sync_tpu_torch.models.online_core import OnlineConfig, init_state, set_live_scan_body
from real_time_audio_sync_tpu_torch.ops.otw_set_live import pallas_batched_set_live
from real_time_audio_sync_tpu_torch.parallel.mesh import Mesh, shards

#: the JAX package's long-pair threshold (``ops/pallas_otw.py``'s
#: ``_SET_LIVE_LONG_N``): from this padded n_max + t_max on, its banded
#: route runs the pairs one by one and takes a float64 mean of their
#: lengths.  The port has one kernel for every length; only the mean's
#: arithmetic follows the threshold.
_SET_LIVE_LONG_N = 12000


def corpus_mesh(n_devices: Optional[int] = None, axis: str = "data", *, device="cuda") -> Mesh:
    """A 1-D mesh named ``axis``: the first ``n_devices`` cards (all of
    them by default, sliced as JAX slices ``jax.devices()``), or with
    ``device="cpu"`` the CPU ``n_devices`` times (default once).  Asks for
    the card unless the caller asks for the CPU; with no card it raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("corpus_mesh: no CUDA device on this machine (pass device='cpu')")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())][:n_devices]
    else:
        devices = [device] * (1 if n_devices is None else int(n_devices))
    return Mesh(np.asarray(devices, dtype=object), (axis,))


def mean_path_length(lengths, long_pairs: bool = False) -> np.float32:
    """The JAX package's mean path length, bit for bit: its ``jnp.mean``
    (an XLA reduction) multiplies the float32 sum by float32(1/B)
    (``parallel/corpus.py:90,235``); its long-pair route takes the float64
    mean and the port rounds it to float32 (``:219``).  Lengths are
    integers, so a float32 sum is exact below 2^24 in any order."""
    lengths = np.asarray(lengths, np.int64)
    if long_pairs:
        return np.float32(np.mean(lengths.astype(np.float64)))
    return np.float32(lengths.sum()) * (np.float32(1) / np.float32(len(lengths)))


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
    mesh: Optional[Mesh] = None,
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
    ``device``, or sharded over ``mesh`` (B divisible by its size; its
    entries decide the devices).  Returns (per-pair (Lᵢ, 2) int32 paths, the
    mean path length as a 0-d float32 tensor on the first device, equal to
    the JAX package's).

    ``backend="banded"`` (default) in float32: the whole-pair set_live
    kernel on each pair's true lengths, one launch a shard (its plain
    version on the CPU); JAX runs pairs from 12,000 padded frames one by
    one on its default device, and the port shards them like any other.
    ``backend="dense"``, and float64 under ``"banded"``: the online
    engine's batched scan a shard, carrying the dense (2N, N) accumulator a
    pair (at most 8 GB a pair).  Committed paths are identical."""
    if backend not in ("banded", "dense"):
        raise ValueError(f"unknown backend {backend!r}; choose 'banded' or 'dense'")
    p = OTWParams.from_any(params)
    ref_lens = [int(n) for n in np.asarray(ref_lens)]
    live_lens = [int(t) for t in np.asarray(live_lens)]
    parts = shards(mesh, len(ref_lens), device)
    paths: List[np.ndarray] = []
    if backend == "banded" and np.dtype(dtype) == np.float32:
        for sh in parts:
            rows = range(len(ref_lens))[sh.rows]
            out = pallas_batched_set_live(
                [refs[i][:, : ref_lens[i]] for i in rows], [lives[i][:, : live_lens[i]] for i in rows],
                p, monotone_path=monotone_path, euclidean=euclidean, sentinel=sentinel,
                run_count_init=run_count_init, device=sh.device)
            paths += [o[0] for o in out]
        long_pairs = np.shape(refs)[2] + np.shape(lives)[2] >= _SET_LIVE_LONG_N
    else:
        cfg = OnlineConfig(c=p.c, max_run_count=p.max_run_count, sentinel=sentinel, run_count_init=run_count_init,
                           monotone_path=monotone_path, euclidean=euclidean)
        dt = torch_dtype(dtype)
        for sh in parts:
            r = torch.as_tensor(np.asarray(refs[sh.rows])).to(device=sh.device, dtype=dt)
            l = torch.as_tensor(np.asarray(lives[sh.rows])).to(device=sh.device, dtype=dt)
            out = set_live_scan_body(init_state(r, cfg, dt), l, r, cfg,
                                     live_len=torch.tensor(live_lens[sh.rows], dtype=torch.int64, device=sh.device),
                                     ref_len=torch.tensor(ref_lens[sh.rows], dtype=torch.int64, device=sh.device))
            path, plen = out.path.cpu().numpy().astype(np.int32), out.path_len.cpu().numpy()
            paths += [path[i, : plen[i]] for i in range(len(plen))]
        long_pairs = False  # JAX's dense scan takes its jnp.mean at every length
    mean = mean_path_length([len(q) for q in paths], long_pairs)
    return paths, torch.tensor(mean, dtype=torch.float32, device=parts[0].device)


def sharded_chroma_frames(frames, mesh: Mesh, dtype=np.float32) -> torch.Tensor:
    """The feature frontend with the frames (time) axis split over the
    mesh's ``data`` axis (JAX's ``P("data", None)``, replicated over any
    other axis): each shard's (T/n, n_fft) frames through
    ``features/chroma.chroma_frames`` on its entry, the (12, T) chromagram
    gathered onto the first entry.  As in JAX, a mesh without a ``data``
    axis, or a frame count that the axis does not divide, raises."""
    if "data" not in mesh.axis_names:
        raise ValueError(f"the frames shard over a 'data' mesh axis; the mesh has {mesh.axis_names}")
    n = mesh.shape["data"]
    frames = frames if isinstance(frames, torch.Tensor) else torch.from_numpy(np.asarray(frames))
    frames = frames.to(torch_dtype(dtype))
    if frames.shape[0] % n:
        raise ValueError(f"{frames.shape[0]} frames: the frames axis must be divisible by the mesh's "
                         f"'data' axis of {n}")
    # the entry at each index of the data axis, index 0 of every other axis
    devices = np.moveaxis(mesh.devices, mesh.axis_names.index("data"), 0).reshape(n, -1)[:, 0]
    size = frames.shape[0] // n
    cols = [chroma_frames(frames[i * size : (i + 1) * size].to(d)) for i, d in enumerate(devices)]
    return torch.cat([c.to(devices[0]) for c in cols], dim=1)
