"""A device mesh over torch devices, and the shards of a batch on it.

:class:`Mesh` stands in for ``jax.sharding.Mesh``: an array of devices of
any shape, one axis name for each dimension.  The JAX package shards a
batch axis over every axis of a mesh at once (``parallel/serving.py:38-47``);
shard ``i`` of a batch of ``B`` is then rows ``[i·B/n, (i+1)·B/n)`` on
``devices.flat[i]``, ``n`` the mesh's size.

Entries may repeat.  The port has no virtual devices: where the JAX tests
split one CPU into 8 (``--xla_force_host_platform_device_count``), a mesh
of the CPU 8 times stands in, and on a machine with one card a mesh of that
card 4 times runs 4 shards side by side.  Each shard keeps its own state
and its own launches wherever its entry lies.

A shard's state is a row slice of the unsharded state (padded shapes are
the batch's, as JAX pads before it shards), so a checkpoint does not depend
on the mesh; :func:`gather_rows` and :func:`scatter_rows` carry rows
between the shards and one stream-ordered tensor.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """``devices``: an array (or nested lists) of torch devices or device
    strings, any shape; ``axis_names``: one name a dimension.  Every entry
    has one device type; a ``"cuda"`` entry without an index means the
    current card, and a CUDA entry on a machine without that card raises."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        if len(names) != arr.ndim:
            raise ValueError(f"{len(names)} axis names for a {arr.ndim}-D device array")
        self.devices = np.empty(arr.shape, dtype=object)
        for i, d in enumerate(arr.flat):
            self.devices.flat[i] = _device(d)
        kinds = {d.type for d in self.devices.flat}
        if len(kinds) > 1:
            raise ValueError(f"a mesh's entries must share one device type, got {sorted(kinds)}")
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, arr.shape))
        self.size = int(arr.size)

    def __repr__(self) -> str:
        return f"Mesh({', '.join(f'{a}={n}' for a, n in self.shape.items())}; {[str(d) for d in self.devices.flat]})"


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh entry {d}: no CUDA device on this machine")
        index = torch.cuda.current_device() if d.index is None else d.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"mesh entry {d}: only {torch.cuda.device_count()} CUDA devices")
        d = torch.device("cuda", index)
    return d


def on_device(device: torch.device):
    """``torch.cuda.device(device)``, so that work issued under it runs on
    that card's current stream, or nothing where ``device`` is the CPU or
    already the current card (one shard, or a mesh on the current card)."""
    if device.type != "cuda" or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def require_batch_divisible(mesh: Mesh, b: int) -> None:
    """JAX's check (``parallel/serving.py:49-55``), with its message."""
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    if b % n_dev:
        raise ValueError(
            f"stream count {b} must be divisible by the mesh's {n_dev} "
            f"devices (pad with inactive dummy streams)"
        )


def batch_axis_sharding_put(mesh: Mesh):
    """A function that splits the leading (batch) axis of an array or
    tensor into ``mesh.size`` contiguous shards, over all of the mesh's
    axes, and puts shard i on ``devices.flat[i]`` (JAX
    ``parallel/serving.py:38-46``): it returns the shards in order.  The
    split is :func:`shards`' (a leading axis that does not divide raises
    :func:`require_batch_divisible`'s error)."""

    def put(x) -> List[torch.Tensor]:
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        return [x[sh.rows].to(sh.device, copy=True) for sh in shards(mesh, x.shape[0], None)]

    return put


@dataclasses.dataclass
class Shard:
    """The streams ``rows`` of a batch, on ``device``: the follower keeps
    its state there (``state``), its pinned staging (``staging``) and its
    pending delta rows (``deltas``)."""

    rows: slice
    device: torch.device
    state: Any = None
    staging: Any = None
    deltas: list = dataclasses.field(default_factory=list)


def shards(mesh: Optional[Mesh], b: int, device) -> List[Shard]:
    """One shard a mesh entry, each with B/n streams in stream order (a
    batch that does not divide raises JAX's ``ValueError``), or one shard
    of every stream on ``device`` without a mesh."""
    if mesh is None:
        return [Shard(slice(0, b), torch.device(device))]
    require_batch_divisible(mesh, b)
    n = b // mesh.size
    return [Shard(slice(i * n, (i + 1) * n), d) for i, d in enumerate(mesh.devices.flat)]


def per_device(shard_list: Sequence[Shard], make) -> Dict[torch.device, Any]:
    """``make(device)`` once for each distinct device of the shards: what
    the streams share (a reference) is held once a device."""
    held: Dict[torch.device, Any] = {}
    for sh in shard_list:
        if sh.device not in held:
            held[sh.device] = make(sh.device)
    return held


def gather_rows(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards' rows as one stream-ordered tensor on the first shard's
    device (the tensor itself for one shard)."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(parts[0].device) for p in parts])


def scatter_rows(shard_list: Sequence[Shard], targets: Sequence[torch.Tensor], value: torch.Tensor) -> None:
    """Copy the stream-ordered ``value`` into each shard's tensor in
    ``targets`` (one a shard), row slice by row slice."""
    for sh, t in zip(shard_list, targets):
        t.copy_(value[sh.rows])
