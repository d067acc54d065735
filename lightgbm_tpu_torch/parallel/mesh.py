"""Device meshes and the collectives over them — the port of the mesh half
of ``lightgbm_tpu/parallel/data_parallel.py`` (``make_mesh``,
``shard_rows``) and ``feature_parallel.py`` (``make_mesh_2d``).

The reference is single-controller SPMD: one program per shard under
``shard_map``, talking through ``lax.psum`` / ``psum_scatter`` /
``ppermute`` / ``all_gather`` / ``axis_index``.  PyTorch has no
``shard_map``, so the port keeps one process and one public call and makes
the shard axis explicit:

* a :class:`Mesh` is an ordered list of ``D`` ``torch.device``\\ s with a
  1-D ``("data",)`` / ``("feature",)`` or 2-D ``("data", "feature")``
  shape;
* per-shard state is a Python list of tensors, one on each shard's device,
  rows split in order (:func:`shard_rows`);
* the collectives are plain functions over such lists.  A hop between
  shards is ``Tensor.to(device, non_blocking=True)``: a no-op for virtual
  shards (several shards on one device), a peer copy between cards.  Sums
  run in a fixed order, shard 0 first, with no float atomics, so a result
  does not depend on timing (ROADMAP "Determinism is part of the
  contract").

How many devices: the CUDA devices visible, or with
:func:`set_virtual_devices` (or ``LIGHTGBM_TPU_TORCH_VIRTUAL_DEVICES=n`` in
the environment) ``n`` virtual shards on the Dataset's device — the
counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count`` CPU mesh, off by
default.  The CPU tests use it at ``n = 8``; ``chip_smoke.py`` uses it on
one card.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"
FEATURE_AXIS = "feature"

# the process-wide default, as the reference's XLA flag is an environment
# setting: LIGHTGBM_TPU_TORCH_VIRTUAL_DEVICES=n (the CLI's route to it)
_VIRTUAL = {"n": int(os.environ.get("LIGHTGBM_TPU_TORCH_VIRTUAL_DEVICES",
                                    "0") or 0)}


def set_virtual_devices(n: int) -> None:
    """Place ``n`` virtual shards on the training Dataset's device (0: off,
    the default; then the mesh takes the visible CUDA devices).  One
    process-wide setting, as the reference's XLA flag is."""
    n = int(n)
    if n < 0:
        raise ValueError(f"virtual device count must be >= 0, got {n}")
    _VIRTUAL["n"] = n


def visible_devices(base: torch.device) -> List[torch.device]:
    """The devices a mesh on ``base``'s platform may use: ``n`` copies of
    ``base`` under :func:`set_virtual_devices`, else every CUDA device for
    a CUDA ``base`` (``base`` first), else ``[base]``."""
    base = torch.device(base)
    if _VIRTUAL["n"] > 0:
        return [base] * _VIRTUAL["n"]
    if base.type == "cuda":
        first = base.index if base.index is not None else \
            torch.cuda.current_device()
        n = torch.cuda.device_count()
        return [torch.device("cuda", (first + i) % n) for i in range(n)]
    return [base]


class Mesh:
    """An ordered list of devices with a 1-D or 2-D shape (row-major: shard
    ``(i, j)`` is ``devices[i * shape[1] + j]``)."""

    def __init__(self, devices: Sequence[torch.device],
                 shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        devices = [torch.device(d) for d in devices]
        size = 1
        for s in shape:
            size *= int(s)
        if len(devices) != size or len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} over {axis_names} needs "
                             f"{size} devices, got {len(devices)}")
        self.devices = devices
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """Shard 0's device: where the replicated tree work runs."""
        return self.devices[0]

    def axis_size(self, name: str) -> int:
        return (self.shape[self.axis_names.index(name)]
                if name in self.axis_names else 1)

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, axes={self.axis_names}, "
                f"devices={[str(d) for d in self.devices]})")


def make_mesh(n_devices: Optional[int] = None, devices=None,
              axis_name: str = DATA_AXIS,
              base: Optional[torch.device] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (``devices``, else
    :func:`visible_devices` of ``base``, default ``cuda``)."""
    if devices is None:
        devices = visible_devices(base if base is not None else "cuda")
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)}; call "
                f"parallel.set_virtual_devices({n_devices}) for virtual "
                "shards on one device")
        devices = devices[:n_devices]
    return Mesh(devices, (len(devices),), (axis_name,))


def make_mesh_2d(n_data: int, n_feature: int, devices=None,
                 base: Optional[torch.device] = None) -> Mesh:
    """2-D (rows x features) mesh ``[n_data, n_feature]`` over
    ``("data", "feature")``."""
    if devices is None:
        devices = visible_devices(base if base is not None else "cuda")
    need = int(n_data) * int(n_feature)
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh(list(devices)[:need], (int(n_data), int(n_feature)),
                (DATA_AXIS, FEATURE_AXIS))


def row_bounds(n: int, n_shards: int) -> List[Tuple[int, int]]:
    """Contiguous equal row ranges ``[(start, stop)]`` of ``n`` rows over
    ``n_shards`` (``n`` must divide evenly, as the reference's sharding
    requires)."""
    if n % n_shards:
        raise ValueError(f"{n} rows do not divide over {n_shards} shards")
    w = n // n_shards
    return [(d * w, (d + 1) * w) for d in range(n_shards)]


def shard_rows(devices: Sequence[torch.device], x: torch.Tensor
               ) -> List[torch.Tensor]:
    """``x``'s rows split in order over ``devices``: shard ``d`` holds rows
    ``[d * n/D, (d + 1) * n/D)`` on ``devices[d]`` (a view of ``x`` for a
    shard on ``x``'s own device)."""
    return [x[a:b].to(dev, non_blocking=True)
            for (a, b), dev in zip(row_bounds(x.shape[0], len(devices)),
                                   devices)]


def gather_rows(shards: Sequence[torch.Tensor],
                device: torch.device) -> torch.Tensor:
    """The shards' rows concatenated in shard order on ``device``."""
    return torch.cat([s.to(device, non_blocking=True) for s in shards])


# ---------------------------------------------------------------------------
# Collectives over per-shard lists (the reference's lax collectives)
# ---------------------------------------------------------------------------


def _put(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return x if x.device == dev else x.to(dev, non_blocking=True)


def place_tables(tables, dev: torch.device, sl: Optional[slice] = None,
                 host: Tuple[str, ...] = ()):
    """A namedtuple of tables on a shard: every field sliced to ``sl`` on
    its leading axis (None: whole) and moved to ``dev``, contiguous; None
    fields stay None and the fields named in ``host`` are sliced but stay
    where they are.  A whole field already on ``dev`` is returned as it is,
    so the tables cached by its identity stay valid."""
    def one(name, a):
        if a is None:
            return None
        a = a if sl is None else a[sl]
        return (a if name in host else a.to(dev)).contiguous()

    return type(tables)(*(one(n, a) for n, a in zip(tables._fields,
                                                     tables)))


def axis_index(shard: int) -> int:
    """``lax.axis_index``: a shard's position on its axis."""
    return int(shard)


def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``lax.psum``: the sum over shards in shard order (shard 0 first,
    accumulated on shard 0's device), copied back to every shard."""
    dev0 = xs[0].device
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + _put(x, dev0)
    return [_put(acc, x.device) for x in xs]


def psum_scatter(xs: Sequence[torch.Tensor], dim: int
                 ) -> List[torch.Tensor]:
    """``lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``: shard
    ``d`` receives chunk ``d`` of ``dim`` summed over shards in shard
    order."""
    n = len(xs)
    size = xs[0].shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} of size {size} does not tile "
                         f"over {n} shards")
    w = size // n
    out = []
    for d, x_d in enumerate(xs):
        acc = _put(xs[0].narrow(dim, d * w, w), x_d.device)
        for x in xs[1:]:
            acc = acc + _put(x.narrow(dim, d * w, w), x_d.device)
        out.append(acc)
    return out


def ppermute(xs: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]
             ) -> List[torch.Tensor]:
    """``lax.ppermute``: shard ``dst`` receives shard ``src``'s tensor for
    every ``(src, dst)`` in ``perm``; a shard that is no destination gets
    zeros."""
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    for src, dst in perm:
        out[dst] = _put(xs[src], xs[dst].device)
    return [torch.zeros_like(x) if o is None else o
            for x, o in zip(xs, out)]


def all_gather(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``lax.all_gather``: every shard receives the ``[D, ...]`` stack of
    all shards' tensors."""
    out = []
    for x_d in xs:
        out.append(torch.stack([_put(x, x_d.device) for x in xs]))
    return out
