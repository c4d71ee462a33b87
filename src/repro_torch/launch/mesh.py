"""The meshes: the cards that a batch's lanes, or an LM's tensors, are sharded over.

Port of ``repro/launch/mesh.py`` (``LANES_AXIS``, ``make_serving_mesh``,
``make_production_mesh``, ``DP_AXES``).  The reference's mesh is a JAX ``Mesh``; the
port's is a plain 1-D tuple of ``torch.device``, one entry a **shard**.
Every lane of a fixed-lane batch (``serving/batched.py``) is an independent
loop over its own buffers, so the lanes split over a single ``"lanes"`` axis:
lane ``i`` lives on shard ``i // (batch_size / D)``, with no tensor axis and
no traffic between shards on the hot path.

A shard has its own executor, slot, CUDA graphs and stream even where two
shards share one card, so :func:`simulated_devices` (``n`` copies of one
device) gives a mesh of ``n`` shards on one CPU or one card: the port's
counterpart of the reference's ``--xla_force_host_platform_device_count``.

The LM's mesh (:class:`LMMesh`) is n-dimensional, ``("data", "model")`` or
``("pod", "data", "model")``, and one process drives all of its shards
(``models/lm/sharding.py``): a device may repeat there too, and the
``meta`` device gives the dry run's 256 or 512 shards without memory
(:func:`make_production_mesh`).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from functools import cached_property

import torch

__all__ = ["DP_AXES", "LANES_AXIS", "LMMesh", "ServingMesh", "make_lm_mesh",
           "make_production_mesh", "make_serving_mesh", "simulated_devices"]

#: The 1-D serving mesh axis: a batch's lanes are data-parallel over it.
LANES_AXIS = "lanes"


@dataclass(frozen=True)
class ServingMesh:
    """A 1-D mesh of shards: ``devices`` (one ``torch.device`` a shard, a
    device may repeat) over the axis ``axis_names == ("lanes",)``."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = (LANES_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_serving_mesh(n_devices: int | None = None, *, devices=None) -> ServingMesh:
    """1-D ``("lanes",)`` mesh over ``devices`` (default: every visible card,
    ``cuda:0 .. cuda:{device_count - 1}``), its first ``n_devices`` (default:
    all of them).  Raises when ``n_devices`` is below 1 or above the devices
    given; the message names :func:`simulated_devices`, the recipe for more
    shards than cards."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    n = len(devs) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n}")
    if n > len(devs):
        raise ValueError(
            f"n_devices={n} but only {len(devs)} devices are visible; to simulate {n} shards "
            f"on one device pass devices=simulated_devices({n}, device)")
    return ServingMesh(tuple(devs[:n]))


def simulated_devices(n: int, device) -> tuple[torch.device, ...]:
    """``n`` copies of ``device``: the devices of an ``n``-shard mesh on one
    CPU or one card (each shard still gets its own executor and stream)."""
    if int(n) < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    return (torch.device(device),) * int(n)


@dataclass(frozen=True)
class LMMesh:
    """An n-dimensional mesh of shards for the LM: ``dims`` shards along the
    axes ``axis_names``, and ``devices``, one ``torch.device`` a shard in
    row-major order (a device may repeat).  ``shape`` maps an axis name to its
    size, as a JAX ``Mesh``'s does."""

    devices: tuple[torch.device, ...]
    dims: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    @cached_property
    def coords(self) -> tuple[tuple[int, ...], ...]:
        """Each shard's coordinates, in the order of ``devices``."""
        return tuple(itertools.product(*(range(n) for n in self.dims)))

    def axis_size(self, axis) -> int:
        """The size of ``axis``: None (1), a name, or a tuple of names."""
        if axis is None:
            return 1
        names = (axis,) if isinstance(axis, str) else axis
        return math.prod(self.shape[a] for a in names)

    def axis_index(self, coord, axis) -> int:
        """A shard's index along ``axis`` (row-major over a tuple of names)."""
        if axis is None:
            return 0
        idx = 0
        for a in (axis,) if isinstance(axis, str) else axis:
            i = self.axis_names.index(a)
            idx = idx * self.dims[i] + coord[i]
        return idx

    def groups(self, axis) -> list[list[int]]:
        """The shards that differ only along ``axis``: lists of shard numbers,
        each ordered by the index along ``axis``."""
        out: dict = {}
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        rest = [i for i, a in enumerate(self.axis_names) if a not in names]
        for n, coord in enumerate(self.coords):
            out.setdefault(tuple(coord[i] for i in rest), []).append(n)
        return [sorted(g, key=lambda n: self.axis_index(self.coords[n], names))
                for g in out.values()]


def make_lm_mesh(dims, axis_names=("data", "model"), *, devices=None) -> LMMesh:
    """An :class:`LMMesh` of shape ``dims`` over ``devices`` (default: the
    visible cards, which must number ``prod(dims)``; pass
    :func:`simulated_devices` for more shards than cards)."""
    dims = tuple(int(n) for n in dims)
    if len(dims) != len(axis_names) or min(dims) < 1:
        raise ValueError(f"mesh dims {dims} do not fit the axes {tuple(axis_names)}")
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = tuple(torch.device(d) for d in devices)
    if len(devs) != math.prod(dims):
        raise ValueError(
            f"a {dims} mesh needs {math.prod(dims)} devices, {len(devs)} given; to simulate "
            f"its shards on one device pass devices=simulated_devices({math.prod(dims)}, device)")
    return LMMesh(devs, dims, tuple(axis_names))


def make_production_mesh(multi_pod: bool = False, devices=None) -> LMMesh:
    """The reference's pod meshes: (16, 16) over ``("data", "model")``, or with
    ``multi_pod`` (2, 16, 16) over ``("pod", "data", "model")``.

    ``devices=None`` puts every shard on the ``meta`` device: tensors placed
    there have shapes and types but no storage, which is what the dry run
    (``launch/dryrun.py``) needs of 256 or 512 shards."""
    dims = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if devices is None:
        devices = simulated_devices(math.prod(dims), "meta")
    return make_lm_mesh(dims, axes, devices=devices)


def DP_AXES(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)
