"""The serving mesh: the cards that a batch's lanes are sharded over.

Port of ``repro/launch/mesh.py`` (``LANES_AXIS``, ``make_serving_mesh``,
``forced_host_devices_env``).  The reference's mesh is a JAX ``Mesh``; the
port's is a plain 1-D tuple of ``torch.device``, one entry a **shard**.
Every lane of a fixed-lane batch (``serving/batched.py``) is an independent
loop over its own buffers, so the lanes split over a single ``"lanes"`` axis:
lane ``i`` lives on shard ``i // (batch_size / D)``, with no tensor axis and
no traffic between shards on the hot path.

A shard has its own executor, slot, CUDA graphs and stream even where two
shards share one card, so :func:`simulated_devices` (``n`` copies of one
device) gives a mesh of ``n`` shards on one CPU or one card: the port's
counterpart of the reference's ``--xla_force_host_platform_device_count``.
``make_production_mesh`` and ``DP_AXES`` (the LM pod meshes) are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["LANES_AXIS", "ServingMesh", "make_serving_mesh", "simulated_devices"]

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
