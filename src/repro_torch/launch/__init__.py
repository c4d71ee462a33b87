"""Launchers of the port: ``python -m repro_torch.launch.serve``, and the
serving mesh its sharded modes build (``launch/mesh.py``)."""
from repro_torch.launch.mesh import (
    LANES_AXIS,
    ServingMesh,
    make_serving_mesh,
    simulated_devices,
)

__all__ = ["LANES_AXIS", "ServingMesh", "make_serving_mesh", "simulated_devices"]
