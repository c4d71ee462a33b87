"""Serving front ends of the port: one request at a time, or a batch of lanes."""
from repro_torch.serving.batched import (
    BatchedFusedServer,
    BatchResult,
    device_fill,
    gather_lanes,
    sanitize_lane_inputs,
    straggler_report,
)
from repro_torch.serving.server import BiathlonServer, ServerStats

__all__ = [
    "BatchResult",
    "BatchedFusedServer",
    "BiathlonServer",
    "ServerStats",
    "device_fill",
    "gather_lanes",
    "sanitize_lane_inputs",
    "straggler_report",
]
