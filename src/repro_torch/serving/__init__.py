"""Serving front ends of the port: one request at a time, a batch of lanes, a
lane table with continuous batching (either sharded over a mesh), and the
arrival-driven runtimes over them."""
from repro_torch.serving.batched import (
    BatchedFusedServer,
    BatchResult,
    chunked_straggler_report,
    device_fill,
    gather_lanes,
    lane_request_inputs,
    sanitize_lane_inputs,
    straggler_report,
    validate_serving_mesh,
)
from repro_torch.serving.continuous import ContinuousBatchedServer
from repro_torch.serving.degrade import (
    DegradationController,
    KnobTier,
    LaneKnobs,
    default_tiers,
    validate_tiers,
)
from repro_torch.serving.faults import (
    ChunkDispatchError,
    FaultProfile,
    FaultyContinuousServer,
    FaultyServer,
    TransientExecutorError,
    corrupt_cache_entry,
    inject_burst,
    poison_lane_carry,
    scramble_chunk_carry,
)
from repro_torch.serving.runtime import (
    AdmissionBatcher,
    Arrival,
    ContinuousServingRuntime,
    RequestRecord,
    RuntimeStats,
    ServingRuntime,
)
from repro_torch.serving.server import BiathlonServer, ServerStats

__all__ = [
    "AdmissionBatcher",
    "Arrival",
    "BatchResult",
    "BatchedFusedServer",
    "BiathlonServer",
    "ChunkDispatchError",
    "ContinuousBatchedServer",
    "ContinuousServingRuntime",
    "DegradationController",
    "FaultProfile",
    "FaultyContinuousServer",
    "FaultyServer",
    "KnobTier",
    "LaneKnobs",
    "RequestRecord",
    "RuntimeStats",
    "ServerStats",
    "ServingRuntime",
    "TransientExecutorError",
    "chunked_straggler_report",
    "corrupt_cache_entry",
    "default_tiers",
    "device_fill",
    "gather_lanes",
    "inject_burst",
    "lane_request_inputs",
    "poison_lane_carry",
    "sanitize_lane_inputs",
    "scramble_chunk_carry",
    "straggler_report",
    "validate_serving_mesh",
    "validate_tiers",
]
