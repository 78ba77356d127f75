"""Serving: the streaming delta-RNN engine (compiled-program driven, one
CUDA graph replay a step on the card, per-stream sessions, a frame guard on
the device, snapshot/rollback and checkpoint/restore), its request
scheduler ``GruStreamBatcher`` (alias ``DeltaStreamBatcher``), the
resilience tier: ``resilience.ResilientStreamServer`` (quarantine, shed,
overload and restart supervision) with ``faults.FaultPlan`` as its seeded
chaos harness, and the distributed serving fabric's front door:
``router.StreamRouter`` (JSQ over bounded per-shard queues, fabric or
pool mode, elastic ``scale_down`` replay) plus the ``loadgen`` open-loop
Poisson harness. The sharded fleet itself is
``repro_torch.dist.serving.ShardedStreamFleet`` (re-exported from
``repro_torch.dist``)."""
from repro_torch.serve.engine import DeltaStreamEngine, GruStreamEngine
from repro_torch.serve.loadgen import poisson_arrivals, run_fabric_load
from repro_torch.serve.resilience import (ResiliencePolicy,
                                          ResilientStreamServer, ServeResult)
from repro_torch.serve.router import RouterPolicy, RouterResult, StreamRouter
from repro_torch.serve.scheduler import DeltaStreamBatcher, GruStreamBatcher

__all__ = [
    "DeltaStreamEngine", "GruStreamEngine",
    "DeltaStreamBatcher", "GruStreamBatcher",
    "ResiliencePolicy", "ResilientStreamServer", "ServeResult",
    "StreamRouter", "RouterPolicy", "RouterResult",
    "poisson_arrivals", "run_fabric_load",
]
