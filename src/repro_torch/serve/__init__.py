"""Serving: the streaming delta-RNN engine (compiled-program driven, one
CUDA graph replay a step on the card, per-stream sessions, a frame guard on
the device, snapshot/rollback and checkpoint/restore), its request
scheduler ``GruStreamBatcher`` (alias ``DeltaStreamBatcher``), and the
resilience tier: ``resilience.ResilientStreamServer`` (quarantine, shed,
overload and restart supervision) with ``faults.FaultPlan`` as its seeded
chaos harness."""
from repro_torch.serve.engine import DeltaStreamEngine, GruStreamEngine
from repro_torch.serve.resilience import (ResiliencePolicy,
                                          ResilientStreamServer, ServeResult)
from repro_torch.serve.scheduler import DeltaStreamBatcher, GruStreamBatcher

__all__ = [
    "DeltaStreamEngine", "GruStreamEngine",
    "DeltaStreamBatcher", "GruStreamBatcher",
    "ResiliencePolicy", "ResilientStreamServer", "ServeResult",
]
