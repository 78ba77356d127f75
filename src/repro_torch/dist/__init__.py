"""Distribution substrate: sharding rules (:mod:`repro_torch.dist.sharding`),
elastic meshes, delta gradient compression
(:mod:`repro_torch.dist.grad_compress`), pipeline parallelism
(:mod:`repro_torch.dist.pipeline`) — and the sharded serving fleet.

Everything is mesh-optional: with no active mesh the sharding helpers are
no-ops, so single-device code paths (the DeltaGRU streaming engine, unit
tests) never pay for the machinery. The port's mesh lists one device k
times (a device listed k times hosts k shards).

The serving-fabric entry points re-exported here:

* :class:`~repro_torch.dist.serving.ShardedStreamFleet` — stream slots
  sharded over a ``("data", "model")`` mesh, one engine a shard, a tick
  one CUDA graph replay a shard, elastic scale-down with
  drain-checkpoints;
* :func:`~repro_torch.dist.elastic.best_mesh` / ``scale_event`` — the
  mesh factory and remesh planner the fleet consumes.

The async front door (``StreamRouter``) and the load generator live on
the serving side: :mod:`repro_torch.serve.router` /
:mod:`repro_torch.serve.loadgen` (re-exported from ``repro_torch.serve``).
"""
from repro_torch.dist.elastic import best_mesh, scale_event

__all__ = ["ShardedStreamFleet", "best_mesh", "scale_event"]


def __getattr__(name):
    # Lazy, as in the JAX package: the fleet pulls in the serving engine,
    # which the serve side's router must not import through this package.
    if name == "ShardedStreamFleet":
        from repro_torch.dist.serving import ShardedStreamFleet
        return ShardedStreamFleet
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
