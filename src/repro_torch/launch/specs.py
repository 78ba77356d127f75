"""Sharding specs by rule, the sharding half of the PyTorch port of
:mod:`repro.launch.specs`.

Each function returns a tree of :class:`~repro_torch.dist.sharding.
NamedSharding` (a mesh and a spec) shaped like its input, a tree of
tensors of any device (``meta`` tensors describe a model without
allocating it, as the reference's ``jax.eval_shape`` structures do). The
launcher places its state and batches with them (``device_put``).
"""
from __future__ import annotations

from repro_torch.dist.elastic import Mesh
from repro_torch.dist.sharding import (P, AxisRules, NamedSharding,
                                       enforce_divisibility,
                                       infer_param_specs)
from repro_torch.train.optim import tree_map
from repro_torch.train.trainer import TrainState


def batch_sharding(batch, mesh: Mesh, rules: AxisRules):
    """Each leaf's batch dim on the ``batch`` axes where they divide it,
    the rest replicated."""
    def one(x):
        spec = rules.resolve(*(["batch"] + [None] * (x.ndim - 1)), mesh=mesh)
        spec = enforce_divisibility(spec, x.shape, mesh)
        return NamedSharding(mesh, spec)
    return tree_map(one, batch)


def param_sharding(params, mesh: Mesh, rules: AxisRules):
    specs = infer_param_specs(params, rules=rules, mesh=mesh)
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def train_state_sharding(state: TrainState, mesh: Mesh, rules: AxisRules,
                         opt_rules: AxisRules | None = None) -> TrainState:
    """``opt_rules`` lets the optimizer state shard differently from the
    parameters (ZeRO-1: params data-replicated, mu/nu data-sharded)."""
    opt_rules = opt_rules or rules
    return TrainState(
        params=param_sharding(state.params, mesh, rules),
        opt={"mu": param_sharding(state.opt["mu"], mesh, opt_rules),
             "nu": param_sharding(state.opt["nu"], mesh, opt_rules),
             "step": NamedSharding(mesh, P())})
