"""Train-step factories and the training loop, the PyTorch port of
:mod:`repro.train.trainer`.

``make_lm_train_step`` builds the step of any registry arch (cross-entropy
plus the MoE aux loss, AdamW with global-norm clipping, an optional
gradient transform for compression, microbatch accumulation);
``make_gru_train_step`` builds the paper's CTC / regression step with QAT.
Both are functional over the parameter trees: the forward (of
:func:`repro_torch.models.lm.lm_forward`, or of
:func:`repro_torch.models.gru_rnn.gru_model_forward` on the ``dense``
backend), gradients by autograd's ``backward`` (the JAX package's
``jax.value_and_grad``), then :func:`repro_torch.train.optim.adam_update`.
``make_lm_train_step_fn`` is the un-compiled step, which runs eagerly, one
PyTorch op at a time, on the device of the parameters.
``make_lm_train_step``, ``make_gru_train_step`` and the launcher's step are
what the reference jits: :class:`CompiledTrainStep` makes each one CUDA
graph on a CUDA device, forward, backward, clip norm and the fused AdamW
update in place over fixed state and batch buffers, replayed once a call
(on the CPU the step stays eager). Under autograd the LM blocks run the
plain scans (:mod:`repro_torch.models.blocks`): the scan kernels have no
backward. The loop handles checkpoint cadence and metric logging.

On a mesh over ranks (one process a device, :mod:`repro_torch.dist.ranks`)
each rank holds the whole state and its rows of the batch. After the
microbatch loop the LM step sums the gradients over the ``batch`` axes'
group in one all-reduce of a flat bucket a dtype (bf16 gradients in
bf16, as the reference's psum adds them; the fp32 metrics ride at the end
of the fp32 bucket) and divides by the group's size, so each rank updates
the same state with the global batch's gradient; the expert stacks that
the expert-parallel MoE splits over the ranks are first summed over the
experts group. Where the mesh's ``model`` axis splits the work (tensor
parallelism, :func:`repro_torch.models.lm.lm_splits`) the ranks of a
``model`` group hold the same rows and compute one loss between them: a
leaf's gradient that a rank computes only its part of (a leaf cut to the
rank's slice, or used whole on the split side, as qwen2.5's ``b_k``
where the KV heads do not split) is summed over ``model`` first, and a
leaf whose gradient ``ranks.psum_grads`` already made whole (the norm
scales) is not. The compiled step captures those collectives in its
graph.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.dist.ranks import (all_gather_bucket, all_reduce_,
                                    axis_group, cut, reduce_scatter_bucket)
from repro_torch.dist.sharding import (P, NamedSharding, _axis_extent,
                                       _map_with_path, _names, block_plan,
                                       block_shape, current_mesh,
                                       current_rules, global_shape,
                                       infer_param_specs, shard_cuts,
                                       sharded_dims, with_sharding_constraint)
from repro_torch.models.gru_rnn import GruTaskConfig, gru_model_forward
from repro_torch.models.lm import lm_forward, lm_splits, vocab_group
from repro_torch.quant.qat import FP32, QatPolicy
from repro_torch.train.losses import ctc_loss_mean, lm_loss, mse_loss
from repro_torch.train.optim import (AdamConfig, adam_update, in_place,
                                     init_adam_state, tree_leaves, tree_map,
                                     updates_in_place)


class TrainState(NamedTuple):
    params: Any
    opt: Any

    @property
    def step(self):
        return self.opt["step"]


def init_train_state(params, opt_cfg: AdamConfig | None = None) -> TrainState:
    return TrainState(params=params, opt=init_adam_state(params))


def _grads(live, what: str):
    """The gradients of ``live`` (leaves that required grad) after
    ``backward``. A leaf without one, cut off from the loss, raises: a
    zero in its place would hide the cut."""
    missing = sum(p.grad is None for p in tree_leaves(live))
    if missing:
        raise RuntimeError(f"{what}: {missing} parameter leaves got no "
                           "gradient (cut off from the loss)")
    return tree_map(lambda p: p.grad, live)


def _in_order(tree) -> list:
    """The leaves of ``tree`` in the order :func:`tree_map` visits them."""
    out = []
    tree_map(out.append, tree)
    return out


def _summed(tensors: list, group) -> list:
    """``tensors`` summed over ``group`` in one all-reduce of a flat bucket
    a dtype, in the order the dtypes first appear (the same on every
    rank); each returned as a view of its bucket, in its own dtype."""
    at: dict = {}
    for i, t in enumerate(tensors):
        at.setdefault(t.dtype, []).append(i)
    views = [None] * len(tensors)
    for dtype, idx in at.items():
        sizes = [tensors[i].numel() for i in idx]
        flat = torch.empty(sum(sizes), dtype=dtype,
                           device=tensors[0].device)
        for i, v in zip(idx, flat.split(sizes)):
            views[i] = v.view(tensors[i].shape)
            views[i].copy_(tensors[i])
        all_reduce_(flat, group)
    return views


def _reduce_over_ranks(grads, metrics: dict, mesh, rules, pending=None):
    """The global batch's gradients and metrics on every rank of a mesh
    over ranks: each gradient summed over the groups its ``pending`` names
    but the data group's, in the order they first appear (the experts
    group for an expert stack the expert-parallel dispatch splits, the
    ``model`` group for a leaf whose gradient a rank computes only its
    part of), one bucket a group and dtype; then every gradient and metric
    summed over the data group and divided by its size (``tokens``
    summed), each in its own dtype.

    ``pending``: per leaf (in ``tree_map``'s order) the groups, as mesh
    axis names, that its gradient still has to be summed over (a
    reduce-scatter summed the others, and divided where it summed the
    data group); by default those of a state that every rank holds whole
    with no split of the work (:func:`_replicated_pending`)."""
    data_axes = _names(rules.resolve("batch", mesh=mesh)[0])
    dp = _axis_extent(mesh, data_axes)
    leaves = _in_order(grads)
    if pending is None:
        pending = _replicated_pending(grads, None, mesh, rules)
    for names in dict.fromkeys(n for p in pending for n in p
                               if n != data_axes):
        on = [names in p for p in pending]
        summed = iter(_summed([g for g, o in zip(leaves, on) if o],
                              axis_group(mesh, names)))
        leaves = [next(summed) if o else g for g, o in zip(leaves, on)]
    on_data = [data_axes in p for p in pending]
    names = sorted(metrics)
    vec = torch.stack([metrics[k].reshape(()).to(torch.float32)
                       for k in names])
    *sums, vec = _summed([g for g, d in zip(leaves, on_data) if d] + [vec],
                         axis_group(mesh, data_axes))

    def mean(x):        # x / 1 is x: no pass over the bucket for it
        return x / dp if dp > 1 else x
    sums = iter(sums)
    it = iter(mean(next(sums)) if d else g for g, d in zip(leaves, on_data))
    grads = tree_map(lambda g: next(it), grads)
    metrics = {k: (vec[i] if k == "tokens" else mean(vec[i])).to(
        metrics[k].dtype) for i, k in enumerate(names)}
    return grads, metrics


def _leaf_splits(params, splits) -> list:
    """Per leaf of ``params`` (``tree_map``'s order) its split in
    ``splits`` (``lm.lm_splits``' tree), or None for every leaf without
    ``splits``."""
    if splits is None:
        return [None] * len(_in_order(params))
    out = []
    tree_map(lambda _, sp: out.append(sp), params, splits)
    return out


def _replicated_pending(params, splits, mesh, rules) -> list:
    """Per leaf (``tree_map``'s order) the sums its gradient takes after
    the backward where every rank holds the whole state and the forward
    splits the work as ``splits`` says (``block_plan`` of ``P()``, as
    :class:`StateLayout` takes them from ``block_plan`` of its specs)."""
    paths = []
    _map_with_path(lambda path, x: paths.append(path), params)
    return [block_plan(path, tuple(x.shape), P(*([None] * x.ndim)), mesh,
                       rules, sp)[1]
            for path, x, sp in zip(paths, _in_order(params),
                                   _leaf_splits(params, splits))]


class StateLayout:
    """A train state laid out over the ranks of ``mesh`` by
    ``state_sharding`` (a :class:`TrainState` of ``NamedSharding``, as
    ``specs.train_state_sharding`` builds it): what the LM step does with
    each parameter leaf, in ``tree_map``'s order. Built from this rank's
    blocks (``params``); everything here is a function of the specs, the
    global shapes and the mesh, the same at every step.

    * ``p_specs``: the parameters' specs, the tree the forward gathers by;
    * ``scatters``: per leaf, ``(mesh axis names, dim)`` of each
      reduce-scatter that takes a gradient from the parameters' layout to
      the moments' (a sum that the moments' spec shards a dim over and the
      parameters' does not), in the order of the sums;
    * ``cuts``: per leaf, the ``ranks.cut`` of the moments' other
      sharded dims that the parameters' do not shard: the gradient (and
      the parameter, for the update) cut to the rank's slice;
    * ``extra``: per leaf, ``(dim, mesh axis names)`` of every dim the
      moments shard and the parameters do not (the scatters' and the
      cuts'): the parameter is cut to them for the update and all-gathered
      back over them after it;
    * ``pending``: per leaf, the sums left for the step's bucket;
    * ``norm_over``: the clip norm's leaves and group where a moment leaf
      is sharded (``optim.global_norm``), else None.

    ``splits``: the forward's split of the work (``lm.lm_splits``, a tree
    shaped like ``params``), which decides each leaf's gathers and sums
    (``block_plan``); None: no split."""

    def __init__(self, params, state_sharding, mesh, rules, splits=None):
        self.mesh = mesh
        p_sh = state_sharding.params
        mu_sh, nu_sh = state_sharding.opt["mu"], state_sharding.opt["nu"]
        # keyed by the parameters' tree: the trees may list their keys in
        # other orders
        self.p_specs = tree_map(lambda _, s: s.spec, params, p_sh)
        sp = _in_order(self.p_specs)
        so = _in_order(tree_map(lambda _, s: s.spec, params, mu_sh))
        if _in_order(tree_map(lambda _, s: s.spec, params, nu_sh)) != so:
            raise NotImplementedError("the two moments laid out apart")
        paths = []
        _map_with_path(lambda path, x: paths.append(path), params)
        blocks = _in_order(params)
        leaf_splits = _leaf_splits(params, splits)
        self.shapes = [global_shape(b.shape, s, mesh)
                       for b, s in zip(blocks, sp)]
        data = _names(rules.resolve("batch", mesh=mesh)[0])
        self.dp = _axis_extent(mesh, data)
        self.data = data
        self.so = so
        self.scatters, self.cuts, self.pending, self.extra = [], [], [], []
        for path, shape, a, b, split in zip(paths, self.shapes, sp, so,
                                            leaf_splits):
            have = dict(sharded_dims(a, mesh))
            want = dict(sharded_dims(b, mesh))
            if any(want.get(d) != n for d, n in have.items()):
                raise NotImplementedError(
                    f"{'/'.join(map(str, path))}: moments laid out by {b} "
                    f"do not refine the parameters' {a}")
            extra = {d: n for d, n in want.items() if d not in have}
            self.extra.append(sorted(extra.items()))
            _, pending = block_plan(path, shape, a, mesh, rules, split)
            scat, left = [], []
            for names in pending:
                d = next((d for d, n in extra.items() if n == names), None)
                if d is None:
                    left.append(names)
                else:
                    scat.append((names, d))
                    del extra[d]
            self.scatters.append(tuple(scat))
            self.cuts.append(shard_cuts(sorted(extra.items()), mesh))
            self.pending.append(tuple(left))
        self.refine = [bool(e) for e in self.extra]
        self.norm_over = None
        if any(sharded_dims(b, mesh) for b in so):
            at = mesh.coords()
            mine = []
            for b in so:
                axes = {n for _, ns in sharded_dims(b, mesh) for n in ns}
                mine.append(all(at[a] == 0 for a in mesh.axis_names
                                if a not in axes))
            it = iter(mine)
            self.norm_over = (tree_map(lambda _: next(it), params),
                              axis_group(mesh, mesh.axis_names))

    def to_moments(self, grads):
        """The gradients (this rank's, each in its parameter's layout after
        the backward) in the moments' layout: reduce-scattered in one
        bucket a group and dtype where the moments shard a dim the
        parameters do not, then cut to the rank's slice; a sum over the
        data group divided by its extent."""
        leaves = _in_order(grads)
        if not any(self.refine):
            return grads
        for names in dict.fromkeys(n for sc in self.scatters for n, _ in sc):
            idx = [(i, d) for i, sc in enumerate(self.scatters)
                   for n, d in sc if n == names]
            outs = reduce_scatter_bucket([leaves[i] for i, _ in idx],
                                         [d for _, d in idx],
                                         axis_group(self.mesh, names))
            for (i, _), g in zip(idx, outs):
                leaves[i] = (g / self.dp if names == self.data
                             and self.dp > 1 else g)
        for i, cuts in enumerate(self.cuts):
            leaves[i] = cut(leaves[i], cuts)
        it = iter(g.contiguous() for g in leaves)
        return tree_map(lambda _: next(it), grads)

    def params_for_update(self, params):
        """The parameters in the moments' layout: a leaf the moments shard
        further, this rank's slice of it (a copy); every other leaf
        itself."""
        it = iter(cut(p, shard_cuts(e, self.mesh)).contiguous() if e else p
                  for p, e in zip(_in_order(params), self.extra))
        return tree_map(lambda _: next(it), params)

    def params_back(self, new, params):
        """The updated parameters in their own layout: the leaves the
        moments shard further all-gathered, one bucket a group and dtype,
        into ``params``' leaves in place within ``updates_in_place`` (new
        tensors otherwise)."""
        if not any(self.refine):
            return new
        leaves = _in_order(new)
        stages = {}
        for i, extra in enumerate(self.extra):
            for d, names in extra:
                stages.setdefault(names, []).append((i, d))
        for names, idx in stages.items():
            got = all_gather_bucket([leaves[i] for i, _ in idx],
                                    [d for _, d in idx],
                                    axis_group(self.mesh, names))
            for (i, _), g in zip(idx, got):
                leaves[i] = g
        it = iter(g if not r else p.copy_(g) if in_place()
                  else g.contiguous() for g, p, r in zip(
                      leaves, _in_order(params), self.refine))
        return tree_map(lambda _: next(it), params)

    def global_meta(self, params):
        """``params``' global tree, as tensors on the ``meta`` device."""
        it = iter(self.shapes)
        return tree_map(lambda p: torch.empty(next(it), dtype=p.dtype,
                                              device="meta"), params)

    def accum_zeros(self, params):
        """An fp32 accumulator of zeros in the moments' layout."""
        it = iter(block_shape(shape, b, self.mesh)
                  for shape, b in zip(self.shapes, self.so))
        return tree_map(lambda p: torch.zeros(next(it), dtype=torch.float32,
                                              device=p.device), params)


def make_lm_train_step_fn(cfg: ModelConfig, opt_cfg: AdamConfig,
                          aux_weight: float = 0.01,
                          grad_transform: Callable | None = None,
                          grad_accum: int = 1,
                          accum_rules=None, state_sharding=None):
    """``step(state, batch) -> (state, metrics)`` for any registry arch.

    ``batch``: dict with ``tokens [B, S]`` (+ ``image_embeds`` /
    ``audio_frames`` for the VLM / the encoder-decoder), on the
    parameters' device. The loss is ``lm_loss`` (next-token cross-entropy
    with a z-loss) plus ``aux_weight`` times the MoE aux loss. Metrics are
    0-d tensors on that device: ``loss``, ``ce``, ``accuracy``,
    ``tokens``, ``aux``, ``grad_norm`` (with clipping) and ``lr``.

    ``grad_accum > 1`` loops over that many microbatches (the batch dim
    must divide), accumulating the gradients in fp32, then divides by
    ``grad_accum`` and averages the metrics, as the reference's
    ``lax.scan`` does: the live activations scale with the microbatch.
    ``accum_rules`` (an ``AxisRules``) lays the fp32 accumulator out as
    the ZeRO-1 optimizer state under the active mesh
    (``infer_param_specs``, each spec checked as a sharding constraint);
    without a mesh, or with one microbatch, it is ignored, as in the
    reference.

    On a mesh over ranks ``batch`` is this rank's rows of the global batch
    (``shard_batch``), and the gradients and metrics are those of the
    global batch, reduced over the ranks after the microbatch loop (see
    the module's docstring); the clip norm and the update then run alike
    on every rank. Where the mesh's ``model`` axis splits the work,
    ``lm_forward`` is tensor-parallel (each rank its heads, FFN columns and
    vocabulary slice; its logits the rank's columns, which ``lm_loss``
    reads with ``vocab=``), and each gradient takes the sums over
    ``model`` that ``sharding.block_plan`` gives its leaf's split (a rank
    whose leaf is its slice computes that slice's whole gradient; one
    that cut its slice from a whole leaf, or used the whole leaf on the
    split side, computes its part, summed over ``model``). With
    ``grad_accum > 1`` the rows are
    ``shard_batch(..., grad_accum=grad_accum)``'s, the rank's block of
    each of the reference's microbatches in turn, so microbatch ``m``
    here is the rank's block of the global batch's microbatch ``m``.

    ``state_sharding``: the layout of the state on a mesh over ranks (a
    :class:`TrainState` of ``NamedSharding``, ``specs.
    train_state_sharding``), when the state holds this rank's blocks of it
    (``device_put``); the step then gathers, reduce-scatters and updates
    blocks (:class:`StateLayout`; the accumulator lies in the moments'
    layout, ``accum_rules`` only checked as constraints). None: the state
    is the global one on every rank. A layout that shards a leaf on a mesh
    that lists one device raises (such a mesh holds every tensor whole).

    Every parameter leaf must get a gradient from autograd: a leaf that
    does not (``None``, cut off from the loss) raises (``jax.grad`` would
    give it zeros); no arch of the registry has one."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def loss_fn(params, batch, specs, splits):
        logits, aux = lm_forward(
            params, cfg, batch["tokens"],
            image_embeds=batch.get("image_embeds"),
            audio_frames=batch.get("audio_frames"), specs=specs,
            splits=splits)
        # the rank's vocabulary columns where the forward splits them
        loss, metrics = lm_loss(logits, batch["tokens"],
                                vocab=vocab_group(splits))
        if not isinstance(aux, torch.Tensor):
            # a dense arch's aux is the float 0.0: filled on the device, as
            # a copy from pageable host memory would break a graph capture
            aux = torch.full((), aux, dtype=torch.float32, device=loss.device)
        aux = aux.to(torch.float32)
        total = loss + aux_weight * aux
        metrics["aux"] = aux
        metrics["loss"] = total
        return total, metrics

    def value_and_grad(params, batch, lay, splits):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        total, metrics = loss_fn(live, batch,
                                 lay.p_specs if lay is not None else None,
                                 splits)
        total.backward()
        grads = _grads(live, cfg.name)
        if lay is not None:
            grads = lay.to_moments(grads)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def compute_grads(params, batch, lay, splits):
        if grad_accum == 1:
            return value_and_grad(params, batch, lay, splits)
        b = batch["tokens"].shape[0]
        if b % grad_accum:
            raise ValueError(f"a batch of {b} does not split into "
                             f"{grad_accum} microbatches")
        mesh = current_mesh()
        if lay is not None:
            # blocks in the moments' layout (the reference's ZeRO-1 and
            # FSDP accumulators); accum_rules' specs, where they differ,
            # are checked as constraints and not taken (ROADMAP.md R40)
            acc = lay.accum_zeros(params)
            specs = infer_param_specs(lay.global_meta(params),
                                      rules=accum_rules, mesh=mesh) if (
                accum_rules is not None) else None
        else:
            acc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            specs = infer_param_specs(acc, rules=accum_rules, mesh=mesh) if (
                accum_rules is not None and mesh is not None) else None
        if specs is not None:
            # ZeRO-1: the fp32 accumulator sharded like the optimizer
            # state even when the params are data-replicated
            tree_map(lambda z, sp: with_sharding_constraint(
                z, NamedSharding(mesh, sp)), acc, specs)
        per_mb = []
        for m in range(grad_accum):
            micro = {k: v.reshape(grad_accum, b // grad_accum,
                                  *v.shape[1:])[m] for k, v in batch.items()}
            grads, metrics = value_and_grad(params, micro, lay, splits)
            tree_map(lambda a, g: a.add_(g.to(torch.float32)), acc, grads)
            per_mb.append(metrics)
            del grads
        grads = tree_map(lambda a: a / grad_accum, acc)
        metrics = {k: torch.mean(torch.stack([m[k] for m in per_mb]))
                   for k in per_mb[0]}
        return grads, metrics

    def step(state: TrainState, batch):
        mesh = current_mesh()
        lay = pending = None
        splits = (lm_splits(state.params, cfg)
                  if mesh is not None and mesh.on_ranks else None)
        if state_sharding is not None and mesh is not None:
            if mesh.on_ranks:
                lay = StateLayout(state.params, state_sharding, mesh,
                                  current_rules(), splits)
                pending = lay.pending
            elif any(sharded_dims(s.spec, mesh)
                     for s in tree_leaves(state_sharding)):
                raise ValueError(
                    f"a train state sharded over the mesh {mesh.shape} that "
                    "lists one device: a sharded state needs a mesh over "
                    "ranks (init_ranks, then best_mesh())")
        grads, metrics = compute_grads(state.params, batch, lay, splits)
        if mesh is not None and mesh.on_ranks:
            if lay is None:
                pending = _replicated_pending(state.params, splits, mesh,
                                              current_rules())
            grads, metrics = _reduce_over_ranks(grads, metrics, mesh,
                                                current_rules(), pending)
        if grad_transform is not None:
            grads = grad_transform(grads)
        if lay is None:
            params, opt, opt_metrics = adam_update(grads, state.opt,
                                                   state.params, opt_cfg)
        else:
            params, opt, opt_metrics = adam_update(
                grads, state.opt, lay.params_for_update(state.params),
                opt_cfg, lay.norm_over)
            params = lay.params_back(params, state.params)
        metrics.update(opt_metrics)
        return TrainState(params, opt), metrics

    return step


# -- compiled steps ----------------------------------------------------------


def _capture_for(device: torch.device):
    """How a compiled step captures on ``device``: a CUDA graph
    (:func:`repro_torch.kernels.ops.capture_cuda_graph`) on a CUDA device,
    None elsewhere, where the step runs eagerly. The CPU tests put a stub
    capture in its place."""
    if device.type != "cuda":
        return None
    return ops.capture_cuda_graph


def _layout(tree) -> list:
    """What of a tree a captured step bakes in: its structure, and each
    leaf's shape, dtype and device."""
    if isinstance(tree, dict):
        return [(k, _layout(tree[k])) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [type(tree).__name__, *(_layout(v) for v in tree)]
    return (tuple(tree.shape), tree.dtype, tree.device)


class CompiledTrainStep:
    """A train step ``step(state, batch) -> (state, metrics)`` as one
    captured program, the port's counterpart of ``jax.jit`` of a step.

    On a CUDA device the first call captures one step (forward, backward,
    the clip norm, the fused AdamW update in place and the step count) over
    fixed buffers of the state and the batch as a CUDA graph, and every
    call replays it: the batch is copied into its buffers device to device,
    the state too unless it is the graph's own, then one replay, and the
    metrics come back as copies (a later replay does not overwrite them).
    A call after the first makes no host sync. A change of what the
    capture bakes in (the layout of the batch or the state, the mesh, the
    deterministic-algorithms switch, the process group) captures again.
    On a mesh over ranks the step's collectives are captured too; a
    capture that fails there raises with the reason and never falls back
    to eager steps. Before a capture one
    eager step runs on a side stream (what runs at first use: cuBLAS's
    handle and workspace, kernel builds), functional, so the state stays
    as it was; its memory is freed before the capture.

    ``donate=True`` is the reference's donation of the old state: the
    returned state is the graph's own buffers, updated in place by the next
    call, and the state handed in becomes them at a capture (no copy). The
    caller must not read a state it passed in after the call: JAX raises on
    a donated buffer, the port cannot and does not. ``donate=False`` copies
    the caller's state into the buffers and returns copies; the caller's
    state stays valid. On the CPU the step runs eagerly, exactly as
    ``step``, and nothing is captured. ``eager`` is the step itself, the
    eager twin a check compares against.
    """

    def __init__(self, step: Callable, donate: bool = False):
        self.eager = step
        self.donate = donate
        self._graph = None          # (replay, launches of a replay)
        self._key = self._refs = None
        self._state = self._batch = None
        self._metric_names = ()     # per metric vector, its keys
        self.stats = {"captures": 0, "capture_s": 0.0, "replays": 0}

    def _capture_key(self, state, batch) -> tuple:
        group = dist.group.WORLD if dist.is_initialized() else None
        return (_layout(state), _layout(batch), id(current_mesh()),
                torch.are_deterministic_algorithms_enabled(), id(group))

    def __call__(self, state: TrainState, batch: dict):
        device = tree_leaves(state)[0].device
        capture = _capture_for(device)
        if capture is None:
            return self.eager(state, batch)
        away = sorted(k for k, v in batch.items() if v.device != device)
        if away:
            raise ValueError(f"compiled step on {device}: batch entries "
                             f"{away} lie on another device")
        key = self._capture_key(state, batch)
        if key != self._key:
            self._capture(capture, state, batch, key)
        else:
            self._load(state, batch)
        replay, launches = self._graph
        vectors = replay()
        ops.add_launches(launches)
        self.stats["replays"] += 1
        metrics = {}
        for names, vec in zip(self._metric_names, vectors):
            vec = vec.clone()
            metrics.update((k, vec[i]) for i, k in enumerate(names))
        if self.donate:
            return self._state, metrics
        return tree_map(torch.clone, self._state), metrics

    def _own(self, state) -> bool:
        return all(a is b for a, b in zip(tree_leaves(state),
                                          tree_leaves(self._state)))

    def _load(self, state, batch) -> None:
        if not self._own(state):
            torch._foreach_copy_(tree_leaves(self._state), tree_leaves(state))
        for k, v in batch.items():
            self._batch[k].copy_(v, non_blocking=True)

    def _capture(self, capture, state, batch, key) -> None:
        t0 = time.perf_counter()
        self._graph = None                  # free the old graph first
        self._state = state if self.donate else tree_map(torch.clone, state)
        self._batch = {k: v.clone() for k, v in batch.items()}
        device = tree_leaves(state)[0].device
        ops.run_aside(device, self.eager, self._state, self._batch)
        if device.type == "cuda":
            torch.cuda.empty_cache()

        def body():
            with updates_in_place():
                new, metrics = self.eager(self._state, self._batch)
            if not self._own(new):
                raise RuntimeError(
                    "compiled step: the step returned a state that is not "
                    "its buffers (its update must run through adam_update, "
                    "which writes them in place here)")
            groups = {}
            for k, v in metrics.items():
                groups.setdefault(v.dtype, []).append(k)
            self._metric_names = tuple(tuple(g) for g in groups.values())
            return [torch.stack([metrics[k].reshape(()) for k in names])
                    for names in self._metric_names]

        before = ops.launch_counts()
        mesh = current_mesh()
        try:
            replay = capture(body)
        except RuntimeError as err:
            if mesh is None or not mesh.on_ranks:
                raise
            # no eager fallback: the step's collectives did not capture
            raise RuntimeError(
                f"compiled step on a mesh over ranks: the capture of the "
                f"step and its collectives failed ({err}); .eager is the "
                f"un-compiled step") from err
        self._graph = (replay, ops.take_back_launches(before))
        self._key = key
        # keep the mesh and the group alive, so the ids in the key stay
        # unique
        self._refs = (mesh, dist.group.WORLD if dist.is_initialized()
                      else None)
        self.stats["captures"] += 1
        self.stats["capture_s"] = time.perf_counter() - t0


def make_lm_train_step(cfg: ModelConfig, opt_cfg: AdamConfig,
                       aux_weight: float = 0.01,
                       grad_transform: Callable | None = None,
                       donate: bool = True) -> CompiledTrainStep:
    """:func:`make_lm_train_step_fn` with one microbatch, compiled (the
    reference's jitted convenience wrapper). ``donate`` is the reference's
    donation of the old state to the step: the caller hands the state over
    and must not read it after the call; on a CUDA device the step then
    returns its graph's own buffers, updated in place by the next call
    (:class:`CompiledTrainStep`)."""
    return CompiledTrainStep(
        make_lm_train_step_fn(cfg, opt_cfg, aux_weight, grad_transform),
        donate=donate)


def make_gru_train_step(task: GruTaskConfig, opt_cfg: AdamConfig,
                        qat: QatPolicy = FP32, use_delta: bool = True
                        ) -> CompiledTrainStep:
    """Paper training step ``step(state, batch) -> (state, metrics)``.
    batch: ``{features [T,B,I], labels, in_lens, lab_lens}`` for CTC, or
    ``{features, targets [T,B,O]}`` for regression, on the parameters'
    device. Metrics are 0-d tensors on that device (``loss``, ``ctc`` or
    ``mse``/``rmse``, ``grad_norm`` with clipping, ``lr``). Compiled as the
    reference jits it, without donation (:class:`CompiledTrainStep`: one
    CUDA graph on a CUDA device, eager on the CPU; ``.eager`` is the
    un-compiled step)."""

    def loss_fn(params, batch):
        out, _ = gru_model_forward(params, task, batch["features"],
                                   use_delta=use_delta, qat=qat)
        if task.task == "ctc":
            loss, metrics = ctc_loss_mean(out, batch["labels"],
                                          batch["in_lens"], batch["lab_lens"])
        else:
            loss, metrics = mse_loss(out, batch["targets"])
        metrics["loss"] = loss
        return loss, metrics

    def step(state: TrainState, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(True),
                          state.params)
        loss, metrics = loss_fn(params, batch)
        loss.backward()
        grads = _grads(params, "the GRU step")
        metrics = {k: v.detach() for k, v in metrics.items()}
        new_params, opt, opt_metrics = adam_update(grads, state.opt,
                                                   state.params, opt_cfg)
        metrics.update(opt_metrics)
        return TrainState(new_params, opt), metrics

    return CompiledTrainStep(step)


@dataclass
class LoopHooks:
    on_step: Callable | None = None           # (step, metrics) -> None
    checkpoint_every: int = 0
    save_checkpoint: Callable | None = None   # (step, state) -> None


def train_loop(step_fn, state: TrainState, batches, num_steps: int,
               hooks: LoopHooks | None = None):
    """Run ``num_steps`` steps; returns (state, history). ``batches`` is an
    iterator/iterable of batch dicts. Each step's metrics are read to the
    host (``float``), which waits for the step."""
    hooks = hooks or LoopHooks()
    history = []
    it = iter(batches)
    for i in range(num_steps):
        batch = next(it)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["step_time_s"] = time.perf_counter() - t0
        history.append(metrics)
        if hooks.on_step:
            hooks.on_step(i, metrics)
        if (hooks.checkpoint_every and hooks.save_checkpoint
                and (i + 1) % hooks.checkpoint_every == 0):
            hooks.save_checkpoint(i + 1, state)
    return state, history
