"""The train state sharded over the ranks as the reference lays it out, on
the CPU: one process a rank, gloo, four ranks (``repro_torch.dist.ranks``).

``specs.train_state_sharding`` lays the state out as the reference does:
FSDP (``AxisRules()`` for the parameters and both moments, the reference
launcher's) or ZeRO-1 (the parameters under the dry-run's ``zero1``
variant, ``embed_fsdp=None``; the moments and the accumulator under
``AxisRules()``). Each rank holds
its blocks; ``make_lm_train_step_fn(..., state_sharding=)`` gathers a
parameter where the forward reads it and reduce-scatters its gradient in
the backward. Over meshes (4, 1) and (2, 2), both layouts, llama3.2-1b and
granite-moe-3b-a800m (``--reduced``, [8, 32]) and one or two microbatches,
one step is held against the replicated step over the same ranks
(the whole state on every rank, ``state_sharding=None``) and against JAX's
step jitted under ``train_state_sharding`` (``test_torch_rank_train.
_jax_step``; granite at (4, 1) fails there, ROADMAP.md R29a, and is held to
the replicated step). Both steps take ``shard_batch(..., grad_accum=)``'s
rows, each rank's block of each of the reference's microbatches. The
replicated rules for both trees give the replicated step bitwise.
Checkpoints of a sharded state hold global leaves and restore across world
sizes, one global leaf on the host at a time; a sharded state resumes
through the step and through the launcher over the ranks.

Tolerances: the loss bitwise the replicated step's (the forward reads the
same global tensors); the other metrics within ``TOL_METRIC`` relative
(``tokens`` exactly) of the replicated step's and JAX's; the gradients
handed to the update within ``TOL_PAIR`` of each leaf's largest of the
replicated step's reduced gradient cut to the block (reduce-scatters add
in other orders than the all-reduce); every gathered parameter within
Adam's first-step bound of a gradient ``TOL_GRAD`` of its leaf's largest
apart, and each moment within the same gradient bound's reach; the
gather / scatter pair: the gathered tensors bitwise, the reduced
gradient within ``TOL_PAIR``.
"""
import concurrent.futures
import json

import jax
import numpy as np
import pytest
import torch

from repro_torch.dist import ranks
from repro_torch.ft import checkpoint as tckpt
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as tlaunch
from repro_torch.train import optim as toptim
from test_torch_lm_train import (LR, TOL_GRAD, TOL_METRIC, U32,
                                 adam_first_step_bound)
from test_torch_mesh import _lm
from test_torch_rank_train import _jax_step, _metrics_rel
import torch_rank_workers as workers

torch.set_num_threads(1)

WORLD = 4
DEADLINE_S = 300
B, S = 8, 32
ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m")
MESHES = {"4x1": 1, "2x2": 2}          # the model-parallel degree
LAYOUTS = ("fsdp", "zero1")
ACCUMS = (1, 2)
TOL_PAIR = 1e-6
B1, B2 = 0.9, 0.999
LAUNCH = ["--arch", "llama3.2-1b", "--reduced", "--batch", "8", "--seq",
          "32", "--device", "cpu", "--log-every", "1"]

_RUNS = {}


def _run(arch):
    """Every case of ``arch`` in one spawn of four ranks (the steps of both
    layouts, the replicated rules and the replicated step, the gather /
    scatter pairs), with JAX's steps run here meanwhile; cached."""
    if arch not in _RUNS:
        jcfg, tcfg, jp, tp, tokens = _lm(arch, B, S)
        params = toptim.tree_map(lambda t: t.numpy(), tp)
        cases = [(mp, layout, accum) for mp in MESHES.values()
                 for layout in LAYOUTS + ("repl",) for accum in ACCUMS]
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ranked = pool.submit(ranks.spawn_ranks, workers.sharded_steps,
                                 WORLD, "cpu", timeout=DEADLINE_S,
                                 args=(arch, params, tokens, LR, cases))
            ref = {}
            for mp in MESHES.values():
                for accum in ACCUMS:
                    shape = (WORLD // mp, mp)
                    if tcfg.n_experts and mp == 1:
                        with pytest.raises(Exception) as err:   # R29a
                            _jax_step(jcfg, jp, tokens, accum, shape)
                        assert type(err.value).__name__ == (
                            "DuplicateSpecError")
                        ref[(mp, accum)] = None
                    else:
                        ref[(mp, accum)] = _jax_step(jcfg, jp, tokens,
                                                     accum, shape)
            got = ranked.result()
        _RUNS[arch] = (got, ref)
    return _RUNS[arch]


def _scale(norm):
    return min(1.0, 1.0 / (norm + 1e-9))


def _state_within(state, params_ref, grads, norm, ref_norm):
    """Every parameter within Adam's first-step bound, and each moment
    within the reach of the gradient bound (the clip scales of the two
    steps apart too), of a reference step's ``params_ref`` / moments from
    its gradients ``grads``; ``state``: the global leaves in
    ``tree_leaves`` order (parameters, mu, nu, step)."""
    n = len(grads)
    params, mu, nu = state[:n], state[n:2 * n], state[2 * n:3 * n]
    s, sr = _scale(norm), _scale(ref_norm)
    for p, q, g in zip(params, params_ref[:n], grads):
        bound = adam_first_step_bound(g, TOL_GRAD * np.abs(g).max(), s)
        assert (np.abs(p - q) <= bound + np.spacing(np.abs(q))).all()
    for k, (moment, ref) in enumerate(((mu, params_ref[n:2 * n]),
                                       (nu, params_ref[2 * n:3 * n]))):
        for m, r, g in zip(moment, ref, grads):
            a = np.abs(g).astype(np.float64)
            d = s * TOL_GRAD * a.max() + a * abs(s - sr)
            bound = ((1 - B1) * d if k == 0
                     else (1 - B2) * (2 * s * a + d) * d)
            assert (np.abs(m - r) <= bound + 4 * np.spacing(np.abs(r))
                    + 8 * U32 * np.abs(r)).all()
    assert int(state[-1]) == 1


def _jax_leaves(js):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(js)]


@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_step_matches_the_replicated_step_and_jax(mesh, layout,
                                                          arch, accum):
    """One step over the sharded state: its loss bitwise the replicated
    step's over the same ranks, its metrics near them and JAX's, the
    gradients it hands the update the replicated step's reduced ones cut
    to the blocks, and the gathered state within Adam's first-step bound
    of JAX's (of the replicated step's where JAX's fails)."""
    got, ref = _run(arch)
    mp = MESHES[mesh]
    outs = [r["steps"][(mp, layout, accum)] for r in got]
    first = outs[0]
    for o in outs:
        assert o["metrics"]["loss"] == o["repl_metrics"]["loss"]
        assert o["metrics"] == first["metrics"]
        assert max(o["gerr"]) <= TOL_PAIR, max(o["gerr"])
        assert all(np.array_equal(a, b) for a, b in zip(o["state"],
                                                        first["state"]))
    _metrics_rel(first["metrics"], first["repl_metrics"], "replicated")
    jax_step = ref[(mp, accum)]
    if jax_step is None:
        _state_within(first["state"], first["repl_state"],
                      first["repl_grads"], first["metrics"]["grad_norm"],
                      first["repl_metrics"]["grad_norm"])
        return
    js, jmet, jg = jax_step
    _metrics_rel(first["metrics"], jmet, "jax")
    _state_within(first["state"], _jax_leaves(js), jg,
                  first["metrics"]["grad_norm"], float(jmet["grad_norm"]))


@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_replicated_rules_give_the_replicated_step_bitwise(mesh, arch,
                                                           accum):
    """``AxisRules(embed_fsdp=None, experts_fsdp=None)`` for the parameters
    and the moments. At (4, 1) they shard nothing: the step's metrics, the
    gradients it hands the update and its new state are the replicated
    step's, bitwise. At (2, 2) they still lay the model dims over
    ``model`` (the reference's layout), which the forward gathers and the
    backward cuts without a sum: the loss and the gradients are bitwise,
    and the clip norm, summed over blocks and then over the ranks
    (ROADMAP.md R39), within ``TOL_METRIC``, the state within Adam's
    first-step bound."""
    got, _ = _run(arch)
    for r in got:
        o = r["steps"][(MESHES[mesh], "repl", accum)]
        assert o["same_grads"]
        assert len(o["state"]) == len(o["repl_state"])
        if mesh == "4x1":
            assert o["metrics"] == o["repl_metrics"]
            assert all(np.array_equal(a, b) for a, b in zip(
                o["state"], o["repl_state"]))
            continue
        assert o["metrics"]["loss"] == o["repl_metrics"]["loss"]
        _metrics_rel(o["metrics"], o["repl_metrics"], "replicated")
        _state_within(o["state"], o["repl_state"], o["repl_grads"],
                      o["metrics"]["grad_norm"],
                      o["repl_metrics"]["grad_norm"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh", MESHES)
def test_gather_and_reduce_scatter_pair(mesh, layout, arch):
    """``sharding.gather_tree`` of every parameter's block is the global
    tensor bitwise, and its backward (then the step's bucket for what no
    reduce-scatter summed) the reduced gradient's block: the expert stacks
    the expert-parallel dispatch splits summed over the experts group,
    every gradient averaged over the data group."""
    got, _ = _run(arch)
    for r in got:
        pair = r["pairs"][(MESHES[mesh], layout)]
        assert pair["same"]
        assert max(pair["errs"]) <= TOL_PAIR, max(pair["errs"])
        if layout == "fsdp":
            assert pair["issued"]["all_gather"] > 0
            assert pair["issued"]["reduce_scatter"] > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_holds_only_its_blocks(mesh, layout, arch):
    """Every parameter, moment and accumulator leaf on every rank is the
    block of its spec (its elements the global leaf's over the spec's
    extent), and the step issues the collectives of its layout: FSDP
    gathers and reduce-scatters in the step, ZeRO-1 reduce-scatters the
    gradient and gathers the parameters once."""
    got, _ = _run(arch)
    mp = MESHES[mesh]
    for r in got:
        for accum in ACCUMS:
            o = r["steps"][(mp, layout, accum)]
            assert o["blocks"]
            assert o["held"] < o["whole"]
            assert o["issued"]["reduce_scatter"] >= accum
            assert o["issued"]["all_gather"] >= 1


def _block(a, spec, coords, mesh):
    for d, entry in enumerate(spec):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        i, n = 0, 1
        for name in names:
            i, n = i * mesh[name] + coords[name], n * mesh[name]
        step = a.shape[d] // n
        a = a[(slice(None),) * d + (slice(i * step, (i + 1) * step),)]
    return a


def test_a_checkpoint_saved_over_ranks_restores_in_one_process(tmp_path):
    """A state sharded under FSDP over four ranks, after a step, saved by
    the lead from the gathered global leaves: the files restore in one
    process, and each rank's blocks are the blocks of the restored leaves
    bitwise; saved in one process, the same files restore over the four
    ranks into the blocks of the saved leaves."""
    cfg_params = toptim.tree_map(lambda t: t.numpy(),
                                 _lm("llama3.2-1b", B, S)[3])
    ck = str(tmp_path / "ranks")
    got = ranks.spawn_ranks(workers.save_sharded, WORLD, "cpu",
                            timeout=DEADLINE_S,
                            args=("llama3.2-1b", cfg_params, ck, None))
    cfg = tlaunch.get_config("llama3.2-1b").reduced()
    abstract = tspecs.abstract_train_state(cfg)
    whole = tckpt.restore(ck, abstract, device="cpu")
    leaves = [t.numpy() for t in toptim.tree_leaves(whole)]
    for r in got:
        assert len(r["blocks"]) == len(leaves)
        for blk, a, spec in zip(r["blocks"], leaves, r["specs"]):
            assert np.array_equal(blk, _block(a, spec, r["coords"],
                                              r["mesh"]))
    assert sum(b.size for b in got[0]["blocks"]) < sum(a.size
                                                       for a in leaves)
    # the other way round: saved in one process, restored over the ranks
    one = str(tmp_path / "one")
    rng = np.random.default_rng(7)
    state = toptim.tree_map(
        lambda a: (rng.standard_normal(a.shape).astype(np.float32)
                   if a.dtype == np.float32 else a),
        toptim.tree_map(lambda t: t.numpy(), whole))
    tckpt.save(one, 5, state)
    back = ranks.spawn_ranks(workers.save_sharded, WORLD, "cpu",
                             timeout=DEADLINE_S,
                             args=("llama3.2-1b", cfg_params, one, state))
    assert all(r["same"] for r in back)
    assert back[0]["numel"] < sum(a.size for a in leaves)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_a_sharded_state_resumes_through_the_step(layout, tmp_path):
    """Under FSDP and ZeRO-1 over four ranks, two microbatches a step: a run
    saved at step 2 (global leaves, written by the lead), restored into
    blocks and stepped once repeats the uninterrupted run's losses and
    final blocks bitwise; the restore holds at most one global leaf on the
    host beside the rank's blocks, less than the whole state."""
    got = ranks.spawn_ranks(workers.resume_sharded, WORLD, "cpu",
                            timeout=DEADLINE_S,
                            args=("llama3.2-1b", layout, str(tmp_path)))
    for r in got:
        assert len(r["want"]) == 3 and r["got"] == r["want"]
        assert r["same"]
        assert r["peak"] <= r["largest"] + r["blocks"], r
        assert r["largest"] + r["blocks"] < r["whole"], r


def test_launcher_over_ranks_resumes_the_sharded_state(tmp_path, capsys):
    """``launch.train`` over four ranks (FSDP, the reference launcher's
    layout; two microbatches): a run stopped at step 2 and resumed to 3
    repeats the uninterrupted run's losses bitwise, and only the lead
    writes; the checkpoint (global leaves) also resumes in one process,
    its step-3 loss within ``TOL_METRIC`` of the ranks'."""
    argv = LAUNCH + ["--grad-accum", "2"]
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    whole = ranks.spawn_ranks(workers.launch, WORLD, "cpu",
                              timeout=DEADLINE_S, args=(argv + ["--steps",
                                                                "3"],))
    first = ranks.spawn_ranks(workers.launch, WORLD, "cpu",
                              timeout=DEADLINE_S,
                              args=(argv + ["--steps", "2"] + ck,))
    second = ranks.spawn_ranks(workers.launch, WORLD, "cpu",
                               timeout=DEADLINE_S,
                               args=(argv + ["--steps", "3"] + ck,))
    want = whole[0]["losses"]
    assert len(want) == 3 and all(r["losses"] == want for r in whole)
    assert [r["start"] for r in second] == [2] * WORLD
    assert first[0]["losses"] == want[:2]
    assert second[0]["losses"] == want[2:]
    assert [r["managers"] for r in first] == [1, 0, 0, 0]
    assert [r["saved"] for r in first] == [[2], [], [], []]
    one = tlaunch.main(argv + ["--steps", "3"] + ck)
    capsys.readouterr()
    assert one["start"] == 2 and len(one["losses"]) == 1
    assert abs(one["losses"][0] - want[2]) <= TOL_METRIC * abs(want[2])
    assert json.loads(json.dumps(one["losses"])) == one["losses"]


def test_a_sharded_state_on_a_mesh_listing_one_device_raises():
    """No silent replication: a layout that shards a leaf over a mesh that
    lists the CPU four times (every tensor whole in one process) makes the
    step and ``gather_tree`` raise; the (1, 1) mesh of the one-process
    launcher shards nothing and runs."""
    from repro_torch.dist import sharding as tsh
    from repro_torch.dist.elastic import Mesh
    from repro_torch.train import trainer as ttrainer
    cfg = tlaunch.get_config("llama3.2-1b").reduced()
    cpu = torch.device("cpu")
    tokens = torch.from_numpy(_lm("llama3.2-1b", B, S)[4])
    for shape, raises in (((4, 1), True), ((1, 1), False)):
        mesh = Mesh(np.array([cpu] * int(np.prod(shape)),
                             dtype=object).reshape(shape), ("data", "model"))
        with tsh.use_mesh(mesh, tsh.AxisRules()):
            state, st_sh = tlaunch.init_state(cfg, 0, cpu, mesh,
                                              tsh.AxisRules())
            step = ttrainer.make_lm_train_step_fn(
                cfg, toptim.AdamConfig(), state_sharding=st_sh)
            p_specs = toptim.tree_map(lambda s: s.spec, st_sh.params)
            if raises:
                with pytest.raises(ValueError, match="mesh over ranks"):
                    step(state, {"tokens": tokens})
                with pytest.raises(ValueError, match="mesh over ranks"):
                    tsh.gather_tree(state.params, p_specs)
            else:
                _, metrics = step(state, {"tokens": tokens})
                assert np.isfinite(float(metrics["loss"]))
                assert tsh.gather_tree(state.params, p_specs) is not None
