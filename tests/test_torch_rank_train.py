"""The LM train step and the training launcher over ranks on the CPU: one
process a rank, gloo (``repro_torch.dist.ranks``).

One step of ``make_lm_train_step_fn`` on meshes of four ranks, (4, 1) and
(2, 2), each rank holding the whole state and its rows of the batch, is
held against the port's one-process step on the same mesh listing the CPU
four times and against JAX's step jitted under an ``AxisType.Auto`` mesh
over four devices (as ``test_torch_mesh.py`` builds it): llama3.2-1b with
two microbatches and the ZeRO-1 ``accum_rules`` on [8, 16] (the smallest
batch that two microbatches split on four data ranks), and
granite-moe-3b-a800m on [16, 16], through the expert-parallel all-to-all
at (2, 2) and the sorted path at (4, 1), where JAX's step fails (ROADMAP.md
R29a) and the port is held to itself. JAX runs here, in the parent, never
in a rank.

The launcher runs under ``python -m torch.distributed.run --standalone
--nproc-per-node 2`` against the one-process launcher; a checkpointed run
stopped at step 2 and resumed to 3 repeats the uninterrupted run, with
only rank 0 writing.

Tolerances: the loss and metrics within ``TOL_METRIC`` relative (the
ranks' means are taken over the data group, in other orders), ``tokens``
exactly; every parameter within Adam's first-step bound of a gradient
``TOL_GRAD`` of its leaf's largest apart; every rank's state bitwise rank
0's; each router call's choices exactly the one-process call's on its data
shard, with the top-k held ``ROUTE_GAP`` apart. The launcher's losses
within ``TOL_METRIC`` relative of the one-process launcher's, the resume
bitwise.
"""
import concurrent.futures
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.dist import sharding as jsh
from repro.launch import specs as jspecs
from repro.train import optim as joptim
from repro.train import trainer as jtrainer
from repro_torch.data.pipeline import shard_batch
from repro_torch.dist import ranks
from repro_torch.dist import sharding as tsh
from repro_torch.dist.elastic import Mesh
from repro_torch.launch import train as tlaunch
from repro_torch.models import moe_ep as tmoe_ep
from repro_torch.train import optim as toptim
from repro_torch.train import trainer as ttrainer
from test_torch_lm_train import (LR, ROUTE_GAP, TOL_GRAD, TOL_METRIC, _jb,
                                 _opt, _params_within, _tb,
                                 adam_first_step_bound)
from test_torch_mesh import _jgrads_mesh, _lm
import torch_rank_workers as workers

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
WORLD = 4
DEADLINE_S = 120
MPS = (1, 2)
LAUNCH = ["--arch", "llama3.2-1b", "--reduced", "--batch", "8", "--seq",
          "32", "--device", "cpu", "--log-every", "1"]


def _shape(mp):
    return (WORLD // mp, mp)


def _jmesh(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:WORLD])


def _cpu_mesh(shape):
    return Mesh(np.array([CPU] * WORLD, dtype=object).reshape(shape),
                ("data", "model"))


def _jax_step(jcfg, jp, tokens, accum, shape):
    """JAX's step under its mesh, and its gradients (the microbatches'
    mean) for the parameters' bound."""
    jm = _jmesh(shape)
    batch = {"tokens": tokens}
    rules = jsh.AxisRules()
    jstep = jtrainer.make_lm_train_step_fn(jcfg, _opt(joptim),
                                           grad_accum=accum,
                                           accum_rules=rules)
    jstate = jtrainer.init_train_state(jp)
    st_sh = jspecs.train_state_sharding(jax.eval_shape(lambda: jstate), jm,
                                        rules)
    b_sh = jspecs.batch_sharding(jax.eval_shape(lambda: _jb(batch)), jm,
                                 rules)
    with jsh.use_mesh(jm, rules):
        js, jmet = jax.jit(jstep, in_shardings=(st_sh, b_sh),
                           out_shardings=(st_sh, None))(jstate, _jb(batch))
    b = tokens.shape[0]
    parts = [{"tokens": tokens[i * b // accum:(i + 1) * b // accum]}
             for i in range(accum)]
    jgs = [_jgrads_mesh(jcfg, jp, p, jm) for p in parts]
    jg = [sum(gs[1:], np.float32(0) + gs[0]) / np.float32(accum)
          for gs in zip(*jgs)]
    return js, jmet, jg


def _port_step(tcfg, tp, tokens, accum, shape, monkeypatch):
    """The port's one-process step on the mesh listing the CPU four times:
    state, metrics, gradients and the router calls' choices."""
    calls, orig = [], tmoe_ep._route_local

    def route(router_w, xt, k):
        out = orig(router_w, xt, k)
        calls.append(out[1].numpy().copy())
        return out
    monkeypatch.setattr(tmoe_ep, "_route_local", route)
    kept = {}

    def keep(grads):
        kept["g"] = grads
        return grads
    step = ttrainer.make_lm_train_step_fn(
        tcfg, _opt(toptim), grad_transform=keep, grad_accum=accum,
        accum_rules=tsh.AxisRules())
    mesh = _cpu_mesh(shape)
    with tsh.use_mesh(mesh, tsh.AxisRules()):
        new, met = step(ttrainer.init_train_state(tp),
                        shard_batch(_tb({"tokens": tokens}), mesh))
    monkeypatch.setattr(tmoe_ep, "_route_local", orig)
    grads = [g.numpy() for g in toptim.tree_leaves(kept["g"])]
    return new, met, grads, calls


def _metrics_rel(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, v in got.items():
        w = float(want[k])
        if k == "tokens":
            assert v == w, (what, k)
        else:
            assert abs(v - w) <= TOL_METRIC * abs(w), (what, k, v, w)


@pytest.mark.parametrize("arch,b,accum", [("llama3.2-1b", 8, 2),
                                          ("granite-moe-3b-a800m", 16, 1)])
def test_rank_train_step_matches_one_process_and_jax(arch, b, accum,
                                                     monkeypatch):
    jcfg, tcfg, jp, tp, tokens = _lm(arch, b, 16)
    params = toptim.tree_map(lambda t: t.numpy(), tp)
    # the ranks run while this process runs JAX and the one-process steps
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranked = pool.submit(ranks.spawn_ranks, workers.train_step, WORLD,
                             "cpu", timeout=DEADLINE_S,
                             args=(arch, MPS, params, tokens, accum, LR))
        here = {}
        for mp in MPS:
            shape = _shape(mp)
            port = _port_step(tcfg, tp, tokens, accum, shape, monkeypatch)
            if tcfg.n_experts and mp == 1:
                # R29a: JAX's sorted path names the model axis twice
                with pytest.raises(Exception) as err:
                    _jax_step(jcfg, jp, tokens, accum, shape)
                assert type(err.value).__name__ == "DuplicateSpecError"
                here[mp] = port, None
            else:
                here[mp] = port, _jax_step(jcfg, jp, tokens, accum, shape)
        got = ranked.result()
    for mp in MPS:
        dp = _shape(mp)[0]
        (new, met, grads, calls), jax_step = here[mp]
        ep = tcfg.n_experts and mp > 1      # the expert-parallel branch
        first = got[0][mp]
        for r, out in enumerate(got):
            o = out[mp]
            assert all(np.array_equal(p, q) for p, q in zip(
                o["params"], first["params"])), (mp, r)
            assert o["metrics"] == first["metrics"]
            i = o["coords"]["data"]
            mine = calls[i::dp]
            assert len(o["routes"]) == len(mine) == (
                tcfg.n_layers if ep else 0)
            for (idx, gap), want in zip(o["routes"], mine):
                assert np.array_equal(idx, want) and gap >= ROUTE_GAP
        _metrics_rel(first["metrics"], met, ("port", mp))
        scale = min(1.0, 1.0 / (float(met["grad_norm"]) + 1e-9))
        for p, q, g in zip(first["params"], toptim.tree_leaves(new.params),
                           grads):
            bound = adam_first_step_bound(g, TOL_GRAD * np.abs(g).max(),
                                          scale)
            q = q.numpy()
            assert (np.abs(p - q) <= bound + np.spacing(np.abs(q))).all()
        if jax_step is None:
            continue
        js, jmet, jg = jax_step
        _metrics_rel(first["metrics"], jmet, ("jax", mp))
        ts = types.SimpleNamespace(
            params=[torch.from_numpy(p) for p in first["params"]])
        _params_within(ts, js, jg, float(jmet["grad_norm"]), TOL_GRAD)


def test_a_refused_capture_over_ranks_raises_with_the_reason():
    """No eager fallback: where the compiled step's capture fails over the
    ranks (NCCL refusing its collective, here a stub), the call raises
    with the reason and runs no step in its place; the state is as it
    was."""
    tokens = np.random.default_rng(2).integers(0, 128, (4, 16)).astype(
        np.int32)
    got = ranks.spawn_ranks(workers.refused_capture, 2, "cpu",
                            timeout=DEADLINE_S,
                            args=("llama3.2-1b", tokens))
    for out in got:
        assert "capture of the step and its collectives failed" in (
            out["error"] or "")
        assert "capture refused by the stub" in out["error"]
        assert out["stats"]["captures"] == 0 and out["stats"]["replays"] == 0
        assert out["step"] == 0


def _torchrun(argv, timeout=DEADLINE_S):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *argv]
    run = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=timeout, cwd=str(ROOT))
    assert run.returncode == 0, run.stderr[-3000:]
    return run.stdout.splitlines()


def _losses(lines):
    found = [json.loads(line[len("[train] losses "):]) for line in lines
             if line.startswith("[train] losses ")]
    assert len(found) == 1, lines
    return found[0]


@pytest.fixture(scope="module")
def two_ranks():
    """The launcher under torchrun on two CPU ranks, 3 steps."""
    return _torchrun(LAUNCH + ["--steps", "3"])


def test_launcher_under_torchrun_matches_one_process(two_ranks, capsys):
    """``torch.distributed.run --nproc-per-node 2 ... --device cpu``: a
    (2, 1) mesh over the ranks, one set of lines (rank 0's), its losses
    within ``TOL_METRIC`` relative of the one-process launcher's."""
    one = tlaunch.main(LAUNCH + ["--steps", "3"])
    capsys.readouterr()
    assert two_ranks[0] == ("[train] llama3.2-1b-smoke on mesh "
                            "{'data': 2, 'model': 1}")
    got = _losses(two_ranks)
    assert len(got) == len(one["losses"]) == 3
    for a, b in zip(got, one["losses"]):
        assert abs(a - b) <= TOL_METRIC * abs(b)


def test_launcher_resume_over_ranks_repeats_the_run(two_ranks, tmp_path):
    """A run over two ranks with ``--ckpt-dir`` stopped at step 2, then
    resumed to 3: every rank restores, the losses are the uninterrupted
    torchrun run's, bitwise; only rank 0 made a checkpoint manager and
    printed."""
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    first = ranks.spawn_ranks(workers.launch, 2, "cpu", timeout=DEADLINE_S,
                              args=(LAUNCH + ["--steps", "2"] + ck,))
    second = ranks.spawn_ranks(workers.launch, 2, "cpu", timeout=DEADLINE_S,
                               args=(LAUNCH + ["--steps", "3"] + ck,))
    whole = _losses(two_ranks)
    for runs, start in ((first, 0), (second, 2)):
        assert [r["start"] for r in runs] == [start, start]
        assert runs[0]["losses"] == runs[1]["losses"]
        assert [r["managers"] for r in runs] == [1, 0]
        assert runs[0]["lines"] and not runs[1]["lines"]
    assert first[0]["losses"] == whole[:2]
    assert second[0]["losses"] == whole[2:]
    assert second[0]["lines"][1] == "[train] resumed from step 2"
    assert sorted(os.listdir(tmp_path / "ck")) == ["LATEST", "step_00000002"]
