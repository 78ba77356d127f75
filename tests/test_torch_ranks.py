"""The port's mesh over ranks on the CPU: one process a rank, gloo, world
size 4 (``repro_torch.dist.ranks``). The process group and its refusals,
the mesh over the ranks (``best_mesh``, ``axis_group``), the blocks a rank
keeps (``device_put``, ``shard_batch``) against JAX's shards, the
expert-parallel MoE's all-to-all against the one-process loop, and the
pipeline's send / recv against the stages applied in turn.

Every rank runs in a process that ``spawn_ranks`` starts, with a deadline
of ``DEADLINE_S``; the workers live in ``torch_rank_workers.py``, which
imports no JAX. JAX runs here, in the parent.

Tolerances: the blocks, the MoE's outputs and the pipeline are bitwise.
The MoE's aux loss is within ``AUX_ULPS`` ulp: its router statistics are
summed over the data group in gloo's order, the one-process loop's in
shard order. Its gradients are within ``TOL_GRAD`` of each leaf's largest
(sums in other orders).
"""
import ast
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, NamedSharding, PartitionSpec

from repro_torch.dist import ranks
from repro_torch.dist import sharding as tsh
from repro_torch.data.pipeline import shard_batch
from repro_torch.dist.elastic import Mesh, best_mesh
from repro_torch.models import moe_ep as tmoe_ep
from test_torch_mesh import _moe
import torch_rank_workers as workers

torch.set_num_threads(1)

CPU = torch.device("cpu")
WORLD = 4
DEADLINE_S = 120
AUX_ULPS = 2
TOL_GRAD = 1e-6
MPS = (1, 2)            # (4, 1) and (2, 2) meshes over the four ranks


def _spawn(fn, *args):
    return ranks.spawn_ranks(fn, WORLD, "cpu", timeout=DEADLINE_S,
                             args=args)


def _cpu_mesh(shape):
    n = int(np.prod(shape))
    return Mesh(np.array([CPU] * n, dtype=object).reshape(shape),
                ("data", "model"))


def test_ranks_imports_only_the_standard_library_torch_and_the_port():
    """``dist/ranks.py`` and the workers' module: every import is of the
    standard library, ``torch`` or ``repro_torch`` (the workers' also
    numpy), so a spawned rank never imports JAX."""
    root = Path(__file__).resolve().parents[1]
    for path, extra in ((root / "src/repro_torch/dist/ranks.py", ()),
                        (Path(workers.__file__), ("numpy",))):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert (top in sys.stdlib_module_names or top in (
                    "torch", "repro_torch") + extra), (path.name, name)


def test_init_ranks_refuses_the_wrong_backend_and_a_missing_group(
        monkeypatch):
    """The backend follows the device and nothing else chooses it: a
    CUDA rank asks the process group for NCCL and never gloo, the CPU for
    gloo, and a device with no backend raises before any group forms;
    without a rank and world size (or torchrun's environment)
    ``init_ranks`` raises; without a group there is no rank device and no
    mesh over ranks, and ``best_mesh`` with devices stays in-process."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    asked = []

    class Stop(Exception):
        pass

    def init_process_group(backend, **kw):
        asked.append((backend, kw["device_id"]))
        raise Stop
    monkeypatch.setattr(ranks.dist, "init_process_group", init_process_group)
    monkeypatch.setattr(ranks, "resolve_device", lambda dev: dev)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    for device in ("cuda:0", "cpu"):
        with pytest.raises(Stop):
            ranks.init_ranks(device, rank=0, world_size=1)
    assert asked == [("nccl", torch.device("cuda:0")), ("gloo", None)]
    monkeypatch.undo()
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="no backend for a meta device"):
        ranks.init_ranks("meta", rank=0, world_size=1)
    with pytest.raises(ValueError, match="torchrun environment"):
        ranks.init_ranks("cpu")
    with pytest.raises(ValueError, match="rank 2 of a world of 2"):
        ranks.init_ranks("cpu", rank=2, world_size=2)
    assert not ranks.ranks_ready()
    with pytest.raises(RuntimeError, match="no process group"):
        ranks.rank_device()
    mesh = best_mesh(devices=[CPU] * 4, model_parallel=2)
    assert not mesh.on_ranks and tsh.mesh_device(mesh) == CPU


def test_a_mesh_over_distinct_devices_in_one_process_still_raises():
    two = Mesh(np.array([[CPU, torch.device("meta")]], dtype=object))
    with pytest.raises(NotImplementedError, match="Multi-card GSPMD"):
        tsh.use_mesh(two)


def test_a_failed_rank_is_raised_with_its_traceback(tmp_path):
    """A rank that raises ends the spawn at once: the parent kills the
    others and raises with the child's traceback."""
    with pytest.raises(RuntimeError, match="rank 3 of 4 is out"):
        ranks.spawn_ranks(workers.fail_on, WORLD, "cpu",
                          workdir=str(tmp_path), timeout=DEADLINE_S,
                          args=(3,))
    assert not list(tmp_path.iterdir())


def test_ranks_past_the_deadline_are_killed(tmp_path):
    """Ranks that outlast the spawn's deadline are killed and the parent
    raises, well before they would have finished."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish in 6"):
        ranks.spawn_ranks(workers.stall, WORLD, "cpu",
                          workdir=str(tmp_path), timeout=6, args=(300,))
    assert time.monotonic() - t0 < 60
    assert not list(tmp_path.iterdir())


def test_the_mesh_over_ranks_its_positions_and_groups():
    """``best_mesh`` over four ranks: (4, 1) and (2, 2) in rank order, each
    rank at its own position on its own device, and ``axis_group`` the
    ranks that differ only along the named axes."""
    got = _spawn(workers.mesh_layout, MPS)
    for mp in MPS:
        shape = (WORLD // mp, mp)
        want = np.arange(WORLD).reshape(shape)
        for r, out in enumerate(got):
            o = out[mp]
            assert o["on_ranks"] and o["device"] == "cpu"
            assert o["shape"] == {"data": shape[0], "model": shape[1]}
            assert o["ranks"] == want.tolist()
            i, j = divmod(r, mp)
            assert o["coords"] == {"data": i, "model": j}
            assert o["groups"][("data",)] == want[:, j].tolist()
            assert o["groups"][("model",)] == want[i, :].tolist()
            assert o["groups"][("data", "model")] == list(range(WORLD))


def test_the_gradient_buckets_reduce_each_dtype_in_its_own():
    """The train step's reduction over the data group: one all-reduce a
    dtype (the fp32 leaves and the metrics in one bucket, the bf16 leaves
    in another), each leaf back in its dtype, the mean over the ranks of
    its data group (exact: the values are exact in bf16), ``tokens``
    summed and the other metrics averaged."""
    got = _spawn(workers.bucket_reduction, MPS)
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    for mp in MPS:
        dp = WORLD // mp
        for r, out in enumerate(got):
            o = out[mp]
            data = [q for q in range(WORLD) if q % mp == r % mp]
            assert len(data) == dp and o["all_reduce"] == 2
            want = [(np.mean([base + q for q in data], 0), "torch.float32"),
                    (np.mean([base * 0.5 - q for q in data], 0),
                     "torch.bfloat16"),
                    (np.full(5, np.mean([0.25 * q for q in data])),
                     "torch.float32"),
                    (np.full(4, np.mean([2.0 * q for q in data])),
                     "torch.bfloat16")]
            for (g, dtype), (w, wdtype) in zip(o["grads"], want):
                assert dtype == wdtype and np.array_equal(g, w), (mp, r)
            assert o["metrics"] == {"loss": 1.0 + np.mean(data),
                                    "tokens": 8.0 * dp}


def test_device_put_and_shard_batch_keep_jaxs_shard_on_each_rank():
    """Each rank's ``device_put`` block under a spec is the shard JAX's
    ``device_put`` puts on the device at that rank's mesh position, and
    its ``shard_batch`` rows are the batch's shard there; the spec is the
    one-process placement's."""
    rng = np.random.default_rng(7)
    arrays = {"a": rng.normal(0, 1, (8, 4, 6)).astype(np.float32)}
    specs = [(), ("data",), (None, "model"), (("data", "model"),),
             ("model", None, None), ("data", None, "model")]
    batch = {"tokens": rng.integers(0, 128, (8, 16)).astype(np.int32),
             "image_embeds": rng.normal(0, 1, (8, 5, 4)).astype(
                 np.float32)}
    got = _spawn(workers.placements, MPS, arrays, specs, batch)
    for mp in MPS:
        shape = (WORLD // mp, mp)
        jm = jax.make_mesh(shape, ("data", "model"),
                           axis_types=(AxisType.Auto,) * 2,
                           devices=jax.devices()[:WORLD])
        placed = shard_batch({k: torch.from_numpy(v)
                              for k, v in batch.items()}, _cpu_mesh(shape))
        for r, out in enumerate(got):
            o = out[mp]
            dev = jm.devices[o["coords"]["data"], o["coords"]["model"]]

            def shard_of(a, spec):
                put = jax.device_put(a, NamedSharding(jm, PartitionSpec(
                    *spec)))
                return next(np.asarray(s.data) for s in put.addressable_shards
                            if s.device == dev)
            for (name, spec), (block, got_spec) in o["put"].items():
                assert got_spec == spec
                assert np.array_equal(block, shard_of(arrays[name], spec)), (
                    mp, r, spec)
            for k, (rows, spec) in o["batch"].items():
                assert spec == tuple(placed[k].sharding.spec)
                assert np.array_equal(rows, shard_of(batch[k], spec))


MOE_CFS = (8.0, 1.25)


@pytest.fixture(scope="module")
def moe_case():
    """The MoE, its input and cotangent, and every rank's results on both
    meshes (one spawn)."""
    jp, tp, x = _moe(e=8, pad_to=2, b=8, s=8)
    r = np.random.default_rng(1).normal(0, 1, x.shape).astype(np.float32)
    params = {k: v.numpy() for k, v in tp.items()}
    got = _spawn(workers.moe_forward_backward, MPS, params, x, r, 2,
                 MOE_CFS)
    return tp, x, r, got


@pytest.mark.parametrize("mp", [2, 1])
def test_moe_apply_ep_over_ranks_is_the_one_process_loop(mp, moe_case):
    """``moe_apply_ep`` over the ranks (two all-to-alls over the experts
    group) at (2, 2), and at (4, 1) where the experts group is one rank:
    each rank's output rows bitwise the one-process loop's on the same
    mesh listing the CPU four times, at a capacity that drops assignments
    and one that does not; aux within ``AUX_ULPS`` ulp; the gradients of
    ``sum(y * r) + aux``, reduced as the train step reduces them, within
    ``TOL_GRAD`` of the one-process gradients of the global batch's loss
    (``sum(y * r) / dp + aux``, the mean of the ranks' losses), and each
    rank's ``x`` gradient ``dp`` times its rows of the one-process one."""
    tp, x, r, got = moe_case
    got = [out[mp] for out in got]
    cfs = MOE_CFS
    shape = (WORLD // mp, mp)
    dp = shape[0]
    bl = x.shape[0] // dp
    for cf in cfs:
        live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        tx = torch.from_numpy(x).requires_grad_(True)
        with tsh.use_mesh(_cpu_mesh(shape), tsh.AxisRules()):
            y, aux = tmoe_ep.moe_apply_ep(live, tx, top_k=2,
                                          capacity_factor=cf)
        (torch.sum(y * torch.from_numpy(r)) / dp + aux).backward()
        ulp = np.spacing(np.float32(aux.item()))
        for rank, out in enumerate(got):
            o, i = out[cf], out["coords"]["data"]
            assert np.array_equal(o["y"], y.detach().numpy()[
                i * bl:(i + 1) * bl]), (cf, rank)
            assert abs(o["aux"] - aux.item()) <= AUX_ULPS * ulp
            for k, g in o["grads"].items():
                want = live[k].grad.numpy()
                assert np.abs(g - want).max() <= TOL_GRAD * np.abs(
                    want).max(), (cf, rank, k)
            want = dp * tx.grad.numpy()[i * bl:(i + 1) * bl]
            assert np.abs(o["dx"] - want).max() <= TOL_GRAD * np.abs(
                want).max()
            # forward and backward: two exchanges each, over the experts
            # group; the router statistics summed over the data group
            assert o["collectives"]["all_to_all"] == 4
        assert (cf == 1.25) == bool(_dropped(x, tp, dp, cf))


def _dropped(x, tp, dp, cf):
    """Assignments the capacity drops over the data shards."""
    from repro_torch.models import moe as tmoe
    bl = x.shape[0] // dp
    t = bl * x.shape[1]
    cap = tmoe.moe_capacity(t, 2, cf, 8)
    n = 0
    for i in range(dp):
        xt = torch.from_numpy(x[i * bl:(i + 1) * bl].reshape(t, -1))
        idx = tmoe_ep._route_local(tp["router"], xt, 2)[1]
        n += int((tmoe._sort_assignments(idx, 8)[4] >= cap).sum())
    return n


PIPELINES = [((4,), ("stage",), 8), ((4,), ("stage",), 3),
             ((2, 2), ("stage", "data"), 4)]


def _pipeline_inputs(shape, n_micro):
    rng = np.random.default_rng(shape[0] * 10 + n_micro)
    ws = (rng.normal(0, 1, (shape[0], 8, 8)) * 0.3).astype(np.float32)
    x = rng.normal(0, 1, (n_micro * 2, 4, 8)).astype(np.float32)
    return ws, x


@pytest.fixture(scope="module")
def pipelines():
    """Every case of ``PIPELINES`` over the ranks (one spawn)."""
    cases = [(shape, names, *_pipeline_inputs(shape, n), n)
             for shape, names, n in PIPELINES]
    got = _spawn(workers.pipelines, cases)
    return {case: [out[i] for out in got]
            for i, case in enumerate(PIPELINES)}


@pytest.mark.parametrize("shape,names,n_micro", PIPELINES)
def test_pipeline_over_ranks_is_the_stages_in_turn(shape, names, n_micro,
                                                   pipelines):
    """``pipeline_forward`` with each stage on its own rank, hops by send /
    recv in the ``M + S - 1`` tick schedule: every rank returns the last
    stage's outputs, bitwise the stages applied in turn on each microbatch
    (as ``test_torch_mesh.py`` holds the one-process pipeline); over a
    (2, 2) mesh two pipelines run side by side."""
    n_stages = shape[0]
    ws, x = _pipeline_inputs(shape, n_micro)
    got = pipelines[(shape, names, n_micro)]
    want = torch.from_numpy(x).reshape(n_micro, 2, 4, 8)
    for s in range(n_stages):
        want = torch.stack([torch.tanh(want[m] @ torch.from_numpy(ws[s]))
                            for m in range(n_micro)])
    for out in got:
        assert np.array_equal(out, want.numpy())
