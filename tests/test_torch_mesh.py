"""The port's mesh paths against the JAX package, on the CPU: the sharding
rules (``dist/sharding.py``), the sharding half of ``launch/specs.py``,
the expert-parallel MoE (``models/moe_ep.py``) and ``moe_apply_auto``'s
choice of it, the embedding's one-hot branch, the mesh train step with the
ZeRO-1 accumulator, ``dist/pipeline.py`` and the mesh-placed batches
(``data/pipeline.py``).

The JAX meshes are built with ``AxisType.Auto`` axes over the 8 CPU
devices of ``tests/conftest.py``: on this jax ``jax.make_mesh`` defaults to
``Explicit`` axes, which ``with_sharding_constraint`` refuses (ROADMAP.md
R1). The port's meshes list the CPU 8 times (``best_mesh(devices=[cpu] *
8)``), as the card hosts them.

Tolerances: specs are compared as tuples, exactly. The MoE against JAX:
outputs and aux within ``TOL`` = 1e-5 (float32 sums in other orders over
two or eight rows a token), the same kept assignments (exactly), the
router's choices held at least ``ROUTE_GAP`` apart (as
``tests/test_torch_lm_train.py``), gradients within ``TOL`` of each leaf's
largest. The train steps: the loss and metrics within
``test_torch_lm_train.py``'s ``TOL_METRIC``, gradients within
``TOL_GRAD`` of each leaf's largest, parameters within Adam's first-step
bound of that (``test_torch_lm_train.py``'s helpers). The pipeline: within
``TOL`` of JAX's stages applied in turn (the reference's
``pipeline_forward`` fails on an ``Auto`` mesh, R29b), and bitwise equal
to the port's stages applied in turn on the same microbatch shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import registry as jreg
from repro.configs.base import ShapeConfig
from repro.data import pipeline as jpipe
from repro.dist import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import moe_ep as jmoe_ep
from repro.train import optim as joptim
from repro.train import trainer as jtrainer
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as tpipe
from repro_torch.dist import pipeline as tpipeline
from repro_torch.dist import sharding as tsh
from repro_torch.dist.elastic import Mesh, best_mesh
from repro_torch.launch import specs as tspecs
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models import moe_ep as tmoe_ep
from repro_torch.train import optim as toptim
from repro_torch.train import trainer as ttrainer
from test_torch_lm_train import (ROUTE_GAP, TOL_GRAD, _jb, _metrics_close,
                                 _opt, _params_within, _port, _tb)

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 1e-5
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "8x1": ((8, 1), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
ARCHS = tuple(jreg.ARCH_IDS)


def _jmesh(shape, names):
    return jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(names))


def _tmesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array([CPU] * n, dtype=object).reshape(shape), names)


def _meshes(key):
    return _jmesh(*MESHES[key]), _tmesh(*MESHES[key])


def _jspecs(tree):
    """A JAX tree of specs or shardings as a list of tuples, leaf order."""
    leaves = jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(
            x, (jax.sharding.PartitionSpec, jax.sharding.NamedSharding)))
    return [tuple(getattr(s, "spec", s)) for s in leaves]


def _tspecs(tree):
    return [tuple(getattr(s, "spec", s)) for s in toptim.tree_leaves(tree)]


# -- the rules -------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
def test_resolve_and_divisibility_match_jax(mesh):
    jm, tm = _meshes(mesh)
    jr, tr = jsh.AxisRules(), tsh.AxisRules()
    names = list(jsh._DEFAULT_RULES) + [None, "unknown"]
    assert tsh._DEFAULT_RULES == jsh._DEFAULT_RULES
    for a in names:
        for b in names:
            assert tuple(tr.resolve(a, b, mesh=tm)) == tuple(
                jr.resolve(a, b, mesh=jm)), (a, b)
    over = {"batch": ("data", "model"), "ff": (), "embed_fsdp": None}
    jo, to = jr.with_overrides(**over), tr.with_overrides(**over)
    assert to.rules == jo.rules and to.embed_fsdp == jo.embed_fsdp
    for shape in [(8, 6, 4), (3, 5, 7), (16,), (2, 8)]:
        for axes in [("batch", "seq", "ff"), ("batch", "vocab"),
                     ("experts", None, "heads"), (("batch",))]:
            js = jsh.enforce_divisibility(jr.resolve(*axes, mesh=jm), shape,
                                          jm)
            ts = tsh.enforce_divisibility(tr.resolve(*axes, mesh=tm), shape,
                                          tm)
            assert tuple(ts) == tuple(js), (shape, axes)


_SDS = {}


def _abstract(arch):
    """JAX's full-size parameter shapes (``eval_shape``, nothing
    allocated) and the same tree as ``meta`` tensors in the port's form."""
    if arch not in _SDS:
        cfg = jreg.get_config(arch)
        sds = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0), cfg))

        def meta(node):
            if isinstance(node, dict):
                return {k: meta(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(meta(v) for v in node)
            return torch.empty(node.shape, dtype=torch.float32,
                               device="meta")
        _SDS[arch] = (sds, meta(sds))
    return _SDS[arch]


def test_meta_trees_mirror_the_ports_own_tree():
    """The ``meta`` trees below are the port's trees: at ``reduced()`` the
    port's ``init_lm`` has JAX's leaf paths and shapes, for every arch."""
    for arch in ARCHS:
        jp = jax.eval_shape(lambda: jlm.init_lm(
            jax.random.PRNGKey(0), jreg.get_config(arch).reduced()))
        tp = tlm.init_lm(0, treg.get_config(arch).reduced(), device="cpu")
        jpaths = [(jax.tree_util.keystr(k), v.shape) for k, v in
                  jax.tree_util.tree_flatten_with_path(jp)[0]]
        tpaths = []
        tsh._map_with_path(lambda p, x: tpaths.append(
            ("".join(f"[{k!r}]" for k in p), tuple(x.shape))), tp)
        assert sorted(tpaths) == sorted(jpaths), arch


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_infer_param_specs_match_jax_at_full_size(arch, mesh):
    jm, tm = _meshes(mesh)
    sds, meta = _abstract(arch)
    for jr, tr in [(jsh.AxisRules(), tsh.AxisRules()),
                   (jsh.AxisRules(embed_fsdp=None, experts_fsdp=None),
                    tsh.AxisRules(embed_fsdp=None, experts_fsdp=None))]:
        want = _jspecs(jsh.infer_param_specs(sds, rules=jr, mesh=jm))
        got = _tspecs(tsh.infer_param_specs(meta, rules=tr, mesh=tm))
        assert got == want


@pytest.mark.parametrize("mesh", ["4x2", "2x2x2", "8x1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_and_batch_sharding_match_jax(arch, mesh):
    """``train_state_sharding`` (with ZeRO-1 optimizer rules),
    ``param_sharding`` and ``batch_sharding`` at full size."""
    jm, tm = _meshes(mesh)
    sds, meta = _abstract(arch)
    jr, tr = jsh.AxisRules(), tsh.AxisRules()
    jz = jr.with_overrides(embed_fsdp=None)
    tz = tr.with_overrides(embed_fsdp=None)
    jstate = jtrainer.TrainState(sds, jax.eval_shape(joptim.init_adam_state,
                                                     sds))
    tstate = ttrainer.init_train_state(meta)
    jss = jspecs.train_state_sharding(jstate, jm, jz, opt_rules=jr)
    tss = tspecs.train_state_sharding(tstate, tm, tz, opt_rules=tr)
    assert _tspecs(tss) == _jspecs(jss)
    assert tss.opt["step"].spec == ()
    assert _tspecs(tspecs.param_sharding(meta, tm, tr)) == _jspecs(
        jspecs.param_sharding(sds, jm, jr))
    cfg = jreg.get_config(arch)
    for b in (8, 6, 1):
        jb = jspecs.input_specs(cfg, ShapeConfig("train", 16, b, "train"))
        tb = {k: torch.empty(v.shape, device="meta") for k, v in jb.items()}
        assert _tspecs(tspecs.batch_sharding(tb, tm, tr)) == _jspecs(
            jspecs.batch_sharding(jb, jm, jr))


def test_shard_is_the_identity_and_raises_where_jax_does():
    """``shard`` returns its tensor; a spec longer than the rank and one
    mesh axis on two dims (R29a: the sorted MoE path's ``shard(h,
    "experts", None, "ff")`` on a (data, model) mesh) raise in both
    packages; no mesh, no check."""
    jm, tm = _meshes("4x2")
    h = np.ones((8, 4, 6), np.float32)
    x = torch.from_numpy(h)
    assert tsh.shard(x, "experts", None, "ff") is x
    with tsh.use_mesh(tm):
        assert tsh.shard(x, "batch", "seq", "embed") is x
        with pytest.raises(tsh.DuplicateSpecError, match="duplicate"):
            tsh.shard(x, "experts", None, "ff")
        with pytest.raises(ValueError, match="incompatible"):
            tsh.shard(x[0], "batch", None, None)
    with jsh.use_mesh(jm):
        assert np.array_equal(np.asarray(jax.jit(lambda a: jsh.shard(
            a, "batch", "seq", "embed"))(h)), h)
        with pytest.raises(Exception) as err:
            jax.jit(lambda a: jsh.shard(a, "experts", None, "ff"))(h)
        assert type(err.value).__name__ == "DuplicateSpecError"
        with pytest.raises(ValueError, match="incompatible"):
            jax.jit(lambda a: jsh.shard(a, "batch", None, None))(h[0])
    with pytest.raises(ValueError, match="not found in mesh"):
        tsh.NamedSharding(tm, tsh.P("pod"))


def test_use_mesh_refuses_distinct_devices_and_nests():
    two = best_mesh(devices=[CPU, torch.device("meta")])
    with pytest.raises(NotImplementedError, match="item 9"):
        tsh.use_mesh(two)
    _, tm = _meshes("4x2")
    _, t1 = _meshes("1x1")
    assert tsh.current_mesh() is None
    with tsh.use_mesh(tm) as m:
        assert m is tm and tsh.current_mesh() is tm
        with tsh.use_mesh(t1, tsh.AxisRules(embed_fsdp=None)):
            assert tsh.current_mesh() is t1
            assert tsh.current_rules().embed_fsdp is None
        assert tsh.current_mesh() is tm
    assert tsh.current_mesh() is None and tm.size == 8


# -- expert-parallel MoE -------------------------------------------------------------

def _moe(e=8, pad_to=2, d=16, f=32, b=4, s=8, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), d, f, e, pad_to=pad_to)
    x = np.random.default_rng(seed).normal(0, 1, (b, s, d)).astype(
        np.float32)
    return jp, _port(jp), x


def _kept(gate_idx, cap, e_phys):
    """The reference's keep rule on one shard's choices, in numpy: a stable
    sort by expert, each assignment's rank within its expert, kept below
    the capacity; in (token, k) order."""
    flat = np.asarray(gate_idx).reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=e_phys)
    offs = np.cumsum(counts) - counts
    rank = np.empty_like(order)
    rank[order] = np.arange(flat.size) - offs[flat[order]]
    return rank < cap


@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("mesh", ["4x2", "2x4"])
def test_moe_apply_ep_matches_jax(mesh, cf):
    jm, tm = _meshes(mesh)
    jp, tp, x = _moe()
    r = np.random.default_rng(1).normal(0, 1, x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe_ep.moe_apply_ep(p, xx, top_k=2, capacity_factor=cf)
        return jnp.sum(y * r) + aux, (y, aux)

    with jsh.use_mesh(jm, jsh.AxisRules()):
        (_, (jy, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(jp, x)
    live = toptim.tree_map(lambda t: t.detach().requires_grad_(True), tp)
    tx = torch.from_numpy(x).requires_grad_(True)
    with tsh.use_mesh(tm, tsh.AxisRules()):
        ty, taux = tmoe_ep.moe_apply_ep(live, tx, top_k=2,
                                        capacity_factor=cf)
    (torch.sum(ty * torch.from_numpy(r)) + taux).backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=TOL,
                               rtol=0)
    assert abs(float(taux) - float(jaux)) <= TOL * abs(float(jaux))
    for k in ("router", "experts_gate", "experts_up", "experts_down"):
        g, want = live[k].grad.numpy(), np.asarray(jg[k])
        assert np.abs(g - want).max() <= TOL * np.abs(want).max(), k
    assert np.abs(tx.grad.numpy() - np.asarray(jgx)).max() <= TOL * np.abs(
        np.asarray(jgx)).max()

    # the kept assignments, shard by shard, and the router's margins
    dp = MESHES[mesh][0][0]
    bl = x.shape[0] // dp
    t = bl * x.shape[1]
    cap = tmoe.moe_capacity(t, 2, cf, 8)
    dropped = 0
    for i in range(dp):
        xt = x[i * bl:(i + 1) * bl].reshape(t, -1)
        _, jidx, _ = jmoe_ep._route_local(jp["router"], jnp.asarray(xt), 2)
        _, tidx, _, _ = tmoe_ep._route_local(tp["router"],
                                             torch.from_numpy(xt), 2)
        assert np.array_equal(tidx.numpy(), np.asarray(jidx))
        rank = tmoe._sort_assignments(tidx, 8)[4]
        keep = (rank < cap).numpy()
        assert np.array_equal(keep, _kept(jidx, cap, 8))
        dropped += int((~keep).sum())
        probs = torch.softmax(torch.from_numpy(xt) @ tp["router"], -1)
        top = probs.sort(-1, descending=True).values
        assert float((top[:, 1] - top[:, 2]).min()) >= ROUTE_GAP
    assert (dropped > 0) == (cf == 1.25)


@pytest.mark.parametrize("mesh", ["4x2", "2x4", "8x1", "2x2x2", "data8"])
def test_moe_apply_auto_takes_ep_exactly_where_jax_does(mesh, monkeypatch):
    """Over batches that do and do not divide the data extent and expert
    counts that do and do not divide the experts extent: the port takes
    the expert-parallel path exactly where JAX does and then matches it
    within ``TOL``. Where JAX takes the sorted path under a mesh whose
    ``model`` extent divides the experts it raises (R29a); the port's
    sorted path runs there and equals ``moe_apply`` without a mesh,
    bitwise."""
    spec = MESHES.get(mesh, ((8,), ("data",)))
    jm, tm = _jmesh(*spec), _tmesh(*spec)
    seen = {"jax": [], "torch": []}
    for pkg, mod in (("jax", jmoe_ep), ("torch", tmoe_ep)):
        orig = mod.moe_apply_ep

        def spy(*a, _orig=orig, _pkg=pkg, **kw):
            seen[_pkg].append(True)
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, "moe_apply_ep", spy)
    n_ep = 0
    for e, pad_to, b in [(8, 2, 4), (8, 2, 6), (6, 3, 8), (8, 8, 8),
                         (5, 16, 2)]:
        jp, tp, x = _moe(e=e, pad_to=pad_to, b=b, s=4, seed=e + b)
        seen["jax"].clear()
        seen["torch"].clear()
        with jsh.use_mesh(jm, jsh.AxisRules()):
            try:
                jy, jaux = jax.jit(lambda p, xx: jmoe.moe_apply_auto(
                    p, xx, top_k=2, capacity_factor=8.0))(jp, x)
                jerr = None
            except Exception as err:  # R29a, pinned below
                jerr = err
        with tsh.use_mesh(tm, tsh.AxisRules()):
            ty, taux = tmoe.moe_apply_auto(tp, torch.from_numpy(x), top_k=2,
                                           capacity_factor=8.0)
        assert bool(seen["torch"]) == bool(seen["jax"]), (e, pad_to, b)
        if seen["jax"]:
            n_ep += 1
            assert jerr is None
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL,
                                       rtol=0)
            assert abs(float(taux) - float(jaux)) <= TOL * abs(float(jaux))
            continue
        sy, saux = tmoe.moe_apply(tp, torch.from_numpy(x), top_k=2,
                                  capacity_factor=8.0)
        assert torch.equal(ty, sy) and torch.equal(taux, saux)
        # R29a: JAX's h [E, C, F] spec keeps "model" on E and F where both
        # divide by its extent
        m = dict(zip(spec[1], spec[0])).get("model")
        if m and e % m == 0 and 32 % m == 0:
            assert type(jerr).__name__ == "DuplicateSpecError"
        else:
            assert jerr is None
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL,
                                       rtol=0)
    assert n_ep == {"4x2": 3, "2x4": 4, "8x1": 0, "2x2x2": 3,
                    "data8": 0}[mesh]


# -- the LM under a mesh ----------------------------------------------------------

_LM = {}


def _lm(arch, b, s, seed=0):
    key = (arch, b, s)
    if key not in _LM:
        jcfg = jreg.get_config(arch).reduced()
        jp = jlm.init_lm(jax.random.PRNGKey(seed), jcfg)
        tokens = np.random.default_rng(len(arch) + b).integers(
            0, jcfg.vocab, (b, s)).astype(np.int32)
        _LM[key] = (jcfg, jp, tokens)
    jcfg, jp, tokens = _LM[key]
    return jcfg, treg.get_config(arch).reduced(), jp, _port(jp), tokens


def _route_recorder(monkeypatch) -> list:
    """The port's expert-parallel router calls keep their probabilities."""
    calls, orig = [], tmoe_ep._route_local

    def route(router_w, xt, k):
        out = orig(router_w, xt, k)
        calls.append(torch.softmax(xt.float() @ router_w, -1).detach())
        return out
    monkeypatch.setattr(tmoe_ep, "_route_local", route)
    return calls


def _min_gap(calls, k) -> float:
    return min(float((p.sort(-1, descending=True).values[:, k - 1]
                      - p.sort(-1, descending=True).values[:, k]).min())
               for p in calls)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-lite-16b"])
def test_lm_forward_under_the_mesh_matches_jax(arch, monkeypatch):
    """``lm_forward`` under a (4, 2) mesh: the one-hot embedding (the
    reduced vocabulary of 128 divides the model axis) and, for deepseek,
    the expert-parallel MoE; logits and aux against JAX's jitted forward
    under its mesh within ``TOL`` of their magnitude. The one-hot forward
    equals the gather's bitwise; prefill and decode gather."""
    jm, tm = _meshes("4x2")
    jcfg, tcfg, jp, tp, tokens = _lm(arch, 4, 16)
    calls = _route_recorder(monkeypatch)
    with jsh.use_mesh(jm, jsh.AxisRules()):
        jlog, jaux = jax.jit(lambda p, t: jlm.lm_forward(p, jcfg, t))(
            jp, tokens)
    tt = torch.from_numpy(tokens)
    with tsh.use_mesh(tm, tsh.AxisRules()):
        tlog, taux = tlm.lm_forward(tp, tcfg, tt)
        emb = tlm._embed(tp, tt, "train")
        live = {"embedding": tp["embedding"].clone().requires_grad_(True)}
        # the one-hot's gradient is a matmul; the gather's an index
        assert type(tlm._embed(live, tt, "train").grad_fn).__name__ == (
            "UnsafeViewBackward0")
        assert type(tlm._embed(live, tt, "decode").grad_fn).__name__ == (
            "IndexBackward0")
        assert torch.equal(tlm._embed(tp, tt, "decode"), emb)
    assert torch.equal(emb, tlm._embed(tp, tt))
    jlog = np.asarray(jlog)
    np.testing.assert_allclose(tlog.numpy(), jlog, rtol=0,
                               atol=TOL * max(1.0, np.abs(jlog).max()))
    assert abs(float(taux) - float(jaux)) <= TOL * max(1.0, abs(float(jaux)))
    if tcfg.n_experts:
        assert calls and _min_gap(calls, tcfg.top_k) >= ROUTE_GAP


def _jgrads_mesh(jcfg, jp, batch, jm):
    def loss_fn(params, b):
        logits, aux = jlm.lm_forward(params, jcfg, b["tokens"])
        from repro.train.losses import lm_loss
        return lm_loss(logits, b["tokens"])[0] + 0.01 * aux
    with jsh.use_mesh(jm, jsh.AxisRules()):
        _, grads = jax.jit(jax.value_and_grad(loss_fn))(jp, _jb(batch))
    return [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


@pytest.mark.parametrize("arch,b,accum", [("llama3.2-1b", 4, 2),
                                          ("granite-moe-3b-a800m", 16, 1)])
def test_mesh_train_step_matches_jax(arch, b, accum, monkeypatch):
    """One step of ``make_lm_train_step_fn`` under a (4, 2) mesh with the
    ZeRO-1 ``accum_rules``, against the reference's step jitted with
    ``train_state_sharding`` / ``batch_sharding`` under its mesh (llama:
    [4, 16] in two microbatches, the one-hot embedding; granite: [16, 16],
    the expert-parallel MoE). The batch is placed with ``shard_batch``."""
    jm, tm = _meshes("4x2")
    jcfg, tcfg, jp, tp, tokens = _lm(arch, b, 16)
    batch = {"tokens": tokens}
    calls = _route_recorder(monkeypatch)
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
    halves = [{"tokens": tokens[i * b // accum:(i + 1) * b // accum]}
              for i in range(accum)]
    jgs = [_jgrads_mesh(jcfg, jp, h, jm) for h in halves]
    jg = [sum(gs[1:], np.float32(0) + gs[0]) / np.float32(accum)
          for gs in zip(*jgs)] if accum > 1 else jgs[0]

    trules = tsh.AxisRules()
    tstep = ttrainer.make_lm_train_step_fn(tcfg, _opt(toptim),
                                           grad_accum=accum,
                                           accum_rules=trules)
    with tsh.use_mesh(tm, trules):
        tbatch = tpipe.shard_batch(_tb(batch), tm, trules)
        ts, tmet = tstep(ttrainer.init_train_state(tp), tbatch)
    _metrics_close(tmet, jmet, TOL_GRAD)
    _params_within(ts, js, jg, float(jmet["grad_norm"]), TOL_GRAD)
    if tcfg.n_experts:           # four data shards a layer
        assert len(calls) == 4 * tcfg.n_layers
        assert _min_gap(calls, tcfg.top_k) >= ROUTE_GAP


def test_accum_rules_shard_the_accumulator_under_a_mesh(monkeypatch):
    """Under a mesh the accumulator's specs are ``infer_param_specs`` of
    the ZeRO-1 rules, each put through a sharding constraint; without a
    mesh, or with one microbatch, the rules are not read."""
    _, tm = _meshes("2x4")
    jcfg, tcfg, jp, tp, tokens = _lm("llama3.2-1b", 4, 16)
    seen = []
    orig = tsh.with_sharding_constraint

    def spy(x, s):
        seen.append((tuple(x.shape), x.dtype, tuple(s.spec)))
        return orig(x, s)
    monkeypatch.setattr(ttrainer, "with_sharding_constraint", spy)
    rules = tsh.AxisRules(embed_fsdp=("data",))
    step = ttrainer.make_lm_train_step_fn(tcfg, _opt(toptim), grad_accum=2,
                                          accum_rules=rules)
    step(ttrainer.init_train_state(tp), _tb({"tokens": tokens}))
    assert not seen
    with tsh.use_mesh(tm, tsh.AxisRules()):
        step(ttrainer.init_train_state(tp), _tb({"tokens": tokens}))
    want = _jspecs(jsh.infer_param_specs(
        jax.tree_util.tree_map(lambda p: jnp.zeros(p.shape, jnp.float32), jp),
        rules=jsh.AxisRules(embed_fsdp=("data",)), mesh=_jmesh(
            *MESHES["2x4"])))
    assert sorted(map(str, want)) == sorted(str(s) for _, _, s in seen)
    assert all(dt == torch.float32 for _, dt, _ in seen)


# -- pipeline ------------------------------------------------------------------------

@pytest.mark.parametrize("stages,n_micro", [(4, 8), (4, 4), (2, 1), (1, 3)])
def test_pipeline_forward_matches_the_stages_in_turn(stages, n_micro):
    """``pipeline_forward`` over a mesh listing the CPU ``stages`` times
    against JAX's stage function applied in turn (``jax.vmap`` over the
    microbatches, as the reference's own test), within ``TOL``; bitwise
    the port's stages in turn on each microbatch. ``split_microbatches``
    equals JAX's."""
    rng = np.random.default_rng(stages * 10 + n_micro)
    ws = (rng.normal(0, 1, (stages, 8, 8)) * 0.3).astype(np.float32)
    x = rng.normal(0, 1, (n_micro * 2, 4, 8)).astype(np.float32)

    def jstage(w, xm):
        return jnp.tanh(xm @ w)

    jxs = jpipe_split(x, n_micro)
    want = jxs
    for i in range(stages):
        want = jax.vmap(lambda xm: jstage(ws[i], xm))(want)
    txs = tpipeline.split_microbatches(torch.from_numpy(x), n_micro)
    assert np.array_equal(txs.numpy(), np.asarray(jxs))
    mesh = Mesh(np.array([CPU] * stages, dtype=object), ("stage",))
    fwd = tpipeline.pipeline_forward(
        lambda w, xm: torch.tanh(xm @ w), mesh, "stage", n_micro)
    got = fwd(torch.from_numpy(ws), txs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    for m in range(n_micro):
        y = txs[m]
        for s in range(stages):
            y = torch.tanh(y @ torch.from_numpy(ws[s]))
        assert torch.equal(got[m], y)


def jpipe_split(x, n_micro):
    from repro.dist.pipeline import split_microbatches
    return split_microbatches(jnp.asarray(x), n_micro)


def test_pipeline_forward_takes_each_stage_on_its_device():
    """Stage ``s`` runs on the mesh device at coordinate ``s`` of the
    stage axis (the other axes replicate); a weight count that is not the
    stage axis's raises."""
    mesh = Mesh(np.array([[CPU, CPU], [CPU, CPU]], dtype=object),
                ("stage", "data"))
    used = []

    def stage(w, xm):
        used.append(w.device)
        return xm @ w
    fwd = tpipeline.pipeline_forward(stage, mesh, "stage", 2)
    out = fwd(torch.eye(3).repeat(2, 1, 1), torch.ones(2, 1, 3))
    assert torch.equal(out, torch.ones(2, 1, 3))
    assert len(used) == 2 * 3 and set(used) == {CPU}
    with pytest.raises(ValueError, match="stage weights"):
        fwd(torch.eye(3).repeat(3, 1, 1), torch.ones(2, 1, 3))


# -- mesh-placed batches -----------------------------------------------------------

@pytest.mark.parametrize("mesh", ["4x2", "2x2x2", "1x1"])
def test_shard_batch_and_prefetch_to_mesh_match_jax(mesh):
    jm, tm = _meshes(mesh)
    rng = np.random.default_rng(3)
    batches = [{"tokens": rng.integers(0, 128, (8, 16)).astype(np.int32),
                "image_embeds": rng.normal(0, 1, (8, 5, 4)).astype(
                    np.float32)} for _ in range(3)]
    jout = list(jpipe.prefetch_to_mesh(iter(batches), jm))
    tout = list(tpipe.prefetch_to_mesh((_tb(b) for b in batches), tm))
    assert len(tout) == len(jout) == 3
    for jb, tb, src in zip(jout, tout, batches):
        assert sorted(tb) == sorted(jb)
        for k in jb:
            assert tb[k].device == CPU
            assert tuple(tb[k].sharding.spec) == tuple(jb[k].sharding.spec)
            assert tb[k].sharding.mesh is tm
            assert np.array_equal(tb[k].numpy(), np.asarray(jb[k]))
    placed = {"tokens": torch.from_numpy(batches[0]["tokens"])}
    one = tpipe.shard_batch(placed, tm)
    assert one["tokens"] is not placed["tokens"]
    assert not hasattr(placed["tokens"], "sharding")
    if mesh != "1x1":
        with pytest.raises(ValueError, match="divisible"):
            tpipe.shard_batch({"tokens": torch.zeros(3, 4)}, tm)
        with pytest.raises(ValueError, match="divisible"):
            jpipe.shard_batch({"tokens": np.zeros((3, 4))}, jm)
