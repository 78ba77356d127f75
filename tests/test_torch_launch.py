"""The port's launch tooling against the JAX package, on the CPU:
``launch/mesh.py``, the abstract half of ``launch/specs.py``, the op-cost
counter ``launch/hlo_cost.py`` and the dry-run ``launch/dryrun.py``.

* The abstract structures (meta tensors) equal ``jax.eval_shape``'s, leaf
  path for leaf path, shape and dtype, for every arch at full size.
* Specs are compared as tuples, exactly: on a (2, 4) ``Auto`` mesh of the
  8 host devices against the port's mesh listing the CPU 8 times, and the
  rule functions also at the production extents (16, 16) and (2, 16, 16),
  where JAX is handed a stand-in mesh (its rules read only the axis names
  and extents). Per-device bytes are equal.
* The op-cost counter is exact on ``tests/test_hlo_cost.py``'s hand counts;
  on a reduced llama3.2-1b forward and train step its FLOPs equal JAX's
  ``module_costs`` over the jitted step (measured gap: 0, within the 2 %
  asked). The meta-device loop of the plain scans counts the FLOPs and the
  core traffic of the loop run trip by trip exactly, its raw traffic
  within 2 % (the first trip has no carry gradient to compute) and its
  peak live bytes within 10 %.
* The dry-run completes a train, a prefill and a decode cell of
  smollm-360m on ``make_debug_mesh(devices=["cpu"] * 4)`` with the
  arguments' per-device bytes of JAX's specs, and its depth extension
  equals a run of the whole stack.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import registry as jreg
from repro.configs.base import ALL_SHAPES as J_SHAPES
from repro.dist import sharding as jsh
from repro.launch import specs as jspecs
from repro.launch.hlo_cost import module_costs
from repro.models import lm as jlm
from repro.train import optim as joptim
from repro.train import trainer as jtrainer
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ALL_SHAPES, ShapeConfig
from repro_torch.dist import sharding as tsh
from repro_torch.kernels.rglru_scan import rglru_scan_batched_ref
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_batched_ref
from repro_torch.launch import dryrun, hlo_cost
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.models import lm as tlm
from repro_torch.train import optim as toptim
from repro_torch.train import trainer as ttrainer

torch.set_num_threads(1)

ARCHS = tuple(jreg.ARCH_IDS)
SHAPES = {s.name: s for s in ALL_SHAPES}
J_SHAPE = {s.name: s for s in J_SHAPES}
DECODE = SHAPES["decode_32k"]


# -- trees -------------------------------------------------------------------

def _jleaves(tree) -> dict:
    """``{path: (shape, dtype name)}`` of a JAX tree."""
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", getattr(
            k, "name", None))) for k in path)
        out[key] = (tuple(x.shape), jnp.dtype(x.dtype).name)
    return out


def _tleaves(tree) -> dict:
    out = {}

    def one(path, x):
        out[path] = (tuple(x.shape), str(x.dtype).split(".")[-1])
    tsh._map_with_path(one, tree)
    return out


def _jspecs(tree) -> dict:
    return {k: tuple(s.spec) for k, s in _jpaths(tree).items()}


def _jpaths(tree) -> dict:
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", getattr(
            k, "name", None))) for k in path)
        out[key] = s
    return out


def _tspecs(tree) -> dict:
    out = {}

    def one(path, s):
        out[path] = tuple(s.spec)
    tsh._map_with_path(one, tree)
    return out


def _jbytes(tree, shardings) -> int:
    """Per-device bytes of a JAX tree laid out by its shardings."""
    total = 0
    xs = jax.tree_util.tree_leaves(tree)
    ss = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    for x, s in zip(xs, ss):
        total += int(np.prod(s.shard_shape(x.shape))) * jnp.dtype(
            x.dtype).itemsize
    return total


def _jmesh(shape, names):
    return jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(names))


def _tmesh(shape, names):
    n = int(np.prod(shape))
    return tsh.Mesh(np.array([torch.device("cpu")] * n,
                             dtype=object).reshape(shape), names)


# -- mesh ----------------------------------------------------------------------

def test_production_and_debug_meshes():
    m = tmesh.make_production_mesh(devices="cpu")
    assert m.axis_names == ("data", "model") and m.shape == {
        "data": 16, "model": 16} and m.size == 256
    assert {str(d) for d in m.devices.flat} == {"cpu"}
    m = tmesh.make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(ValueError, match="positions"):
        tmesh.make_production_mesh(devices=["cpu"] * 8)
    assert tmesh.make_debug_mesh(devices=["cpu"] * 4).shape == {
        "data": 2, "model": 2}
    assert tmesh.make_debug_mesh(devices=["cpu"] * 3).shape == {
        "data": 2, "model": 1}
    assert tmesh.make_debug_mesh(4, 2, devices=["cpu"] * 8).shape == {
        "data": 4, "model": 2}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_at_production_extents(arch, multi_pod):
    """``resolve`` (batch over pod and data), ``enforce_divisibility`` and
    ``infer_param_specs`` on the production meshes, every parameter leaf of
    every arch, against JAX's rule functions on a stand-in mesh of the same
    axes and extents."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    tm = tmesh.make_production_mesh(multi_pod=multi_pod, devices="cpu")
    jm = types.SimpleNamespace(axis_names=names, devices=np.empty(shape))
    for rules in ((jsh.AxisRules(), tsh.AxisRules()),
                  (jsh.AxisRules().with_overrides(embed_fsdp=None),
                   tsh.AxisRules().with_overrides(embed_fsdp=None))):
        got = rules[1].resolve("batch", "seq", "heads", mesh=tm)
        assert tuple(got) == tuple(rules[0].resolve("batch", "seq", "heads",
                                                    mesh=jm))
        for dims in ((32, 4096, 7), (1, 12, 16), (512, 2, 48)):
            assert tuple(tsh.enforce_divisibility(got, dims, tm)) == tuple(
                jsh.enforce_divisibility(jsh.P(*got), dims, jm))
        jparams = jspecs.abstract_params(jreg.get_config(arch))
        tparams = tspecs.abstract_params(treg.get_config(arch))
        jp = jsh.infer_param_specs(jparams, rules=rules[0], mesh=jm)
        tp = tsh.infer_param_specs(tparams, rules=rules[1], mesh=tm)
        want = {k: tuple(v) for k, v in _jpaths_specs(jp).items()}
        assert _tspecs_p(tp) == want
    if multi_pod:
        assert tuple(got)[0] == ("pod", "data")


def _jpaths_specs(tree) -> dict:
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jsh.P))[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", getattr(
            k, "name", None))) for k in path)
        out[key] = s
    return out


def _tspecs_p(tree) -> dict:
    out = {}

    def one(path, s):
        out[path] = tuple(s)
    tsh._map_with_path(one, tree)
    return out


# -- abstract structures -------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_structures_equal_eval_shape(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    jst = jspecs.abstract_train_state(jcfg)
    tst = tspecs.abstract_train_state(tcfg)
    assert {x.device.type for x in toptim.tree_leaves(tst)} == {"meta"}
    assert _tleaves(tst.params) == _jleaves(jst.params)
    assert _tleaves(tst) == _jleaves(jst)
    assert _tleaves(tspecs.abstract_params(tcfg)) == _jleaves(
        jspecs.abstract_params(jcfg))
    b, s = DECODE.global_batch, DECODE.seq_len
    assert _tleaves(tspecs.abstract_caches(tcfg, b, s)) == _jleaves(
        jspecs.abstract_caches(jcfg, b, s))
    for name, shape in SHAPES.items():
        assert _tleaves(tspecs.input_specs(tcfg, shape)) == _jleaves(
            jspecs.input_specs(jcfg, J_SHAPE[name])), name


def test_abstract_params_draw_nothing_and_init_lm_refuses_meta():
    cfg = treg.get_config("qwen2.5-32b")
    params = tspecs.abstract_params(cfg)
    n = sum(x.numel() for x in toptim.tree_leaves(params))
    assert n > 3e10
    assert all(x.is_meta for x in toptim.tree_leaves(params))
    with pytest.raises(ValueError, match="unsupported device"):
        tlm.init_lm(0, cfg.reduced(), device="meta")


# -- specs ------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch):
    jm, tm = _jmesh((2, 4), ("data", "model")), _tmesh((2, 4),
                                                       ("data", "model"))
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    jr, tr = jsh.AxisRules(), tsh.AxisRules()
    jz = jr.with_overrides(embed_fsdp=None)
    tz = tr.with_overrides(embed_fsdp=None)
    jst, tst = (jspecs.abstract_train_state(jcfg),
                tspecs.abstract_train_state(tcfg))
    pairs = [(jspecs.param_sharding(jst.params, jm, jr),
              tspecs.param_sharding(tst.params, tm, tr), jst.params,
              tst.params)]
    for (jrules, trules) in ((jr, tr), (jz, tz)):
        pairs.append((jspecs.train_state_sharding(jst, jm, jrules,
                                                  opt_rules=jr),
                      tspecs.train_state_sharding(tst, tm, trules,
                                                  opt_rules=tr), jst, tst))
    b, s = DECODE.global_batch, DECODE.seq_len
    jc, tc = (jspecs.abstract_caches(jcfg, b, s),
              tspecs.abstract_caches(tcfg, b, s))
    pairs.append((jspecs.cache_sharding(jcfg, jc, jm, jr),
                  tspecs.cache_sharding(tcfg, tc, tm, tr), jc, tc))
    for name, shape in SHAPES.items():
        jb = jspecs.input_specs(jcfg, J_SHAPE[name])
        tb = tspecs.input_specs(tcfg, shape)
        pairs.append((jspecs.batch_sharding(jb, jm, jr),
                      tspecs.batch_sharding(tb, tm, tr), jb, tb))
    for jsh_tree, tsh_tree, jtree, ttree in pairs:
        assert _tspecs(tsh_tree) == _jspecs(jsh_tree)
        assert tspecs.per_device_bytes(ttree, tsh_tree) == _jbytes(
            jtree, jsh_tree)
    for batch, vocab in ((0, 0), (32, jcfg.vocab), (1, jcfg.vocab)):
        assert tuple(tspecs.logits_sharding(tm, tr, batch, vocab).spec) == \
            tuple(jspecs.logits_sharding(jm, jr, batch, vocab).spec)


# -- the op-cost counter ---------------------------------------------------------

def _flops(fn, *args):
    return hlo_cost.step_costs(fn, *args)["flops_per_device"]


def test_hand_counts():
    """``tests/test_hlo_cost.py``'s programs: one matmul, a loop of 13
    trips, loops of 4 x 5 trips, a batched dot."""
    e = torch.empty
    assert _flops(lambda x, y: x @ y, e(128, 256), e(256, 64)) == \
        2 * 128 * 256 * 64

    def loop(w, x, n):
        for _ in range(n):
            x = x @ w
        return x
    assert _flops(lambda w, x: loop(w, x, 13), e(64, 64), e(64, 64)) == \
        13 * 2 * 64 ** 3

    def nested(w, x):
        for _ in range(4):
            x = loop(w, x, 5)
        return x
    assert _flops(nested, e(32, 32), e(32, 32)) == 20 * 2 * 32 ** 3
    assert _flops(lambda x, y: torch.einsum("bij,bjk->bik", x, y),
                  e(4, 16, 32), e(4, 32, 8)) == 2 * 4 * 16 * 32 * 8


def test_counts_are_per_device_under_a_mesh_and_track_live_bytes():
    a, b = torch.empty(128, 256), torch.empty(256, 64)
    with tsh.use_mesh(_tmesh((2, 4), ("data", "model"))):
        c = hlo_cost.step_costs(lambda x, y: x @ y, a, b)
    assert c["flops_per_device"] == 2 * 128 * 256 * 64 / 8
    assert c["collective_bytes_per_device"] is None
    assert c["collectives"] is None

    def two_temporaries(x):
        y = x * 2           # 4 KiB, kept
        z = y + 1           # 4 KiB, freed before w
        del z
        w = y - 1           # 4 KiB
        return w
    c = hlo_cost.step_costs(two_temporaries, torch.empty(1024))
    assert c["peak_live_bytes"] == 2 * 4096
    # a view and an in-place op allocate nothing, and move no new storage
    c = hlo_cost.step_costs(lambda x: x.t().add_(1), torch.empty(8, 8))
    assert c["peak_live_bytes"] == 0
    assert c["hbm_traffic_core_per_device"] == 0            # elementwise
    assert c["hbm_traffic_per_device"] == 2 * 8 * 8 * 4


@pytest.mark.parametrize("what", ["forward", "train"])
def test_llama_flops_equal_the_reference_walk(what):
    jcfg = jreg.get_config("llama3.2-1b").reduced()
    tcfg = treg.get_config("llama3.2-1b").reduced()
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = tlm.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (4, 16)).astype(
        np.int32)
    if what == "forward":
        text = jax.jit(lambda p, t: jlm.lm_forward(p, jcfg, t)).lower(
            jp, toks).compile().as_text()
        got = _flops(lambda p, t: tlm.lm_forward(p, tcfg, t), tp,
                     torch.from_numpy(toks))
    else:
        step = jtrainer.make_lm_train_step_fn(jcfg, joptim.AdamConfig())
        text = jax.jit(step).lower(jtrainer.init_train_state(jp),
                                   {"tokens": toks}).compile().as_text()
        got = _flops(ttrainer.make_lm_train_step_fn(tcfg, toptim.AdamConfig()),
                     ttrainer.init_train_state(tp),
                     {"tokens": torch.from_numpy(toks)})
    want = module_costs(text)["flops_per_device"]
    assert want > 0 and abs(got / want - 1) <= 0.02


def _scan_inputs(which, device, grad):
    g = torch.Generator().manual_seed(0)

    def mk(*shape, lo=0.0):
        x = (lo + (1 - lo) * torch.rand(*shape, generator=g)).to(device)
        return x.requires_grad_(grad)
    if which == "rwkv6":
        b, h, t, d = 2, 3, 9, 8
        return [mk(b, h, t, d), mk(b, h, t, d), mk(b, h, t, d),
                mk(b, h, t, d, lo=0.5), mk(h, d)]
    return [mk(2, 9, 16), mk(2, 9, 16, lo=0.5)]


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("which", ["rwkv6", "rglru"])
def test_meta_scan_counts_its_trips(which, grad):
    scan = rwkv6_scan_batched_ref if which == "rwkv6" else \
        rglru_scan_batched_ref

    def run(*args):
        y, s = scan(*args)
        if grad:
            (y.sum() + s.sum()).backward()
        return y, s

    costs, outs = {}, {}
    for dev in ("cpu", "meta"):
        args = _scan_inputs(which, dev, grad)
        costs[dev] = hlo_cost.step_costs(run, *args)
        outs[dev] = [tuple(o.shape) for o in run(*args)]
        if grad:
            assert [tuple(a.grad.shape) for a in args] == [
                tuple(a.shape) for a in args]
    assert outs["cpu"] == outs["meta"]
    cpu, meta = costs["cpu"], costs["meta"]
    assert meta["flops_per_device"] == cpu["flops_per_device"]
    assert meta["hbm_traffic_core_per_device"] == \
        cpu["hbm_traffic_core_per_device"]
    assert abs(meta["hbm_traffic_per_device"]
               / cpu["hbm_traffic_per_device"] - 1) <= 0.02
    assert abs(meta["peak_live_bytes"] / cpu["peak_live_bytes"] - 1) <= 0.1


# -- the dry-run -------------------------------------------------------------------

def _jargs(jcfg, shape, jm, jr) -> int:
    batch = jspecs.input_specs(jcfg, shape)
    total = _jbytes(batch, jspecs.batch_sharding(batch, jm, jr))
    if shape.kind == "train":
        st = jspecs.abstract_train_state(jcfg)
        return total + _jbytes(st, jspecs.train_state_sharding(st, jm, jr))
    p = jspecs.abstract_params(jcfg)
    c = jspecs.abstract_caches(jcfg, shape.global_batch, shape.seq_len)
    return (total + _jbytes(p, jspecs.param_sharding(p, jm, jr))
            + _jbytes(c, jspecs.cache_sharding(jcfg, c, jm, jr)))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_run_cell_on_a_debug_mesh(shape):
    mesh = tmesh.make_debug_mesh(devices=["cpu"] * 4)
    rec = dryrun.run_cell("smollm-360m", SHAPES[shape], mesh=mesh)
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh"] == "2x2" and rec["n_devices"] == 4
    jm = _jmesh((2, 2), ("data", "model"))
    want = _jargs(jreg.get_config("smollm-360m"), J_SHAPE[shape], jm,
                  jsh.AxisRules())
    assert rec["memory"]["argument_bytes"] == want
    cost = rec["cost"]
    assert cost["flops_per_device"] > 0 and cost["peak_live_bytes"] > 0
    assert rec["memory"]["device_bytes"] == dryrun.H100_HBM_BYTES
    if shape == "train_4k":
        assert rec["grad_accum"] == dryrun._grad_accum_for(
            treg.get_config("smollm-360m"), SHAPES[shape], 2)


@pytest.mark.parametrize("arch,kw,kind", [
    ("llama3.2-1b", {"n_layers": 5}, "train"),
    ("recurrentgemma-9b", {"n_layers": 11}, "prefill"),
    ("seamless-m4t-large-v2", {"n_layers": 4, "n_encoder_layers": 3},
     "train")])
def test_depth_extension_equals_the_whole_stack(arch, kw, kind,
                                                monkeypatch):
    """FLOPs and traffic of one and two periods extended to the full depth
    equal a run of every layer, for a plain stack, a schedule with a
    remainder entry and an encoder-decoder."""
    cfg = treg.get_config(arch).reduced(**kw)
    monkeypatch.setattr(dryrun, "get_config", lambda _: cfg)
    shape = ShapeConfig("t", 16, 4, kind)
    mesh = tmesh.make_debug_mesh(devices=["cpu"] * 4)
    ext = dryrun.run_cell(arch, shape, mesh=mesh, grad_accum=2)
    full = dryrun.run_cell(arch, shape, mesh=mesh, grad_accum=2,
                           full_depth=True)
    assert ext["ok"] and full["ok"], (ext.get("traceback"),
                                      full.get("traceback"))
    assert len(ext["depth_points"]) > 1
    for key in ("flops_per_device", "hbm_traffic_per_device",
                "hbm_traffic_core_per_device"):
        assert ext["cost"][key] == full["cost"][key], key
    assert ext["memory"]["argument_bytes"] == full["memory"][
        "argument_bytes"]
