"""Tensor parallelism over the ``model`` axis on the mesh over ranks, on
the CPU: one process a rank, gloo, four ranks (``repro_torch.dist.ranks``).

On a mesh over ranks the teacher-forced forward splits the work of the
dense layers as the reference's GSPMD splits it (``sharding.split_names``
of the ``heads``, ``kv_heads``, ``ff`` and ``vocab`` rules): each rank of a
``model`` group computes its query heads and its key / value heads (all of
them where ``kv_heads`` does not divide), its FFN columns and its
vocabulary slice of the embedding, the logits and the loss. Over meshes
(1, 4) and (2, 2), llama3.2-1b, granite-moe-3b-a800m, qwen2.5-32b (QKV
bias, untied head), olmo-1b and llama-3.2-vision-11b (cross-attention to
seeded image embeddings) ``--reduced`` on [8, 32], one and two
microbatches, one step under FSDP (``specs.train_state_sharding``, the
reference launcher's layout) is held against the replicated step over the
same ranks (the whole state on every rank, the work split alike) and
against JAX's step jitted under ``train_state_sharding`` on the same mesh
shape. ``lm_forward`` of the families that stay whole or half split
(deepseek-v2-lite-16b's MLA, rwkv6-1.6b, recurrentgemma-9b's RG-LRU) at
(1, 4) and (2, 2) is held against the one-process forward. The work is shown split:
rank 0's matmul FLOPs at (1, 4) (``FlopCounterMode``) equal the count the
shapes give with each split product divided by 4, under half the
one-process step's; and the collectives are the design's, with no
all-gather over ``model`` of a leaf whose ``model`` dim the rank computes.
A checkpoint of a split run restores in one process and over (4, 1); the
launcher's ``--model-parallel`` splits the work.

Tolerances: the loss and metrics within ``TOL_METRIC`` relative of the
replicated step's and JAX's (``tokens`` exactly); the gradients handed to
the update within ``TOL_GRAD`` of each leaf's largest of the replicated
step's reduced gradient cut to the blocks; every parameter within Adam's
first-step bound of a gradient ``TOL_GRAD`` of its leaf's largest apart
(``test_torch_fsdp._state_within``); the forward's logits and aux within
``TOL_METRIC`` of their largest magnitude; the sums over ``model`` add in
other orders than one process (ROADMAP.md R44). In bf16 the row-parallel
products' parts are summed in fp32 and rounded once (within half a bf16
ulp of the exact product, fp32's summation error aside).
"""
import concurrent.futures

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.dist import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro.train import losses as jlosses
from repro.train import optim as joptim
from repro.train import trainer as jtrainer
from repro_torch.dist import ranks
from repro_torch.ft import checkpoint as tckpt
from repro_torch.launch import specs as tspecs
from repro_torch.models.lm import lm_forward
from repro_torch.train import optim as toptim
from repro_torch.train import trainer as ttrainer
from test_torch_fsdp import _jax_leaves, _state_within
from test_torch_lm_train import LR, TOL_GRAD, TOL_METRIC, _jb, _opt
from test_torch_mesh import _lm
from test_torch_rank_train import _jmesh, _metrics_rel
import torch_rank_workers as workers

torch.set_num_threads(1)

WORLD = 4
DEADLINE_S = 300
B, S = 8, 32
ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m", "qwen2.5-32b", "olmo-1b",
         "llama-3.2-vision-11b")
HALF_SPLIT = ("deepseek-v2-lite-16b", "rwkv6-1.6b", "recurrentgemma-9b")
MESHES = {"1x4": 4, "2x2": 2}          # the model-parallel degree
ACCUMS = (1, 2)
LAUNCH = ["--arch", "llama3.2-1b", "--reduced", "--batch", "8", "--seq",
          "32", "--device", "cpu", "--log-every", "1", "--steps", "2"]

_RUNS = {}


def _batch(arch, tcfg, tokens):
    """The arch's batch: the tokens, and seeded image embeddings [B, N,
    vision_dim] for the VLM."""
    batch = {"tokens": tokens}
    if tcfg.cross_attn_every:
        rng = np.random.default_rng(len(arch))
        batch["image_embeds"] = (0.02 * rng.standard_normal(
            (B, tcfg.n_image_tokens, tcfg.vision_dim))).astype(np.float32)
    return batch


def _jgrads(jcfg, jp, batch, jm):
    """JAX's gradients of ``lm_loss`` + 0.01 aux under the mesh ``jm``."""
    def loss_fn(params, b):
        logits, aux = jlm.lm_forward(params, jcfg, b["tokens"],
                                     image_embeds=b.get("image_embeds"))
        return jlosses.lm_loss(logits, b["tokens"])[0] + 0.01 * aux
    with jsh.use_mesh(jm, jsh.AxisRules()):
        _, grads = jax.jit(jax.value_and_grad(loss_fn))(jp, _jb(batch))
    return [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


def _jax_step(jcfg, jp, batch, accum, shape):
    """JAX's step jitted under ``train_state_sharding`` / ``batch_sharding``
    on the mesh of ``shape``, and its gradients (the microbatches' mean)
    for the parameters' bound."""
    jm = _jmesh(shape)
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
    parts = [{k: v[i * B // accum:(i + 1) * B // accum]
              for k, v in batch.items()} for i in range(accum)]
    jgs = [_jgrads(jcfg, jp, p, jm) for p in parts]
    jg = [sum(gs[1:], np.float32(0) + gs[0]) / np.float32(accum)
          for gs in zip(*jgs)]
    return js, jmet, jg


def _run(arch):
    """Every step case of ``arch`` in one spawn of four ranks, with JAX's
    steps run here meanwhile; cached."""
    if arch not in _RUNS:
        jcfg, tcfg, jp, tp, tokens = _lm(arch, B, S)
        params = toptim.tree_map(lambda t: t.numpy(), tp)
        batch = _batch(arch, tcfg, tokens)
        cases = [(mp, accum) for mp in MESHES.values() for accum in ACCUMS]
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ranked = pool.submit(ranks.spawn_ranks, workers.tp_steps, WORLD,
                                 "cpu", timeout=DEADLINE_S,
                                 args=(arch, params, batch, LR, cases,
                                       MESHES["1x4"]))
            ref = {case: _jax_step(jcfg, jp, batch, case[1],
                                   (WORLD // case[0], case[0]))
                   for case in cases}
            got = ranked.result()
        _RUNS[arch] = (got, ref)
    return _RUNS[arch]


@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_split_step_matches_the_replicated_step_and_jax(mesh, arch, accum):
    """One step with the work split over ``model``, the state under FSDP:
    every rank's metrics and state the same, its loss bitwise the
    replicated step's over the same ranks (the forward reads the same
    values), its metrics near that step's and JAX's, the gradients it
    hands the update that step's reduced ones cut to the blocks, and the
    gathered state within Adam's first-step bound of both steps'."""
    got, ref = _run(arch)
    outs = [r[(MESHES[mesh], accum)] for r in got]
    first = outs[0]
    for o in outs:
        assert o["metrics"] == first["metrics"]
        assert o["metrics"]["loss"] == o["repl_metrics"]["loss"]
        assert max(o["gerr"]) <= TOL_GRAD, max(o["gerr"])
        assert all(np.array_equal(a, b) for a, b in zip(o["state"],
                                                        first["state"]))
        assert all(np.array_equal(a, b) for a, b in zip(
            o["repl_state"], first["repl_state"]))
    _metrics_rel(first["metrics"], first["repl_metrics"], "replicated")
    _state_within(first["state"], first["repl_state"], first["repl_grads"],
                  first["metrics"]["grad_norm"],
                  first["repl_metrics"]["grad_norm"])
    js, jmet, jg = ref[(MESHES[mesh], accum)]
    _metrics_rel(first["metrics"], jmet, "jax")
    _state_within(first["state"], _jax_leaves(js), jg,
                  first["metrics"]["grad_norm"], float(jmet["grad_norm"]))


def _step_flops(cfg, parts, kv_parts, onehot):
    """The matmul FLOPs of one llama train step on [B, S] whose attention
    heads, FFN columns and vocabulary are split ``parts`` ways and KV
    heads ``kv_parts`` ways: every product of the blocks and the head
    three times its forward (the forward and the two products of its
    backward), the one-hot embedding of the rank's vocabulary twice (its
    one-hot needs no gradient); without it the embedding is a gather."""
    t, d, hd, f = B * S, cfg.d_model, cfg.head_dim, cfg.d_ff
    heads, kv = cfg.n_heads // parts, cfg.n_kv_heads // kv_parts
    vocab = cfg.vocab // parts
    attn = (2 * t * d * heads * hd            # q
            + 2 * (2 * t * d * kv * hd)       # k, v
            + 2 * (2 * B * heads * S * S * hd)  # scores, probabilities x v
            + 2 * t * heads * hd * d)         # o
    ffn = 3 * (2 * t * d * (f // parts))
    total = 3 * (cfg.n_layers * (attn + ffn) + 2 * t * d * vocab)
    return total + (2 * (2 * t * vocab * d) if onehot else 0)


def test_the_work_is_split():
    """Rank 0's matmul FLOPs of the split step at (1, 4) equal the count
    the shapes give with the heads, FFN columns and vocabulary divided by
    4 (llama's 2 KV heads stay whole: 2 does not divide by 4), the
    one-process step's the count without a split, and the split step's are
    under half the one-process step's."""
    got, _ = _run("llama3.2-1b")
    _, tcfg, _, tp, tokens = _lm("llama3.2-1b", B, S)
    step = ttrainer.make_lm_train_step_fn(tcfg, _opt(toptim))
    with FlopCounterMode(display=False) as fc:
        step(ttrainer.init_train_state(tp), {"tokens": torch.from_numpy(
            tokens)})
    one = fc.get_total_flops()
    split = got[0][(MESHES["1x4"], 1)]["flops"]
    assert tcfg.n_kv_heads % 4
    assert one == _step_flops(tcfg, 1, 1, False)
    assert split == _step_flops(tcfg, 4, 1, True)
    assert split < 0.5 * one, (split, one)


# llama's split FSDP step, one microbatch, on each mesh: the collectives the
# design gives (2 layers, one stacked entry of 2 periods). Forward sums: an
# attention and an FFN a layer and the embedding (5); the loss's maximum,
# its sums, its argmax (3); backward sums of psum_grads: an attention and
# an FFN a layer and the head (5); the data group's bucket (1) and the clip
# norm's sum of squares over the ranks (1): 15 all-reduces. The row-parallel
# w_o and w_down swap columns for rows, forward and backward, each period:
# 8 all-to-alls. (1, 4): the data extent is 1, so only the norm scales (2 a
# period) and the whole KV projections (w_k, w_v: 2 KV heads do not split
# 4 ways) are gathered over model, 8 all-gathers, and the KV projections'
# gradients, the rank's part, reduce-scattered over model, 4. (2, 2): no
# all-gather over model but the norm scales' (2 leaves, gathered whole
# over data and model before the periods): the embedding (1), the two
# norms over data and model (4), and the 7 matrices a period over data
# (14), 19 all-gathers; their reduce-scatters over data, 17.
COLLECTIVES = {"1x4": {"all_reduce": 15, "all_gather": 8, "all_to_all": 8,
                       "reduce_scatter": 4},
               "2x2": {"all_reduce": 15, "all_gather": 19, "all_to_all": 8,
                       "reduce_scatter": 17}}


@pytest.mark.parametrize("mesh", MESHES)
def test_the_collectives_are_the_designs(mesh):
    """The split FSDP step of llama issues the collectives the design gives
    (``COLLECTIVES``), and no all-gather over ``model`` of a leaf whose
    ``model`` dim the rank computes (the query, FFN and embedding
    matrices): over ``model`` it gathers only the norm scales, and at (1,
    4) the whole KV projections."""
    got, _ = _run("llama3.2-1b")
    _, tcfg, _, _, _ = _lm("llama3.2-1b", B, S)
    d, kv = tcfg.d_model, tcfg.n_kv_heads * tcfg.head_dim
    for r in got:
        o = r[(MESHES[mesh], 1)]
        assert o["issued"] == COLLECTIVES[mesh], o["issued"]
        over_model = {size for over, size in o["gathered"]
                      if over == "model"}
        if mesh == "1x4":
            assert over_model == {d, d * kv}, over_model
        else:
            assert over_model == {2 * d}, over_model


@pytest.mark.parametrize("arch", HALF_SPLIT)
@pytest.mark.parametrize("mesh", MESHES)
def test_forward_of_the_families_left_whole(mesh, arch):
    """``lm_forward`` at (1, 4) and (2, 2) of the families whose mixers
    stay whole on every rank (MLA, RWKV6's time and channel mix, the
    RG-LRU; their vocabulary, FFNs and local attention split): every
    rank's logits, gathered over ``model``, and aux within ``TOL_METRIC``
    of the largest magnitude of the one-process forward's on the rank's
    rows; each rank computed its share of the vocabulary."""
    mp = MESHES[mesh]
    _, tcfg, _, tp, tokens = _lm(arch, B, S)
    params = toptim.tree_map(lambda t: t.numpy(), tp)
    batch = _batch(arch, tcfg, tokens)
    got = ranks.spawn_ranks(workers.tp_forward, WORLD, "cpu",
                            timeout=DEADLINE_S,
                            args=(arch, params, batch, mp))
    with torch.no_grad():
        want, aux = lm_forward(tp, tcfg, torch.from_numpy(tokens))
    want = want.numpy()
    rows = B // (WORLD // mp)
    for r in got:
        mine = want[r["coords"]["data"] * rows:][:rows]
        assert r["cols"] == tcfg.vocab // mp
        assert r["logits"].shape == mine.shape
        assert np.abs(r["logits"] - mine).max() <= (
            TOL_METRIC * np.abs(mine).max())
        assert abs(r["aux"] - float(aux)) <= TOL_METRIC * max(
            abs(float(aux)), 1.0)


@pytest.mark.parametrize("mesh", MESHES)
def test_row_parallel_rounds_the_sum_once(mesh):
    """In bf16 ``row_parallel`` keeps each rank's part of the product in
    fp32 and rounds the sum over ``model`` once, as one process's bf16
    matmul rounds the whole product: every output within half a bf16 ulp
    of the exact product, give or take fp32's summation error (a part
    rounded to bf16 before the sum can miss by more, R44); the backward is
    autograd's of the rank's ``h @ w`` in bf16, bitwise."""
    rng = np.random.default_rng(3)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).bfloat16().float().numpy()
    h, w, g = bf16(2, 8, 64), bf16(64, 16), bf16(2, 8, 16)
    got = ranks.spawn_ranks(workers.row_products, WORLD, "cpu",
                            timeout=DEADLINE_S,
                            args=(h, w, g, MESHES[mesh]))
    exact = h.astype(np.float64) @ w.astype(np.float64)
    slack = 2.0 ** -8 * np.abs(exact) + 2.0 ** -20 * (np.abs(h) @ np.abs(w))
    for r in got:
        assert r["dtype"] == "torch.bfloat16"
        assert r["cols"] == 64 // MESHES[mesh]
        assert np.all(np.abs(r["y"] - exact) <= slack)
        lo, n = r["lo"], r["cols"]
        hs = torch.from_numpy(h[..., lo:lo + n]).bfloat16().requires_grad_()
        ws = torch.from_numpy(w[lo:lo + n]).bfloat16().requires_grad_()
        (hs @ ws).backward(torch.from_numpy(g).bfloat16())
        assert np.array_equal(r["dh"], hs.grad.float().numpy())
        assert np.array_equal(r["dw"], ws.grad.float().numpy())


def test_a_split_run_checkpoint_restores_in_one_process_and_over_4x1(
        tmp_path):
    """A checkpoint of a split FSDP step at (1, 4) holds the global leaves:
    the lead's files restore in one process to the leaves every rank
    gathered, and over the (4, 1) mesh into their blocks, bitwise."""
    _, tcfg, _, tp, tokens = _lm("llama3.2-1b", B, S)
    params = toptim.tree_map(lambda t: t.numpy(), tp)
    ck = str(tmp_path / "ck")
    got = ranks.spawn_ranks(workers.tp_checkpoint, WORLD, "cpu",
                            timeout=DEADLINE_S,
                            args=("llama3.2-1b", params, tokens, ck,
                                  MESHES["1x4"]))
    whole = tckpt.restore(ck, tspecs.abstract_train_state(tcfg),
                          device="cpu")
    leaves = [t.numpy() for t in toptim.tree_leaves(whole)]
    for r in got:
        assert r["same"] and r["mesh"] == {"data": 1, "model": 4}
        assert len(r["state"]) == len(leaves)
        assert all(np.array_equal(a, b) for a, b in zip(r["state"],
                                                        leaves))


def test_launcher_model_parallel_splits_the_work():
    """``launch.train`` over four ranks (as under torchrun) with
    ``--model-parallel`` 1, 2 and 4: the meshes (4, 1), (2, 2) and (1, 4),
    and the split runs' losses within ``TOL_METRIC`` relative of the
    unsplit run's."""
    argvs = [LAUNCH + ["--model-parallel", str(k)] for k in (1, 2, 4)]
    got = ranks.spawn_ranks(workers.launches, WORLD, "cpu",
                            timeout=DEADLINE_S, args=(argvs,))
    lead = got[0]
    for run, (d, m) in zip(lead, ((4, 1), (2, 2), (1, 4))):
        assert run["lines"][0] == (f"[train] llama3.2-1b-smoke on mesh "
                                   f"{{'data': {d}, 'model': {m}}}")
        assert len(run["losses"]) == 2
    for run in lead[1:]:
        for a, b in zip(run["losses"], lead[0]["losses"]):
            assert abs(a - b) <= TOL_METRIC * abs(b), (a, b)
    assert all(r[i]["losses"] == lead[i]["losses"] for r in got
               for i in range(3))
