"""The fused AdamW update (``repro_torch.kernels.fused_adam``) on the CPU:
its plain version, the host constants the kernel multiplies by, and the
leaf table the wrapper builds for a launch. The kernel itself runs only on
the card (``chip_smoke.py`` phase 3 holds it bitwise against the plain
version there).

* ``adam_update`` (which reaches ``fused_adam_ref`` on the CPU) is bitwise
  the update as the port computed it before the kernel, written out here
  as ``_adam_before`` (a clip pass over the tree, then the per-leaf ops):
  fp32 and bf16 leaves, with and without clipping and decay, at steps 1
  and 1000; in place (``updates_in_place``) bitwise functional.
* Against the JAX package's ``adam_update`` within
  ``tests/test_torch_train.py``'s optimizer bound, 8 float32 ulps of each
  leaf's largest element (XLA contracts the multiply-adds, R5, and the
  schedule's ``cos``, the corrections' ``pow`` and the norm's sum order
  differ by an ulp); a bf16 parameter also within one bf16 step of its
  value, where the two fp32 results fall on either side of a rounding
  boundary.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optim as joptim
from repro_torch.kernels import fused_adam as fa
from repro_torch.kernels import ops
from repro_torch.train import optim as toptim

torch.set_num_threads(1)

U32 = 2.0 ** -24
BF16_STEP = 2.0 ** -7      # a bf16 ulp relative to the value, at most


def _tree(rng, dtype=torch.float32, mixed=False):
    """A GRU-like tree: a dict holding a list of layers, sizes 1, 3, 4095
    and a few matrices; with ``mixed`` one leaf in the other dtype."""
    def t(*shape, s=1.0):
        return torch.from_numpy(rng.normal(0, s, shape).astype(np.float32))
    tree = {"layers": [{"w": t(6, 4), "b": t(1, s=0.1)},
                       {"w": t(4095), "b": t(3, s=0.1)}],
            "head": t(6, 3)}
    tree = toptim.tree_map(lambda x: x.to(dtype), tree)
    if mixed:
        other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
        tree["head"] = tree["head"].to(other)
    return tree


def _adam_before(grads, state, params, cfg):
    """``adam_update`` as the port computed it before the fused kernel."""
    metrics = {}
    if cfg.clip_norm is not None:
        grads, gnorm = toptim.clip_by_global_norm(grads, cfg.clip_norm)
        metrics["grad_norm"] = gnorm
    step = state["step"] + 1
    lr = cfg.schedule(step)
    metrics["lr"] = lr
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(torch.float32)
    corr1, corr2 = 1 - b1 ** t, 1 - b2 ** t

    def upd(g, mu, nu, p):
        g = g.to(torch.float32)
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        delta = (mu / corr1) / (torch.sqrt(nu / corr2) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), mu, nu

    out = toptim.tree_map(lambda p, g, mu, nu: upd(g, mu, nu, p), params,
                          grads, state["mu"], state["nu"])
    part = [toptim.tree_map(lambda _, o, i=i: o[i], params, out)
            for i in range(3)]
    return part[0], {"mu": part[1], "nu": part[2], "step": step}, metrics


def _bits(t):
    """A tensor's bits, so NaNs compare too."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _same(a, b) -> bool:
    la, lb = toptim.tree_leaves(a), toptim.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def _state_at(params, step, rng):
    """An Adam state at ``step`` with moments of a plausible size."""
    state = toptim.init_adam_state(params)
    state["mu"] = toptim.tree_map(
        lambda m: torch.from_numpy(rng.normal(0, 1e-2, m.shape).astype(
            np.float32)), state["mu"])
    state["nu"] = toptim.tree_map(
        lambda m: torch.from_numpy(np.abs(rng.normal(0, 1e-4, m.shape))
                                   .astype(np.float32)), state["nu"])
    state["step"] = torch.tensor(step - 1, dtype=torch.int32)
    return state


CASES = [(dt, clip, wd, step) for dt in ("float32", "bfloat16", "mixed")
         for clip in (None, 1.0) for wd in (0.0, 0.1) for step in (1, 1000)]


@pytest.mark.parametrize("dtype,clip,wd,step", CASES)
def test_plain_version_is_the_update_before_the_kernel(dtype, clip, wd,
                                                       step):
    rng = np.random.default_rng(CASES.index((dtype, clip, wd, step)))
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    params = _tree(rng, dt, mixed=dtype == "mixed")
    grads = toptim.tree_map(lambda p: (torch.randn(p.shape, generator=(
        torch.Generator().manual_seed(p.numel()))) * 3).to(p.dtype), params)
    state = _state_at(params, step, rng)
    cfg = toptim.AdamConfig(schedule=toptim.warmup_cosine_schedule(
        1e-2, 20, 2000), weight_decay=wd, clip_norm=clip)
    ops.reset_launch_counts()
    p1, s1, m1 = toptim.adam_update(grads, state, params, cfg)
    p0, s0, m0 = _adam_before(grads, state, params, cfg)
    assert sum(ops.launch_counts().values()) == 0        # CPU: plain
    assert _same(p1, p0) and _same(s1["mu"], s0["mu"])
    assert _same(s1["nu"], s0["nu"])
    assert int(s1["step"]) == step and s1["step"].dtype == torch.int32
    assert sorted(m1) == sorted(m0)
    assert all(torch.equal(m1[k], m0[k]) for k in m0)
    # in place: the same values, written into the tensors handed in
    ip = toptim.tree_map(torch.clone, params)
    ist = toptim.tree_map(torch.clone, state)
    with toptim.updates_in_place():
        p2, s2, _ = toptim.adam_update(grads, ist, ip, cfg)
    assert all(a is b for a, b in zip(toptim.tree_leaves(p2),
                                      toptim.tree_leaves(ip)))
    assert all(a is b for a, b in zip(toptim.tree_leaves(s2["mu"]),
                                      toptim.tree_leaves(ist["mu"])))
    assert all(a is b for a, b in zip(toptim.tree_leaves(s2["nu"]),
                                      toptim.tree_leaves(ist["nu"])))
    assert s2["step"] is ist["step"] and int(ist["step"]) == step
    assert _same(p2, p0) and _same(s2["mu"], s0["mu"])
    assert _same(s2["nu"], s0["nu"])


def test_plain_version_propagates_nan_and_inf_as_the_ops_before():
    rng = np.random.default_rng(8)
    params = _tree(rng)
    grads = toptim.tree_map(torch.ones_like, params)
    grads["layers"][1]["w"][7] = float("nan")
    grads["head"][0, 1] = float("inf")
    grads["head"][2, 2] = -float("inf")
    for clip in (None, 1.0):
        cfg = toptim.AdamConfig(clip_norm=clip)
        state = toptim.init_adam_state(params)
        p1, s1, _ = toptim.adam_update(grads, state, params, cfg)
        p0, s0, _ = _adam_before(grads, state, params, cfg)
        assert _same(p1, p0) and _same(s1["mu"], s0["mu"])
        assert _same(s1["nu"], s0["nu"])
        assert torch.isnan(p1["layers"][1]["w"][7])


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_update_matches_jax(dtype, clip, weight_decay):
    rng = np.random.default_rng(3)
    tdt = getattr(torch, dtype)
    p0 = toptim.tree_map(lambda t: t.to(tdt), _tree(rng))
    grads = [toptim.tree_map(lambda t: t.to(tdt), _tree(rng))
             for _ in range(6)]

    def to_jax(tree):
        return jax.tree_util.tree_map(
            lambda t: jnp.asarray(t.float().numpy()).astype(dtype), tree)
    jcfg = joptim.AdamConfig(
        schedule=joptim.warmup_cosine_schedule(1e-2, 2, 6),
        weight_decay=weight_decay, clip_norm=clip)
    tcfg = toptim.AdamConfig(
        schedule=toptim.warmup_cosine_schedule(1e-2, 2, 6),
        weight_decay=weight_decay, clip_norm=clip)
    jp, tp = to_jax(p0), p0
    js, ts = joptim.init_adam_state(jp), toptim.init_adam_state(tp)
    for g in grads:
        jp, js, _ = joptim.adam_update(to_jax(g), js, jp, jcfg)
        tp, ts, _ = toptim.adam_update(g, ts, tp, tcfg)
        for jt, tt, is_param in ((jp, tp, True), (js["mu"], ts["mu"], False),
                                 (js["nu"], ts["nu"], False)):
            for a, b in zip(jax.tree_util.tree_leaves(jt),
                            toptim.tree_leaves(tt)):
                a = np.asarray(a.astype(jnp.float32))
                b = b.float().numpy()
                bound = 8 * U32 * np.abs(a).max()
                if is_param and tdt == torch.bfloat16:
                    bound = bound + BF16_STEP * np.abs(a)
                assert (np.abs(a - b) <= bound).all()
    assert int(ts["step"]) == 6


def test_host_constants_round_as_pytorch_scalars():
    values = (0.9, 0.999, 1e-8, 0.1)
    consts = fa.host_constants(*values)
    want = (0.9, 1 - 0.9, 0.999, 1 - 0.999, 1e-8, 0.1)
    one = torch.ones((), dtype=torch.float32)
    for c, v in zip(consts, want):
        # a Python float times a float32 tensor: PyTorch rounds the double
        # to float32 once
        assert c == float(one * v)
    assert consts[1] == float(np.float32(0.1))
    assert consts[1] != float(np.float32(1.0) - np.float32(0.9))


def _rows(ns, g_bf16=False):
    return [(tuple(range(7 * i, 7 * i + 7)), n, g_bf16)
            for i, n in enumerate(ns)]


def test_leaf_table_of_an_empty_tree():
    table, items = fa.leaf_table([])
    assert table.shape == (0, fa.TABLE_WORDS) and items == 0


def test_leaf_table_numbers_the_chunks_and_skips_empty_leaves():
    c = fa.FA_CHUNK
    ns = [1, 0, 3, 4095, c, c + 1, 2 ** 20 + 1, 0]
    table, items = fa.leaf_table(_rows(ns))
    kept = [n for n in ns if n]
    assert table.shape == (len(kept), fa.TABLE_WORDS)
    assert list(table[:, 7]) == kept
    chunks = [-(-n // c) for n in kept]
    assert list(table[:, 8]) == list(np.cumsum([0] + chunks[:-1]))
    assert items == sum(chunks)
    assert list(table[0, :7]) == list(range(7))      # the pointers, in order
    assert (table[:, 9] == 0).all()
    assert (fa.leaf_table(_rows([5], g_bf16=True))[0][:, 9] == 1).all()


def test_launch_groups_split_a_mixed_tree_by_parameter_dtype():
    rng = np.random.default_rng(1)
    params = toptim.tree_leaves(_tree(rng, torch.bfloat16, mixed=True))
    grads = [torch.zeros_like(p) for p in params]
    first = next(j for j, p in enumerate(params) if p.dtype == torch.bfloat16)
    grads[first] = grads[first].float()   # an fp32 gradient of a bf16 leaf
    mu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    nu = [torch.zeros_like(m) for m in mu]
    groups = fa.launch_groups(params, grads, mu, nu, (params, mu, nu))
    assert sorted(groups, key=str) == [torch.bfloat16, torch.float32]
    assert [n for _, n, _ in groups[torch.float32]] == [18]     # the head
    assert [n for _, n, _ in groups[torch.bfloat16]] == [
        p.numel() for p in params if p.dtype == torch.bfloat16]
    assert [g for _, _, g in groups[torch.bfloat16]] == [False] + [True] * 3
    ptrs = groups[torch.bfloat16][0][0]
    assert ptrs[0] == ptrs[4] == params[first].data_ptr()     # in place
    assert ptrs[1] == grads[first].data_ptr()


@pytest.mark.parametrize("bad", ["fp16", "moment", "strided", "shape"])
def test_launch_groups_refuse_what_the_kernel_does_not_take(bad):
    p = torch.zeros(4, 6)
    g, mu, nu = torch.zeros(4, 6), torch.zeros(4, 6), torch.zeros(4, 6)
    if bad == "fp16":
        p, g = p.half(), g.half()
    elif bad == "moment":
        mu = mu.bfloat16()
    elif bad == "strided":
        g = torch.zeros(6, 4).t()
    else:
        nu = torch.zeros(24)
    with pytest.raises((TypeError, ValueError)):
        fa.launch_groups([p], [g], [mu], [nu], ([p], [mu], [nu]))


def test_a_table_outside_the_repos_capture_raises():
    """A launch inside a capture that ``ops.capture_cuda_graph`` does not
    run would read a table nobody writes: the wrapper raises instead."""
    with pytest.raises(RuntimeError, match="capture_cuda_graph"):
        ops.table_after_capture(torch.zeros((2, fa.TABLE_WORDS),
                                            dtype=torch.int64))


# -- the kernel's plan: a scalar head, vector pieces, a scalar tail -----------

_SIZES = {"f32": (4, 4, 4, 4, 4, 4, 4), "bf16": (2, 2, 4, 4, 2, 4, 4),
          "bf16_g32": (2, 4, 4, 4, 2, 4, 4)}


def _ptrs(sizes, offset, base=1 << 20):
    """Seven operands, each ``offset`` elements past a 16-byte boundary
    (a view that many elements into a buffer of its own)."""
    return tuple(base + 4096 * k + offset * s for k, s in enumerate(sizes))


def _leaf_elements(n, head):
    """Every element the kernel's tiles of a leaf take, tile by tile, and
    the tiles fit the leaf's tile slots (32 a chunk)."""
    tiles = fa.leaf_tiles(n, head)
    assert tiles <= -(-n // fa.FA_CHUNK) * (fa.FA_CHUNK // fa.FA_TILE)
    return [i for r in range(tiles) for i in fa.tile_elements(n, head, r)]


@pytest.mark.parametrize("kind", sorted(_SIZES))
@pytest.mark.parametrize("offset", range(8))
def test_plan_covers_every_element_exactly_once(kind, offset):
    sizes = _SIZES[kind]
    ptrs = _ptrs(sizes, offset)
    for n in [*range(1, 41), 255, 256, 257, 8 * 3 + 5, fa.FA_CHUNK - 1,
              fa.FA_CHUNK, fa.FA_CHUNK + 1, 2 * fa.FA_CHUNK + 13]:
        head, body, tail, vec = fa.leaf_plan(n, ptrs, sizes)
        assert vec                   # one offset a leaf: always alignable
        assert head + body + tail == n and body % fa.FA_PIECE == 0
        assert 0 <= head < 8 and 0 <= tail < fa.FA_PIECE
        if body:                     # every piece starts each operand on 16
            assert all((p + head * s) % fa.FA_ALIGN == 0
                       for p, s in zip(ptrs, sizes))
            # the first such element: 4 fp32 or 8 bf16 elements a 16 bytes
            assert head == (-offset) % (4 if kind == "f32" else 8)
        elements = _leaf_elements(n, head)
        assert sorted(elements) == list(range(n))
        # the body's pieces: whole, each lane's on 16 (fp32) or 8 bytes
        for r in range(fa.leaf_tiles(n, head)):
            for lane in range(32):
                for q in range(0, fa.FA_TILE, 32 * fa.FA_PIECE):
                    i = head + r * fa.FA_TILE + q + fa.FA_PIECE * lane
                    if i + fa.FA_PIECE <= n:
                        assert i < head + body
                        assert all((p + i * sz) % (4 * sz) == 0
                                   for p, sz in zip(ptrs, sizes))


def test_plan_of_operands_at_odd_phases_is_all_tail():
    sizes = _SIZES["f32"]
    # p 4 bytes off, g 8 bytes off: no element starts both on 16 bytes
    ptrs = (1 << 20) + 4, (1 << 21) + 8, *_ptrs(sizes, 0)[2:]
    for n in (1, 7, 8, 9, 100, 600):
        assert fa.leaf_plan(n, ptrs, sizes) == (0, 0, n, False)
        assert sorted(_leaf_elements(n, 0)) == list(range(n))


def test_leaf_table_carries_each_leafs_plan():
    rows = [(_ptrs(_SIZES["bf16"], off), n, True)
            for off, n in ((0, 5), (3, 100), (7, 9))]
    table, _ = fa.leaf_table(rows, p_bf16=True)
    for row, (ptrs, n, _) in zip(table, rows):
        head, _, _, vec = fa.leaf_plan(n, ptrs, _SIZES["bf16"])
        assert (row[10], row[11]) == (head, int(vec))
    assert list(table[:, 10]) == [0, 5, 1]


@pytest.mark.parametrize("items", [1, 7, 263, 264, 265, 661, 5000])
def test_the_sweep_hands_each_tile_slot_to_one_warp(items):
    grid = fa.adam_grid(items)
    assert grid == min(items, ops.H100_SMS * fa.FA_BLOCKS_PER_SM)
    slots = items * (fa.FA_CHUNK // fa.FA_TILE)
    per_warp = fa.warp_slots(slots, grid)
    assert len(per_warp) == grid * fa.FA_WARPS
    assert sorted(s for w in per_warp for s in w) == list(range(slots))
    # in tree order: each warp's slots rise, and the grid's first sweep
    # takes the first grid * FA_WARPS slots
    assert all(w == sorted(w) for w in per_warp)
    assert [w[0] for w in per_warp if w] == list(range(min(
        slots, grid * fa.FA_WARPS)))


@pytest.mark.parametrize("r", [0, 1, 31])
def test_each_access_of_a_warp_covers_consecutive_elements(r):
    """A warp's accesses to one operand: lane after lane, each lane's piece
    follows the one before, so one instruction reads ``32 * FA_PIECE``
    consecutive elements (whole 32-byte sectors once the head is done),
    and the tile's pieces follow one another up to ``FA_TILE``."""
    head, n = 3, fa.FA_CHUNK + 7
    got = fa.tile_elements(n, head, r)
    base = head + r * fa.FA_TILE
    per_lane = fa.FA_TILE // 32
    pieces = [got[k:k + fa.FA_PIECE] for k in range(0, 32 * per_lane,
                                                    fa.FA_PIECE)]
    step = 32 * fa.FA_PIECE
    for q in range(fa.FA_TILE // step):
        access = [i for lane in range(32)
                  for i in pieces[lane * (per_lane // fa.FA_PIECE) + q]]
        assert access == list(range(base + q * step, base + (q + 1) * step))
    assert got[32 * per_lane:] == (list(range(head)) if r == 0 else [])
