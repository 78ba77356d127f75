"""The clip's global norm (``repro_torch.kernels.global_norm``) on the CPU:
its plain version, the leaf table and the partition the wrapper hands the
kernel, and a model of the kernel's order. The kernel itself runs only on
the card (``chip_smoke.py`` phase 3 holds it against the plain version
there, bitwise from call to call and from replay to replay).

* ``global_norm_ref`` (what ``optim.global_norm`` reaches on the CPU) is
  bitwise the ops the port ran before the kernel, written out here as
  ``_norm_before``, and within 2 float32 ulps of the JAX package's
  ``global_norm`` (``tests/test_torch_train.py``'s bound: the sums' order
  differs between the libraries) on seeded fp32, bf16 and mixed trees.
* The kernel's order, emulated here from the wrapper's own table and
  partition (a group's 8 squares, two runs of 4, as an fp32 tree, zeros
  past the chunk's end in their places, each thread's groups in
  order in float64, the warp and block trees, the chunks' tree a leaf),
  then rounded as the kernel rounds: each leaf's sum to fp32, the leaves
  added in tree order in fp32, the root. It equals ``global_norm_model``
  (an exact sum of each leaf, rounded alike) on these trees and lies
  within ``L * 2**-23`` of the float64 norm, relative (L leaves: the
  group trees' 3 roundings, 2**-24 each, a rounding of each leaf's sum and
  of each fp32 addition, each at most 2**-24 of the total, the root
  halving them and adding its own); where the plain version gives inf or
  NaN, so do the model and the emulation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optim as joptim
from repro_torch.kernels import global_norm as gn
from repro_torch.kernels import ops
from repro_torch.train import optim as toptim

torch.set_num_threads(1)

SIZES = (1, 7, 4097, gn.NORM_CHUNK + 3, 0, 24)


def _norm_before(tree):
    """``optim.global_norm`` as the port computed it before the kernel."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in toptim.tree_leaves(tree)))


def _tree(rng, kind, scale=1.0):
    """A dict of leaves of ``SIZES`` elements: fp32, bf16, or both
    alternating."""
    out = {}
    for j, n in enumerate(SIZES):
        t = torch.from_numpy(rng.normal(0, scale, n).astype(np.float32))
        bf16 = kind == "bfloat16" or (kind == "mixed" and j % 2)
        out[f"l{j}"] = t.to(torch.bfloat16) if bf16 else t
    return out


def _bits(t):
    return t.view(torch.int32)


def _ulps(a, b):
    a, b = np.float32(a), np.float32(b)
    return abs(float(a) - float(b)) / np.spacing(max(abs(a), abs(b)))


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "mixed"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_version_is_the_ops_before_and_near_jax(kind, seed):
    rng = np.random.default_rng(seed)
    tree = _tree(rng, kind, scale=10.0 ** (seed - 1))
    ops.reset_launch_counts()
    got = toptim.global_norm(tree)
    assert sum(ops.launch_counts().values()) == 0        # CPU: plain
    assert got.dtype == torch.float32 and got.shape == ()
    assert torch.equal(_bits(got), _bits(_norm_before(tree)))
    assert torch.equal(_bits(got),
                       _bits(gn.global_norm_ref(toptim.tree_leaves(tree))))
    jtree = {k: jnp.asarray(v.float().numpy()).astype(
        jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
        for k, v in tree.items()}
    assert _ulps(joptim.global_norm(jtree), got.numpy()) <= 2


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "mixed"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sum_of_squares_form_is_the_total_before_the_root(kind, seed):
    """``squares=True``: the plain version's fp32 total of the squares,
    whose root is the norm bitwise, from ``ops.global_norm`` and
    ``global_norm_ref`` alike; near JAX's sum of squares."""
    rng = np.random.default_rng(seed)
    tree = _tree(rng, kind, scale=10.0 ** (seed - 1))
    leaves = toptim.tree_leaves(tree)
    squares = ops.global_norm(leaves, squares=True)
    assert squares.dtype == torch.float32 and squares.shape == ()
    assert torch.equal(_bits(squares),
                       _bits(gn.global_norm_ref(leaves, squares=True)))
    assert torch.equal(_bits(torch.sqrt(squares)),
                       _bits(ops.global_norm(leaves)))
    want = sum(float(np.sum(np.square(t.float().numpy(), dtype=np.float64)))
               for t in leaves)
    assert abs(float(squares) - want) <= 1e-6 * want


def test_sharded_norm_adds_each_block_once():
    """``optim.global_norm(tree, over=(mine, group))`` on one gloo rank
    (``spawn_ranks``): the leaves ``mine`` marks, summed before the root;
    all marked is the unsharded norm bitwise, none marked is 0."""
    from repro_torch.dist import ranks
    import torch_rank_workers as workers
    tree = _tree(np.random.default_rng(3), "mixed")
    got = ranks.spawn_ranks(workers.sharded_norm, 1, "cpu", timeout=120,
                            args=(tree, ("l1", "l2")))[0]
    assert torch.equal(_bits(got["every"]), _bits(toptim.global_norm(tree)))
    want = toptim.global_norm({k: tree[k] for k in ("l1", "l2")})
    assert torch.equal(_bits(got["some"]), _bits(want))
    assert float(got["none"]) == 0.0


def test_meta_leaves_give_a_meta_norm():
    leaves = [torch.empty(5, 3, device="meta"),
              torch.empty(7, dtype=torch.bfloat16, device="meta")]
    out = ops.global_norm(leaves)
    assert out.device.type == "meta" and out.shape == ()


def test_leaf_table_keeps_pointers_lengths_dtypes_and_first_chunks():
    c = gn.NORM_CHUNK
    ns = [1, 0, 7, 4097, c, c + 1, 3 * c + 5, 0]
    rows = [(1000 + 64 * j, n, j % 2) for j, n in enumerate(ns)]
    table, items = gn.norm_table(rows)
    kept = [(p, n, b) for p, n, b in rows if n]
    assert table.shape == (len(kept), gn.TABLE_WORDS)
    assert list(table[:, 0]) == [p for p, _, _ in kept]
    assert list(table[:, 1]) == [n for _, n, _ in kept]
    assert list(table[:, 3]) == [b for _, _, b in kept]
    chunks = [-(-n // c) for _, n, _ in kept]
    assert list(table[:, 2]) == list(np.cumsum([0] + chunks[:-1]))
    assert items == sum(chunks)
    empty, none = gn.norm_table([])
    assert empty.shape == (0, gn.TABLE_WORDS) and none == 0
    assert gn.norm_grid(0) == 1 and gn.norm_grid(5) == 5
    assert gn.norm_grid(10 ** 6) == ops.H100_SMS * gn.NORM_BLOCKS_PER_SM


def test_partition_is_a_function_of_the_tree_alone():
    c = gn.NORM_CHUNK
    ns = [3, c - 1, c, 2 * c + 9, 1]
    a, _ = gn.norm_table([(16 * j, n, 0) for j, n in enumerate(ns)])
    # other addresses (misaligned), other dtypes, the same shapes
    b, _ = gn.norm_table([(10 ** 6 + 2 * j + 2, n, 1)
                          for j, n in enumerate(ns)])
    items = gn.norm_items(a)
    assert items == gn.norm_items(b)
    seen = [np.zeros(n, np.int64) for n in ns]
    for leaf, c0, c1 in items:
        assert c1 - c0 <= c
        covered = []
        for tid in range(gn.NORM_THREADS):
            groups = gn.thread_groups(c0, c1, tid)
            assert len(groups) == gn.NORM_GROUPS
            assert all(len(grp) == gn.NORM_GROUP for grp in groups)
            covered += [k for grp in groups for k in grp if k >= 0]
        assert sorted(covered) == list(range(c0, c1))
        seen[leaf][c0:c1] += 1
    assert all((s == 1).all() for s in seen)  # every element exactly once


def _warp_tree(v):
    """``warp_sum`` of the kernel: shuffle-down steps 16, 8, 4, 2, 1 over
    32 lanes, lane 0's value."""
    v = list(v)
    for off in (16, 8, 4, 2, 1):
        v = [v[i] + v[i + off] if i + off < 32 else v[i]
             for i in range(32)]
    return v[0]


def _tree8(v):
    """A group's 8 squares as the kernel's fp32 tree."""
    return np.float32(np.float32(np.float32(v[0] + v[1])
                                 + np.float32(v[2] + v[3]))
                      + np.float32(np.float32(v[4] + v[5])
                                   + np.float32(v[6] + v[7])))


def _kernel_order(leaves):
    """The kernel's arithmetic, from the wrapper's table and partition:
    fp32 squares; a group's 8 as an fp32 tree; a thread's groups in order
    in float64; the warps' and the block's trees; the chunks of a leaf a
    lane each, a warp tree; each leaf's sum rounded to fp32; the leaves
    added in fp32; the fp32 root."""
    xs = [t.float().numpy().reshape(-1) for t in leaves]
    table, items = gn.norm_table(
        [(0, t.numel(), t.dtype == torch.bfloat16) for t in leaves])
    kept = [x for x in xs if x.size]
    partial = []
    for leaf, c0, c1 in gn.norm_items(table):
        sq = (kept[leaf] * kept[leaf]).astype(np.float32)
        thread = []
        for tid in range(gn.NORM_THREADS):
            acc = 0.0
            for grp in gn.thread_groups(c0, c1, tid):
                v = np.array([sq[k] if k >= 0 else 0.0 for k in grp],
                             np.float32)
                acc += float(_tree8(v))
            thread.append(acc)
        warps = [_warp_tree(thread[w * 32:(w + 1) * 32])
                 for w in range(gn.NORM_THREADS // 32)]
        t = warps[0]
        for w in warps[1:]:
            t += w
        partial.append(t)
    total = np.float32(0.0)
    for j, (_, _, item0, _) in enumerate(table.tolist()):
        i1 = table[j + 1, 2] if j + 1 < len(table) else items
        lanes = [0.0] * 32
        for i in range(item0, i1):
            lanes[(i - item0) % 32] += partial[i]
        s = np.float32(_warp_tree(lanes))
        total = s if j == 0 else np.float32(total + s)
    return np.float32(np.sqrt(np.float64(total)))


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "mixed"])
def test_kernel_order_is_the_model_and_near_float64(kind):
    rng = np.random.default_rng(11)
    leaves = toptim.tree_leaves(_tree(rng, kind, scale=3.0))
    got = _kernel_order(leaves)
    model = gn.global_norm_model(leaves)
    assert got == model.numpy()
    exact = np.sqrt(sum(float(np.sum(
        t.float().numpy().astype(np.float64) ** 2)) for t in leaves))
    n_leaves = sum(1 for t in leaves if t.numel())
    assert abs(float(got) - exact) <= n_leaves * 2.0 ** -23 * exact
    plain = float(gn.global_norm_ref(leaves))
    assert abs(plain - exact) <= n_leaves * 2.0 ** -23 * exact


@pytest.mark.parametrize("case", ["inf", "nan", "square_overflow",
                                  "sum_overflow", "zeros"])
def test_model_gives_inf_and_nan_where_the_plain_version_does(case):
    rng = np.random.default_rng(5)
    leaves = toptim.tree_leaves(_tree(rng, "mixed"))
    if case == "inf":
        leaves[2][3] = float("inf")
    elif case == "nan":
        leaves[3][4096] = float("nan")
    elif case == "square_overflow":      # a bf16 value whose square is inf
        leaves[1][0] = 3e19
    elif case == "sum_overflow":         # each square finite, the sum not
        leaves[3][:] = 1.5e19
    else:
        leaves = [torch.zeros_like(t) for t in leaves]
    plain = float(gn.global_norm_ref(leaves))
    model = float(gn.global_norm_model(leaves))
    with np.errstate(over="ignore", invalid="ignore"):
        kern = float(_kernel_order(leaves))
    want = {"inf": np.inf, "nan": np.nan, "square_overflow": np.inf,
            "sum_overflow": np.inf, "zeros": 0.0}[case]
    for v in (plain, model, kern):
        if np.isnan(want):
            assert np.isnan(v)
        else:
            assert v == want
