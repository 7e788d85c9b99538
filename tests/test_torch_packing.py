"""Parity of the port's pack-once layout (repro_torch.core.packing) with the
reference's: leaf order, specs and packed arrays bitwise, int8
quantization bitwise, and gradients born packed through unpack_rows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch
from repro.core import packing as jpk
from repro.core.gossip import leaf_groups as jleaf_groups
from repro.models import model as JM
from repro_torch.core import packing as tpk
from repro_torch.core.gossip import leaf_groups as tleaf_groups
from repro_torch.core.tree import flatten_sorted, tree_map, unflatten

W = 4


def reduced_worker_tree(seed=0):
    """The reduced smollm param tree with a leading worker axis, as numpy,
    each worker perturbed differently."""
    cfg = get_arch("smollm-135m").reduced()
    params = JM.init_model(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x)[None]
                   + 0.01 * rng.standard_normal((W,) + x.shape))
        .astype(np.float32), params)


def to_torch(tree):
    return tree_map(torch.from_numpy, tree)


def spec_pair(tree_np, groups: bool):
    jt = jax.tree.map(jnp.asarray, tree_np)
    tt = to_torch(tree_np)
    if not groups:
        return (jpk.pack_spec_w(jt, block_rows=64),
                tpk.pack_spec_w(tt, block_rows=64), jt, tt)
    return (jpk.pack_spec_w(jt, block_rows=64, groups=jleaf_groups(jt, 4),
                            n_groups=4),
            tpk.pack_spec_w(tt, block_rows=64, groups=tleaf_groups(tt, 4),
                            n_groups=4), jt, tt)


def test_leaf_order_matches_jax_flatten():
    tree = reduced_worker_tree()
    jl = jax.tree.leaves(tree)
    tl, treedef = flatten_sorted(tree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a is b
    # the treedef keeps the empty 'tail' dict of the reference tree
    assert unflatten(treedef, tl)["tail"] == {}


def test_leaf_groups_match():
    tree = reduced_worker_tree()
    assert jax.tree.leaves(jleaf_groups(tree, 4)) == \
        flatten_sorted(tleaf_groups(to_torch(tree), 4))[0]


@pytest.mark.parametrize("groups", [False, True])
def test_pack_spec_and_pack_w_bitwise(groups):
    tree = reduced_worker_tree()
    jspec, tspec, jt, tt = spec_pair(tree, groups)
    for f in ("shapes", "sizes", "n", "rows", "block_rows", "n_workers",
              "group_leaves", "group_row_ranges"):
        assert getattr(jspec, f) == getattr(tspec, f), f
    if groups:
        assert tspec.rows == 2624   # the reduced slice's R
    np.testing.assert_array_equal(np.asarray(jpk.pack_w(jt, jspec)),
                                  tpk.pack_w(tt, tspec).numpy())


def test_full_smollm_spec_matches_reference():
    """The main path's layout at full size: the port's spec from shapes
    alone (meta tensors) equals the reference's — (4, 262848, 512) with
    the group row ranges the kernels are sized for."""
    cfg = get_arch("smollm-135m")
    shapes = jax.eval_shape(lambda: JM.init_model(cfg, jax.random.key(0)))
    jt = jax.tree.map(lambda s: jax.ShapeDtypeStruct((W,) + s.shape,
                                                     s.dtype), shapes)
    tt = jax.tree.map(lambda s: torch.empty((W,) + s.shape, device="meta"),
                      shapes)
    jspec = jpk.pack_spec_w(jt, block_rows=64, groups=jleaf_groups(jt, 4),
                            n_groups=4)
    tspec = tpk.pack_spec_w(tt, block_rows=64, groups=tleaf_groups(tt, 4),
                            n_groups=4)
    assert tspec.rows == jspec.rows == 262848
    assert tspec.n == 134_515_008
    assert tspec.group_row_ranges == jspec.group_row_ranges == (
        (0, 61824), (61824, 133120), (133120, 204416), (204416, 262848))


@pytest.mark.parametrize("groups", [False, True])
def test_unpack_w_roundtrip_and_views(groups):
    tree = reduced_worker_tree()
    _, tspec, _, tt = spec_pair(tree, groups)
    packed = tpk.pack_w(tt, tspec)
    back = tpk.unpack_w(packed, tspec)
    for a, b in zip(flatten_sorted(tt)[0], flatten_sorted(back)[0]):
        assert torch.equal(a, b)
    rows0 = tpk.unpack_rows(packed[0], tspec)
    for a, b in zip(flatten_sorted(tt)[0], flatten_sorted(rows0)[0]):
        assert torch.equal(a[0], b)
        # a view of the packed storage, not a copy
        assert b.untyped_storage().data_ptr() == \
            packed.untyped_storage().data_ptr()


def test_gradient_through_unpack_rows_is_pack_w():
    """d/d(packed) of sum_leaf <leaf, c_leaf> through unpack_rows views is
    pack_w(c) bitwise, zeros in the padding included — the reference's
    'gradient born packed' identity."""
    tree = reduced_worker_tree()
    _, tspec, _, tt = spec_pair(tree, True)
    rng = np.random.default_rng(1)
    coef = tree_map(lambda x: torch.from_numpy(
        rng.standard_normal(tuple(x.shape)).astype(np.float32)), tt)
    leaf = tpk.pack_w(tt, tspec).requires_grad_(True)
    total = 0.0
    for w, rows in enumerate(leaf.unbind(0)):
        views = flatten_sorted(tpk.unpack_rows(rows, tspec))[0]
        total = total + sum((v * c[w]).sum() for v, c in
                            zip(views, flatten_sorted(coef)[0]))
    total.backward()
    assert torch.equal(leaf.grad, tpk.pack_w(coef, tspec))


def test_quantize_rows_bitwise():
    rng = np.random.default_rng(2)
    blk = (rng.standard_normal((W, 256, jpk.LANE))
           * np.exp(rng.uniform(-6, 3, (W, 256, 1)))).astype(np.float32)
    blk[1, 64:128] = 0.0                     # an all-zero tile -> scale 0
    blk[2, 0, :3] = [1.5, -2.5, 0.5]         # ties for round-half-even
    # jitted, as every reference engine runs it (XLA turns the division by
    # the constant 127 into a multiply by its reciprocal; eager op-by-op
    # dispatch divides and can differ in the last bit)
    jq, js = jax.jit(jpk.quantize_rows, static_argnums=1)(
        jnp.asarray(blk), 64)
    tq, ts = tpk.quantize_rows(torch.from_numpy(blk), 64)
    assert tq.dtype == torch.int8 and ts.shape == (W, 4)
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    assert float(ts[1, 1]) == 0.0 and not tq[1, 64:128].any()
    np.testing.assert_array_equal(
        np.asarray(jpk.dequantize_rows(jq, js, 64)),
        tpk.dequantize_rows(tq, ts, 64).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jpk.fake_quant_rows, static_argnums=1)(
            jnp.asarray(blk), 64)),
        tpk.fake_quant_rows(torch.from_numpy(blk), 64).numpy())


def test_scale_blocks_rejects_unaligned_rows():
    with pytest.raises(ValueError, match="not a multiple"):
        tpk.quantize_rows(torch.zeros((2, 100, tpk.LANE)), 64)


def test_single_worker_pack_roundtrip():
    rng = np.random.default_rng(3)
    tree = {"b": rng.standard_normal((3, 5)).astype(np.float32),
            "a": {"x": rng.standard_normal((700,)).astype(np.float32)}}
    jspec = jpk.pack_spec(jax.tree.map(jnp.asarray, tree), block_rows=8)
    tspec = tpk.pack_spec(to_torch(tree), block_rows=8)
    assert (tspec.rows, tspec.n, tspec.sizes) == \
        (jspec.rows, jspec.n, jspec.sizes)
    packed = tpk.pack(to_torch(tree), tspec)
    np.testing.assert_array_equal(
        np.asarray(jpk.pack(jax.tree.map(jnp.asarray, tree), jspec)),
        packed.numpy())
    back = tpk.unpack(packed, tspec)
    assert torch.equal(back["b"], torch.from_numpy(tree["b"]))


def test_group_ranges_array():
    tree = reduced_worker_tree()
    jspec, tspec, _, _ = spec_pair(tree, True)
    np.testing.assert_array_equal(np.asarray(jpk.group_ranges_array(jspec)),
                                  tpk.group_ranges_array(tspec).numpy())
    with pytest.raises(ValueError, match="no group layout"):
        tpk.group_ranges_array(spec_pair(tree, False)[1])
