"""The port's per-leaf partition specs (repro_torch.launch.sharding) against
the reference's (repro.launch.sharding), and their placement on a
DeviceMesh.

Specs: every param leaf of the ten archs at full size, train (leading W
axis) and serve, on the production meshes' axis sizes — {"data": 16,
"model": 16} with worker axis "data", and {"pod": 2, "data": 16, "model":
16} with worker axes ("pod", "data") — and every decode pair's cache
leaves.  The reference's leaves come from ``jax.eval_shape`` and the
port's from the meta device, so nothing is allocated and no mesh is
needed: the spec functions read key paths, shapes and axis sizes only.
Each port spec must equal ``tuple(PartitionSpec)`` of the reference's.

Placements: one process as rank 6 of a "fake" process group of 8 — the
point (pod 1, data 1, model 0) of a (2, 2, 2) mesh — whose worker slice
is 3 (pod-major); the group is destroyed in the fixture's teardown.
"""
import functools
import math

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.configs.registry import ARCHS as J_ARCHS
from repro.launch import sharding as JS
from repro.models import model as JM
from repro_torch.configs.registry import ARCHS, assigned_pairs
from repro_torch.core.tree import tree_map
from repro_torch.launch import sharding as TS
from repro_torch.launch.mesh import _auto_mesh, fake_process_group
from repro_torch.models import model as TM

MESHES = {
    "16x16": ({"data": 16, "model": 16}, ("data",)),
    "2x16x16": ({"pod": 2, "data": 16, "model": 16}, ("pod", "data")),
}
DECODE_PAIRS = [(c.name, s.name) for c, s in assigned_pairs()
                if s.kind == "decode"]


def _w(axis_sizes, worker_axes):
    return math.prod(axis_sizes[a] for a in worker_axes)


@functools.lru_cache
def ref_param_shapes(arch):
    return jax.eval_shape(lambda: JM.init_model(
        J_ARCHS[arch], jax.random.key(0), dtype=jnp.bfloat16))


def ref_specs(tree, fn):
    """{key path: tuple(spec)} of a reference tree of ShapeDtypeStructs."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(JS._key_names(path))] = tuple(fn(path, leaf))
    return out


def port_specs(tree, fn):
    return {tuple(p): fn(p, leaf) for p, leaf in TS.tree_paths(tree)}


@pytest.mark.parametrize("train", [True, False], ids=["train", "serve"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(arch, mesh, train):
    sizes, wa = MESHES[mesh]
    W = _w(sizes, wa)
    shapes = ref_param_shapes(arch)
    if train:
        shapes = jax.tree.map(
            lambda s: jax.ShapeDtypeStruct((W,) + s.shape, s.dtype), shapes)
    want = ref_specs(shapes, lambda p, l: JS.param_pspec(
        p, l, axis_sizes=sizes, worker_axes=wa, train=train))
    params = TM.init_model(ARCHS[arch], device="meta", dtype=torch.bfloat16)
    if train:
        params = tree_map(lambda x: x.expand((W,) + tuple(x.shape)), params)
    got = port_specs(params, lambda p, l: TS.param_pspec(
        p, l, axis_sizes=sizes, worker_axes=wa, train=train))
    assert got == want
    # the fallbacks show: smollm's 9 heads shard d_model instead
    if arch == "smollm-135m" and not train:
        assert got[("scan", "pos0", "attn", "wq")] == (None, "model", None,
                                                       None)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("pair", DECODE_PAIRS, ids="-".join)
def test_cache_specs_match_reference(pair, mesh):
    from repro.configs.registry import get_shape as j_shape
    from repro_torch.configs.registry import get_shape
    arch, shape_name = pair
    sizes, wa = MESHES[mesh]
    jcfg, jshape = J_ARCHS[arch], j_shape(shape_name)
    cache = jax.eval_shape(lambda: JM.init_cache(
        jcfg, jshape.global_batch, jshape.seq_len, dtype=jnp.bfloat16))
    want = ref_specs(cache, lambda p, l: JS.cache_pspec(
        p, l, jcfg, axis_sizes=sizes, worker_axes=wa))
    shape = get_shape(shape_name)
    tcache = TM.init_cache(ARCHS[arch], shape.global_batch, shape.seq_len,
                           device="meta")
    got = port_specs(tcache, lambda p, l: TS.cache_pspec(
        p, l, ARCHS[arch], axis_sizes=sizes, worker_axes=wa))
    assert got == want
    if shape_name == "long_500k":    # a batch of 1 cannot split over data
        assert all(s[1 if p[0] == "scan" else 0] is None
                   for p, s in got.items())


@pytest.fixture
def pod_rank():
    """This process as rank 6 of a fake (2, 2, 2) ("pod", "data",
    "model") mesh: pod 1, data 1, model 0."""
    with fake_process_group(8, rank=6):
        yield _auto_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    assert not dist.is_initialized()


def test_placements_and_pod_major_worker_slice(pod_rank):
    from torch.distributed.tensor import Replicate, Shard
    mesh = pod_rank
    assert tuple(mesh.get_coordinate()) == (1, 1, 0)
    wa = ("pod", "data")
    assert TS.placements(mesh, (wa, None, "model")) == (Shard(0), Shard(0),
                                                        Shard(2))
    assert TS.placements(mesh, (None, None)) == (Replicate(),) * 3
    W, V, D = 4, 8, 6
    tree = {"embed": torch.arange(W * V * D, dtype=torch.float32).reshape(
        W, V, D), "final_norm": {"scale": torch.arange(W * D,
                                                       dtype=torch.float32)
                                 .reshape(W, D)}}
    specs = TS.tree_pspecs(mesh, tree, worker_axes=wa)
    assert specs["embed"] == (wa, "model", None)
    assert specs["final_norm"]["scale"] == (wa, None)
    placed = TS.tree_shardings(mesh, tree, worker_axes=wa)
    assert placed["embed"] == (Shard(0), Shard(0), Shard(1))
    dt = TS.distribute_params(mesh, tree, worker_axes=wa)
    # the fake group moves no data: the shards' shapes and offsets say
    # which slice this rank holds — worker 3 (pod-major: pod 1 * 2 +
    # data 1), vocab half 0 (model 0)
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset as local_of
    e = dt["embed"]
    assert e.shape == tree["embed"].shape and e.placements == placed["embed"]
    assert tuple(e.to_local().shape) == (1, V // 2, D)
    assert local_of(e.shape, mesh, e.placements) == ((1, V // 2, D),
                                                     (3, 0, 0))
    s = dt["final_norm"]["scale"]
    assert local_of(s.shape, mesh, s.placements) == ((1, D), (3, 0))


def test_cache_placements(pod_rank):
    from torch.distributed.tensor import Replicate, Shard
    cfg = ARCHS["smollm-135m"].reduced()
    cache = TM.init_cache(cfg, 4, 32, device="meta")
    placed = TS.cache_shardings(pod_rank, cache, cfg,
                                worker_axes=("pod", "data"))
    # (n_full, B, S, KV, Dh): batch over (pod, data); 2 KV heads over model
    assert placed["scan"]["pos0"]["k"] == (Shard(1), Shard(1), Shard(3))
    sizes = TS.axis_sizes_of(pod_rank)
    k = cache["scan"]["pos0"]["k"]
    spec = TS.cache_pspecs(pod_rank, cache, cfg,
                           worker_axes=("pod", "data"))["scan"]["pos0"]["k"]
    assert TS.placed_bytes(k.shape, k.dtype, spec, sizes) == \
        k.numel() * k.element_size() // 8
    assert Replicate() not in placed["scan"]["pos0"]["k"]
