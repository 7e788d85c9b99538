"""The port's step input specs (repro_torch.launch.steps input_specs,
packed_spec_for) against the reference's, for every assigned (arch x
shape) pair and every train engine, at full size.

The reference runs on ``make_host_mesh(1, 1)``, as its own tests do
(tests/test_gossip_pipelined.py TestPackedInputSpecs); the port on a
(1, 1) ("data", "model") mesh of a one-rank "fake" process group,
destroyed after the module.  Leaf by leaf: the shape, the dtype and the
spec (padded with None to the leaf's rank) of every tensor.  The
reference's stacked FIFO (D, W, R, LANE) is the port's tuple of D slots;
the scalars the reference carries as device ints (its key, the FIFO's
partition indices and step, the sgd placeholder, the decode position) are
host ints in the port, and must be there.  To keep the suite fast the
reference's ``params_struct`` is memoized per (arch, train) around the
reference's own function.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.launch.steps as JST
from repro.configs.registry import get_arch as j_arch
from repro.configs.registry import get_shape as j_shape
from repro.core.gossip import GossipConfig as JGossipConfig
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro_torch.configs.registry import assigned_pairs, get_arch, get_shape
from repro_torch.core.gossip import GossipConfig
from repro_torch.launch import steps as ST
from repro_torch.launch.dryrun import structs_of
from repro_torch.launch.mesh import fake_process_group, make_host_mesh

ENGINES = ("pytree", "packed", "pipelined")
CASES = [(c.name, s.name, e) for c, s in assigned_pairs()
         for e in (ENGINES if s.kind == "train" else ("pytree",))]


@pytest.fixture(scope="module")
def meshes():
    jmesh = j_host_mesh(data=1, model=1)
    orig = JST.params_struct
    memo = {}

    @functools.wraps(orig)
    def params_struct(cfg, mesh, *, train):
        key = (cfg.name, train)
        if key not in memo:
            memo[key] = orig(cfg, mesh, train=train)
        return memo[key]
    JST.params_struct = params_struct
    try:
        with fake_process_group(1):
            yield jmesh, make_host_mesh(1, 1, device="cpu")
    finally:
        JST.params_struct = orig
    assert not dist.is_initialized()


def _pad(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def ref_leaves(tree, fifo_stacked=False):
    """[(path, shape, dtype, spec)] of a reference tree of sharded
    ShapeDtypeStructs; ``fifo_stacked``: every leaf is a stacked FIFO,
    which becomes its D slots."""
    out = []
    for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = jax.tree_util.keystr(path)
        spec = _pad(s.sharding.spec, len(s.shape))
        dtype = str(np.dtype(s.dtype))
        if fifo_stacked:
            out += [(f"{name}[{i}]", s.shape[1:], dtype, spec[1:])
                    for i in range(s.shape[0])]
        else:
            out.append((name, s.shape, dtype, spec))
    return out


def port_leaves(tree):
    return [(tuple(s.shape), str(s.dtype).removeprefix("torch."),
             _pad(s.spec, len(s.shape))) for s in structs_of(tree)]


def _strip(rows):
    return [r[1:] for r in rows]


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_input_specs_match_reference(meshes, case):
    jmesh, tmesh = meshes
    arch, shape_name, engine = case
    jgcfg, gcfg = JGossipConfig(), GossipConfig()
    want = JST.input_specs(j_arch(arch), j_shape(shape_name), jmesh, jgcfg,
                           engine=engine)
    got = ST.input_specs(get_arch(arch), get_shape(shape_name), tmesh, gcfg,
                         engine=engine)
    kind = get_shape(shape_name).kind
    if kind == "train":
        assert set(want) == {"params", "gossip", "opt", "batch", "key"}
        assert set(got) == {"params", "gossip", "opt_state", "batch",
                            "shift_idx", "block_idx"}
        assert (got["opt_state"], got["shift_idx"], got["block_idx"]) == (
            0, 0, 0)
        stacked = engine == "pipelined"           # delay 1: depth 2
        jg, tg = want["gossip"], got["gossip"]
        assert _strip(ref_leaves(jg.buf, stacked)) == port_leaves(tg.buf)
        if engine != "pytree":
            assert tg.buf_scales is None and jg.buf_scales is None
            assert tg.buf_idx == (0,) * len(tg.buf)
        else:
            assert tg.buf_idx == 0
        assert tg.step == 0
        pairs = ("params", "batch")
    elif kind == "prefill":
        assert set(got) == set(want) == {"params", "batch"}
        pairs = ("params", "batch")
    else:
        assert set(got) == set(want) == {"params", "token", "pos", "cache"}
        assert got["pos"] == get_shape(shape_name).seq_len - 1
        pairs = ("params", "token", "cache")
    for k in pairs:
        assert _strip(ref_leaves(want[k])) == port_leaves(got[k]), k


@pytest.mark.parametrize("arch", ["smollm-135m", "phi3.5-moe-42b-a6.6b",
                                  "whisper-tiny", "recurrentgemma-9b"])
def test_packed_spec_rows_match_reference(meshes, arch):
    jmesh, tmesh = meshes
    for jg, tg in ((JGossipConfig(), GossipConfig()),
                   (JGossipConfig(partial_blocks=2, fused_block_rows=8),
                    GossipConfig(partial_blocks=2, fused_block_rows=8))):
        want = JST.packed_spec_for(j_arch(arch), jmesh, jg)
        got = ST.packed_spec_for(get_arch(arch), tmesh, tg)
        assert (got.n_workers, got.rows, got.block_rows, got.n) == (
            want.n_workers, want.rows, want.block_rows, want.n)
        assert got.group_row_ranges == tuple(
            tuple(int(v) for v in r) for r in want.group_row_ranges)
        assert got.group_leaves == tuple(tuple(g)
                                         for g in want.group_leaves)


def test_int8_fifo_and_workers(meshes):
    """The int8 wire's scales ride with each slot; ``workers`` sets W and
    the batch split as the trainer's --workers does."""
    _, tmesh = meshes
    cfg = get_arch("smollm-135m")
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=128,
                                global_batch=8)
    g = ST.input_specs(cfg, shape, tmesh, GossipConfig(wire_format="int8"),
                       engine="pipelined", workers=4)
    spec = ST.packed_spec_for(cfg, tmesh, GossipConfig(wire_format="int8"),
                              workers=4)
    assert g["params"].shape == (4, spec.rows, 512)
    assert g["batch"]["tokens"].shape == (4, 2, 128)
    assert [s.dtype for s in g["gossip"].buf] == [torch.int8] * 2
    assert [s.shape for s in g["gossip"].buf_scales] == [
        (4, spec.rows // spec.block_rows)] * 2
    with pytest.raises(ValueError):
        ST.input_specs(cfg, shape, tmesh, engine="bogus")
