"""models/hints.py ``constrain`` and the ambient mesh of launch/mesh.py
``mesh_context``, and the model with its ``constrain`` calls.

``constrain`` is the reference's ``with_sharding_constraint`` hint: the
argument itself with no ambient mesh or for a plain tensor; a DTensor
redistributed to the spec's placements under an ambient mesh, axis names
the mesh lacks dropped.  The mesh is a one-process "fake" process group
(rank 0 of 4, a (2, 2) ("data", "model") mesh), destroyed in the fixture's
teardown; the DTensors are on the meta device, so nothing moves.

The model: the reduced configs of the archs whose flags turn the hints on
(``seq_parallel``, ``attn_batch_shard``: qwen, gemma3, paligemma) and
recurrentgemma with ``attn_batch_shard`` set for its 'R' layers, at a
per-worker batch of 16 (the batch-sharded condition), forward bitwise
equal with and without the flags, under an ambient mesh and without one;
the calls are counted.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_arch
from repro_torch.launch.mesh import (_auto_mesh, fake_process_group,
                                     mesh_context)
from repro_torch.models import blocks, hints
from repro_torch.models import model as M
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def mesh():
    with fake_process_group(4):
        yield _auto_mesh((2, 2), ("data", "model"), "cpu")
    assert not dist.is_initialized()


def test_no_mesh_returns_the_argument():
    x = torch.zeros(2, 3)
    assert hints.ambient_mesh() is None
    assert hints.constrain(x, "model", None) is x


def test_mesh_context_sets_and_restores(mesh):
    assert hints.ambient_mesh() is None
    with mesh_context(mesh):
        assert hints.ambient_mesh() is mesh
        with mesh_context(mesh["data"]):
            assert hints.ambient_mesh().mesh_dim_names == ("data",)
        assert hints.ambient_mesh() is mesh
    assert hints.ambient_mesh() is None


def test_plain_tensor_is_identity_under_a_mesh(mesh):
    x = torch.zeros(4, 6)
    with mesh_context(mesh):
        assert hints.constrain(x, "data", "model") is x


def test_dtensor_takes_the_spec(mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = distribute_tensor(torch.empty(4, 8, 2, device="meta"), mesh,
                          [Replicate(), Replicate()])
    with mesh_context(mesh):
        y = hints.constrain(x, "data", "expert", None)   # no 'expert' axis
        assert y.placements == (Shard(0), Replicate())
        assert y.to_local().shape == (2, 8, 2)
        z = hints.constrain(x, hints.WORKERS, "model", None)
        assert z.placements == (Shard(0), Shard(1))
        # all-None after the drop: a no-op
        assert hints.constrain(x, None, "expert", None) is x
        assert hints.constrain(x, ("pod", "data"), None, None) is x
    assert hints.constrain(x, "data", None, None) is x   # no mesh


def _flagged(arch):
    cfg = get_arch(arch).reduced()
    if arch == "recurrentgemma-9b":
        cfg = dataclasses.replace(cfg, attn_batch_shard=True)
    return cfg


@pytest.mark.parametrize("arch", ["qwen3-14b", "gemma3-1b", "paligemma-3b",
                                  "recurrentgemma-9b"])
def test_model_with_hints_is_bitwise_the_same(mesh, monkeypatch, arch):
    cfg = _flagged(arch)
    plain = dataclasses.replace(cfg, seq_parallel=False,
                                attn_batch_shard=False)
    assert cfg.attn_batch_shard
    rng = np.random.default_rng(0)
    params = M.init_model(cfg, 0, device="cpu")
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (16, 8), dtype=np.int32))}
    if cfg.frontend == "vision":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (16, cfg.prefix_len, cfg.d_model), dtype=np.float32))
    calls = []
    real = blocks.constrain

    def counted(x, *spec):
        calls.append(spec)
        return real(x, *spec)
    monkeypatch.setattr(blocks, "constrain", counted)
    with torch.no_grad():
        want = M.forward(plain, params, batch)
        assert not calls
        got = M.forward(cfg, params, batch)
        with mesh_context(mesh):
            got_mesh = M.forward(cfg, params, batch)
    assert calls
    assert all(s[0] == hints.WORKERS for s in calls)
    assert torch.equal(got, want) and torch.equal(got_mesh, got)
