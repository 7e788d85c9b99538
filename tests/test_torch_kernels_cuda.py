"""The port's CUDA kernels against their plain-torch versions, on the card.

This file imports neither jax nor the reference, so it also runs where
only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tests marked ``cuda`` skip without a GPU.  Tolerances: the (W, P, 3) sums
within rtol 1e-5 (the kernel and torch add in different orders); the
apply pass within atol 1e-6 (the same elementwise operations in the same
order — the kernels are built without fused multiply-add — save the sum
over P externals, whose order torch picks).
"""
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.core.packing import quantize_rows
from repro_torch.kernels.gossip_blend import gossip_gates
from repro_torch.kernels.gossip_blend.kernel import (SOURCE, gossip_apply,
                                                     gossip_apply_w,
                                                     gossip_apply_w_resident,
                                                     gossip_reduce,
                                                     gossip_reduce_w,
                                                     gossip_reduce_w_resident)
from repro_torch.kernels.gossip_blend.ref import (
    gossip_apply_plain, gossip_apply_w_plain, gossip_apply_w_resident_plain,
    gossip_reduce_plain, gossip_reduce_w_plain,
    gossip_reduce_w_resident_plain)

W, R, LANE, BR = 4, 2624, 512, 64
EPS, LR, ALPHA = 0.05, 0.07, 0.3
RANGES = {"full": (0, R), "partial": (768, 1408), "empty": (1408, 1408),
          "unaligned": (100, 1000)}


def make_operands(p, wire, seed, device):
    rng = np.random.default_rng(seed)
    w = (0.05 * rng.standard_normal((W, R, LANE))).astype(np.float32)
    dw = (0.01 * rng.standard_normal((W, R, LANE))).astype(np.float32)
    side = np.where(rng.permutation(W * p) % 2 == 0, 0.5, -0.5)
    ext = (w[:, None] - side.reshape(W, p, 1, 1) * dw[:, None]
           + 0.02 * rng.standard_normal((W, p, R, LANE))).astype(np.float32)
    ops = {"w": torch.from_numpy(w), "dw": torch.from_numpy(dw),
           "ext": torch.from_numpy(ext), "scales": None}
    if wire == "int8":
        ops["ext"], ops["scales"] = quantize_rows(ops["ext"], BR)
    return {k: None if v is None else v.to(device) for k, v in ops.items()}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_build_targets_hopper_and_is_keyed_by_source():
    assert SOURCE in K.kernel_sources()
    flags = " ".join(K.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    lib = K.library_path(SOURCE)
    assert lib.parent == K.BUILD_DIR and lib == K.library_path(SOURCE)
    assert lib.name.startswith("gossip_blend-")


def test_kernel_source_names_what_it_replaces():
    text = pathlib.Path(SOURCE).read_text()
    for name in ("gossip_reduce_w_resident_pallas",
                 "gossip_apply_w_resident_pallas", "Bound:"):
        assert name in text


def test_batched_source_builds_apart_and_names_what_it_replaces():
    """B2 and B3 build from B1's source, one library for the six kernels,
    each with its own C entry point."""
    blend = [s for s in K.kernel_sources() if s.parent == SOURCE.parent]
    assert blend == [SOURCE]
    text = pathlib.Path(SOURCE).read_text()
    for name in ("gossip_reduce_w_pallas", "gossip_apply_w_pallas",
                 "gossip_reduce_pallas", "gossip_apply_pallas", "Bound:"):
        assert name in text
    for entry in ("gossip_reduce_w_resident(", "gossip_apply_w_resident(",
                  "gossip_reduce_w(", "gossip_apply_w(", "gossip_reduce(",
                  "gossip_apply("):
        assert f"int {entry}" in text


@pytest.mark.cuda
@pytest.mark.parametrize("rng_name", sorted(RANGES))
@pytest.mark.parametrize("wire,p,elastic", [("f32", 1, False),
                                            ("int8", 1, True),
                                            ("f32", 2, True),
                                            ("int8", 3, False)])
def test_cuda_kernels_match_plain(cuda_device, wire, p, elastic, rng_name):
    ops = make_operands(p, wire, 2, cuda_device)
    rr = RANGES[rng_name]
    if wire == "int8" and rng_name == "unaligned":
        rr = (128, 1024)    # int8 partitions are block_rows-aligned
    args = (ops["w"], ops["dw"], ops["ext"])
    K.reset_launch_counts()
    acc = gossip_reduce_w_resident(*args, rr, ops["scales"], block_rows=BR)
    acc_p = gossip_reduce_w_resident_plain(*args, rr, ops["scales"],
                                           block_rows=BR)
    torch.testing.assert_close(acc, acc_p, rtol=1e-5, atol=0)
    gates = gossip_gates(acc_p, EPS)
    inv = 1.0 / (gates.sum(dim=1) + 1.0)
    kw = {"elastic": elastic, "elastic_alpha": ALPHA, "block_rows": BR}
    out = gossip_apply_w_resident(*args, gates, inv, LR, rr, ops["scales"],
                                  **kw)
    out_p = gossip_apply_w_resident_plain(*args, gates, inv, LR, rr,
                                          ops["scales"], **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-6)
    assert K.launch_counts() == {"gossip_reduce_w_resident": 1,
                                 "gossip_apply_w_resident": 1}


@pytest.mark.cuda
def test_cuda_reduce_is_deterministic(cuda_device):
    ops = make_operands(1, "int8", 3, cuda_device)
    runs = [gossip_reduce_w_resident(ops["w"], ops["dw"], ops["ext"],
                                     (768, 1408), ops["scales"],
                                     block_rows=BR) for _ in range(3)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])


@pytest.mark.cuda
def test_cuda_rejects_bad_operands(cuda_device):
    ops = make_operands(1, "f32", 4, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        gossip_reduce_w_resident(ops["w"].transpose(0, 1).contiguous()
                                 .transpose(0, 1), ops["dw"], ops["ext"],
                                 (0, R), block_rows=BR)
    with pytest.raises(ValueError, match="several devices"):
        gossip_reduce_w_resident(ops["w"], ops["dw"].cpu(), ops["ext"],
                                 (0, R), block_rows=BR)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("p,elastic", [(1, False), (3, True), (8, False)])
def test_cuda_batched_kernels_match_plain(cuda_device, p, elastic, masked):
    """B2r/B2a (W=4, a partition mask or none) and B3r/B3a (worker 0's
    slice) against their plain versions."""
    ops = make_operands(p, "f32", 5, cuda_device)
    w, dw, ext = ops["w"], ops["dw"], ops["ext"]
    mask = None
    if masked:
        mask = torch.zeros(R * LANE, device=cuda_device)
        mask[1000:R * LANE // 2 + 333] = 1.0
        mask = mask.reshape(R, LANE)
    kw = {"eps": EPS, "elastic": elastic, "elastic_alpha": ALPHA}
    K.reset_launch_counts()
    acc = gossip_reduce_w(w, dw, ext, mask)
    acc_p = gossip_reduce_w_plain(w, dw, ext, mask)
    torch.testing.assert_close(acc, acc_p, rtol=1e-5, atol=0)
    gates = gossip_gates(acc_p, EPS)
    inv = 1.0 / (gates.sum(dim=1) + 1.0)
    out = gossip_apply_w(w, dw, ext, gates, inv, mask, **kw)
    out_p = gossip_apply_w_plain(w, dw, ext, gates, inv, mask, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-6)
    acc1 = gossip_reduce(w[0], dw[0], ext[0])
    acc1_p = gossip_reduce_plain(w[0], dw[0], ext[0])
    torch.testing.assert_close(acc1, acc1_p, rtol=1e-5, atol=0)
    g1 = gossip_gates(acc1_p, EPS)
    inv1 = 1.0 / (g1.sum() + 1.0)
    out1 = gossip_apply(w[0], dw[0], ext[0], g1, inv1, **kw)
    out1_p = gossip_apply_plain(w[0], dw[0], ext[0], g1, inv1, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out1, out1_p, rtol=0, atol=1e-6)
    assert K.launch_counts() == {"gossip_reduce_w": 1, "gossip_apply_w": 1,
                                 "gossip_reduce": 1, "gossip_apply": 1}


@pytest.mark.cuda
def test_cuda_batched_reduce_is_deterministic_and_bounds_p(cuda_device):
    ops = make_operands(2, "f32", 6, cuda_device)
    mask = torch.ones((R, LANE), device=cuda_device)
    runs = [gossip_reduce_w(ops["w"], ops["dw"], ops["ext"], mask)
            for _ in range(3)]
    runs1 = [gossip_reduce(ops["w"][0], ops["dw"][0], ops["ext"][0])
             for _ in range(3)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    for r in runs1[1:]:
        assert torch.equal(r, runs1[0])
    big = ops["ext"][0, :1].expand(9, R, LANE).contiguous()
    with pytest.raises(ValueError, match="P=9 externals exceed"):
        gossip_reduce(ops["w"][0], ops["dw"][0], big)
