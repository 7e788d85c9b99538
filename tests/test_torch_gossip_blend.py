"""The port's packed-resident gossip blend (repro_torch.kernels.gossip_blend)
against the reference's Pallas kernels (interpret mode on the CPU) and jnp
oracle, at the reduced slice's shape (W=4, R=2624).

On the CPU the wrappers run their plain-torch versions, so these tests
hold the plain versions — the functions the CUDA kernels are checked
against on the card — to the TPU kernels.  Tolerances: the (W, P, 3)
sums within rtol 1e-5 (the packages add in different orders); gates equal
wherever the gate margin |2*eps*dot - eps^2*sq_dw| exceeds 1e-4 of its
scale (a hard threshold may flip inside that band); states within atol
1e-6 (f32 rounding of O(0.1) values).  The CUDA kernels themselves are
held to these plain versions in test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import quantize_rows as jquantize_rows
from repro.kernels.gossip_blend import gossip_gates as jgossip_gates
from repro.kernels.gossip_blend.kernel import (
    gossip_apply_w_resident_pallas, gossip_reduce_w_resident_pallas)
from repro.kernels.gossip_blend.ref import \
    gossip_blend_w_resident_ref as jblend_ref
from repro_torch import kernels as K
from repro_torch.kernels.gossip_blend import (gossip_blend_w_resident,
                                              gossip_gates)
from repro_torch.kernels.gossip_blend.kernel import (gossip_apply_w_resident,
                                                     gossip_reduce_w_resident)
from repro_torch.kernels.gossip_blend.ops import choose_block_rows
from repro_torch.kernels.gossip_blend.ref import \
    gossip_blend_w_resident_ref as tblend_ref

W, R, LANE, BR = 4, 2624, 512, 64
EPS, LR, ALPHA = 0.05, 0.07, 0.3
RANGES = {"full": (0, R), "partial": (768, 1408), "empty": (1408, 1408)}


def make_operands(p=1, wire="f32", seed=0):
    """w, dw, ext (+ int8 q and scales).  Half the (worker, external)
    pairs sit ahead of the local step and half behind, far from the gate
    threshold, so the gates mix and no summation order can flip them."""
    rng = np.random.default_rng(seed)
    w = (0.05 * rng.standard_normal((W, R, LANE))).astype(np.float32)
    dw = (0.01 * rng.standard_normal((W, R, LANE))).astype(np.float32)
    side = np.where(rng.permutation(W * p) % 2 == 0, 0.5, -0.5)
    ext = (w[:, None] - side.reshape(W, p, 1, 1) * dw[:, None]
           + 0.02 * rng.standard_normal((W, p, R, LANE))).astype(np.float32)
    ops = {"w": w, "dw": dw, "ext": ext, "scales": None}
    if wire == "int8":
        q, s = jquantize_rows(jnp.asarray(ext), BR)
        ops["ext"], ops["scales"] = np.asarray(q), np.asarray(s)
    return ops


def t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def j(x):
    return None if x is None else jnp.asarray(x)


def assert_gates_agree(g_ref, g_port, acc_ref):
    dot, sq_dw = np.asarray(acc_ref[..., 0]), np.asarray(acc_ref[..., 2])
    margin = np.abs(2 * EPS * dot - EPS * EPS * sq_dw)
    scale = np.abs(2 * EPS * dot) + EPS * EPS * sq_dw
    far = margin > 1e-4 * scale
    np.testing.assert_array_equal(np.asarray(g_ref)[far],
                                  np.asarray(g_port)[far])
    return far


@pytest.mark.parametrize("rng_name", sorted(RANGES))
@pytest.mark.parametrize("elastic", [False, True])
@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_plain_passes_match_pallas_kernels(wire, elastic, rng_name):
    ops = make_operands(wire=wire)
    r0, r1 = RANGES[rng_name]
    rr = jnp.asarray([r0, r1], jnp.int32)
    acc_j = gossip_reduce_w_resident_pallas(
        rr, j(ops["w"]), j(ops["dw"]), j(ops["ext"]), j(ops["scales"]),
        block_rows=BR, interpret=True)
    acc_t = gossip_reduce_w_resident(t(ops["w"]), t(ops["dw"]), t(ops["ext"]),
                                     (r0, r1), t(ops["scales"]),
                                     block_rows=BR)
    assert acc_t.shape == (W, 1, 3)
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), rtol=1e-5,
                               atol=0)
    g_j = jgossip_gates(acc_j, EPS)
    far = assert_gates_agree(g_j, gossip_gates(acc_t, EPS).numpy(), acc_j)
    if rng_name == "empty":   # every term zero: all gates closed
        assert not np.asarray(acc_j).any() and not acc_t.any()
        assert not np.asarray(g_j).any() and not gossip_gates(acc_t,
                                                              EPS).any()
    else:
        assert far.all() and 0 < np.asarray(g_j).sum() < W
    # the apply pass on the same gates
    inv = 1.0 / (jnp.sum(g_j, axis=1) + 1.0)
    out_j = gossip_apply_w_resident_pallas(
        rr, j(ops["w"]), j(ops["dw"]), j(ops["ext"]), g_j, inv, LR,
        j(ops["scales"]), elastic=elastic, elastic_alpha=ALPHA,
        block_rows=BR, interpret=True)
    out_t = gossip_apply_w_resident(
        t(ops["w"]), t(ops["dw"]), t(ops["ext"]), t(g_j), t(inv), LR,
        (r0, r1), t(ops["scales"]), elastic=elastic, elastic_alpha=ALPHA,
        block_rows=BR)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("rng_name", sorted(RANGES))
@pytest.mark.parametrize("wire,p,elastic", [("f32", 1, False),
                                            ("int8", 1, True),
                                            ("f32", 2, True),
                                            ("int8", 2, False)])
def test_blend_matches_reference_oracle(wire, p, elastic, rng_name):
    """ops.gossip_blend_w_resident (both passes and the gates between) and
    the port's direct oracle, against the reference's jnp oracle."""
    ops = make_operands(p=p, wire=wire, seed=1)
    r0, r1 = RANGES[rng_name]
    kw = {"elastic": elastic, "elastic_alpha": ALPHA}
    out_j, g_j = jblend_ref(j(ops["w"]), j(ops["dw"]), j(ops["ext"]),
                            jnp.asarray([r0, r1]), EPS, lr=LR,
                            ext_scales=j(ops["scales"]), block_rows=BR, **kw)
    for fn in (gossip_blend_w_resident, tblend_ref):
        extra = {"block_rows": BR} if fn is tblend_ref else {}
        out_t, g_t = fn(t(ops["w"]), t(ops["dw"]), t(ops["ext"]), (r0, r1),
                        EPS, lr=LR, ext_scales=t(ops["scales"]), **kw,
                        **extra)
        np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                                   atol=1e-6)


def test_gate_scale_and_default_lr():
    """gate_scale 0 closes every gate (the staleness guard) and leaves the
    plain SGD step; lr defaults to eps."""
    ops = make_operands()
    args = (t(ops["w"]), t(ops["dw"]), t(ops["ext"]), (0, R), EPS)
    out, gates = gossip_blend_w_resident(*args, gate_scale=0.0)
    assert not gates.any()
    torch.testing.assert_close(out, t(ops["w"]) - EPS * t(ops["dw"]),
                               rtol=0, atol=0)
    out_a, _ = gossip_blend_w_resident(*args)
    out_b, _ = gossip_blend_w_resident(*args, lr=EPS)
    assert torch.equal(out_a, out_b)


def test_cpu_runs_plain_version_without_launching():
    K.reset_launch_counts()
    ops = make_operands()
    gossip_blend_w_resident(t(ops["w"]), t(ops["dw"]), t(ops["ext"]),
                            (0, R), EPS)
    assert K.launch_counts() == {}


def test_operand_checks():
    ops = make_operands()
    w, dw, ext = t(ops["w"]), t(ops["dw"]), t(ops["ext"])
    with pytest.raises(ValueError, match="int8 needs ext_scales"):
        gossip_reduce_w_resident(w, dw, ext.to(torch.int8), (0, R),
                                 block_rows=BR)
    with pytest.raises(ValueError, match="must divide"):
        gossip_reduce_w_resident(w, dw, ext, (0, R), block_rows=100)
    with pytest.raises(ValueError, match="ext4d must be"):
        gossip_reduce_w_resident(w, dw, ext[:, :, :64], (0, R),
                                 block_rows=BR)
    meta = [x.to("meta") for x in (w, dw, ext)]
    with pytest.raises(ValueError, match="run on cuda"):
        gossip_reduce_w_resident(*meta, (0, R), block_rows=BR)


def test_choose_block_rows_fixed_fallback():
    assert choose_block_rows(2624) == 64
    assert choose_block_rows(262848) == 64
    assert choose_block_rows(96) == 32
    assert choose_block_rows(None) == 64
