"""The port's dry-run stack: launch/hlo_analysis.py against the reference's
formulas, and launch/dryrun.py's counters.

* ``model_flops`` equals the reference's for all 33 assigned pairs;
  ``RooflineTerms`` with the H100 constants is the reference's
  ``test_roofline_terms_dominant`` case, rescaled.
* Meta against real: a step traced on meta tensors counts the same aten
  FLOPs, the same aten bytes and the same modeled kernel calls as the
  same step run on real CPU tensors (the kernels' plain versions hidden
  from the counters), for reduced configs on each train engine and on
  prefill and decode — a dense arch, mamba2 (B5 and B5b modeled) and
  granite-moe — at a (1, 1) mesh of one gloo rank (the pytree and serve
  steps run tensor-parallel: tests/test_torch_dryrun_tp.py holds them at
  (2, 2)), every train engine on the int8 wire (the pytree step's on the
  rank's shards).
* The 1-/2-cycle extrapolation equals a full-depth trace of reduced
  configs of 3 cycles (FLOPs, bytes, peak, argument bytes and kernels):
  the dense arch on every step, mamba2 and gemma3's (5 'L' + 'G') cycle
  on a packed engine.
* ``run_pair`` on a reduced pair on a fake (2, 2) mesh, the counterpart of
  the reference's ``test_dryrun_smoke_small_mesh``, and on the production
  two-pod (2, 16, 16) mesh in a fake group of 512.
* The kernels' meta branches return the plain versions' output shapes and
  dtypes and note their modeled work; operands on another device raise.

The fake process groups are destroyed in the fixtures' teardowns.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro.configs.registry import get_arch as j_arch
from repro.configs.registry import get_shape as j_shape
from repro.launch.hlo_analysis import model_flops as j_model_flops
from repro_torch import kernels as K
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import assigned_pairs, get_arch
from repro_torch.core.gossip import GossipConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch.mesh import (fake_process_group, init_ranks,
                                    make_host_mesh)

PAIRS = [(c.name, s.name) for c, s in assigned_pairs()]
TRAIN = ShapeConfig("train_small", 16, 4, "train")
PREFILL = ShapeConfig("prefill_small", 16, 2, "prefill")
DECODE = ShapeConfig("decode_small", 32, 2, "decode")
GCFG = GossipConfig(shifts=(1,), partial_blocks=2, wire_format="int8")
STEPS = [(TRAIN, "pytree"), (TRAIN, "packed"), (TRAIN, "pipelined"),
         (PREFILL, "pytree"), (DECODE, "pytree")]


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_model_flops_match_reference(pair):
    from repro_torch.configs.registry import get_shape
    arch, shape = pair
    for chips in (1, 256, 512):
        assert HA.model_flops(get_arch(arch), get_shape(shape), chips) == \
            j_model_flops(j_arch(arch), j_shape(shape), chips)


def test_roofline_terms_dominant():
    t = HA.RooflineTerms(arch="a", shape="s", mesh="m", chips=256,
                         hlo_flops=67e12, hlo_bytes=3.35e12 * 10,
                         collective_bytes=450e9, model_flops=67e12)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(10.0)
    assert t.collective_s == pytest.approx(1.0)
    assert t.dominant == "memory"
    assert t.useful_ratio == pytest.approx(1.0)
    tc = dataclasses.replace(t, dtype="tf32", kernel_compute_s=0.5)
    assert tc.compute_s == pytest.approx(67 / 495 + 0.5)
    assert set(t.as_dict()) >= {"compute_s", "memory_s", "collective_s",
                                "dominant", "useful_ratio", "dtype"}


@pytest.fixture
def mesh11(tmp_path):
    """A (1, 1) mesh on a one-rank gloo group: the pytree and serve steps
    run tensor-parallel, and their CPU run's transports take gloo."""
    init_ranks(str(tmp_path / "store"), 0, 1, device="cpu")
    try:
        yield make_host_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def filler(vocab, seed=0):
    """Writes seeded values into a step's arguments: params and batch
    floats N(0, 0.02^2), token ids in [0, vocab), gossip state and caches
    zero (their initial values)."""
    def fill(args):
        g = torch.Generator().manual_seed(seed)
        for k, v in args.items():
            for t in D.arg_tensors(v):
                if k in ("gossip", "cache"):
                    t.zero_()
                elif t.is_floating_point():
                    t.normal_(0, 0.02, generator=g)
                else:
                    t.random_(0, vocab, generator=g)
    return fill


# every step of the dense arch; the SSM's and the MoE's own layers on one
# train engine and one serving step each
META_CASES = ([("smollm-135m", s) for s in STEPS]
              + [("mamba2-370m", STEPS[2]), ("mamba2-370m", STEPS[3]),
                 ("granite-moe-1b-a400m", STEPS[0]),
                 ("granite-moe-1b-a400m", STEPS[4])])


def _case_id(case):
    arch, (shape, engine) = case
    return f"{arch}-{shape.kind}-{engine}"


@pytest.mark.parametrize("case", META_CASES, ids=_case_id)
def test_meta_trace_counts_as_the_cpu_step(mesh11, case):
    arch, (shape, engine) = case
    cfg = get_arch(arch).reduced()
    kw = dict(engine=engine, workers=2)
    meta = D.trace_step(cfg, shape, mesh11, GCFG, **kw)
    real = D.trace_step(cfg, shape, mesh11, GCFG, device="cpu",
                        fill=filler(cfg.vocab), **kw)
    assert meta["flops"] > 0
    for k in ("flops", "bytes", "kernels", "arg_bytes"):
        assert meta[k] == real[k], k
    names = [k["name"] for k in meta["kernels"]]
    if shape.kind == "train" and engine != "pytree":
        assert names.count("gossip_reduce_w_resident") == 1
        assert names.count("gossip_apply_w_resident") == 1
    if arch == "mamba2-370m" and shape.kind != "decode":
        n = cfg.n_layers
        train = shape.kind == "train"
        # a training step rematerializes: its backward reruns each forward
        assert names.count("ssd_scan") == (2 * n if train else n)
        assert names.count("ssd_scan_bwd") == (n if train else 0)


@pytest.fixture
def mesh22():
    with fake_process_group(4):
        yield make_host_mesh(2, 2, device="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize(
    "case", [("smollm-135m", s) for s in STEPS]
    + [("mamba2-370m", STEPS[2]), ("gemma3-1b", STEPS[1])], ids=_case_id)
def test_extrapolation_equals_full_depth(mesh22, case):
    arch, (shape, engine) = case
    base = get_arch(arch).reduced()
    cfg = dataclasses.replace(base, n_layers=3 * len(base.pattern_cycle))
    rec = D.run_pair(arch, shape.name, multi_pod=False,
                     gcfg=GCFG, engine=engine, mesh=mesh22,
                     cfg=cfg, shape=shape, full_budget_s=1e9, verbose=False)
    assert rec["trace_full_s"] is not None
    assert not rec["memory"]["extrapolated"]
    sh = rec["shallow"]
    assert sh["flops"] == rec["hlo_flops"]
    assert sh["bytes"] == rec["aten_bytes"]
    bias = 0
    if shape.kind == "decode":
        # the tensor-parallel decode's first layer reads the replicated
        # embedding; every later one a residual left Partial by the MLP,
        # which it holds beside its all-reduced copy: one (B_local, D) f32
        # row more from the second layer on, which the 1- and 2-cycle
        # extrapolation counts again in each further cycle
        rows = shape.global_batch // mesh22.shape[0]
        bias = (3 - 2) * rows * cfg.d_model * 4
    assert sh["peak"] == rec["memory"]["peak_bytes"] + bias
    assert sh["arg_bytes"] == rec["memory"]["argument_bytes"]
    assert sh["kernels"] == rec["kernels"]
    assert sh["collectives"] == rec["collective_traced"]


def test_run_pair_smoke_small_mesh(mesh22):
    """A reduced pair on a (2, 2) mesh through run_pair: W = 2 worker
    groups, W_local = 1, the ring send planned, roofline terms formed."""
    cfg = get_arch("smollm-135m").reduced()
    rec = D.run_pair("smollm-135m", "train_small", multi_pod=False,
                     gcfg=GossipConfig(shifts=(1,), partial_blocks=2),
                     engine="pipelined", mesh=mesh22, cfg=cfg, shape=TRAIN,
                     full_budget_s=0.0, verbose=False)
    assert rec["mesh"] == "2x2" and rec["chips"] == 4 and rec["w_local"] == 1
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > rec["aten_bytes"]
    assert rec["memory"]["extrapolated"] and rec["trace_full_s"] is None
    assert rec["collective_by_op"]["ppermute"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert 0 < rec["useful_ratio"] and rec["fits"]
    assert rec["kernels"]["gossip_apply_w_resident"]["launches"] == 1
    # the packed ensemble and its FIFO split over the worker axes only,
    # so the tensor-parallel layout places what one port rank holds
    assert rec["memory"]["placed_bytes"] == rec["memory"]["argument_bytes"]
    assert not dist.is_initialized() or dist.get_world_size() == 4


def test_run_pair_two_pod_mesh():
    """A reduced pair through run_pair(multi_pod=True) with no mesh given:
    the production (2, 16, 16) ("pod", "data", "model") mesh in a fake
    group of 512 ranks, W = 32 worker groups (pod-major), W_local = 1,
    the ring send planned, roofline terms formed; the group is gone
    after."""
    cfg = get_arch("smollm-135m").reduced()
    shape = ShapeConfig("train_small", 16, 64, "train")
    rec = D.run_pair("smollm-135m", shape.name, multi_pod=True,
                     gcfg=GossipConfig(shifts=(1,), partial_blocks=2),
                     cfg=cfg, shape=shape, full_budget_s=0.0, verbose=False)
    assert rec["mesh"] == "2x16x16" and rec["chips"] == 512
    assert rec["ranks"] == 512 and rec["w_local"] == 1
    assert rec["collective_by_op"]["ppermute"] > 0
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert 0 < rec["useful_ratio"] and rec["fits"]
    assert not dist.is_initialized()


def test_counters_track_live_bytes():
    a = torch.empty(100, device="meta")
    with D.Counters([a]) as c:
        b = a * 2                  # 400 + 400 bytes alive
        del a
        d = b + 1                  # a freed: still 800
        del b, d
        e = torch.empty(300, device="meta")    # 1200 bytes, moves none
        del e
    assert c.peak == 1200
    assert c.bytes == 4 * 400 and c.flops == 0


def test_kernel_meta_branches():
    from repro_torch.kernels.gossip_blend import kernel as GB
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_chunked
    m = dict(device="meta")
    W, R, P = 2, 128, 1
    w, dw = torch.empty(W, R, 512, **m), torch.empty(W, R, 512, **m)
    ext = torch.empty(W, P, R, 512, dtype=torch.int8, **m)
    sc = torch.empty(W, P, R // 64, **m)
    with K.record_modeled() as rec:
        acc = GB.gossip_reduce_w_resident(w, dw, ext, (64, 128), sc,
                                          block_rows=64)
        out = GB.gossip_apply_w_resident(
            w, dw, ext, torch.empty(W, P, **m), torch.empty(W, **m), 0.1,
            (64, 128), sc, block_rows=64)
        acc2 = GB.gossip_reduce_w(w, dw, ext.float(), None)
        out2 = GB.gossip_apply_w(w, dw, ext.float(), torch.empty(W, P, **m),
                                 torch.empty(W, **m), None, eps=0.1)
        x = torch.empty(2, 64, 3, 8, **m, requires_grad=True)
        y, h = ssd_scan_chunked(x, torch.empty(2, 64, 3, **m),
                                torch.empty(2, 3, **m),
                                torch.empty(2, 64, 4, **m),
                                torch.empty(2, 64, 4, **m), 32)
        (y.sum() + h.sum()).backward()
    assert (acc.shape, acc.dtype) == ((W, P, 3), torch.float32)
    assert (out.shape, out.dtype) == ((W, R, 512), torch.float32)
    assert acc2.shape == (W, P, 3) and out2.shape == (W, R, 512)
    assert y.shape == (2, 64, 3, 8) and h.shape == (2, 3, 4, 8)
    assert x.grad.shape == x.shape and x.grad.device.type == "meta"
    assert [r["name"] for r in rec] == [GB.REDUCE, GB.APPLY, GB.REDUCE_W,
                                        GB.APPLY_W, "ssd_scan",
                                        "ssd_scan_bwd"]
    assert rec[0]["bytes"] == GB.resident_work(
        GB.REDUCE, W, P, R, (64, 128), 1, 64, True)[0]
    assert K.launch_counts() == {} or all(
        n not in K.launch_counts() for n in (GB.REDUCE, GB.APPLY))
    # the modeled work is each kernel's PERF.md bound: B1r/B1a at the
    # [kernels] int8 shape (1.314 GB, 6.606 GB), B5 at the serve shape
    # (3 x 10.89 GFLOP of TF32), B5b at the training shape (3 x 9.82)
    from repro_torch.kernels.ssd_scan.kernel import (scan_bwd_work,
                                                     scan_work)
    b1r = GB.resident_work(GB.REDUCE, 4, 1, 262848, (61824, 133120), 1, 64,
                           True)
    b1a = GB.resident_work(GB.APPLY, 4, 1, 262848, (61824, 133120), 1, 64,
                           True)
    assert (round(b1r[0] / 1e9, 3), round(b1a[0] / 1e9, 3)) == (1.314,
                                                                 6.606)
    assert round(scan_work(4, 2048, 32, 64, 128, 128)[1] / 3e9, 2) == 10.89
    assert round(scan_bwd_work(8, 512, 32, 64, 128, 128)[1] / 3e9, 2) == 9.82


def test_other_devices_raise():
    from repro_torch.kernels.gossip_blend import kernel as GB
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_chunked

    class OnDevice:
        def __init__(self, dev):
            self.device = torch.device(dev)
    with pytest.raises(ValueError, match="run on cuda"):
        GB._route(OnDevice("xla"), OnDevice("xla"))
    with pytest.raises(ValueError, match="several devices"):
        GB._route(torch.empty(1, device="meta"), torch.empty(1))
    m = torch.empty(1, 64, 1, 4, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        ssd_scan_chunked(m, torch.empty(1, 64, 1), torch.empty(1, 1),
                         torch.empty(1, 64, 4), torch.empty(1, 64, 4), 32)
    # B3 is not on the dry-run's path: meta still raises there
    with pytest.raises(ValueError, match="run on cuda"):
        GB.gossip_reduce(torch.empty(8, 512, device="meta"),
                         torch.empty(8, 512, device="meta"),
                         torch.empty(1, 8, 512, device="meta"))


def test_planned_collectives_by_algo():
    """The plan's ops: the ring send's mean over every (shift, partition)
    pair, the gate terms a psum gathers, the sync baseline's ring
    all-reduce (2x the gradient), nothing for silent."""
    from repro_torch.core.gossip import leaf_groups
    from repro_torch.core.packing import pack_spec_w
    tree = {"a": torch.zeros(2, 40, 30), "b": torch.zeros(2, 6)}
    g = GossipConfig(shifts=(1, 2), partial_blocks=2, fused_block_rows=8)
    spec = pack_spec_w(tree, block_rows=8, groups=leaf_groups(tree, 2),
                       n_groups=2)
    kw = dict(engine="packed", gcfg=g, n_shards=4, w_local=2, spec=spec)
    want = sum(HA.ppermute_bytes(spec, g, 4, 2, s, b)
               for s in (0, 1) for b in (0, 1)) / 4
    out = HA.planned_collectives(algo="asgd", psum_ranks=2, **kw)
    assert out["by_op"] == {"ppermute": want, "psum": 2 * 3 * 4}
    assert out["total"] == want + 24 and out["count"] == 2
    assert HA.planned_collectives(algo="silent", **kw)["total"] == 0
    assert HA.planned_collectives(algo="sync", **kw)["by_op"] == {
        "all-reduce": 2.0 * 2 * spec.rows * 512 * 4}
    # shift 1 over W_local = 2: one of the two rows crosses to the next rank
    assert HA.moved_rows(1, 4, 2) == 1 and HA.moved_rows(2, 4, 2) == 2
    assert HA.moved_rows(8, 4, 2) == 0          # the whole ring: local
    pt = HA.planned_collectives(algo="asgd", engine="pytree", gcfg=g,
                                n_shards=4, w_local=2, params=tree)
    assert pt["by_op"]["ppermute"] == (1 + 2) / 2 * (40 * 30 + 6) * 4 / 2
