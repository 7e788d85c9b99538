"""The dry-run's trace of one rank of the tensor-parallel layout
(launch/dryrun.py over launch/steps.py ``step_and_args``): the pytree
train step and the serve steps on DTensor shards over ``model``.

* Meta against real: ranks 0 and 1 of a (2, 2) ``("data", "model")``
  mesh (model ranks 0 and 1 of data coordinate 0) traced on meta tensors
  in a fake process group, against the same ranks' steps run on real CPU
  DTensors in a 4-rank gloo group (one launch of
  tests/_torch_tp_dryrun_ranks.py) under the same ``dryrun.Counters``:
  FLOPs, aten bytes, argument bytes, the modeled kernel calls and the
  traced collectives all equal, the live-bytes peak equal or the real
  one at most 1% above (a gloo collective's buffer held by its
  asynchronous work on a loaded host), for reduced smollm
  (the fused blend, the plain one, algo 'sync'), mamba2 (train and
  prefill: B5 and B5b on each rank's heads), granite-moe (train, decode)
  and whisper (prefill).  The calls are compared by name: B2r/B2a's
  modeled bytes count a meta mask whole and a real one by its ones.
* At a (1, 1) mesh the placed trace counts the FLOPs of the replicated
  one (the single-device step on the rank's workers, as the dry-run
  traced the pytree and serve steps before), and no collective bytes;
  whisper's placed prefill adds exactly its cross K/V's second
  projection for the cache.
* At (2, 2), reduced smollm (4 heads and 2 KV heads divide 2): argument
  bytes equal ``placed_bytes``, the peak below the replicated trace's,
  and a sharded projection's local FLOPs on the two ``model`` ranks sum
  to the whole one's.
* ``run_pair`` on the fake two-pod (2, 16, 16) mesh: a reduced pytree
  pair and a reduced decode pair read ``"layout": "tensor_parallel"``,
  argument bytes equal to placed bytes; a packed pair "worker_split".
* The transports' meta branches (launch/mesh.py) move nothing and are
  taken for meta tensors only; the collectives plan of the placed step.

The fake process groups are destroyed where they are made.
"""
import dataclasses
import json
import time

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core.asgd import ASGDConfig
from repro_torch.core.gossip import GossipConfig
from repro_torch.kernels.ssd_scan.kernel import scan_bwd_work, scan_work
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch import mesh as MM
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import fake_process_group, make_host_mesh
from repro_torch.models.mlp import apply_mlp

import _torch_tp_dryrun_ranks as DR
import _torch_tp_ranks as R
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_tensor_parallel import finish_ranks

TIMEOUT_S = 150            # the whole launch; a hang fails, it never waits
CASE_IDS = [c[0] for c in DR.CASES]
CASES = {c[0]: c for c in DR.CASES}


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """{rank: {case: meta counts}} for ranks 0 and 1, and the four gloo
    ranks' real counts."""
    t_end = time.monotonic() + TIMEOUT_S
    tmp = tmp_path_factory.mktemp("tp_dryrun")
    procs, logs = R.start_ranks(tmp, {}, script=DR.__file__)
    meta = {}
    try:
        for rank in (0, 1):
            with fake_process_group(DR.WORLD, rank=rank):
                mesh = make_host_mesh(*DR.MESH, device="cpu")
                meta[rank] = {c[0]: DR.trace(c, mesh) for c in DR.CASES}
    finally:
        ranks = finish_ranks(tmp, procs, logs, t_end)
    real = [{k: json.loads(str(v)) for k, v in rk.items()} for rk in ranks]
    return meta, real


# a real gloo collective's output lives until its asynchronous work is
# done, which on a loaded host can outlast its last use by a few ops: the
# real peak may hold one such buffer more than the meta trace (0.3% of
# whisper's prefill seen under the suite's load; equal when unloaded)
PEAK_RATIO = 1.01


@pytest.mark.parametrize("rank", (0, 1))
@pytest.mark.parametrize("case", CASE_IDS)
def test_meta_trace_counts_as_the_rank(traces, case, rank):
    """Every count of the meta trace equals the real rank's, exactly, but
    the peak: the real one within PEAK_RATIO above it."""
    meta, real = traces
    m, r = meta[rank][case], real[rank][case]
    assert m["flops"] > 0 and m["peak"] >= m["arg_bytes"] > 0
    for k in ("flops", "bytes", "arg_bytes", "kernels", "collectives",
              "n_collectives"):
        assert m[k] == r[k], (k, m[k], r[k])
    assert m["peak"] <= r["peak"] <= PEAK_RATIO * m["peak"], (m["peak"],
                                                              r["peak"])
    # model > 1: DTensor's redistributions reach the counters
    assert m["n_collectives"] > 0


def test_kernels_run_on_local_shards(traces):
    """B2r/B2a once a round under the fused blend, none under the plain
    one; B5 twice an 'S' layer in training (remat reruns it), B5b once,
    B5 once in a prefill, each modeled on the rank's half of the heads
    and its rows (``ssd_scan.kernel.scan_work``, ``scan_bwd_work``)."""
    meta, _ = traces
    names = {c: meta[0][c]["kernels"] for c in CASE_IDS}
    assert names["smollm-fused"] == ["gossip_reduce_w", "gossip_apply_w"]
    assert names["smollm-plain"] == names["smollm-sync"] == []
    n = get_arch("mamba2-370m").reduced().n_layers
    assert names["mamba2-train"].count("ssd_scan") == 2 * n
    assert names["mamba2-train"].count("ssd_scan_bwd") == n
    assert names["mamba2-prefill"] == ["ssd_scan"] * n
    cfg = get_arch("mamba2-370m").reduced()
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    dims = (cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk)
    # each rank's half of the heads: train W_local 1 x batch 2 rows,
    # prefill its 1 row of the batch of 2
    fwd = scan_work(2, DR.TRAIN.seq_len, H // 2, *dims)[1]
    bwd = scan_bwd_work(2, DR.TRAIN.seq_len, H // 2, *dims)[1]
    ops = meta[0]["mamba2-train"]["kernel_ops"]
    assert ops == {"ssd_scan": 2 * n * fwd, "ssd_scan_bwd": n * bwd}
    assert meta[0]["mamba2-prefill"]["kernel_ops"] == {
        "ssd_scan": n * scan_work(1, DR.PREFILL.seq_len, H // 2, *dims)[1]}


def replicated_trace(cfg, shape, mesh, algo="asgd", acfg=None):
    """The dry-run's trace before the tensor-parallel layout: the
    single-device step (no mesh) on the rank's worker slice, every leaf
    whole, under the same counters.  Returns (counters, argument bytes)."""
    specs = ST.input_specs(cfg, shape, mesh, DR.GCFG, dtype=D.TRACE_DTYPE,
                           workers=DR.WORKERS)
    if shape.kind == "train":
        fn = ST.make_train_step(cfg, algo=algo, gcfg=DR.GCFG, acfg=acfg)
    elif shape.kind == "prefill":
        fn = ST.make_prefill_step(cfg)
    else:
        fn = ST.make_decode_step(cfg)
    args = D.rank_args(specs, mesh, layout="worker_split")
    tensors = D.arg_tensors(args)
    with D.Counters(tensors) as c:
        fn(*args.values())
    return c, sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("case", ["smollm-fused", "smollm-sync",
                                  "mamba2-train", "granite-train",
                                  "granite-decode", "whisper-prefill"])
def test_one_rank_mesh_counts_the_replicated_flops(case):
    """At a (1, 1) mesh the placed trace runs every leaf whole: its FLOPs
    are the replicated trace's exactly, and run_pair sends nothing."""
    _, arch, shape, algo, fused = CASES[case]
    cfg = get_arch(arch).reduced()
    acfg = ASGDConfig(eps=DR.EPS, use_fused=fused)
    with fake_process_group(1):
        mesh = make_host_mesh(1, 1, device="cpu")
        placed = D.trace_step(cfg, shape, mesh, DR.GCFG, algo=algo,
                              workers=DR.WORKERS, acfg=acfg)
        repl, repl_args = replicated_trace(cfg, shape, mesh, algo, acfg)
        rec = D.run_pair(arch, shape.name, multi_pod=False, gcfg=DR.GCFG,
                         algo=algo, mesh=mesh, cfg=cfg, shape=shape,
                         full_budget_s=0.0, verbose=False)
    extra = 0
    if cfg.frontend == "audio" and shape.kind == "prefill":
        # the placed prefill projects each decoder layer's cross K/V a
        # second time for its cache (models/blocks.py _cross_full, as the
        # reference does); the plain one keeps the attention's
        extra = (cfg.n_layers * 2 * 2 * shape.global_batch * cfg.encoder_seq
                 * cfg.d_model * cfg.n_kv_heads * cfg.resolved_head_dim)
    assert placed["flops"] == repl.flops + extra > 0
    assert placed["arg_bytes"] == repl_args
    assert placed["collectives"] == {} and placed["n_collectives"] == 0
    assert rec["collective_bytes"] == 0 and rec["collective_traced"] == {}
    assert rec["layout"] == "tensor_parallel"


@pytest.fixture
def mesh22():
    with fake_process_group(4):
        yield make_host_mesh(2, 2, device="cpu")
    assert not dist.is_initialized()


def test_two_by_two_record_holds_a_ranks_share(mesh22):
    """Reduced smollm at (2, 2): argument bytes are placed_bytes (the
    params and gossip buffer sharded over model, the worker axis and the
    batch over data), and the rank's peak is below the replicated
    trace's."""
    cfg = get_arch("smollm-135m").reduced()
    assert cfg.n_heads % 2 == 0 and cfg.n_kv_heads % 2 == 0
    rec = D.run_pair("smollm-135m", DR.TRAIN.name, multi_pod=False,
                     gcfg=DR.GCFG, mesh=mesh22, cfg=cfg, shape=DR.TRAIN,
                     full_budget_s=1e9, verbose=False)
    repl, repl_args = replicated_trace(cfg, DR.TRAIN, mesh22)
    mem = rec["memory"]
    assert rec["layout"] == "tensor_parallel" and not mem["extrapolated"]
    assert mem["argument_bytes"] == mem["placed_bytes"] < repl_args
    assert mem["peak_bytes"] < repl.peak
    assert rec["collective_traced"] and rec["collective_planned"]
    assert rec["collective_bytes"] == pytest.approx(
        sum(rec["collective_planned"].values())
        + sum(rec["collective_traced"].values()))


def test_sharded_projection_flops_sum_to_the_whole():
    """The GLU MLP of reduced smollm on placed leaves (gate and up
    ``Shard`` on d_ff, down on its rows): each ``model`` rank's local
    FLOPs are half the whole MLP's, and the two ranks' sum to it."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = get_arch("smollm-135m").reduced()
    W, B, S, Dm, F = 1, 2, 8, cfg.d_model, cfg.d_ff
    shapes = {"gate": (W, Dm, F), "up": (W, Dm, F), "down": (W, F, Dm)}
    specs = {"gate": ("data", None, "model"), "up": ("data", None, "model"),
             "down": ("data", "model", None)}
    x = torch.empty(W, B, S, Dm, device="meta")
    flops = []
    for rank in (0, 1):
        with fake_process_group(4, rank=rank):
            mesh = make_host_mesh(2, 2, device="cpu")
            from repro_torch.launch.tensor_parallel import model_mesh
            sizes = SH.axis_sizes_of(mesh)
            params = {k: D._placed(ST._struct((2,) + shapes[k][1:],
                                              torch.float32, specs[k]),
                                   sizes, model_mesh(mesh), "meta")
                      for k in shapes}
            with D.Counters() as c, implicit_replication():
                apply_mlp(params, x)
            flops.append(c.flops)
    with D.Counters() as whole:
        apply_mlp({k: torch.empty(v, device="meta")
                   for k, v in shapes.items()}, x)
    assert flops[0] == flops[1] == whole.flops // 2
    assert sum(flops) == whole.flops == 3 * 2 * W * B * S * Dm * F


@pytest.mark.parametrize("kind", ("train", "decode"))
def test_run_pair_two_pod_mesh_is_placed(kind):
    """Reduced smollm on the production (2, 16, 16) mesh in a fake group
    of 512 (W = 32 worker groups): a pytree train pair and a decode pair
    trace the tensor-parallel layout, argument bytes the placed bytes."""
    cfg = get_arch("smollm-135m").reduced()
    shape = (ShapeConfig("train_small", 16, 64, "train") if kind == "train"
             else ShapeConfig("decode_small", 32, 64, "decode"))
    rec = D.run_pair("smollm-135m", shape.name, multi_pod=True,
                     gcfg=DR.GCFG, cfg=cfg, shape=shape, full_budget_s=0.0,
                     verbose=False)
    assert rec["mesh"] == "2x16x16" and rec["layout"] == "tensor_parallel"
    assert rec["memory"]["argument_bytes"] == rec["memory"]["placed_bytes"]
    assert rec["collective_traced"]
    assert not dist.is_initialized()


def test_packed_pairs_stay_worker_split(mesh22):
    """The packed engines keep their layout: the worker axis over the data
    axes, the rest whole, nothing traced over ``model``."""
    cfg = get_arch("smollm-135m").reduced()
    rec = D.run_pair("smollm-135m", DR.TRAIN.name, multi_pod=False,
                     gcfg=DR.GCFG, engine="packed", mesh=mesh22, cfg=cfg,
                     shape=DR.TRAIN, full_budget_s=0.0, verbose=False)
    assert rec["layout"] == "worker_split"
    assert rec["collective_traced"] == {}
    assert ST.layout_of(DR.TRAIN, "pipelined") == "worker_split"
    assert ST.layout_of(DR.PREFILL, "packed") == "tensor_parallel"


def test_a_pair_the_mesh_step_cannot_carry_fails():
    """The int8 wire on the pytree step, once refused (ROADMAP 15d), runs
    on the placed trace in run_pair: its planned ring send is each
    group's local shards in int8 codes plus one f32 scale a worker and
    sent leaf, and the scales' absmaxes' max over ``model`` an
    all-reduce of (W_local, n_sent) f32."""
    from repro_torch.core.gossip import leaf_groups
    from repro_torch.core.tree import flatten_sorted
    cfg = get_arch("smollm-135m").reduced()
    int8 = dataclasses.replace(DR.GCFG, wire_format="int8")
    with fake_process_group(4):
        mesh = make_host_mesh(2, 2, device="cpu")
        rec = D.run_pair("smollm-135m", DR.TRAIN.name, multi_pod=False,
                         gcfg=int8, mesh=mesh, cfg=cfg, shape=DR.TRAIN,
                         full_budget_s=0.0, verbose=False)
        specs = ST.input_specs(cfg, DR.TRAIN, mesh, int8,
                               dtype=D.TRACE_DTYPE)
        params = D.rank_args(specs, mesh, layout="tensor_parallel")["params"]
    assert not dist.is_initialized()
    assert rec["layout"] == "tensor_parallel" and rec["w_local"] == 1
    leaves = flatten_sorted(params)[0]
    groups = flatten_sorted(leaf_groups(params, int8.partial_blocks))[0]
    sent = [[x.to_local() for x, g in zip(leaves, groups) if g == b]
            for b in range(int8.partial_blocks)]
    # shift 1 over two worker groups of W_local 1: the one row crosses
    codes = [sum(x.numel() for x in xs) + 4 * len(xs) for xs in sent]
    plan = rec["collective_planned"]
    assert plan["ppermute"] == sum(codes) / len(codes)
    assert plan["all-reduce"] == 2.0 * sum(4 * len(xs) for xs in sent) / 2
    assert plan["ppermute"] < sum(sum(x.numel() * 4 for x in xs)
                                  for xs in sent) / len(sent) / 3


def test_transports_move_nothing_on_meta():
    """gather_workers, psum_rank_order and the ring roll return meta
    outputs of their shapes without a collective (the bytes a send would
    move still tallied); a CPU tensor still goes through the transport
    check, which refuses it on an NCCL group, and a meta one passes."""
    def refuse(*a, **k):
        raise AssertionError("a meta tensor reached a collective")
    with fake_process_group(4):
        mesh = make_host_mesh(2, 2, device="cpu")
        group = MM._worker_group(mesh)
        x = torch.empty(3, 5, device="meta")
        with pytest.MonkeyPatch.context() as mp:
            for name in ("all_gather", "batch_isend_irecv"):
                mp.setattr(MM.dist, name, refuse)
            g = MM.gather_workers(x, mesh)
            s = MM.psum_rank_order(x, mesh, ("model",))
            ctx = MM._RegionCtx(mesh, group, 2, 3, (), None)
            r = MM._roll_workers_manual(x, 2, group, 2, 3, ctx)
        assert (g.shape, s.shape, r.shape) == ((6, 5), (3, 5), (3, 5))
        assert {t.device.type for t in (g, s, r)} == {"meta"}
        assert ctx.bytes_sent == 2 * 5 * 4
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(MM.dist, "get_backend", lambda g: "nccl")
            MM._check_transport(x, group)
            with pytest.raises(ValueError, match="cannot travel"):
                MM._check_transport(torch.empty(3), group)
    assert not dist.is_initialized()


def test_planned_collectives_of_the_placed_step():
    """The placed step's plan on a (2, 2) mesh, W_local 2, one leaf of
    (W, 40, 30) with d 30 over model: the ring send of the rank's shard
    (shift 1 moves one of its 2 worker rows), the gate terms' rank-order
    sum over model, the metrics — the losses and, for 'asgd', the gates —
    gathered over the worker group; 'sync' a rank-order sum of one
    worker's shard over the worker group; 'silent' the losses only."""
    g = GossipConfig(shifts=(1,), partial_blocks=1)
    with fake_process_group(4):
        mesh = make_host_mesh(2, 2, device="cpu")
        from repro_torch.launch.tensor_parallel import model_mesh
        leaf = D._placed(ST._struct((4, 40, 30), torch.float32,
                                    ("data", None, "model")),
                         SH.axis_sizes_of(mesh), model_mesh(mesh), "meta")
        assert leaf.shape == (2, 40, 30)
        assert leaf.to_local().shape == (2, 40, 15)
        kw = dict(engine="pytree", gcfg=g, n_shards=2, w_local=2,
                  params={"a": leaf}, placed=True)
        asgd = HA.planned_collectives(algo="asgd", psum_ranks=2, **kw)
        sync = HA.planned_collectives(algo="sync", **kw)
        silent = HA.planned_collectives(algo="silent", **kw)
    shard = 40 * 15 * 4                       # one worker's local bytes
    assert asgd["by_op"] == {"ppermute": shard, "psum": 2 * 3 * 4,
                             "all-gather": 2 * 2 * 4}
    assert asgd["count"] == 3
    assert sync["by_op"] == {"psum": shard, "all-gather": 2 * 4}
    assert silent["by_op"] == {"all-gather": 2 * 4}
    assert HA.traced_collective("all_gather_into_tensor", 64) == (
        "all-gather", 64.0)
    assert HA.traced_collective("all_reduce", 64) == ("all-reduce", 128.0)
    assert HA.traced_collective("wait_tensor", 64) is None
