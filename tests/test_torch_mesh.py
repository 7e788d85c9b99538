"""The port's manual-region gossip rounds (repro_torch.launch.mesh) across
8 gloo CPU processes, against the reference's single-device engines.

One launch (tests/_torch_mesh_ranks.py) runs 8 ranks as a (4, 2)
``("data", "model")`` mesh, the reference's shape, at W = 8 (W_local = 2,
so the roll takes its two-fetch path), on the reference tests' tree
({"a": (W, 20, 30), "b": (W, 6)}, block_rows 8, shifts (1, 2, 3, 5),
partial_blocks 2, 'leaves' mode) made from a seed with numpy.  Before the
launch this process runs the reference's engines (``repro.core.gossip``
``asgd_gossip_apply_packed`` and ``asgd_gossip_apply_pipelined``, jitted
as its engines run) round by round; each rank restarts every round from
the reference's state before it, so every round compares the two from
identical inputs.  Per case (both wires, delay 0 and 1, and the elastic
kill/revive schedule of tests/test_elastic.py) the rounds cover every
(shift, partition) pair.

Tolerances: ``sent`` (f32 rows, or the int8 payload) bitwise, its int8
scales within rtol 1e-6, ensembles within rtol 1e-5 and atol 1e-6 (the
blend's sums in another order), gates and liveness equal (the seeded
inputs keep every gate away from its threshold).
"""
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import gossip as jg
from repro.core.asgd import ASGDConfig
from repro.core.packing import (pack_group_mask, pack_spec_w, pack_w,
                                quantize_rows)
from repro.kernels.gossip_blend import (gossip_blend_w_resident,
                                        gossip_blend_worker_batched)

import _torch_mesh_ranks as R

LANE = 512
WORLD = 8
TIMEOUT_S = 240            # the whole launch; a hang fails, it never waits
RANKS = pathlib.Path(__file__).with_name("_torch_mesh_ranks.py")
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
WORKER_RANKS = [d * R.MESH[1] for d in range(R.MESH[0])]   # model 0
CASES = [R.case_id(*c) for c in R.cases()]


def tree(seed=0):
    """The params and gradients: half the workers step toward the worker
    mean, half away from it, so some gates open and some stay shut."""
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in R.tree_shapes().items()}
    side = rng.choice([-0.5, 0.5], R.W).astype(np.float32)

    def grad(x):
        toward = x - x.mean(axis=0, keepdims=True)
        return (side.reshape((R.W,) + (1,) * (x.ndim - 1)) * toward
                + 1e-3 * rng.standard_normal(x.shape)).astype(np.float32)
    return params, {k: grad(v) for k, v in params.items()}


def jax_draws(key, cfg):
    k_shift, k_blk = jax.random.split(key)
    return (int(jax.random.randint(k_shift, (), 0, len(cfg.shifts))),
            int(jax.random.randint(k_blk, (), 0, cfg.partial_blocks)))


@functools.lru_cache
def covering_keys(n_shifts, p):
    """Keys whose draws cover every (shift, partition) pair, one each."""
    cfg = jg.GossipConfig(shifts=tuple(range(1, n_shifts + 1)),
                          partial_blocks=p)
    keys, seen, k = [], set(), 0
    while len(seen) < n_shifts * p:
        pair = jax_draws(jax.random.key(k), cfg)
        if pair not in seen:
            seen.add(pair)
            keys.append(k)
        k += 1
    return tuple(keys)


def live_at(t):
    live = np.ones(R.W, np.float32)
    if R.T0 <= t < R.T0 + R.K:
        live[R.DEAD] = 0.0
    return live


def tail(x, stacked):
    if x is None:
        return None
    return np.asarray(x[-1] if stacked else x)


def run_reference(inputs, engine, wire, delay, elastic, packed, pdw, spec):
    """The reference engine's rounds of one case: writes each round's
    inputs into ``inputs`` and returns its outputs per round."""
    cid = R.case_id(engine, wire, delay, elastic)
    gkw, akw = R.config_kw(wire, delay, elastic)
    gcfg, acfg = jg.GossipConfig(**gkw), ASGDConfig(**akw)
    pipelined = engine == "pipelined"
    init = (jg.init_pipelined_gossip_state if pipelined
            else jg.init_packed_gossip_state)
    fn = (jg.asgd_gossip_apply_pipelined if pipelined
          else jg.asgd_gossip_apply_packed)
    st = init(packed, gcfg, block_rows=R.BLOCK_ROWS if wire else None,
              elastic=elastic)
    stacked = jg.fifo_depth(gcfg, pipelined=pipelined) >= 2
    step = jax.jit(lambda p, s, k, live: fn(p, pdw, s, k, gcfg, acfg, spec,
                                            live=live))
    if elastic:
        keys = list(range(R.ELASTIC_ROUNDS))
    else:   # a warm-up round per FIFO slot, then every pair
        keys = [1000 + i for i in range(jg.fifo_depth(
            gcfg, pipelined=pipelined))] + list(covering_keys(
                len(gcfg.shifts), gcfg.partial_blocks))
    out, p = [], packed
    for t, k in enumerate(keys):
        key = jax.random.key(k)
        ext, ext_s, ext_idx, ext_live = jg._fifo_head(st, stacked)
        si, bi = jax_draws(key, gcfg)
        rin = {"pk": p, "ext": ext, "ext_s": ext_s, "ext_idx": ext_idx,
               "step": st.step, "si": si, "bi": bi, "ext_live": ext_live,
               "live": live_at(t) if elastic else None}
        for n, v in rin.items():
            if v is not None:
                inputs[f"{cid}.{t}.{n}"] = np.asarray(v)
        p, st, m = step(p, st, key, None if rin["live"] is None
                        else jnp.asarray(rin["live"]))
        out.append({"pk": np.asarray(rin["pk"]), "new": np.asarray(p),
                    "gates": np.asarray(m["gate"]),
                    "sent": tail(st.buf, stacked),
                    "sent_s": tail(st.buf_scales, stacked),
                    "sent_live": tail(st.buf_live, stacked),
                    "si": si, "bi": bi})
    inputs[f"{cid}.rounds"] = np.int64(len(keys))
    return out


def blend_inputs(inputs, params, grads, packed, pdw, spec):
    """Inputs and reference results of shard_map_workers and the psum
    blends."""
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    plain = pack_spec_w(jp, block_rows=R.BLOCK_ROWS)
    # even workers' external lies ahead of their step (admitted), odd
    # workers' behind it (refused)
    c = np.where(np.arange(R.W) % 2 == 0, -0.5, 2.0).astype(np.float32)
    ext = {k: params[k] + c.reshape((R.W,) + (1,) * (params[k].ndim - 1))
           * grads[k] for k in params}
    w3, d3 = pack_w(jp, plain), pack_w({k: jnp.asarray(v)
                                        for k, v in grads.items()}, plain)
    e4 = pack_w({k: jnp.asarray(v) for k, v in ext.items()}, plain)[:, None]
    mask = pack_group_mask(jg.leaf_groups(jp, R.P), jnp.int32(0), plain)
    # B1's: each half of the rows alone would gate the other way than the
    # whole does, so a missing sum over the 'model' ranks shows in the gates
    pk, d = np.asarray(packed), np.asarray(pdw)
    half = spec.rows // 2
    c = c[:, None, None]
    res_ext = np.concatenate([pk[:, :half] + c * d[:, :half],
                              pk[:, half:] - c * d[:, half:]], axis=1)
    q, s = quantize_rows(jnp.asarray(res_ext), R.BLOCK_ROWS)
    inputs.update({"w3": w3, "d3": d3, "e4": e4, "mask": mask,
                   "psum.pk": packed, "psum.ext": res_ext, "psum.q": q,
                   "psum.s": s})
    b2 = jax.jit(lambda m: gossip_blend_worker_batched(
        w3, d3, e4, R.EPS, mask2d=m, block_rows=R.BLOCK_ROWS))
    rr = jnp.asarray([0, spec.rows], jnp.int32)
    b1 = jax.jit(lambda e, sc: gossip_blend_w_resident(
        packed, pdw, e[:, None], rr, R.EPS, block_rows=R.BLOCK_ROWS,
        ext_scales=None if sc is None else sc[:, None]))
    smw_mask = b2(mask)    # the psum case's reference too: one call
    return {"smw": b2(None), "smw_mask": smw_mask, "psum_b2": smw_mask,
            "psum_b1": b1(jnp.asarray(res_ext), None),
            "psum_b1_int8": b1(q, s)}


def launch_ranks(tmp, inputs):
    np.savez(tmp / "inputs.npz", **{k: np.asarray(v)
                                    for k, v in inputs.items()})
    # loopback only, one thread a rank (8 ranks share the host)
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1",
           "GLOO_SOCKET_IFNAME": "lo"}
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(WORLD)]
    try:
        procs = [subprocess.Popen(
            [sys.executable, str(RANKS), str(r), str(WORLD),
             str(tmp / "store"), str(tmp / "inputs.npz"), str(tmp)],
            env=env, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(WORLD)]
        try:
            for p in procs:
                p.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    finally:
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        # the rank that failed first, not one its crash took down
        logs = [(tmp / f"rank{r}.log").read_text() for r in bad]
        text = next((t for t in logs if "closed by peer" not in t),
                    logs[0])[-3000:]
        pytest.fail(f"ranks {bad} failed (codes "
                    f"{[procs[r].returncode for r in bad]}):\n{text}")
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """(reference rounds per case, blend references, the ranks' outputs)."""
    tmp = tmp_path_factory.mktemp("mesh")
    params, grads = tree()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    spec = pack_spec_w(jp, block_rows=R.BLOCK_ROWS,
                       groups=jg.leaf_groups(jp, R.P), n_groups=R.P)
    packed = pack_w(jp, spec)
    pdw = pack_w({k: jnp.asarray(v) for k, v in grads.items()}, spec)
    inputs = {"pdw": pdw}
    ref = {R.case_id(*c): run_reference(inputs, *c, packed, pdw, spec)
           for c in R.cases()}
    blends = blend_inputs(inputs, params, grads, packed, pdw, spec)
    ranks = launch_ranks(tmp, inputs)
    return ref, blends, ranks, spec


def gathered(ranks, key, which=WORKER_RANKS):
    return np.concatenate([ranks[r][key] for r in which])


def assert_round(got, want, name, *, new_key="new", gates_key="gates"):
    if new_key in got:
        np.testing.assert_allclose(got[new_key], want["new"], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    if gates_key in got:
        np.testing.assert_array_equal(got[gates_key], want["gates"],
                                      err_msg=name)
    if "sent" in got:
        np.testing.assert_array_equal(got["sent"], want["sent"],
                                      err_msg=name)
    if "sent_s" in got:
        np.testing.assert_allclose(got["sent_s"], want["sent_s"], rtol=1e-6,
                                   atol=0, err_msg=name)
    if "sent_live" in got:
        np.testing.assert_array_equal(got["sent_live"], want["sent_live"],
                                      err_msg=name)


def region_outputs(ranks, key, region, prefix=""):
    """{output name: the global array} of one region's round."""
    head = f"{prefix}{key}.{region}."
    names = {k[len(head):] for k in ranks[0] if k.startswith(head)}
    return {n: gathered(ranks, head + n) for n in names if n != "bytes"}


@pytest.mark.parametrize("cid", CASES)
def test_regions_match_reference_engine(launch, cid):
    """Every region of the case, every round, against the reference's
    engine; the pipelined engine's rounds hold the pipelined region and the
    initiate + consume pair both."""
    ref, _, ranks, _ = launch
    regions = ("round",) if cid.startswith("packed") else ("pipe", "init",
                                                           "cons")
    pairs, opened = set(), 0
    for t, want in enumerate(ref[cid]):
        for region in regions:
            got = region_outputs(ranks, f"{cid}.{t}", region)
            assert got, f"{cid} round {t}: no {region} outputs"
            assert_round(got, want, f"{cid} round {t} {region}")
        pairs.add((want["si"], want["bi"]))
        opened += int(want["gates"].sum())
    if "elastic" not in cid:
        assert len(pairs) == len(R.SHIFTS) * R.P
    assert 0 < opened < R.W * len(ref[cid])


def expected_bytes(shift, rows, int8, elastic):
    """The bytes a rank sends in one exchange: the rows of its W_local
    slice that go to another rank (a fetch from 0 shards back is local),
    each the partition's rows of f32, or of int8 plus one f32 scale per
    block_rows; the liveness vector travels the same shift."""
    n, wl = R.MESH[0], R.W // R.MESH[0]
    q, r = divmod(shift % R.W, wl)
    moved = ((wl - r) * (q % n != 0) + r * ((q + 1) % n != 0) if r
             else wl * (q % n != 0))
    per = (rows * LANE + rows // R.BLOCK_ROWS * 4 if int8
           else rows * LANE * 4)
    return moved * (per + (4 if elastic else 0))


@pytest.mark.parametrize("cid", CASES)
def test_only_the_partition_goes_on_the_wire(launch, cid):
    """Bytes each rank sends a round: the partition's rows of its slice —
    W_local·(r1 − r0)·LANE (+ scales) when both fetches cross ranks —
    never the full-size buffer."""
    ref, _, ranks, spec = launch
    ranges = jg.packed_row_ranges(spec, jg.GossipConfig(
        **R.config_kw(None, 1, False)[0]))
    shifts = R.ELASTIC_SHIFTS if "elastic" in cid else R.SHIFTS
    wl = R.W // R.MESH[0]
    full = 0
    for t, want in enumerate(ref[cid]):
        r0, r1 = ranges[want["bi"]]
        want_b = expected_bytes(shifts[want["si"]], r1 - r0, "int8" in cid,
                                "elastic" in cid)
        for region in ("round", "pipe", "init"):
            key = f"{cid}.{t}.{region}.bytes"
            if key in ranks[0]:
                assert {int(rk[key]) for rk in ranks} == {want_b}, key
        if shifts[want["si"]] != 1:     # both fetches cross ranks
            rows = r1 - r0
            per = (rows * LANE + rows // R.BLOCK_ROWS * 4 if "int8" in cid
                   else rows * LANE * 4)
            assert want_b == wl * per
            full += 1
    assert full or "elastic" in cid


@pytest.mark.parametrize("cid", CASES)
def test_planned_bytes_equal_the_tally(launch, cid):
    """launch/hlo_analysis.py ppermute_bytes — the send planned from the
    row plan, with no process group — equals the bytes each rank's
    regions tallied, every round and region (the pod mesh's too)."""
    _, _, ranks, _ = launch
    seen = 0
    for rk in ranks:
        for k in rk:
            if k.startswith((f"plan:{cid}.", f"plan:pod:{cid}.")):
                assert int(rk[k]) == int(rk[f"{k[len('plan:'):]}.bytes"]), k
                seen += int(rk[k]) > 0
    assert seen


@pytest.mark.parametrize("engine", ["packed", "pipelined"])
@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_elastic_region_kills_and_revives(launch, engine, wire):
    """The reference's mid-run kill (tests/test_elastic.py): worker 5 is
    down in rounds 2-3; its rows stay bitwise frozen, the payload it sends
    is dropped (its receiver's sent_live is 0), that receiver's gate is
    closed when the payload is blended (one round later, two pipelined),
    and after the revival the gate opens again."""
    ref, _, ranks, _ = launch
    cid = f"{engine}-{wire}-d1-elastic"
    region, lag = ("round", 1) if engine == "packed" else ("pipe", 2)
    nxt = (R.DEAD + 1) % R.W
    for t in range(R.ELASTIC_ROUNDS):
        got = region_outputs(ranks, f"{cid}.{t}", region)
        if R.T0 <= t < R.T0 + R.K:
            np.testing.assert_array_equal(got["new"][R.DEAD],
                                          ref[cid][t]["pk"][R.DEAD])
            assert got["sent_live"][nxt] == 0.0
        if t == R.T0 + lag:
            assert got["gates"][nxt] == 0.0
        if t >= R.T0 + R.K + lag:
            assert got["gates"][nxt] > 0.0


def test_model_ranks_hold_the_same_slices(launch):
    """Replicated over 'model': both ranks of a worker coordinate return
    bitwise the same region outputs."""
    _, _, ranks, _ = launch
    keys = [k for k in ranks[0] if "." in k and not k.startswith(
        ("psum", "check"))]
    assert keys
    for k in keys:
        for r in WORKER_RANKS:
            np.testing.assert_array_equal(ranks[r][k], ranks[r + 1][k],
                                          err_msg=k)


@pytest.mark.parametrize("name", ["smw", "smw_mask"])
def test_shard_map_workers(launch, name):
    """The worker-batched blend (B2r/B2a) under shard_map_workers — the
    'leaves' mask replicated — equals the reference's unsharded blend;
    every rank gets the gathered result."""
    _, blends, ranks, _ = launch
    out, gates = blends[name]
    for rk in ranks:
        np.testing.assert_allclose(rk[f"{name}.out"], np.asarray(out),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(rk[f"{name}.gates"],
                                      np.asarray(gates))


@pytest.mark.parametrize("name", ["psum_b2", "psum_b1", "psum_b1_int8"])
def test_psum_over_model_rows(launch, name):
    """Each worker's rows split across the two 'model' ranks, the gate
    accumulator summed over them (psum_axes=("model",)): the blend equals
    the reference's unsplit one."""
    _, blends, ranks, _ = launch
    out, gates = blends[name]
    got = np.concatenate([
        np.concatenate([ranks[r + m][f"{name}.out"] for m in (0, 1)],
                       axis=-2) for r in WORKER_RANKS])
    np.testing.assert_allclose(got, np.asarray(out), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(gathered(ranks, f"{name}.gates"),
                                  np.asarray(gates))
    assert 0 < np.asarray(gates).sum() < gates.size
    for r in WORKER_RANKS:
        np.testing.assert_array_equal(ranks[r][f"{name}.gates"],
                                      ranks[r + 1][f"{name}.gates"])


def test_pod_mesh_flattens_pod_major(launch):
    """On a (2, 2, 2) ("pod", "data", "model") mesh the worker axis is
    the flattened (pod, data) group, pod-major: the same slices, so the
    same outputs bitwise as the (4, 2) mesh's."""
    _, _, ranks, _ = launch
    assert {int(rk["pod.groups"]) for rk in ranks} == {4}
    cid = "packed-int8-d1"
    keys = [k for k in ranks[0] if k.startswith(f"pod:{cid}.")]
    assert keys
    for k in keys:      # rank r is worker coordinate r // 2 on both
        for rk in ranks:
            np.testing.assert_array_equal(rk[k], rk[k[len("pod:"):]],
                                          err_msg=k)


def test_mesh_construction_and_errors(launch):
    _, _, ranks, _ = launch
    for rk in ranks:
        assert tuple(rk["check.shape"]) == R.MESH
        assert int(rk["check.groups"]) == 4 and int(rk["check.w_local"]) == 2
        assert tuple(rk["check.host_clamped"]) == (4, 2)
        for k in ("prod_raises", "indivisible_raises", "meta_gathers",
                  "unknown_dim_raises", "no_data_axes_raises",
                  "wrong_slice_raises"):
            assert int(rk[f"check.{k}"]) == 1, k
