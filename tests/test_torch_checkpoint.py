"""The port's checkpoints (repro_torch.checkpoint) against the reference's
file format and its checkpoint module, and the trainer's --save,
--restore and --elastic.

  * codec: the port's msgpack subset writes exactly msgpack.packb's bytes
    (use_bin_type=True) for objects covering every encoding it writes,
    and decodes msgpack.packb's output;
  * cross-package files: for a pytree state with adam, a packed f32
    state, and a pipelined int8 state with a stacked FIFO and adam, the
    two packages write the same leaf list (dtype, shape and bytes, leaf
    for leaf: the port's canonical order is jax.tree.flatten's), and a
    file of either restores into the other bitwise — with one stated
    exception: the reference re-quantizes an int8 FIFO with an eager
    absmax / 127, which misses the saved scale by one ulp in some tiles,
    so its restored scales are held within 1 ulp; the port recovers the
    saved scales exactly, and both restore the int8 values bitwise;
  * round trips: mixed dtypes with bf16, shape and leaf-count mismatches
    raise, a packed file restores into the pytree structure, W migrates
    4 -> 2 and 4 -> 8 by cyclic tiling (resize_worker_axis as the
    reference's);
  * the trainer on the reduced smollm-135m: save then resume at step 6
    for 4 more steps; restore a file saved by the reference's trainer;
    restore with --elastic at a new W (the join window's gates closed).

Every test that needs the reference's checkpoint module or msgpack skips
when msgpack is missing (pytest.importorskip).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import asgd as jasgd
from repro.core import gossip as jg
from repro.core import packing as jpk
from repro_torch.checkpoint import (canonical_leaves, codec, load_checkpoint,
                                    load_checkpoint_packed, save_checkpoint,
                                    save_checkpoint_packed)
from repro_torch.core import gossip as tg
from repro_torch.core import packing as tpk
from repro_torch.core.tree import flatten_sorted, tree_map
from repro_torch.launch import train as ttrain

from _torch_threads import one_torch_thread  # noqa: F401

W = 4


@pytest.fixture
def msgpack():
    return pytest.importorskip("msgpack")


@pytest.fixture
def jck(msgpack):
    from repro.checkpoint import checkpoint
    return checkpoint


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

CODEC_CASES = {
    "nil-bool": [None, True, False],
    "fixint": [0, 1, 127, -1, -32],
    "uint": [128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1],
    "int": [-33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
    "str": ["", "a" * 31, "a" * 32, "é" * 200, "b" * 65535, "c" * 65536],
    "bin": [b"", b"x" * 255, b"x" * 256, b"y" * 65535, b"z" * 65536],
    "array": [[], list(range(15)), list(range(16)), list(range(65536))],
    "map": [{}, {str(i): i for i in range(15)},
            {str(i): [i] for i in range(16)},
            {str(i): None for i in range(65536)}],
    "payload": {"treedef": "PyTreeDef(*)", "leaves": [
        {"dtype": "<f4", "shape": [2, 3], "data": b"\x01" * 24},
        {"dtype": "|i1", "shape": [], "data": b"\x02"}]},
}


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_codec_bytes_equal_msgpack(msgpack, case):
    obj = CODEC_CASES[case]
    want = msgpack.packb(obj, use_bin_type=True)
    assert codec.packb(obj) == want
    assert codec.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_codec_streams_the_payload_and_rejects_other_types(msgpack,
                                                           tmp_path):
    leaves = [("<f4", [2, 3], np.arange(6, dtype=np.float32)),
              ("|i1", [], np.array([5], np.int8)),
              ("bfloat16", [70000], np.zeros(70000, np.uint16))]
    path = tmp_path / "p.bin"
    with open(path, "wb") as f:
        n = codec.write_payload(f, "tdef", len(leaves), iter(leaves))
    want = msgpack.packb({"treedef": "tdef", "leaves": [
        {"dtype": d, "shape": s, "data": a.tobytes()}
        for d, s, a in leaves]}, use_bin_type=True)
    assert path.read_bytes() == want and n == len(want)
    with pytest.raises(TypeError):
        codec.packb(1.5)
    with pytest.raises(ValueError):
        codec.unpackb(msgpack.packb(1.5))


# ---------------------------------------------------------------------------
# round trips in the port
# ---------------------------------------------------------------------------

def test_roundtrip_mixed_dtypes(tmp_path):
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": torch.ones(5, dtype=torch.bfloat16) * 1.5,
            "step": 7, "half": torch.full((2,), 0.1, dtype=torch.float16),
            "nested": {"k": torch.arange(-4, 4, dtype=torch.int8)
                       .reshape(2, 2, 2),
                       "i": torch.arange(3, dtype=torch.int32)},
            "lst": [torch.ones(2), 3]}
    p = tmp_path / "ckpt.msgpack"
    save_checkpoint(p, tree)
    assert not (tmp_path / "ckpt.tmp").exists()
    like = {"w": torch.zeros(3, 4), "b": torch.zeros(5, dtype=torch.bfloat16),
            "step": 0, "half": torch.zeros(2, dtype=torch.float16),
            "nested": {"k": torch.zeros((2, 2, 2), dtype=torch.int8),
                       "i": torch.zeros(3, dtype=torch.int32)},
            "lst": [torch.zeros(2), 0]}
    out = load_checkpoint(p, like)
    assert out["step"] == 7 and out["lst"][1] == 3
    for a, b in zip(canonical_leaves(out)[0], canonical_leaves(tree)[0]):
        assert (a == b) if isinstance(a, int) else (
            a.dtype == b.dtype and torch.equal(a, b))


def test_mismatches_raise(tmp_path):
    p = tmp_path / "c.msgpack"
    save_checkpoint(p, {"w": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(p, {"w": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(p, {"w": torch.zeros(2, 2), "v": torch.zeros(1)})
    # a worker axis re-seats only on the elastic path, and nothing else does
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(p, {"w": torch.zeros(4, 2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(p, {"w": torch.zeros(2, 3)}, resize_workers=True)


@pytest.mark.parametrize("w_old,w_new", [(4, 2), (4, 8), (3, 7), (4, 4),
                                         (2, 1)])
def test_resize_worker_axis_matches_reference(w_old, w_new):
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((w_old, 3, 5)).astype(np.float32),
            "b": rng.integers(-127, 127, (w_old, 7)).astype(np.int8)}
    want = jpk.resize_worker_axis(jax.tree.map(jnp.asarray, tree), w_new)
    got = tpk.resize_worker_axis(
        {k: torch.from_numpy(v) for k, v in tree.items()}, w_new)
    for k in tree:
        assert got[k].dtype == torch.from_numpy(tree[k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError):
        tpk.resize_worker_axis(torch.zeros(2), 0)


# ---------------------------------------------------------------------------
# cross-package files
# ---------------------------------------------------------------------------

def np_tree(seed, w=W):
    rng = np.random.default_rng(seed)
    return {"wq": rng.standard_normal((w, 16, 8)).astype(np.float32),
            "bias": rng.standard_normal((w, 6)).astype(np.float32),
            "wo": {"k": rng.standard_normal((w, 8, 4)).astype(np.float32)}}


def t_of(x):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), x)


def adam_of(tree_np, seed):
    rng = np.random.default_rng(seed)
    m = jax.tree.map(lambda x: rng.standard_normal(x.shape)
                     .astype(np.float32), tree_np)
    v = jax.tree.map(lambda x: np.abs(rng.standard_normal(x.shape))
                     .astype(np.float32), tree_np)
    return ({"m": jax.tree.map(jnp.asarray, m), "t": jnp.int32(3),
             "v": jax.tree.map(jnp.asarray, v)},
            {"m": t_of(m), "t": 3, "v": t_of(v)})


def gossip_cfgs(kind):
    wire = "int8" if kind == "pipelined-int8" else None
    kw = dict(shifts=(1, 2), partial_blocks=2, delay=1, wire_format=wire)
    return jg.GossipConfig(**kw), tg.GossipConfig(**kw)


def states(kind, w=W):
    """(reference state, port state, reference spec, port spec) of one kind
    after 3 reference rounds (so the buffers hold real payloads), the port
    state holding the same numbers in the port's layout."""
    jcfg, tcfg = gossip_cfgs(kind)
    acfg = jasgd.ASGDConfig(eps=0.05)
    params = np_tree(0, w)
    grads = jax.tree.map(lambda x: 0.1 * np.sign(x), np_tree(1, w))
    jp = jax.tree.map(jnp.asarray, params)
    if kind == "pytree":
        g = jg.init_gossip_state(jp, jcfg)
        for t in range(3):
            jp, g, _ = jg.asgd_gossip_apply(
                jp, jax.tree.map(jnp.asarray, grads), g, jax.random.key(t),
                jcfg, acfg)
        jopt, topt = adam_of(params, 2)
        jstate = {"params": jp, "gossip": g, "opt": jopt,
                  "step": jnp.int32(3)}
        tstate = {"params": t_of(jp),
                  "gossip": tg.GossipState(buf=t_of(g.buf),
                                           buf_idx=int(g.buf_idx),
                                           step=int(g.step)),
                  "opt": topt, "step": 3}
        return jstate, tstate, None, None
    jspec = jpk.pack_spec_w(jp, block_rows=2, groups=jg.leaf_groups(jp, 2),
                            n_groups=2)
    tspec = tpk.pack_spec_w(t_of(params), block_rows=2,
                            groups=tg.leaf_groups(t_of(params), 2),
                            n_groups=2)
    packed = jpk.pack_w(jp, jspec)
    pdw = jpk.pack_w(jax.tree.map(jnp.asarray, grads), jspec)
    if kind == "packed-f32":
        g = jg.init_packed_gossip_state(packed, jcfg)
        fn = jg.asgd_gossip_apply_packed
        jopt, topt = jnp.int32(0), 0
    else:
        g = jg.init_pipelined_gossip_state(packed, jcfg, block_rows=2)
        fn = jg.asgd_gossip_apply_pipelined
        jopt, topt = adam_of(np.asarray(packed), 3)
    step = jax.jit(functools.partial(fn, cfg=jcfg, acfg=acfg, spec=jspec))
    for t in range(3):
        packed, g, _ = step(packed, pdw, g, jax.random.key(t))
    stacked = np.asarray(g.buf).ndim == 4

    def slots(x):
        x = np.asarray(x)
        return tuple(torch.from_numpy(s.copy()) for s in
                     (x if stacked else x[None]))
    tg_state = tg.PackedGossipState(
        buf=slots(g.buf),
        buf_idx=tuple(int(i) for i in np.atleast_1d(np.asarray(g.buf_idx))),
        step=int(g.step),
        buf_scales=None if g.buf_scales is None else slots(g.buf_scales))
    jstate = {"params": packed, "gossip": g, "opt": jopt,
              "step": jnp.int32(3)}
    tstate = {"params": torch.from_numpy(np.array(packed)),
              "gossip": tg_state, "opt": topt, "step": 3}
    return jstate, tstate, jspec, tspec


def fresh_like(kind, tstate, tspec, w=W, elastic=False):
    """A zero port state of ``kind`` at ``w`` workers (the restore's
    ``like``)."""
    _, tcfg = gossip_cfgs(kind)
    zeros = functools.partial(tpk.resize_worker_axis, w_new=w)
    opt = tstate["opt"]
    if isinstance(opt, dict):
        opt = {"m": tree_map(torch.zeros_like, zeros(opt["m"])), "t": 0,
               "v": tree_map(torch.zeros_like, zeros(opt["v"]))}
    if kind == "pytree":
        params = tree_map(torch.zeros_like, zeros(tstate["params"]))
        return {"params": params,
                "gossip": tg.init_gossip_state(params, tcfg,
                                               elastic=elastic),
                "opt": opt, "step": 0}
    packed = torch.zeros((w,) + tuple(tstate["params"].shape[1:]))
    init = (tg.init_pipelined_gossip_state if kind == "pipelined-int8"
            else tg.init_packed_gossip_state)
    return {"params": packed,
            "gossip": init(packed, tcfg, block_rows=2, elastic=elastic),
            "opt": opt, "step": 0}


def file_leaves(msgpack, path):
    return msgpack.unpackb(path.read_bytes(), raw=False)["leaves"]


def port_save(kind, tstate, tspec, path):
    if kind == "pytree":
        save_checkpoint(path, tstate)
    else:
        save_checkpoint_packed(path, tstate, tspec)


def port_load(kind, path, like, tspec, elastic=False):
    if kind == "pytree":
        return load_checkpoint(path, like, resize_workers=elastic)
    return load_checkpoint_packed(path, like, tspec, elastic=elastic)


def assert_port_state_equal(got, want):
    gl, wl = canonical_leaves(ttrain_flat(got))[0], \
        canonical_leaves(ttrain_flat(want))[0]
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        if isinstance(b, int):
            assert a == b
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)


def ttrain_flat(state):
    """A port train state with its packed gossip state spelled out as a
    dict of its carried fields (buf_live aside), for leaf comparisons."""
    g = state["gossip"]
    if isinstance(g, tg.PackedGossipState):
        g = {"buf": list(g.buf), "idx": list(g.buf_idx), "step": g.step,
             "scales": None if g.buf_scales is None else list(g.buf_scales)}
    return {**state, "gossip": g}


KINDS = ["pytree", "packed-f32", "pipelined-int8"]


@pytest.mark.parametrize("kind", KINDS)
def test_both_packages_write_the_same_leaves(msgpack, jck, kind, tmp_path):
    jstate, tstate, jspec, tspec = states(kind)
    jpath, tpath = tmp_path / "ref.msgpack", tmp_path / "port.msgpack"
    if kind == "pytree":
        jck.save_checkpoint(jpath, jstate)
        canon = jck._strip_live(jstate)
    else:
        jck.save_checkpoint_packed(jpath, jstate, jspec)
        canon = jck._packed_state_to_tree(jstate, jspec)
    port_save(kind, tstate, tspec, tpath)
    jl, tl = file_leaves(msgpack, jpath), file_leaves(msgpack, tpath)
    assert len(tl) == len(jl) == len(jax.tree.leaves(canon))
    for a, b, ref in zip(tl, jl, jax.tree.leaves(canon)):
        assert (a["dtype"], a["shape"]) == (b["dtype"], b["shape"])
        assert a["shape"] == list(np.shape(ref))
        assert a["data"] == b["data"]
    # the port's bytes are msgpack's for its own payload
    payload = msgpack.unpackb(tpath.read_bytes(), raw=False)
    assert msgpack.packb(payload, use_bin_type=True) == tpath.read_bytes()


@pytest.mark.parametrize("kind", KINDS)
def test_reference_files_restore_into_the_port(jck, kind, tmp_path):
    jstate, tstate, jspec, tspec = states(kind)
    path = tmp_path / "ref.msgpack"
    if kind == "pytree":
        jck.save_checkpoint(path, jstate)
    else:
        jck.save_checkpoint_packed(path, jstate, jspec)
    back = port_load(kind, path, fresh_like(kind, tstate, tspec), tspec)
    # int8 FIFO: values and the saved scales come back bitwise
    assert_port_state_equal(back, tstate)


@pytest.mark.parametrize("kind", KINDS)
def test_port_files_restore_into_the_reference(jck, kind, tmp_path):
    jstate, tstate, jspec, tspec = states(kind)
    path = tmp_path / "port.msgpack"
    port_save(kind, tstate, tspec, path)
    like = jax.tree.map(jnp.zeros_like, jstate)
    if kind == "pytree":
        back = jck.load_checkpoint(path, like)
    else:
        back = jck.load_checkpoint_packed(path, like, jspec)
    want_g, got_g = jstate["gossip"], back["gossip"]
    for key in ("params", "opt", "step"):
        for a, b in zip(jax.tree.leaves(back[key]),
                        jax.tree.leaves(jstate[key])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves((got_g.buf, got_g.buf_idx, got_g.step)),
                    jax.tree.leaves((want_g.buf, want_g.buf_idx,
                                     want_g.step))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if kind == "pipelined-int8":
        # the reference's eager absmax / 127: within one ulp of the saved
        # scales (see the module docstring)
        np.testing.assert_array_max_ulp(np.asarray(got_g.buf_scales),
                                        np.asarray(want_g.buf_scales),
                                        maxulp=1)


def test_canonical_leaves_follow_jax_flatten(jck):
    """The port's canonical leaf list of a pipelined int8 state: one
    entry per leaf of the reference's canonical tree, in its order, with
    its shape (host ints as 0-d)."""
    jstate, tstate, jspec, tspec = states("pipelined-int8")
    from repro_torch.checkpoint.checkpoint import _packed_state_to_tree
    tl = canonical_leaves(_packed_state_to_tree(tstate, tspec))[0]
    jl = jax.tree.leaves(jck._packed_state_to_tree(jstate, jspec))
    assert [() if isinstance(a, int) else tuple(a.shape) for a in tl] == \
        [tuple(np.shape(b)) for b in jl]
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(
            np.asarray(a) if isinstance(a, int) else a.numpy(),
            np.asarray(b))


def test_packed_file_loads_into_the_pytree_structure(tmp_path):
    _, tstate, _, tspec = states("packed-f32")
    path = tmp_path / "ck.msgpack"
    save_checkpoint_packed(path, tstate, tspec)
    back = load_checkpoint_packed(path, fresh_like("packed-f32", tstate,
                                                   tspec), tspec)
    assert_port_state_equal(back, tstate)
    _, tcfg = gossip_cfgs("packed-f32")
    params = tpk.unpack_w(tstate["params"], tspec)
    like = {"params": tree_map(torch.zeros_like, params),
            "gossip": tg.init_gossip_state(params, tcfg), "opt": 0,
            "step": 0}
    plain = load_checkpoint(path, like)
    assert plain["step"] == 3 and plain["gossip"].buf_idx == \
        tstate["gossip"].buf_idx[0]
    for a, b in zip(flatten_sorted(plain["params"])[0],
                    flatten_sorted(params)[0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("w_new", [2, 8])
def test_elastic_worker_count_migration(jck, w_new, tmp_path):
    """A pipelined int8 file saved at W=4 restores at W=2 / W=8 through
    load_checkpoint_packed(elastic=True): params and FIFO are the
    reference's resize_worker_axis of the saved canonical trees (and the
    reference's own restore), the step survives, buf_live is the like's
    zeros."""
    jstate, tstate, jspec, tspec = states("pipelined-int8")
    path = tmp_path / "w4.msgpack"
    save_checkpoint_packed(path, tstate, tspec)
    jnew, _, jspec_new, spec_new = states("pipelined-int8", w=w_new)
    like = fresh_like("pipelined-int8", tstate, tspec, w=w_new, elastic=True)
    back = load_checkpoint_packed(path, like, spec_new, elastic=True)
    got = tpk.unpack_w(back["params"], spec_new)
    want = jpk.resize_worker_axis(jpk.unpack_w(jstate["params"], jspec),
                                  w_new)
    for a, b in zip(flatten_sorted(got)[0], jax.tree.leaves(want)):
        assert a.shape[0] == w_new
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    g = back["gossip"]
    assert back["step"] == 3 and g.buf_idx == tstate["gossip"].buf_idx
    assert all(torch.equal(x, torch.zeros(w_new)) for x in g.buf_live)
    for q, s in zip(g.buf, g.buf_scales):
        assert q.shape[0] == w_new and s.shape[0] == w_new
    for q, q0, s, s0 in zip(g.buf, tstate["gossip"].buf, g.buf_scales,
                            tstate["gossip"].buf_scales):
        assert torch.equal(q, tpk.resize_worker_axis(q0, w_new))
        assert torch.equal(s, tpk.resize_worker_axis(s0, w_new))
    # the reference restores the same file onto the same layout
    jlike = jax.tree.map(jnp.zeros_like, jnew)
    jlike["gossip"] = jg.init_pipelined_gossip_state(
        jlike["params"], gossip_cfgs("pipelined-int8")[0], block_rows=2,
        elastic=True)
    jback = jck.load_checkpoint_packed(path, jlike, jspec_new, elastic=True)
    np.testing.assert_array_equal(back["params"].numpy(),
                                  np.asarray(jback["params"]))
    np.testing.assert_array_equal(torch.stack(g.buf).numpy(),
                                  np.asarray(jback["gossip"].buf))


def test_non_elastic_restore_rejects_other_worker_count(tmp_path):
    _, tstate, _, tspec = states("packed-f32")
    path = tmp_path / "w4.msgpack"
    save_checkpoint_packed(path, tstate, tspec)
    _, _, _, spec2 = states("packed-f32", w=2)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint_packed(path, fresh_like("packed-f32", tstate, tspec,
                                                w=2), spec2)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

TRAIN = ["--arch", "smollm-135m", "--reduced", "--device", "cpu", "--batch",
         "1", "--seq", "32", "--log-every", "100"]


def test_trainer_save_then_resume(tmp_path, capsys):
    ck = str(tmp_path / "t.msgpack")
    first = ttrain.main(TRAIN + ["--workers", "2", "--steps", "6", "--save",
                                 ck])
    out = ttrain.main(TRAIN + ["--workers", "2", "--steps", "10",
                               "--restore", ck])
    assert len(out["losses"]) == 4 and out["state"]["step"] == 10
    log = capsys.readouterr().out
    assert f"saved -> {ck}" in log and f"restored step=6 from {ck}" in log
    # a restore past --steps runs nothing and still saves
    ck2 = str(tmp_path / "t2.msgpack")
    none = ttrain.main(TRAIN + ["--workers", "2", "--steps", "4",
                                "--restore", ck, "--save", ck2])
    assert none["losses"] == [] and none["state"]["step"] == 6
    assert "no steps run" in capsys.readouterr().out
    back = load_checkpoint(ck2, none["state"])
    assert_port_state_equal(back, first["state"])


def test_trainer_resume_draws_as_an_uninterrupted_run(tmp_path):
    """Round t takes the same gossip draws whether the run was restarted
    or not: a pipelined run of 4 steps, and 2 + 2 through a file (the
    batch streams restart on a resume, as the reference's do, so the
    comparison feeds the second half its batches from the start too)."""
    flags = TRAIN + ["--workers", "4", "--pipelined", "--wire-format",
                     "int8"]
    ck = str(tmp_path / "p.msgpack")
    ttrain.main(flags + ["--steps", "2", "--save", ck])
    seen = []
    real = ttrain.draw_gossip_indices

    def spy(gen, cfg):
        seen.append(real(gen, cfg))
        return seen[-1]
    ttrain.draw_gossip_indices = spy
    try:
        ttrain.main(flags + ["--steps", "4", "--restore", ck])
        resumed = seen[:]
        seen.clear()
        ttrain.main(flags + ["--steps", "4"])
    finally:
        ttrain.draw_gossip_indices = real
    assert resumed == seen


def test_trainer_restores_a_reference_trainer_file(msgpack, tmp_path):
    from repro.launch.train import main as jtrain_main
    flags = ["--arch", "smollm-135m", "--reduced", "--batch", "1", "--seq",
             "32", "--workers", "2", "--pipelined", "--wire-format", "int8",
             "--log-every", "100"]
    ck = tmp_path / "ref.msgpack"
    jtrain_main(flags + ["--steps", "2", "--save", str(ck)])
    out = ttrain.main(flags + ["--device", "cpu", "--steps", "2",
                               "--restore", str(ck)])
    assert out["losses"] == [] and out["state"]["step"] == 2
    from repro_torch.checkpoint.checkpoint import (_encode_leaf,
                                                   _packed_state_to_tree)
    mine = canonical_leaves(_packed_state_to_tree(out["state"],
                                                  out["spec"]))[0]
    theirs = file_leaves(msgpack, ck)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        dtype, shape, data = _encode_leaf(a)
        assert (dtype, shape) == (b["dtype"], b["shape"])
        assert data.tobytes() == b["data"]
    more = ttrain.main(flags + ["--device", "cpu", "--steps", "4",
                                "--restore", str(ck)])
    assert len(more["losses"]) == 2 and all(map(np.isfinite,
                                                more["losses"]))


def test_trainer_elastic_restore_at_a_new_worker_count(tmp_path, capsys):
    flags = TRAIN + ["--pipelined", "--wire-format", "int8", "--log-every",
                     "1"]
    ck = str(tmp_path / "w4.msgpack")
    ttrain.main(flags + ["--workers", "4", "--steps", "3", "--save", ck])
    out = ttrain.main(flags + ["--workers", "2", "--steps", "7",
                               "--restore", ck, "--elastic"])
    assert f"restored step=3 from {ck} (re-packed, elastic)" in \
        capsys.readouterr().out
    assert len(out["losses"]) == 4 and all(map(np.isfinite, out["losses"]))
    # delay + 1 = 2 join rounds: the restored FIFO is gated out
    assert out["n_good"][:2] == [0.0, 0.0]
    assert out["state"]["params"].shape[0] == 2
    wq = out["params"]["scan"]["pos0"]["attn"]["wq"]
    assert wq.shape[0] == 2 and bool(torch.isfinite(wq).all())
    # the pytree engine restores at a new W too
    ck2 = str(tmp_path / "tree.msgpack")
    ttrain.main(TRAIN + ["--workers", "2", "--steps", "1", "--save", ck2])
    res = ttrain.main(TRAIN + ["--workers", "3", "--steps", "2", "--restore",
                               ck2, "--elastic"])
    assert res["state"]["gossip"].buf_live.shape == (3,)
    with pytest.raises(SystemExit):
        ttrain.main(TRAIN + ["--elastic", "--algo", "sync", "--steps", "1"])
