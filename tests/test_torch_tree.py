"""Device memory the port frees on time.  The tree helpers
(repro_torch.core.tree, and the checkpoint's canonical leaf list) free
what they were given as soon as the caller drops it: no reference cycle
holds a leaf until the cyclic garbage collector runs.  A nested function
that calls itself is such a cycle; it kept leaves of the trainer's trees
alive (54 MB of tensors in 3 steps of reduced smollm-135m at W = 2, device
memory at full size).  And the packed trainer drops each ensemble a step
replaces.  The tree arithmetic (tree_add, tree_where, tree_cast) equals
the reference's on the same numpy leaves, exactly (one elementwise op)."""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tree as jtree
from repro_torch.checkpoint.checkpoint import _unflatten, canonical_leaves
from repro_torch.core import tree as ttree
from repro_torch.core.gossip import GossipState
from repro_torch.core.tree import flatten_sorted, tree_map, unflatten
from repro_torch.launch import train as ttrain

from _torch_threads import one_torch_thread  # noqa: F401


def np_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "b": {"x": rng.standard_normal((7,)).astype(np.float32),
                  "y": rng.standard_normal((2, 2, 2)).astype(np.float32)}}


def assert_trees_equal(ours, ref):
    leaves, jleaves = flatten_sorted(ours)[0], jax.tree.leaves(ref)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


def test_tree_add_matches_reference():
    a, b = np_tree(0), np_tree(1)
    assert_trees_equal(
        ttree.tree_add(tree_map(torch.from_numpy, a),
                       tree_map(torch.from_numpy, b)),
        jtree.tree_add(jax.tree.map(jnp.asarray, a),
                       jax.tree.map(jnp.asarray, b)))


@pytest.mark.parametrize("pred", [True, False, 0.0, 1.0])
def test_tree_where_matches_reference(pred):
    a, b = np_tree(2), np_tree(3)
    jpred = jnp.asarray(pred)
    assert_trees_equal(
        ttree.tree_where(torch.tensor(pred), tree_map(torch.from_numpy, a),
                         tree_map(torch.from_numpy, b)),
        jtree.tree_where(jpred, jax.tree.map(jnp.asarray, a),
                         jax.tree.map(jnp.asarray, b)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "int32"])
def test_tree_cast_matches_reference(dtype):
    a = jax.tree.map(lambda x: 3.0 * x, np_tree(4))
    assert_trees_equal(
        ttree.tree_cast(tree_map(torch.from_numpy, a),
                        getattr(torch, dtype)),
        jtree.tree_cast(jax.tree.map(jnp.asarray, a), getattr(jnp, dtype)))


@pytest.fixture
def no_cyclic_gc():
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def test_tree_helpers_hold_no_reference_cycles(no_cyclic_gc):
    t = torch.zeros(3)
    ref = weakref.ref(t)
    leaves, treedef = flatten_sorted({"a": {"b": t}, "c": {}})
    out = tree_map(torch.neg, unflatten(treedef, leaves))
    state = {"params": out, "gossip": GossipState(buf=[t], buf_idx=[0],
                                                  step=1), "step": 2}
    cl, cd = canonical_leaves(state)
    back = _unflatten(cd, cl)
    assert torch.equal(back["gossip"].buf[0], t) and back["step"] == 2
    del t, leaves, out, state, cl, back
    assert ref() is None


def test_training_leaves_no_cyclic_garbage(no_cyclic_gc):
    """3 pipelined int8 steps of reduced granite-moe with the cyclic
    collector off: afterwards no tensor is garbage that only it frees."""
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        out = ttrain.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                           "--device", "cpu", "--workers", "2", "--steps",
                           "3", "--pipelined", "--wire-format", "int8",
                           "--log-every", "100"])
        del out
        gc.collect()
        tensors = [o for o in gc.garbage if torch.is_tensor(o)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    assert tensors == []


def test_trainer_drops_each_replaced_ensemble(monkeypatch):
    """The packed trainer keeps no name on an ensemble a step replaced:
    when the second and third steps start, the first ensemble (pack_w's)
    is gone, cyclic garbage collected first so that only live references
    count.  A local name on it kept one ensemble more on the card all run
    long (9.95 GiB at granite-moe's W = 2)."""
    first, seen = [], []
    real_pack, real_make = ttrain.pack_w, ttrain.make_train_step

    def pack(*a, **k):
        out = real_pack(*a, **k)
        first.append(weakref.ref(out))
        return out

    def make(*a, **k):
        step = real_make(*a, **k)

        def counted(params, *args, **kw):
            if params is not first[0]():
                gc.collect()
                seen.append(first[0]() is None)
            return step(params, *args, **kw)
        return counted

    monkeypatch.setattr(ttrain, "pack_w", pack)
    monkeypatch.setattr(ttrain, "make_train_step", make)
    ttrain.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                 "--workers", "2", "--steps", "3", "--pipelined",
                 "--wire-format", "int8", "--log-every", "100"])
    assert seen == [True, True]
