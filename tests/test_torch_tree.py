"""Device memory the port frees on time.  The tree helpers
(repro_torch.core.tree, and the checkpoint's canonical leaf list) free
what they were given as soon as the caller drops it: no reference cycle
holds a leaf until the cyclic garbage collector runs.  A nested function
that calls itself is such a cycle; it kept leaves of the trainer's trees
alive (54 MB of tensors in 3 steps of reduced smollm-135m at W = 2, device
memory at full size).  And the packed trainer drops each ensemble a step
replaces."""
import gc
import weakref

import pytest
import torch

from repro_torch.checkpoint.checkpoint import _unflatten, canonical_leaves
from repro_torch.core.gossip import GossipState
from repro_torch.core.tree import flatten_sorted, tree_map, unflatten
from repro_torch.launch import train as ttrain


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
