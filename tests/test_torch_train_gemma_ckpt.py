"""Checkpoints of the trainer on reduced recurrentgemma-9b (see
test_torch_train_gemma.py; its 'R' leaves, ``Lambda`` first in sorted
order, are the layout this arch adds to the checkpoint's leaf list), both
ways: a reference trainer's --save file restored by the port (leaf for
leaf the file's bytes) and a port trainer's file restored by the
reference trainer, each resumed for 1 step by both, the losses within
rel 1e-4.  gemma3-1b is not a case here: its leaves are kinds the
checkpoint tests of the earlier archs carry (attention with q/k norms, the
GLU MLP, norms), and its reference trainer's runs would double this
file's time."""
import numpy as np
import pytest

from repro_torch.checkpoint import canonical_leaves
from repro_torch.launch import train as ttrain
from _torch_threads import one_torch_thread  # noqa: F401

TRAIN = ["--arch", "recurrentgemma-9b", "--reduced", "--batch", "1",
         "--seq", "32", "--workers", "2", "--pipelined", "--wire-format",
         "int8", "--log-every", "100"]


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A reference trainer's file: the port restores it leaf for leaf
    (the file's bytes), and 1 resumed step of each trainer from it gives
    the same loss."""
    msgpack = pytest.importorskip("msgpack")
    from repro.launch.train import main as jtrain_main
    from repro_torch.checkpoint.checkpoint import (_encode_leaf,
                                                   _packed_state_to_tree)
    ck = tmp_path / "ref.msgpack"
    jtrain_main(TRAIN + ["--steps", "2", "--save", str(ck)])
    out = ttrain.main(TRAIN + ["--device", "cpu", "--steps", "2",
                               "--restore", str(ck)])
    assert out["losses"] == [] and out["state"]["step"] == 2
    mine = canonical_leaves(_packed_state_to_tree(out["state"],
                                                  out["spec"]))[0]
    theirs = msgpack.unpackb(ck.read_bytes(), raw=False)["leaves"]
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        dtype, shape, data = _encode_leaf(a)
        assert (dtype, shape) == (b["dtype"], b["shape"])
        assert data.tobytes() == b["data"]
    more = ttrain.main(TRAIN + ["--device", "cpu", "--steps", "3",
                                "--restore", str(ck)])
    ref = jtrain_main(TRAIN + ["--steps", "3", "--restore", str(ck)])
    assert len(more["losses"]) == 1 and len(ref) == 1
    np.testing.assert_allclose(more["losses"], [float(x) for x in ref],
                               rtol=1e-4)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    """A port trainer's --save file: the reference trainer restores it
    and its 1 resumed step gives the port's resumed loss."""
    pytest.importorskip("msgpack")
    from repro.launch.train import main as jtrain_main
    ck = str(tmp_path / "port.msgpack")
    ttrain.main(TRAIN + ["--device", "cpu", "--steps", "2", "--save", ck])
    ours = ttrain.main(TRAIN + ["--device", "cpu", "--steps", "3",
                                "--restore", ck])
    ref = jtrain_main(TRAIN + ["--steps", "3", "--restore", ck])
    assert len(ours["losses"]) == 1 and len(ref) == 1
    np.testing.assert_allclose(ours["losses"], [float(x) for x in ref],
                               rtol=1e-4)
    assert ours["params"]["scan"]["pos0"]["rglru"]["Lambda"].shape == \
        (2, 1, 256)
