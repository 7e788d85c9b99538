"""Checkpoints of the train state in the reference's msgpack file format
(files of either package restore into the other)."""
from .checkpoint import (canonical_leaves, load_checkpoint,
                         load_checkpoint_packed, save_checkpoint,
                         save_checkpoint_packed)
