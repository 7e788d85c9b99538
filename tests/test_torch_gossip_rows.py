"""The port's pytree gossip engine in 'rows' mode (a 1/p slice of every
leaf along dim 1, the last block clamped) against
``repro.core.gossip.asgd_gossip_apply``; the blend in plain torch and
through the worker-batched kernels (B2, their plain versions on the CPU).
The driver and its tolerances: _torch_gossip_cases.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_gossip_cases import W, run_parity, to_t, tree
from repro.core import gossip as jg
from repro_torch.core import gossip as tg


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("wire,delay", [("none", 0), ("none", 1),
                                        ("bf16", 1), ("int8", 1)])
def test_rows_round_matches_reference(wire, delay, fused):
    gates = run_parity("rows", wire, delay, fused)
    assert 0 < float(sum(g.sum() for g in gates)) < 3 * W
    if delay:
        assert not gates[0].any()


@pytest.mark.parametrize("fused", [False, True])
def test_rows_interval_and_elastic_match_reference(fused):
    gates = run_parity("rows", "none", 1, fused, rounds=4, gossip_every=2)
    assert not gates[1].any() and not gates[3].any()
    run_parity("rows", "none", 0, fused, rounds=2, elastic=True,
               elastic_alpha=0.3)


@pytest.mark.parametrize("block_idx", [0, 1, 2, 3])
def test_slice_and_update_rows_match_reference(block_idx):
    """Blocks of ceil(dim1 / p) rows; the last is clamped inside the leaf
    (so blocks overlap); leaves with fewer than 2 dims pass whole."""
    params, blocks = tree(1), tree(2)
    jp = jax.tree.map(jnp.asarray, params)
    sl_j = jg.slice_rows(jp, jnp.int32(block_idx), 4)
    sl_t = tg.slice_rows(to_t(params), block_idx, 4)
    for a, b in zip(jax.tree.leaves(sl_t), jax.tree.leaves(sl_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    blk = jax.tree.map(lambda x, s: x[tuple(slice(0, n) for n in s.shape)],
                       blocks, jax.tree.map(np.asarray, sl_j))
    up_j = jg.update_rows(jp, jax.tree.map(jnp.asarray, blk),
                          jnp.int32(block_idx), 4)
    up_t = tg.update_rows(to_t(params), to_t(blk), block_idx, 4)
    for a, b in zip(jax.tree.leaves(up_t), jax.tree.leaves(up_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
