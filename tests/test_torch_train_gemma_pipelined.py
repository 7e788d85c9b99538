"""3 pipelined int8 steps of reduced gemma3-1b and reduced
recurrentgemma-9b (see test_torch_train_gemma.py) through the port
against the reference's jitted pipelined train step, from distinct worker
starts, on the same batches and gossip draws: the losses within rel 1e-4,
n_good exactly and the packed state within atol 1e-4 each step, and the
packed ensemble bitwise the reference's at the start.  The packed layout
takes row blocks of BLOCK_ROWS = 256: the reference's Pallas kernels run
in interpret mode here, one grid step a block, and at 64 rows a block its
3 steps took three times as long."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import get_arch as jget_arch
from repro.core import asgd as jasgd
from repro.core import gossip as jg
from repro.core.packing import pack_spec_w as jpack_spec_w
from repro.core.packing import pack_w as jpack_w
from repro.launch.steps import init_inner_state as jinit_inner
from repro.launch.steps import make_train_step as jmake_train_step
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import asgd as tasgd
from repro_torch.core import gossip as tg
from repro_torch.core.packing import pack_spec_w, pack_w
from repro_torch.launch.steps import init_inner_state, make_train_step
from test_torch_train_moe import GOSSIP, run_both, worker_params
from _torch_threads import one_torch_thread  # noqa: F401

BLOCK_ROWS = 256

@pytest.mark.parametrize("arch", ["gemma3-1b", "recurrentgemma-9b"])
def test_pipelined_int8_matches_reference(arch):
    cfg = jget_arch(arch).reduced()
    wnp = worker_params(cfg)
    kw = dict(GOSSIP, wire_format="int8")
    jcfg, tcfg = jg.GossipConfig(**kw), tg.GossipConfig(**kw)
    jw = jax.tree.map(jnp.asarray, wnp)
    jspec = jpack_spec_w(jw, block_rows=BLOCK_ROWS, groups=jg.leaf_groups(jw, 4),
                         n_groups=4)
    jpk = jpack_w(jw, jspec)
    jstep = jax.jit(jmake_train_step(
        cfg, gcfg=jcfg, acfg=jasgd.ASGDConfig(eps=0.05),
        packed_resident=True, pack_spec=jspec, pipelined=True))
    tw = params_from_numpy(wnp)
    tspec = pack_spec_w(tw, block_rows=BLOCK_ROWS, groups=tg.leaf_groups(tw, 4),
                        n_groups=4)
    tpk = pack_w(tw, tspec)
    np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
    tstep = make_train_step(get_arch(arch).reduced(), pack_spec=tspec,
                            gcfg=tcfg, acfg=tasgd.ASGDConfig(eps=0.05),
                            pipelined=True)

    def check(ours, ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-4)

    n_good = run_both(
        jstep, (jpk, jg.init_pipelined_gossip_state(jpk, jcfg,
                                                    block_rows=BLOCK_ROWS),
                jinit_inner(jpk, "sgd")),
        tstep, (tpk, tg.init_pipelined_gossip_state(tpk, tcfg,
                                                    block_rows=BLOCK_ROWS),
                init_inner_state(tpk, "sgd")), jcfg, cfg.vocab, check)
    assert len(n_good) == 3
