"""The cluster communication cost model of the reference's benchmarks
(``benchmarks/common.py``), for the scaling example.

The paper's wall-clock scaling figures (Figs. 1/5/6) are projected, not
measured: per-round communication times modeled on the paper's cluster
(§5.2: dual E5-2670 nodes, FDR Infiniband).  Every time from this module is
labelled "modeled (FDR-Infiniband cost model)"; none is a time of this port
or of any device.

  BATCH : tree all-reduce of S bytes per round: 2*S/BW * log2(n) + L*log2(n)
  SGD   : zero per-round comms.
  ASGD  : one-sided send of S/p bytes: S/(p*BW) + L (never blocks; charged
          fully — conservative)
"""
from __future__ import annotations

import numpy as np

BW = 6.8e9          # FDR Infiniband effective bandwidth, B/s
LAT = 1.5e-6        # per-message latency, s


def t_comm_batch(state_bytes: int, n: int) -> float:
    """Tree all-reduce per BATCH round."""
    lg = max(1.0, np.log2(n))
    return 2.0 * state_bytes / BW * lg + LAT * lg


def t_comm_asgd(state_bytes: int, partial_blocks: int = 1) -> float:
    """One-sided partial-state send; single hop, never blocks the sender.
    Charged fully (conservative — the paper charges ~0 below saturation)."""
    return state_bytes / (partial_blocks * BW) + LAT


def t_comm_sgd() -> float:
    """SimuParallelSGD: communication-free during optimization."""
    return 0.0


def iters_to_error(errors, level) -> int:
    """First round index at which the error trace crosses `level`
    (len(errors) if never)."""
    errors = np.asarray(errors)
    hit = np.nonzero(errors <= level)[0]
    return int(hit[0]) if hit.size else len(errors)
