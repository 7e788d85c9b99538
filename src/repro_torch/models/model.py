"""Full model assembly: embedding -> layer stack -> head.

``forward_w``/``loss_fn_w`` run W worker replicas at once (every param leaf
and the tokens carry a leading worker axis — the reference's vmap over
workers written out); ``forward``/``loss_fn`` take one model in the
reference's layout.

The layer params keep the reference's STACKED layout: every leaf of
``params["scan"]["pos{j}"]`` carries a leading axis over the full cycles
of ``cfg.pattern_cycle`` (the reference scans over it), so a weight
transfer is one array per leaf.  A Python loop over ``unbind`` views of
the layer axis replaces the scan; unbind's backward stacks the per-layer
gradients in one buffer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.tree import flatten_sorted, tree_map, unflatten
from .blocks import apply_layer, check_supported, init_layer
from .common import dense_init, embed_init, make_norm


def cycle_structure(cfg: ModelConfig):
    """(cycle, n_full_cycles, tail_types)."""
    c = len(cfg.pattern_cycle)
    n_full = cfg.n_layers // c
    tail = tuple(cfg.pattern_cycle[: cfg.n_layers - n_full * c])
    return cfg.pattern_cycle, n_full, tail


def _tree_stack(trees):
    leaves = [flatten_sorted(t)[0] for t in trees]
    treedef = flatten_sorted(trees[0])[1]
    return unflatten(treedef, [torch.stack(xs) for xs in zip(*leaves)])


def _tree_unstack(tree, n: int, dim: int = 0):
    """n trees of views: leaf i of tree k is ``leaf.select(dim, k)``."""
    leaves, treedef = flatten_sorted(tree)
    per_leaf = [l.unbind(dim) for l in leaves]
    return [unflatten(treedef, [pl[k] for pl in per_leaf]) for k in range(n)]


def init_model(cfg: ModelConfig, seed: int = 0, *, device=None,
               dtype=torch.float32):
    """Random params from ``seed`` on ``device`` (a torch.Generator on that
    device; the numbers differ from the reference's jax.random init — use
    repro_torch.convert to carry reference weights over)."""
    check_supported(cfg)
    cycle, n_full, tail = cycle_structure(cfg)
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    norm_init, _ = make_norm(cfg.norm_type)
    params = {
        "embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype,
                            device),
        "final_norm": norm_init(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            gen, (cfg.d_model, cfg.padded_vocab), in_axis=0, dtype=dtype,
            device=device)
    params["scan"] = {
        f"pos{j}": _tree_stack([
            init_layer(gen, cfg, ltype, dtype=dtype, device=device)
            for _ in range(n_full)])
        for j, ltype in enumerate(cycle)}
    params["tail"] = {
        f"t{j}": init_layer(gen, cfg, ltype, dtype=dtype, device=device)
        for j, ltype in enumerate(tail)}
    return params


def embed_tokens(cfg: ModelConfig, params, tokens):
    """tokens (W, B, S) -> (W, B, S, D) from each worker's own table."""
    widx = torch.arange(tokens.shape[0], device=tokens.device)[:, None, None]
    return params["embed"][widx, tokens]


def forward_w(cfg: ModelConfig, params, batch):
    """W worker replicas at once: params leaves (W, ...), batch["tokens"]
    (W, B, S).  Returns logits (W, B, S, V)."""
    check_supported(cfg)
    cycle, n_full, tail = cycle_structure(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(tokens.shape[-1], device=x.device)
    # the stacked layer axis sits behind the worker axis
    stacks = {j: _tree_unstack(params["scan"][f"pos{j}"], n_full, dim=1)
              for j in range(len(cycle))}
    for i in range(n_full):
        for j, ltype in enumerate(cycle):
            x = apply_layer(cfg, ltype, stacks[j][i], x, positions)
    for j, ltype in enumerate(tail):
        x = apply_layer(cfg, ltype, params["tail"][f"t{j}"], x, positions)
    _, norm = make_norm(cfg.norm_type)
    x = norm(params["final_norm"], x)
    return unembed(cfg, params, x)


def unembed(cfg: ModelConfig, params, x):
    if cfg.tie_embeddings:
        logits = torch.einsum("wbsd,wvd->wbsv", x, params["embed"])
    else:
        logits = torch.einsum("wbsd,wdv->wbsv", x, params["lm_head"])
    if cfg.padded_vocab != cfg.vocab:
        # mask pad columns so softmax never sees them
        col = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(col < cfg.vocab, logits,
                             torch.full((), -1e30, device=logits.device))
    return logits


def loss_fn_w(cfg: ModelConfig, params, batch):
    """Per-worker next-token cross-entropy (W,), mean over positions."""
    logits = forward_w(cfg, params, batch)
    tokens = batch["tokens"]
    lp = F.log_softmax(logits[:, :, :-1].float(), dim=-1)
    tgt = tokens[:, :, 1:].long()
    nll = -lp.gather(-1, tgt[..., None])[..., 0]
    return nll.mean(dim=(1, 2))


def _one_worker(params, batch):
    return (tree_map(lambda x: x[None], params),
            {k: v[None] for k, v in batch.items()})


def forward(cfg: ModelConfig, params, batch):
    """One model in the reference's layout: params without a worker axis,
    batch["tokens"] (B, S).  Returns logits (B, S, V)."""
    return forward_w(cfg, *_one_worker(params, batch))[0]


def loss_fn(cfg: ModelConfig, params, batch):
    """Next-token cross-entropy of one model (the reference's loss_fn)."""
    return loss_fn_w(cfg, *_one_worker(params, batch))[0]
