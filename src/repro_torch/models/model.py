"""Full model assembly: embedding -> layer stack -> head.

``forward_w``/``loss_fn_w`` run W worker replicas at once (every param leaf
and the tokens carry a leading worker axis — the reference's vmap over
workers written out); ``forward``/``loss_fn`` take one model in the
reference's layout, as do the serving entry points ``init_cache``,
``prefill`` and ``decode_step`` (which run the layers at W = 1).

The layer params keep the reference's STACKED layout: every leaf of
``params["scan"]["pos{j}"]`` carries a leading axis over the full cycles
of ``cfg.pattern_cycle`` (the reference scans over it), so a weight
transfer is one array per leaf.  A Python loop over ``unbind`` views of
the layer axis replaces the scan; unbind's backward stacks the per-layer
gradients in one buffer.

The frontends are the reference's stubs: whisper's encoder runs on
precomputed frame embeddings (``batch["frames"]`` (W, B, S_enc, D), plus
sinusoidal positions, through the 'E' stack under ``params["encoder"]``)
and its decoder attends to the encoder's output; PaliGemma prepends 256
precomputed patch embeddings (``batch["patches"]`` (W, B, P, D), not
scaled) to the text and attends bidirectionally over them.  Only the text
positions carry labels.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.tree import flatten_sorted, tree_map, unflatten
from .blocks import (apply_layer, apply_layer_decode, check_supported,
                     init_layer, init_layer_cache)
from .common import dense_init, embed_init, make_norm


def cycle_structure(cfg: ModelConfig):
    """(cycle, n_full_cycles, tail_types)."""
    c = len(cfg.pattern_cycle)
    n_full = cfg.n_layers // c
    tail = tuple(cfg.pattern_cycle[: cfg.n_layers - n_full * c])
    return cfg.pattern_cycle, n_full, tail


def _tree_stack(trees, dim: int = 0):
    leaves = [flatten_sorted(t)[0] for t in trees]
    treedef = flatten_sorted(trees[0])[1]
    return unflatten(treedef, [torch.stack(xs, dim) for xs in zip(*leaves)])


def _tree_unstack(tree, n: int, dim: int = 0):
    """n trees of views: leaf i of tree k is ``leaf.select(dim, k)``."""
    leaves, treedef = flatten_sorted(tree)
    per_leaf = [l.unbind(dim) for l in leaves]
    return [unflatten(treedef, [pl[k] for pl in per_leaf]) for k in range(n)]


def _use_abs_pos(cfg: ModelConfig) -> bool:
    return (not cfg.use_rope) and any(
        t in ("G", "L", "E") for t in cfg.pattern_cycle)


def sinusoidal(seq, d, dtype=torch.float32, device=None):
    """(seq, d) sinusoidal positions: sin at even columns, cos at odd."""
    pos = torch.arange(seq, device=device)[:, None].float()
    dim = torch.arange(0, d, 2, device=device)[None, :].float()
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    pe = torch.zeros((seq, d), device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe.to(dtype)


def init_model(cfg: ModelConfig, seed: int = 0, *, device=None,
               dtype=torch.float32):
    """Random params from ``seed`` on ``device`` (a torch.Generator on that
    device; the numbers differ from the reference's jax.random init — use
    repro_torch.convert to carry reference weights over).  An encoder
    config adds ``params["encoder"]``: its 'E' layers stacked under
    "scan" and its own "final_norm".  On the ``meta`` device the leaves
    are made directly, with no generator: shapes and dtypes only, nothing
    allocated (the dry-run's params)."""
    check_supported(cfg)
    cycle, n_full, tail = cycle_structure(cfg)
    if torch.device(device or "cpu").type == "meta":
        gen = None
    else:
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
    if cfg.encoder_layers:
        params["encoder"] = {
            "scan": _tree_stack([
                init_layer(gen, cfg, "E", is_decoder=False, dtype=dtype,
                           device=device)
                for _ in range(cfg.encoder_layers)]),
            "final_norm": norm_init(cfg.d_model, dtype, device)}
    return params


def run_encoder(cfg: ModelConfig, params, frames):
    """frames (W, B, S_enc, D), the stub frontend's embeddings, plus
    sinusoidal positions, through the 'E' stack and the encoder's norm ->
    (W, B, S_enc, D)."""
    _, norm = make_norm(cfg.norm_type)
    seq = frames.shape[2]
    x = frames + sinusoidal(seq, cfg.d_model, frames.dtype, frames.device)
    positions = torch.arange(seq, device=frames.device)
    enc = params["encoder"]
    for p in _tree_unstack(enc["scan"], cfg.encoder_layers, dim=1):
        x = apply_layer(cfg, "E", p, x, positions)[0]
    return norm(enc["final_norm"], x)


def embed_tokens(cfg: ModelConfig, params, tokens):
    """tokens (W, B, S) -> (W, B, S, D) from each worker's own table,
    times sqrt(d_model) for the gemma family (``cfg.scale_embeddings``)."""
    widx = torch.arange(tokens.shape[0], device=tokens.device)[:, None, None]
    x = params["embed"][widx, tokens]
    if cfg.scale_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


def vision_prefix(cfg: ModelConfig) -> int:
    """The positions a vision prefix takes before the text (0 without)."""
    return cfg.prefix_len if cfg.frontend == "vision" else 0


def _embed_inputs(cfg: ModelConfig, params, batch):
    """Returns (x (W, B, S, D), positions (S,), prefix_len, enc_out):
    the text embeddings, after the vision prefix's patches (cast to the
    text's dtype, not scaled) where the config has one, plus sinusoidal
    positions where it has no RoPE; enc_out the encoder's output on the
    audio frames (None without)."""
    enc_out = None
    x = embed_tokens(cfg, params, batch["tokens"])
    if cfg.frontend == "audio":
        enc_out = run_encoder(cfg, params, batch["frames"])
    elif cfg.frontend == "vision":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=2)
    seq = x.shape[2]
    if _use_abs_pos(cfg):
        x = x + sinusoidal(seq, cfg.d_model, x.dtype, x.device)
    positions = torch.arange(seq, device=x.device)
    return x, positions, vision_prefix(cfg), enc_out


def forward_w(cfg: ModelConfig, params, batch, *, return_cache=False,
              cache_len=None):
    """W worker replicas at once: params leaves (W, ...), batch["tokens"]
    (W, B, S) (and the frontend's "frames" (W, B, S_enc, D) or "patches"
    (W, B, P, D)).  Returns (logits (W, B, S', V), aux (W,)) or, with
    ``return_cache``, (logits, aux, cache), as the reference's forward:
    S' = P + S with a vision prefix, else S; aux the MoE router's
    load-balance loss summed over the layers (zeros without MoE); cache
    the reference's tree with leaves (W, n_full, B, ...) under "scan" and
    (W, B, ...) under "tail"."""
    check_supported(cfg)
    cycle, n_full, tail = cycle_structure(cfg)
    x, positions, prefix, enc_out = _embed_inputs(cfg, params, batch)
    aux = torch.zeros((x.shape[0],), device=x.device)
    # the stacked layer axis sits behind the worker axis
    stacks = {j: _tree_unstack(params["scan"][f"pos{j}"], n_full, dim=1)
              for j in range(len(cycle))}
    kw = {"enc_out": enc_out, "prefix_len": prefix,
          "return_cache": return_cache, "cache_len": cache_len}
    scan_caches = {j: [] for j in range(len(cycle))}
    for i in range(n_full):
        for j, ltype in enumerate(cycle):
            x, a, c = apply_layer(cfg, ltype, stacks[j][i], x, positions,
                                  **kw)
            if a is not None:
                aux = aux + a
            scan_caches[j].append(c)
    tail_caches = {}
    for j, ltype in enumerate(tail):
        x, a, tail_caches[f"t{j}"] = apply_layer(
            cfg, ltype, params["tail"][f"t{j}"], x, positions, **kw)
        if a is not None:
            aux = aux + a
    _, norm = make_norm(cfg.norm_type)
    x = norm(params["final_norm"], x)
    logits = unembed(cfg, params, x)
    if not return_cache:
        return logits, aux
    cache = {"scan": {f"pos{j}": _tree_stack(cs, dim=1)
                      for j, cs in scan_caches.items()},
             "tail": tail_caches}
    return logits, aux, cache


def unembed(cfg: ModelConfig, params, x):
    if cfg.tie_embeddings:
        logits = torch.einsum("wbsd,wvd->wbsv", x, params["embed"])
    else:
        logits = torch.einsum("wbsd,wdv->wbsv", x, params["lm_head"])
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab:
        # mask pad columns so softmax never sees them
        col = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(col < cfg.vocab, logits,
                             torch.full((), -1e30, device=logits.device))
    return logits


def loss_fn_w(cfg: ModelConfig, params, batch):
    """Per-worker loss (W,): next-token cross-entropy, mean over the text
    positions (a vision prefix carries no labels), plus
    ``cfg.router_aux_weight`` times the MoE aux loss, as the reference's
    loss_fn."""
    logits, aux = forward_w(cfg, params, batch)
    tokens = batch["tokens"]
    logits = logits[:, :, -tokens.shape[-1]:]
    lp = F.log_softmax(logits[:, :, :-1].float(), dim=-1)
    tgt = tokens[:, :, 1:].long()
    nll = -lp.gather(-1, tgt[..., None])[..., 0]
    return nll.mean(dim=(1, 2)) + cfg.router_aux_weight * aux


def _one_worker(params, batch):
    return (tree_map(lambda x: x[None], params),
            {k: v[None] for k, v in batch.items()})


def forward(cfg: ModelConfig, params, batch):
    """One model in the reference's layout: params without a worker axis,
    batch["tokens"] (B, S) (and "frames" or "patches" without a worker
    axis).  Returns logits (B, S', V)."""
    return forward_w(cfg, *_one_worker(params, batch))[0][0]


def loss_fn(cfg: ModelConfig, params, batch):
    """Next-token cross-entropy plus the MoE aux term of one model (the
    reference's loss_fn)."""
    return loss_fn_w(cfg, *_one_worker(params, batch))[0]


# ---------------------------------------------------------------------------
# serving: prefill + decode (one model, the reference's layout)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch, max_seq, dtype=torch.bfloat16,
               device=None):
    """One model's zero decode cache, the reference's tree: leaves
    (n_full, batch, ...) under "scan", (batch, ...) under "tail"; a
    cross-attention config's layers also hold ``cross_k``/``cross_v`` of
    ``cfg.encoder_seq`` positions."""
    check_supported(cfg)
    cycle, n_full, tail = cycle_structure(cfg)
    kw = {"dtype": dtype, "device": device,
          "cross_seq": cfg.encoder_seq if cfg.cross_attention else 0}

    def stacked(ltype):
        one = init_layer_cache(cfg, ltype, batch, max_seq, **kw)
        return tree_map(lambda x: x.expand((n_full,) + tuple(x.shape))
                        .contiguous(), one)

    return {"scan": {f"pos{j}": stacked(t) for j, t in enumerate(cycle)},
            "tail": {f"t{j}": init_layer_cache(cfg, t, batch, max_seq, **kw)
                     for j, t in enumerate(tail)}}


def prefill(cfg: ModelConfig, params, batch, cache_len=None):
    """Full-sequence pass that also builds the decode cache.  params: one
    model; batch["tokens"]: (B, S) (and "frames" or "patches").  Returns
    (last_logits (B, V), cache) — the cache in the reference's tree and
    layout (see :func:`init_cache`), of ``cache_len`` positions, which
    must hold a vision prefix too; its 'S' conv caches are zero, as the
    reference's are; a cross-attention config's ``cross_k``/``cross_v``
    hold the encoder's projected output."""
    logits, _, cache = forward_w(cfg, *_one_worker(params, batch),
                                 return_cache=True, cache_len=cache_len)
    return logits[0, :, -1], tree_map(lambda x: x[0], cache)


def decode_step(cfg: ModelConfig, params, token, pos: int, cache):
    """token: (B,) int; pos: host int, the current write position; cache:
    :func:`prefill`'s or :func:`init_cache`'s tree, updated IN PLACE (the
    reference returns a new tree).  Returns (logits (B, V), cache).  An
    arch without RoPE adds the sinusoidal position ``pos`` of the cache's
    length, as the reference does."""
    cycle, n_full, tail = cycle_structure(cfg)
    wparams = tree_map(lambda x: x[None], params)
    x = embed_tokens(cfg, wparams, token[None, :, None])
    if _use_abs_pos(cfg):
        x = x + sinusoidal(cache_max_seq(cache), cfg.d_model, x.dtype,
                           x.device)[pos]
    stacks = {j: _tree_unstack(wparams["scan"][f"pos{j}"], n_full, dim=1)
              for j in range(len(cycle))}
    caches = {j: _tree_unstack(tree_map(lambda c: c[None],
                                        cache["scan"][f"pos{j}"]),
                               n_full, dim=1)
              for j in range(len(cycle))}
    for i in range(n_full):
        for j, ltype in enumerate(cycle):
            x = apply_layer_decode(cfg, ltype, stacks[j][i], x, pos,
                                   caches[j][i])
    for j, ltype in enumerate(tail):
        x = apply_layer_decode(
            cfg, ltype, wparams["tail"][f"t{j}"], x, pos,
            tree_map(lambda c: c[None], cache["tail"][f"t{j}"]))
    _, norm = make_norm(cfg.norm_type)
    x = norm(wparams["final_norm"], x)
    return unembed(cfg, wparams, x)[0, :, 0], cache


def cache_max_seq(cache) -> int:
    """Max-seq capacity of an attention KV cache: the S axis of a 'k' leaf
    ((..., B, S, KV, Dh) — scan-stacked leaves too; never a ``cross_k``,
    which has the encoder's length); 0 without one."""
    if isinstance(cache, dict):
        k = cache.get("k")
        if torch.is_tensor(k) and k.ndim >= 4:
            return k.shape[-3]
        for v in cache.values():
            n = cache_max_seq(v)
            if n:
                return n
    return 0
