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

Rematerialization follows the reference's ``forward(remat=True)``: with
grad on, each full cycle of the layer pattern is one rematerialized body
(:class:`_RematCycle`), so only the cycles' inputs stay saved and
backward recomputes one cycle at a time; the embedding, the encoder, the
tail layers, the final norm and ``unembed`` stay outside it, as in the
reference.
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


def _init_stacked(n: int, make):
    """``_tree_stack([make() for _ in range(n)])`` without holding the n
    layers beside their stack: each layer is copied into its slot of the
    preallocated stack as it is made (the same draws, in the same order),
    so a full-size init peaks at the stack plus one layer."""
    leaves, treedef = flatten_sorted(make())
    out = [x.new_empty((n,) + tuple(x.shape)) for x in leaves]
    for i in range(n):
        if i:
            leaves = flatten_sorted(make())[0]
        for o, x in zip(out, leaves):
            o[i].copy_(x)
    return unflatten(treedef, out)


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
        f"pos{j}": _init_stacked(n_full, lambda t=ltype: init_layer(
            gen, cfg, t, dtype=dtype, device=device))
        for j, ltype in enumerate(cycle)}
    params["tail"] = {
        f"t{j}": init_layer(gen, cfg, ltype, dtype=dtype, device=device)
        for j, ltype in enumerate(tail)}
    if cfg.encoder_layers:
        params["encoder"] = {
            "scan": _init_stacked(cfg.encoder_layers, lambda: init_layer(
                gen, cfg, "E", is_decoder=False, dtype=dtype,
                device=device)),
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


# cfg.remat_policy: 'full' and 'dots' rematerialize the whole cycle body,
# 'none' keeps every activation.  'dots' is the reference's
# dots_with_no_batch_dims_saveable, which saves the matmul outputs of an
# unbatched loss_fn, but the reference's train step runs loss_fn under
# jax.vmap over the workers, where every dot has the worker axis as a batch
# dim and 'dots' saves what 'full' saves: jax.ad_checkpoint's residuals of
# reduced qwen2.5-14b (2 layers; "not arguments" in brackets) are 28 (15)
# 'full' and 34 (21) 'dots' unbatched, 28 (27) and 28 (27) under the vmap
# over W = 2 (tests/test_torch_remat.py pins it).  forward_w is that
# W-batched step, so it rematerializes the whole cycle under both.
REMAT_POLICIES = ("full", "dots", "none")


def _remat_on(cfg: ModelConfig, remat: bool, return_cache: bool) -> bool:
    """Whether :func:`forward_w` rematerializes its cycles: ``remat`` set,
    no cache returned, ``cfg.remat_policy`` not 'none', grad mode on.
    An unknown policy raises."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                         f"one of {REMAT_POLICIES}")
    return (remat and not return_cache and cfg.remat_policy != "none"
            and torch.is_grad_enabled())


class _RematCycle(torch.autograd.Function):
    """``body(inputs, shared)`` rematerialized, the reference's
    ``jax.checkpoint``: the forward runs it without a graph and saves only
    its inputs; backward reruns it from them with grad on and
    differentiates the rerun.  ``inputs`` (a tree, flattened into the
    Function's tensors) holds every tensor the body reads that may need a
    gradient, but ``shared``: one that every cycle reads (the encoder's
    output), or None.

    Plain autograd sums ``shared``'s gradient in one buffer, each cycle's
    terms in turn; a sum per cycle, then over the cycles, would differ in
    the last bits.  So the cycles pass the running sum down in ``carry``:
    each rerun adds its terms to the sum so far, and the last cycle that
    backward reaches hands ``shared`` the whole sum."""

    @staticmethod
    def forward(ctx, body, treedef, carry, shared, *leaves):
        ctx.body, ctx.treedef, ctx.carry = body, treedef, carry
        ctx.save_for_backward(shared, *leaves)
        return body(unflatten(treedef, leaves), shared)

    @staticmethod
    def backward(ctx, *grads):
        ins = [t if t is None else t.detach().requires_grad_(
            t.requires_grad) for t in ctx.saved_tensors]
        shared, carry = ins[0], ctx.carry
        with torch.enable_grad():
            outs = ctx.body(unflatten(ctx.treedef, ins[1:]), shared)
            pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
            if carry["grad"] is not None:
                # made last, so the rerun's backward adds it first
                pairs.append((shared.view_as(shared), carry["grad"]))
        want = [t for t in ins if t is not None and t.requires_grad]
        got = dict(zip(map(id, want), torch.autograd.grad(
            [o for o, _ in pairs], want, [g for _, g in pairs],
            allow_unused=True)))
        out = [got.get(id(t)) if t is not None else None for t in ins]
        if shared is not None and shared.requires_grad:
            carry["grad"] = out[0]
            carry["left"] -= 1
            out[0] = carry["grad"] if carry["left"] == 0 else None
        return (None, None, None, *out)


def rematerialize(body, inputs, shared, carry):
    """``body(inputs, shared)`` through :class:`_RematCycle`; ``carry``
    ``{"grad": None, "left": the number of cycles}``, one for the cycles
    of one forward."""
    leaves, treedef = flatten_sorted(inputs)
    return _RematCycle.apply(body, treedef, carry, shared, *leaves)


def forward_w(cfg: ModelConfig, params, batch, *, remat=True,
              return_cache=False, cache_len=None):
    """W worker replicas at once: params leaves (W, ...), batch["tokens"]
    (W, B, S) (and the frontend's "frames" (W, B, S_enc, D) or "patches"
    (W, B, P, D)).  Returns (logits (W, B, S', V), aux (W,)) or, with
    ``return_cache``, (logits, aux, cache), as the reference's forward:
    S' = P + S with a vision prefix, else S; aux the MoE router's
    load-balance loss summed over the layers (zeros without MoE); cache
    the reference's tree with leaves (W, n_full, B, ...) under "scan" and
    (W, B, ...) under "tail".  ``remat``: rematerialize each full cycle
    where :func:`_remat_on` says so."""
    check_supported(cfg)
    cycle, n_full, tail = cycle_structure(cfg)
    x, positions, prefix, enc_out = _embed_inputs(cfg, params, batch)
    aux = torch.zeros((x.shape[0],), device=x.device)
    # the stacked layer axis sits behind the worker axis
    stacks = [_tree_unstack(params["scan"][f"pos{j}"], n_full, dim=1)
              for j in range(len(cycle))]
    kw = {"prefix_len": prefix, "return_cache": return_cache,
          "cache_len": cache_len}

    def cycle_body(inputs, enc_out):
        """One full cycle: ``inputs["x"]``, ``inputs["aux"]`` through its
        layers (``inputs["layers"]`` {str(position): params}) -> (x, aux,
        the layers' caches)."""
        x, aux, caches = inputs["x"], inputs["aux"], []
        for j, ltype in enumerate(cycle):
            x, a, c = apply_layer(cfg, ltype, inputs["layers"][str(j)], x,
                                  positions, enc_out=enc_out, **kw)
            if a is not None:
                aux = aux + a
            caches.append(c)
        return x, aux, caches

    remat_on = _remat_on(cfg, remat, return_cache)
    # a tail's terms of enc_out's gradient would be summed apart from the
    # cycles' (the last bits then not remat=False's); no arch has both,
    # since a decoder's cycle is one layer
    carry = {"grad": None, "left": n_full}
    scan_caches = [[] for _ in cycle]
    for i in range(n_full):
        inputs = {"x": x, "aux": aux,
                  "layers": {str(j): s[i] for j, s in enumerate(stacks)}}
        if remat_on:
            x, aux = rematerialize(lambda *a: cycle_body(*a)[:2], inputs,
                                   enc_out, carry)
        else:
            x, aux, caches = cycle_body(inputs, enc_out)
            for out, c in zip(scan_caches, caches):
                out.append(c)
    tail_caches = {}
    for j, ltype in enumerate(tail):
        x, a, tail_caches[f"t{j}"] = apply_layer(
            cfg, ltype, params["tail"][f"t{j}"], x, positions,
            enc_out=enc_out, **kw)
        if a is not None:
            aux = aux + a
    _, norm = make_norm(cfg.norm_type)
    x = norm(params["final_norm"], x)
    logits = unembed(cfg, params, x)
    if not return_cache:
        return logits, aux
    cache = {"scan": {f"pos{j}": _tree_stack(cs, dim=1)
                      for j, cs in enumerate(scan_caches)},
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


def loss_fn_w(cfg: ModelConfig, params, batch, *, remat=True):
    """Per-worker loss (W,): next-token cross-entropy, mean over the text
    positions (a vision prefix carries no labels), plus
    ``cfg.router_aux_weight`` times the MoE aux loss, as the reference's
    loss_fn (``remat`` as in :func:`forward_w`)."""
    logits, aux = forward_w(cfg, params, batch, remat=remat)
    tokens = batch["tokens"]
    logits = logits[:, :, -tokens.shape[-1]:]
    lp = F.log_softmax(logits[:, :, :-1].float(), dim=-1)
    tgt = tokens[:, :, 1:].long()
    nll = -lp.gather(-1, tgt[..., None])[..., 0]
    return nll.mean(dim=(1, 2)) + cfg.router_aux_weight * aux


def _one_worker(params, batch):
    return (tree_map(lambda x: x[None], params),
            {k: v[None] for k, v in batch.items()})


def forward(cfg: ModelConfig, params, batch, *, remat=True):
    """One model in the reference's layout: params without a worker axis,
    batch["tokens"] (B, S) (and "frames" or "patches" without a worker
    axis).  Returns logits (B, S', V)."""
    return forward_w(cfg, *_one_worker(params, batch), remat=remat)[0][0]


def loss_fn(cfg: ModelConfig, params, batch, *, remat=True):
    """Next-token cross-entropy plus the MoE aux term of one model (the
    reference's loss_fn)."""
    return loss_fn_w(cfg, *_one_worker(params, batch), remat=remat)[0]


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
