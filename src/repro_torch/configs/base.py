"""Model/config schema for all assigned architectures + the paper's K-Means.

A plain-data copy of the reference's ``configs/base.py`` (the port imports
nothing of the reference).  One ``ModelConfig`` instance per architecture
lives in its own module (``configs/<id>.py``) citing its source;
``registry.py`` maps the
``--arch`` CLI ids onto them. ``reduced()`` derives the CPU smoke-test
variant (<=2 layers, d_model<=512, <=4 experts) from the same definition so
smoke tests exercise the identical code path as the production config.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                       # dense|moe|ssm|hybrid|audio|vlm
    source: str                          # citation (paper / model card)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None       # default d_model // n_heads

    # layer mixing: cycle of layer types, tiled over n_layers.
    #   'G' global attention · 'L' sliding-window attention ·
    #   'R' RG-LRU recurrent · 'S' mamba-2 SSD
    pattern_cycle: Tuple[str, ...] = ("G",)
    sliding_window: int = 4096

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    logit_softcap: Optional[float] = None
    attn_softcap: Optional[float] = None

    # embedding / head
    tie_embeddings: bool = True
    scale_embeddings: bool = False       # gemma-family x sqrt(d_model)
    norm_type: str = "rmsnorm"
    act: str = "silu"
    glu_mlp: bool = True

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_dispatch_groups: int = 1     # shard-local dispatch (see models/moe.py)

    # SSM (mamba-2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_groups: int = 1

    # hybrid (RG-LRU)
    lru_width: Optional[int] = None

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0                 # stub frontend output length
    cross_attention: bool = False

    # modality frontend stub: None | 'audio' | 'vision'
    frontend: Optional[str] = None
    prefix_len: int = 0                  # VLM image-token prefix (prefix-LM)

    # which input shapes this arch supports (long_500k needs sub-quadratic)
    supports_long_context: bool = False
    decoder_only_decode: bool = True     # False for encoder-only archs

    # execution detail: python-unroll the layer scan (used by the dry-run's
    # shallow cost-extrapolation compiles — XLA's cost_analysis does not
    # multiply while-body costs by trip count, so scanned stacks must be
    # unrolled to be counted)
    unroll_scan: bool = False

    # activation-checkpoint policy for the layer scan:
    #   'full' — checkpoint everything (recompute whole layer in bwd)
    #   'dots' — save matmul outputs, recompute elementwise only
    #   'none' — no remat (smoke scale)
    remat_policy: str = "full"

    # sequence parallelism: shard the residual stream's sequence axis over
    # `model` between matmul segments (norms/elementwise run on S/16 rows
    # per chip). Beyond-paper §Perf option; no-op without an ambient mesh.
    seq_parallel: bool = False

    # batch-sharded attention: run the attention segment with the BATCH
    # axis sharded over `model` and the (small) projection weights
    # replicated. This sidesteps head-count divisibility entirely (40, 9,
    # 6, 4 heads vs 16-way TP all force replicated attention otherwise).
    # Honored only when the local batch divides 16 (see models/blocks.py).
    attn_batch_shard: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding/unembed
        can always shard over the model axis (an odd vocab like whisper's
        51865 otherwise forces D-sharded embeddings whose unembed partial
        sums all-reduce the full (B,S,V) logits — measured 258 GB/step on
        granite prefill, EXPERIMENTS.md §Perf iteration 3). Padded logit
        columns are masked to -inf in unembed; padded rows receive zero
        gradient from the masked loss."""
        return -(-self.vocab // 256) * 256

    @property
    def layer_types(self) -> Tuple[str, ...]:
        c = len(self.pattern_cycle)
        return tuple(self.pattern_cycle[i % c] for i in range(self.n_layers))

    def param_count(self) -> int:
        """Analytic total param count (embedding included once if tied)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        Dh = self.resolved_head_dim
        n = V * D                                   # embedding
        if not self.tie_embeddings:
            n += V * D
        attn = (D * Dh * (self.n_heads + 2 * self.n_kv_heads)
                + self.n_heads * Dh * D)
        ffn = 0
        if F:
            if self.n_experts:
                ffn = D * self.n_experts + 3 * self.n_experts * D * F
            else:
                ffn = 3 * D * F if self.glu_mlp else 2 * D * F + F + D
        for t in self.layer_types:
            if t in ("G", "L"):
                n += attn
                if self.qkv_bias:
                    n += Dh * (self.n_heads + 2 * self.n_kv_heads)
            elif t == "R":
                W = self.lru_width or D
                # in_x/in_gate/out + w_a/w_x + conv + biases + Lambda
                n += 2 * D * W + 2 * W * W + W * D + 9 * W
            elif t == "S":
                d_in = self.ssm_expand * D
                H = d_in // self.ssm_head_dim
                proj = 2 * d_in + 2 * self.ssm_groups * self.ssm_state + H
                conv_ch = d_in + 2 * self.ssm_groups * self.ssm_state
                n += D * proj + d_in * D + 5 * conv_ch + 3 * H + d_in
            if t != "S":
                n += ffn
            if self.cross_attention and t != "S":
                n += attn + D                       # cross-attn + norm
            n += 2 * D                              # norms
        # encoder stack (whisper): self-attn + FFN + norms per layer
        n += self.encoder_layers * (attn + ffn + 2 * D)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts) — the N in
        MODEL_FLOPS = 6*N_active*D."""
        if not self.n_experts:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        dead_per_layer = 3 * (self.n_experts - self.experts_per_token) * D * F
        return self.param_count() - dead_per_layer * self.n_layers

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family, laptop scale."""
        c = len(self.pattern_cycle)
        n_layers = max(2, c)                # at least one full cycle
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        while d_model % (n_heads * 2):
            n_heads //= 2
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            sliding_window=min(self.sliding_window, 16),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            experts_per_token=(min(self.experts_per_token, 2)
                               if self.n_experts else 0),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=8 if self.ssm_state else self.ssm_chunk,
            lru_width=min(self.lru_width or 0, 256) or None,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32),
            prefix_len=min(self.prefix_len, 8),
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
