"""Transformer LM configuration: the port's own copy of ``repro``'s
``models/lm/config.py``, field for field, so one configuration describes
the same model in both packages.

It describes dense GQA models (nemotron/phi4/qwen2), MoE (olmoe), and
MLA + fine-grained MoE + MTP (deepseek-v3); the port serves all of them.
The sharding, remat, optimizer and scan fields are read by the
reference's training and dry-run paths and kept here so a configuration
moves across unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims (arXiv:2412.19437)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 64
    top_k: int = 8
    d_ff_expert: int = 1024
    n_shared: int = 0            # always-on shared experts (DeepSeekMoE)
    first_k_dense: int = 0       # leading dense layers (deepseek-v3: 3)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0              # 0 -> d_model // n_heads
    activation: str = "swiglu"   # swiglu | squared_relu | gelu
    qkv_bias: bool = False       # qwen2 uses QKV bias
    rope_theta: float = 10000.0
    max_seq: int = 4096
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attention: str = "gqa"       # gqa | mla
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    mtp_depth: int = 0           # deepseek-v3 multi-token prediction
    # numerics / performance knobs
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat_policy: str = "nothing"   # nothing | dots | full
    attn_chunk: int = 1024          # q-chunk for memory-safe attention
    causal_unroll: bool = False     # exact-causal unrolled chunks (perf opt)
    optimizer: str = "adamw"        # adamw | adafactor
    grad_compression: str = "none"  # none | int8 | topk  (DESIGN.md §5)
    scan_unroll: bool = False       # unroll layer scan (dry-run: XLA's
                                    # cost_analysis counts while-bodies once)
    microbatch: int = 1             # gradient-accumulation steps per train
                                    # step (activation memory / microbatch)
    cache_latent_tp: bool = False   # MLA decode: shard the cache's LATENT
                                    # dim over `model` instead of sequence —
                                    # cache updates stay local (no SPMD
                                    # resharding); scores psum over model
    serving_shardings: bool = False  # inference: params NOT FSDP-sharded
                                    # over `data` (no optimizer state to
                                    # amortize the gathers); MoE experts
                                    # expert-parallel over data x model

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def reduced(self, **overrides) -> "LMConfig":
        """A small same-family config for CPU smoke tests."""
        from dataclasses import replace
        small = dict(
            n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=256, d_head=16, max_seq=64, attn_chunk=32)
        if self.moe is not None:
            small["moe"] = MoEConfig(
                n_experts=4, top_k=2, d_ff_expert=32,
                n_shared=self.moe.n_shared and 1,
                first_k_dense=min(self.moe.first_k_dense, 1),
                capacity_factor=2.0)
        if self.mla is not None:
            small["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                     qk_nope_head_dim=16, qk_rope_head_dim=8,
                                     v_head_dim=16)
            small["n_kv_heads"] = 4
        small["mtp_depth"] = min(self.mtp_depth, 1)
        small.update(overrides)
        return replace(self, **small)
