"""olmoe-1b-7b [arXiv:2409.02060; hf]: 16L d=2048 16H (MHA) expert-ff=1024
vocab=50304 -- 64 experts, top-8 routing, SwiGLU experts."""
from repro_torch.configs.lm_common import lm_cells
from repro_torch.models.lm.config import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1024, vocab=50304, d_head=128,
    activation="swiglu", rope_theta=10000.0,
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024,
                  capacity_factor=1.25),
    optimizer="adamw", remat_policy="nothing")

REDUCED = CONFIG.reduced()

CELLS = lm_cells("olmoe-1b-7b", CONFIG)
