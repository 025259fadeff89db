"""phi4-mini-3.8b [arXiv:2412.08905; hf]: 32L d=3072 24H (GQA kv=8) ff=8192
vocab=200064 -- RoPE + SwiGLU + GQA."""
from repro_torch.configs.lm_common import lm_cells
from repro_torch.models.lm.config import LMConfig

CONFIG = LMConfig(
    name="phi4-mini-3.8b", n_layers=32, d_model=3072, n_heads=24,
    n_kv_heads=8, d_ff=8192, vocab=200064, d_head=128,
    activation="swiglu", rope_theta=10000.0,
    optimizer="adamw", remat_policy="nothing")

REDUCED = CONFIG.reduced()

CELLS = lm_cells("phi4-mini-3.8b", CONFIG)
