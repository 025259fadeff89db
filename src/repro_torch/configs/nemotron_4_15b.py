"""nemotron-4-15b [arXiv:2402.16819]: 32L d=6144 48H (GQA kv=8) ff=24576
vocab=256000 -- GQA + squared-ReLU."""
from repro_torch.configs.lm_common import lm_cells
from repro_torch.models.lm.config import LMConfig

CONFIG = LMConfig(
    name="nemotron-4-15b", n_layers=32, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=24576, vocab=256000, d_head=128,
    activation="squared_relu", rope_theta=10000.0,
    optimizer="adamw", remat_policy="nothing")

REDUCED = CONFIG.reduced(activation="squared_relu")

CELLS = lm_cells("nemotron-4-15b", CONFIG)
