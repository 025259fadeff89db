"""qwen2-1.5b [arXiv:2407.10671; hf]: 28L d=1536 12H (GQA kv=2) ff=8960
vocab=151936 -- GQA with QKV bias, tied embeddings."""
from repro_torch.configs.lm_common import lm_cells
from repro_torch.models.lm.config import LMConfig

CONFIG = LMConfig(
    name="qwen2-1.5b", n_layers=28, d_model=1536, n_heads=12,
    n_kv_heads=2, d_ff=8960, vocab=151936, d_head=128,
    activation="swiglu", qkv_bias=True, tie_embeddings=True,
    rope_theta=1000000.0, optimizer="adamw", remat_policy="nothing")

REDUCED = CONFIG.reduced(qkv_bias=True, tie_embeddings=True)

CELLS = lm_cells("qwen2-1.5b", CONFIG)
