"""deepseek-v3-671b [arXiv:2412.19437; hf]: 61L d=7168 128H MLA
vocab=129280 -- 1 shared + 256 routed experts top-8 (expert ff 2048, first 3
layers dense ff 18432), MTP depth 1.  The optimizer field (Adafactor) is
read by the reference's training path only."""
from repro_torch.configs.lm_common import lm_cells
from repro_torch.models.lm.config import LMConfig, MLAConfig, MoEConfig

CONFIG = LMConfig(
    name="deepseek-v3-671b", n_layers=61, d_model=7168, n_heads=128,
    n_kv_heads=128, d_ff=18432, vocab=129280, d_head=128,
    activation="swiglu", rope_theta=10000.0,
    attention="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
                  first_k_dense=3, capacity_factor=1.25),
    mtp_depth=1, optimizer="adafactor", remat_policy="nothing")

REDUCED = CONFIG.reduced()

CELLS = lm_cells("deepseek-v3-671b", CONFIG)
