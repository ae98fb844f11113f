"""jamba-1.5-large-398b [arXiv:2403.19887 / Jamba-1.5 report].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.
Hybrid Mamba : attention at 1:7 (one attention layer per 8), MoE 16 experts
top-2 on every other layer.  Period of 8 layers:
  [mamba+ff, mamba+moe, mamba+ff, attn+moe, mamba+ff, mamba+moe, mamba+ff, mamba+moe]
(attention at in-period index 3, MoE on odd indices — matches the published
1:7 attention ratio and every-2-layers MoE placement).  Mamba: d_state 16,
d_conv 4, expand 2 (d_inner 16,384), dt_rank ceil(8192 / 16) = 512.
"""
from repro_torch.config import (ATTN, DENSE_FF, MAMBA, MOE_FF, ArchConfig,
                                MambaConfig, MoEConfig, register)

PATTERN = (
    (MAMBA, DENSE_FF),
    (MAMBA, MOE_FF),
    (MAMBA, DENSE_FF),
    (ATTN, MOE_FF),
    (MAMBA, DENSE_FF),
    (MAMBA, MOE_FF),
    (MAMBA, DENSE_FF),
    (MAMBA, MOE_FF),
)

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=65_536,
    layer_pattern=PATTERN,
    moe=MoEConfig(num_experts=16, num_experts_per_tok=2, expert_d_ff=24_576),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
))
