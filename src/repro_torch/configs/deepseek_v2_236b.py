"""deepseek-v2-236b [arXiv:2405.04434].

60L d_model=5120 128H (MLA kv_lora=512) vocab=102400.
MoE: 160 routed experts top-6 + 2 shared experts, expert_d_ff=1536.
Layer 0 uses a dense FFN (d_ff=12288), layers 1..59 use MoE (per the paper).
MLA: q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128.
"""
from repro_torch.config import (ATTN_MLA, DENSE_FF, MOE_FF, ArchConfig,
                                MLAConfig, MoEConfig, register)

# layer 0 dense FFN (prefix, unscanned); layers 1..59 MoE (scanned)
_PREFIX = ((ATTN_MLA, DENSE_FF),)
_PATTERN = ((ATTN_MLA, MOE_FF),)

CONFIG = register(ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,       # MLA: per-head keys reconstructed from latent
    head_dim=128,           # v_head_dim; qk dims live in MLAConfig
    d_ff=12_288,            # dense FFN (layer 0)
    vocab_size=102_400,
    layer_pattern=_PATTERN,
    prefix_pattern=_PREFIX,
    moe=MoEConfig(num_experts=160, num_experts_per_tok=6,
                  num_shared_experts=2, expert_d_ff=1536),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
))
