"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) expert_d_ff=512 vocab=49155, MoE 32e top-8.
Every layer uses a routed MoE FFN (granite-3.0 MoE family).
"""
from repro_torch.config import ATTN, MOE_FF, ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    layer_pattern=((ATTN, MOE_FF),),
    moe=MoEConfig(num_experts=32, num_experts_per_tok=8, expert_d_ff=512),
    tie_embeddings=True,
    gated_ffn=True,
))
