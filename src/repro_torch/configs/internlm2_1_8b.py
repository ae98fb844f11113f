"""internlm2-1.8b [arXiv:2403.17297].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""
from repro_torch.config import ATTN, DENSE_FF, ArchConfig, register

CONFIG = register(ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92_544,
    layer_pattern=((ATTN, DENSE_FF),),
))
