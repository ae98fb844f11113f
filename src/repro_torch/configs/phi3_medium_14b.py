"""phi3-medium-14b [arXiv:2404.14219].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352, RoPE + SwiGLU.
"""
from repro_torch.config import ATTN, DENSE_FF, ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17_920,
    vocab_size=100_352,
    layer_pattern=((ATTN, DENSE_FF),),
))
