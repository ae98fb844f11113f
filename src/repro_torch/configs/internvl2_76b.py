"""internvl2-76b [arXiv:2404.16821] — InternViT-6B + Llama3-70B-style LM.

Assigned backbone: 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The InternViT vision frontend is a STUB per the assignment: ``input_specs()``
provides precomputed patch embeddings (256 visual tokens of d_model) which
are prepended to the text embedding sequence.
"""
from repro_torch.config import ATTN, DENSE_FF, ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=128_256,
    layer_pattern=((ATTN, DENSE_FF),),
    vision_tokens=256,
    rope_theta=500_000.0,
))
