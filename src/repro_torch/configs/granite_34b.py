"""granite-34b [arXiv:2405.04324] — Granite Code 34B.

88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152, llama-style arch.
MQA (single kv head) makes the metadata:data ratio of the paged-KV path the
highest of the assigned pool (see DESIGN.md §4).
"""
from repro_torch.config import ATTN, DENSE_FF, ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24_576,
    vocab_size=49_152,
    layer_pattern=((ATTN, DENSE_FF),),
    gated_ffn=False,   # granite-code 34b uses GPT-style MLP (gelu)
))
