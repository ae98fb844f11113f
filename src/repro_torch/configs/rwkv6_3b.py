"""rwkv6-3b (Finch) [arXiv:2404.05892].

32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.
Data-dependent decay; head_size=64 -> 40 heads; per-head matrix state
(64x64) replaces the KV cache entirely, so serving it makes no
paged-attention call and the engine's page tables map nothing that a
layer reads.  The channel mix is the relu^2 MLP (two matrices).
"""
from repro_torch.config import DENSE_FF, RWKV, ArchConfig, RWKVConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=8960,
    vocab_size=65_536,
    layer_pattern=((RWKV, DENSE_FF),),
    rwkv=RWKVConfig(head_size=64, decay_lora=64, gate_lora=32),
    gated_ffn=False,   # rwkv channel-mix is relu^2 MLP (2-matrix)
))
