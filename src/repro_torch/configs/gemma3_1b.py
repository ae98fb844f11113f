"""gemma3-1b [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144, head_dim=256.
5:1 local:global attention interleave, sliding window 512, 128k context
(32k for the 1b variant upstream; we honor the assigned shape suite).
"""
from repro_torch.config import (ATTN, ATTN_LOCAL, DENSE_FF, ArchConfig,
                                register)

# one period = 5 sliding-window layers then 1 global layer.
# 26 layers = 2 unscanned local layers (prefix) + 4 periods of 6.
_PREFIX = ((ATTN_LOCAL, DENSE_FF),) * 2
_PATTERN = ((ATTN_LOCAL, DENSE_FF),) * 5 + ((ATTN, DENSE_FF),)

CONFIG = register(ArchConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    layer_pattern=_PATTERN,
    prefix_pattern=_PREFIX,
    window_size=512,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
))
