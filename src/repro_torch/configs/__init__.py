"""Architecture config registry of the port.

Importing this package registers the port's architectures with
``repro_torch.config``: the dense GQA models of the serving and training
slices (internlm2-1.8b) and of the dense attention variants
(gemma3-1b: sliding-window layers, prefix layers, tied embeddings,
head_dim 256; phi3-medium-14b; granite-34b: MQA and a GELU FFN;
internvl2-76b: stub vision tokens) and of the mixture-of-experts slice
(granite-moe-1b-a400m: 32 experts, top 8; deepseek-v2-236b: MLA, a
dense prefix layer, then 160 routed experts with 2 shared) and of the
hybrid slice (jamba-1.5-large-398b: Mamba layers with one attention
layer in eight, 16 experts top 2 on every other layer) and of the RWKV
slice (rwkv6-3b: attention-free, the WKV recurrence and the relu^2
channel mix in every layer) and of the encoder-decoder slice
(whisper-tiny: a non-causal encoder over stub audio frames, a decoder
with cross-attention, sinusoidal positions and no rope).
``configs.ndp_sim`` holds the simulator's machines, workloads and
presets.
"""
from repro_torch.configs import (deepseek_v2_236b,  # noqa: F401
                                 gemma3_1b, granite_34b,
                                 granite_moe_1b_a400m, internlm2_1_8b,
                                 internvl2_76b, jamba_1_5_large_398b,
                                 phi3_medium_14b, rwkv6_3b, whisper_tiny)
