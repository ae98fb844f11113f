"""whisper-tiny [arXiv:2212.04356].

Enc-dec: 4 encoder + 4 decoder layers, d_model=384 6H d_ff=1536 vocab=51865.
The conv audio frontend is a stub: the batch carries precomputed frame
embeddings (1500 frames of d_model, ``train.data.add_modality_stubs``)
and the encoder consumes them directly.  No rope: sinusoidal positions
are added at embed time, in the encoder and the decoder.
"""
from repro_torch.config import ATTN, DENSE_FF, ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,            # decoder layers
    encoder_layers=4,
    encoder_seq_len=1500,    # 30 s of audio at 50 Hz after the conv stub
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51_865,
    layer_pattern=((ATTN, DENSE_FF),),
    gated_ffn=False,         # whisper uses a GELU MLP
    rope_theta=0.0,          # sinusoidal positions instead
    tie_embeddings=True,
))
