"""Whisper-tiny — encoder-decoder, conv frontend stubbed (precomputed frame
embeddings per assignment). [arXiv:2212.04356; unverified]
4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.

The reference's ``configs/whisper_tiny.py``, field for field.  Positions
beyond Whisper's native 448-token decoder context index the learned
table (``max_pos`` rows); long contexts are not applicable to an
encoder-decoder."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,                  # decoder layers
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=51865,
    enc_seq=1500,
    abs_pos_embed=True,
    max_pos=65536,
    norm="layernorm",
    activation="gelu",
)
