"""InternVL2-26B — InternViT-6B (stub frontend) + InternLM2-20B backbone.
[arXiv:2404.16821; hf]  48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553.  The vision tower is a STUB per assignment: the batch
supplies precomputed patch embeddings (256 tokens, dim 3200) which the
trainable projector maps into the LM stream.

The reference's ``configs/internvl2_26b.py``, field for field."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92553,
    rope_theta=1e6,
    frontend="vision",
    frontend_dim=3200,
    num_frontend_tokens=256,
)
