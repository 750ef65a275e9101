"""Gemma-2 2B — alternating local/global attention, logit softcaps,
post-norms, tied embeddings. [arXiv:2408.00118; hf]
26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    window=4096,
    alt_local_global=True,       # even layers local(4096), odd global
    attn_softcap=50.0,
    final_softcap=30.0,
    use_post_norms=True,
    tie_embeddings=True,
    embed_scale=True,
    activation="gelu",           # GeGLU
    rope_theta=1e4,
)
