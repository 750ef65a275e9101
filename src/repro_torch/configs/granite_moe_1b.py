"""Granite-3.0 1B-A400M — fine-grained MoE, 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    n_experts=32,
    top_k=8,
    tie_embeddings=True,
    rope_theta=1e4,
)
