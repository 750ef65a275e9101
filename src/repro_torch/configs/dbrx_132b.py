"""DBRX-132B — 16-expert top-4 fine-grained MoE.
[hf:databricks/dbrx-base; unverified]
40L d_model=6144 48H (GQA kv=8) d_ff=10752/expert vocab=100352."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab=100352,
    n_experts=16,
    top_k=4,
    rope_theta=5e5,
)
