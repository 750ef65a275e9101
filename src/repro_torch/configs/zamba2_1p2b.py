"""Zamba2-1.2B — Mamba-2 backbone with a shared attention block.
[arXiv:2411.15242; hf]
38L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=32000 ssm_state=64.

Long-context: above 64k the shared block's attention switches to Nyström
landmark attention (the paper's sketched two-product structure), keeping the
hybrid sub-quadratic for the long_500k cell."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    d_inner=4096,
    ssm_heads=64,               # headdim 64
    d_conv=4,
    mamba_version=2,
    shared_attn_every=6,
    nystrom_attn_above=65536,
    nystrom_landmarks=256,
)
