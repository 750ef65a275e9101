"""Falcon-Mamba-7B — pure Mamba-1, attention-free.
[arXiv:2410.05355; unverified]
64L d_model=4096 d_ff=0 vocab=65024 ssm_state=16."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,                   # unused (attention-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab=65024,
    ssm_state=16,
    d_inner=8192,
    dt_rank=256,
    d_conv=4,
    mamba_version=1,
)
