"""Config dataclasses of the port: model architecture and run settings.

A copy of the reference's ``configs/base.py`` (which imports jax.numpy for
its dtype table) with torch dtypes.  Field names, defaults, ``reduced()``
and ``layer_windows()`` are the reference's, so a config built here and
one built there describe the same model.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FULL_WINDOW = 1 << 30


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    # attention variants
    window: int = 0               # >0: sliding-window width for SWA layers
    alt_local_global: bool = False  # gemma-2: even layers local, odd global
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    use_post_norms: bool = False  # gemma-2 double-norm residual
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    activation: str = "silu"      # silu | gelu
    embed_scale: bool = False     # gemma: x *= sqrt(d)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_dispatch: str = "scatter"   # scatter (optimized) | einsum (GShard)

    # SSM
    ssm_state: int = 0
    d_inner: int = 0
    dt_rank: int = 0
    d_conv: int = 4
    mamba_version: int = 1
    ssm_heads: int = 0            # mamba2
    ssm_chunk: int = 256

    # hybrid (zamba): one shared attention+FFN block applied every k layers
    shared_attn_every: int = 0

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500
    abs_pos_embed: bool = False
    max_pos: int = 0              # learned abs positions table size

    # modality frontend stubs
    frontend: str = "none"        # none | vision | audio
    frontend_dim: int = 0         # precomputed embedding dim (stub output)
    num_frontend_tokens: int = 0

    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    loss_chunk: int = 512

    # long-context attention substitution (paper technique): use Nyström
    # landmark attention for full-attention blocks above this seq length
    nystrom_attn_above: int = 0   # 0 = never
    nystrom_landmarks: int = 256

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def layer_windows(self, seq_len: int) -> Tuple[int, ...]:
        """Effective attention window per layer (FULL_WINDOW = no limit)."""
        if self.alt_local_global:
            return tuple(self.window if (i % 2 == 0) else FULL_WINDOW
                         for i in range(self.n_layers))
        if self.window > 0:
            return tuple(self.window for _ in range(self.n_layers))
        return tuple(FULL_WINDOW for _ in range(self.n_layers))

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: same family and topology, tiny dims (the
        reference's ``reduced()``)."""
        shrink = dict(
            n_layers=min(self.n_layers, 2 if self.family != "hybrid" else 5),
            d_model=64,
            n_heads=4,
            n_kv_heads=(min(self.n_kv_heads, 2)
                        if self.n_kv_heads < self.n_heads else 4),
            d_ff=128,
            vocab=256,
            head_dim=16,
            window=min(self.window, 8) if self.window else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            d_inner=128 if self.d_inner else 0,
            dt_rank=8 if self.dt_rank else 0,
            ssm_heads=4 if self.ssm_heads else 0,
            ssm_chunk=8,
            shared_attn_every=2 if self.shared_attn_every else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=16 if self.n_enc_layers else self.enc_seq,
            max_pos=4096 if self.max_pos else 0,
            frontend_dim=32 if self.frontend_dim else 0,
            num_frontend_tokens=(8 if self.num_frontend_tokens else 0),
            dtype="float32",
            loss_chunk=16,
            nystrom_landmarks=4,
        )
        shrink.update(overrides)
        return dataclasses.replace(self, **shrink)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training-run settings consumed by the launcher."""
    steps: int = 200
    learning_rate: float = 3e-4
    warmup_steps: int = 20
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    seed: int = 0
    remat: bool = True
    # sketched gradient compression: rank (0 = off)
    grad_compress_rank: int = 0
    grad_compress_min_dim: int = 1024      # legacy heuristic (planner wins)
    # fault tolerance
    checkpoint_every: int = 50
    checkpoint_dir: str = "repro_torch_ckpt"
    keep_checkpoints: int = 3
    # straggler monitor
    straggler_ewma: float = 0.9
    straggler_sigma: float = 3.0
