"""Deterministic synthetic data pipeline (the reference's
``data/pipeline.py``): token streams and the stub frontends' features.

Stateless by construction: batch t is a pure function of (seed, step),
drawn from an explicit ``torch.Generator`` seeded by both, so a restart
resumes the stream exactly from the step counter alone.  The tokens follow
the reference's Markov recurrence ``x_{t+1} = (31·x_t + 17·n_t + 3) mod
vocab`` with noise n_t uniform in [0, 7), so the loss has structure to
learn.  A VLM batch adds ``frontend_feats`` (B, num_frontend_tokens,
frontend_dim) and an encoder-decoder batch adds ``frames`` (B, enc_seq,
d_model), both standard normal f32 drawn from the same generator after
the tokens.  The draws are torch's, not the reference's threefry bits;
tests hand both packages one numpy batch instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # modality stubs
    frontend: str = "none"        # none | vision | audio
    frontend_dim: int = 0
    num_frontend_tokens: int = 0
    enc_seq: int = 0
    d_model: int = 0


def _generator(seed: int, step: int) -> torch.Generator:
    # the CPU generator (mt19937) keeps only the low 32 bits of its seed,
    # so the seed is mixed into them: step + seed * 0x9E3779B9 (mod 2**32),
    # which is the step alone at seed 0
    return torch.Generator().manual_seed(
        (int(step) + int(seed) * 0x9E3779B9) & 0xFFFFFFFF)


def synth_tokens(gen: torch.Generator, batch: int, seq: int,
                 vocab: int) -> torch.Tensor:
    """(batch, seq) int64: x_0 uniform, then the Markov recurrence."""
    x = torch.randint(0, vocab, (batch,), generator=gen)
    noise = torch.randint(0, 7, (batch, seq), generator=gen)
    out = torch.empty((batch, seq), dtype=torch.int64)
    out[:, 0] = x
    for t in range(1, seq):
        x = (x * 31 + noise[:, t - 1] * 17 + 3) % vocab
        out[:, t] = x
    return out


def make_batch(cfg: DataConfig, step: int,
               device=None) -> Dict[str, torch.Tensor]:
    """Batch ``step``: {"tokens", "labels"}, each (global_batch, seq_len),
    labels the tokens shifted by one; plus ``frontend_feats`` (vision) or
    ``frames`` (audio) when the config has that frontend."""
    gen = _generator(cfg.seed, step)
    B = cfg.global_batch
    toks = synth_tokens(gen, B, cfg.seq_len + 1, cfg.vocab)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend == "vision" and cfg.num_frontend_tokens:
        batch["frontend_feats"] = torch.randn(
            (B, cfg.num_frontend_tokens, cfg.frontend_dim), generator=gen)
    if cfg.frontend == "audio" and cfg.enc_seq:
        batch["frames"] = torch.randn((B, cfg.enc_seq, cfg.d_model),
                                      generator=gen)
    if device is not None:
        batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
    return batch


class Pipeline:
    """Step-indexed iterator over :func:`make_batch` (on ``device`` when
    given)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, device=None):
        self.cfg = cfg
        self.step = start_step
        self.device = device

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        b = make_batch(self.cfg, self.step, self.device)
        self.step += 1
        return b

    def state(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.cfg.seed}

    @classmethod
    def from_state(cls, cfg: DataConfig, state: Dict[str, int], **kw):
        if state["seed"] != cfg.seed:
            raise ValueError(f"seed mismatch on restore: checkpoint "
                             f"{state['seed']}, config {cfg.seed}")
        return cls(cfg, start_step=state["step"], **kw)


def data_config_for(model_cfg, shape, seed: int = 0) -> DataConfig:
    """The :class:`DataConfig` of ``model_cfg`` at ``shape`` (anything with
    ``seq_len`` and ``global_batch``), as the reference's: a VLM's
    ``seq_len`` counts its frontend tokens, so its text takes
    ``seq_len - num_frontend_tokens``; an encoder-decoder adds frames of
    ``enc_seq`` x ``d_model``."""
    fam = model_cfg.family
    n_front = model_cfg.num_frontend_tokens
    return DataConfig(
        vocab=model_cfg.vocab,
        seq_len=shape.seq_len - (n_front if fam == "vlm" else 0),
        global_batch=shape.global_batch, seed=seed,
        frontend=("vision" if fam == "vlm"
                  else "audio" if fam == "encdec" else "none"),
        frontend_dim=model_cfg.frontend_dim, num_frontend_tokens=n_front,
        enc_seq=model_cfg.enc_seq if fam == "encdec" else 0,
        d_model=model_cfg.d_model)
