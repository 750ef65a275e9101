"""Deterministic synthetic data pipeline (the reference's
``data/pipeline.py``, token streams only).

Stateless by construction: batch t is a pure function of (seed, step),
drawn from an explicit ``torch.Generator`` seeded by both, so a restart
resumes the stream exactly from the step counter alone.  The tokens follow
the reference's Markov recurrence ``x_{t+1} = (31·x_t + 17·n_t + 3) mod
vocab`` with noise n_t uniform in [0, 7), so the loss has structure to
learn.  The draws are torch's, not the reference's threefry bits; tests
hand both packages one numpy batch instead.
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


def _generator(seed: int, step: int) -> torch.Generator:
    # one 63-bit seed per (seed, step): the step in the low 32 bits
    return torch.Generator().manual_seed(
        ((int(seed) & 0x7FFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))


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
    labels the tokens shifted by one."""
    toks = synth_tokens(_generator(cfg.seed, step), cfg.global_batch,
                        cfg.seq_len + 1, cfg.vocab)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
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
