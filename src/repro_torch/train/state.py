"""Train state of the port: params, optimizer state, step counter and the
worker's error-feedback buffers.  Its tensors are updated in place by the
step functions (``train/step.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.optim.adamw import AdamWState


@dataclasses.dataclass
class TrainState:
    params: Any                       # nested dict of leaf tensors
    opt: AdamWState
    step: int = 0
    error_fb: Optional[Any] = None    # sketched-grad-compression feedback
