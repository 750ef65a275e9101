"""The training half of the reference's planner: per-leaf pricing of the
DP gradient exchange (words only)."""
from .explain import explain_train_compression  # noqa: F401
from .model import Cost, grad_allreduce_cost, grad_compress_cost  # noqa: F401
from .planner import (LeafDecision, TrainCompressionPlan,  # noqa: F401
                      plan_train_compression)
