"""The parts of the reference's planner that the port runs: per-leaf
pricing of the DP gradient exchange (words only) and Alg. 1's costs."""
from .explain import explain_train_compression  # noqa: F401
from .model import (Cost, alg1_communicating_cost, alg1_cost,  # noqa: F401
                    grad_allreduce_cost, grad_compress_cost)
from .planner import (LeafDecision, TrainCompressionPlan,  # noqa: F401
                      plan_train_compression)
