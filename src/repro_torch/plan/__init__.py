"""The parts of the reference's planner that the port runs: per-leaf
pricing of the DP gradient exchange (words only) and the costs of Alg. 1,
Alg. 2, a sharded stream update and a sparse slab's payload."""
from .explain import explain_train_compression  # noqa: F401
from .model import (Cost, alg1_communicating_cost, alg1_cost,  # noqa: F401
                    alg2_cost, alg2_fused_cost, fused_redistribute_words,
                    grad_allreduce_cost, grad_compress_cost,
                    redistribute_words, sparse_payload_words,
                    stream_update_cost)
from .planner import (LeafDecision, TrainCompressionPlan,  # noqa: F401
                      plan_train_compression)
