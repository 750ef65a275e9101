"""The parts of the reference's planner that the port runs: the machine
model and the costs of every variant (Alg. 1, Alg. 2, one-card sketches,
stream updates, sparse slabs, the gradient exchange, ragged buckets), the
calibration of the network terms from measured records, and the per-leaf
pricing of the DP gradient exchange (words only)."""
from .autotune import (calibrate_machine_model, load_sweep,  # noqa: F401
                       save_sweep)
from .explain import explain_train_compression  # noqa: F401
from .model import (H100_GLOO, PRESETS, SPARSE_SCATTER_PENALTY,  # noqa: F401
                    Cost, MachineModel, alg1_communicating_cost, alg1_cost,
                    alg2_cost, alg2_fused_cost, choose_bucket_edges,
                    device_kind_tag, fused_redistribute_words,
                    grad_allreduce_cost, grad_compress_cost,
                    hbm_roofline_words, local_cost, nystrom_local_cost,
                    probe_machine, ragged_bucket_cost, redistribute_words,
                    sparse_payload_words, sparse_sketch_cost,
                    sparse_stream_update_cost, stream_update_cost)
from .planner import (LeafDecision, TrainCompressionPlan,  # noqa: F401
                      plan_train_compression)
