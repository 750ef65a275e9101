"""repro_torch.plan — the cost model, the execution planner and its
measured autotuner (the reference's ``repro.plan``).

``plan_sketch`` / ``plan_nystrom`` / ``plan_stream`` price every variant
the port can run (Alg. 1 grids, Alg. 2 redist / no_redist / two-grid, the
one-card ``cuda_fused`` kernels and ``local_torch``, streaming ingest,
the sparse family) on a :class:`MachineModel`, audit the winner against
the lower bounds, and return a :class:`Plan` whose ``execute`` makes the
call it names; ``autotune`` refines the choice by timing the candidates
on the device; ``explain`` renders the decision.

  model.py    — machine entries and analytic per-variant costs
  planner.py  — candidates, Plan, dispatch, the gradient-exchange plan
  autotune.py — the measured autotuner, its cache and shipped decisions,
                and the calibration of the machine model from its records
  explain.py  — reports (regimes, crossovers, bound gaps)
"""
# ``autotune`` is the module, callable as its ``autotune`` function
# (plan/autotune.py), so that ``repro_torch.plan.autotune(plan)`` tunes, as
# the reference's does, and the module's names stay reachable from it.
from . import autotune  # noqa: F401
from .autotune import (PRESET_ENTRIES, AutotuneCache,  # noqa: F401
                       cache_key, calibrate_machine_model, default_timer,
                       load_sweep, save_sweep, shape_bucket, sweep_records)
from .explain import (bound_report, explain,  # noqa: F401
                      explain_train_compression, nystrom_crossover_P,
                      regime_sweep, sketch_zero_comm_limit)
from .model import (H100_GLOO, PRESETS, SPARSE_SCATTER_PENALTY,  # noqa: F401
                    Cost, MachineModel, alg1_communicating_cost, alg1_cost,
                    alg2_cost, alg2_fused_cost, choose_bucket_edges,
                    device_kind_tag, fused_redistribute_words,
                    grad_allreduce_cost, grad_compress_cost,
                    hbm_roofline_words, local_cost, local_torch_cost,
                    nystrom_local_cost, nystrom_local_torch_cost,
                    probe_machine, ragged_bucket_cost, redistribute_words,
                    sparse_payload_words, sparse_sketch_cost,
                    sparse_stream_update_cost, stream_reshard_traffic_words,
                    stream_reshard_words, stream_update_cost)
from .planner import (Candidate, LeafDecision, Plan,  # noqa: F401
                      TrainCompressionPlan, plan_nystrom, plan_sketch,
                      plan_stream, plan_train_compression)
