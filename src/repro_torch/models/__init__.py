"""The LM substrate of the port, dense, MoE, SSM and hybrid families:
training and serving."""
from .api import (ModelAPI, count_active_params, count_params_split,  # noqa: F401
                  get_api, model_flops, param_leaves, unflatten_like)
from .transformer import (cache_specs, decode_step, init_cache,  # noqa: F401
                          lm_hidden, lm_init, lm_loss, prefill)
