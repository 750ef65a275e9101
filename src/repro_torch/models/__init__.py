"""The LM substrate of the port, all six families (dense, MoE, SSM,
hybrid, encoder-decoder, VLM): training and serving."""
from .api import (ModelAPI, count_active_params, count_params_split,  # noqa: F401
                  get_api, model_flops, param_leaves, unflatten_like)
from .common import count_params  # noqa: F401
from .transformer import (cache_specs, decode_step, init_cache,  # noqa: F401
                          lm_hidden, lm_init, lm_loss, prefill)
