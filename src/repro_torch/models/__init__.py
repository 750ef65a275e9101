"""The LM substrate of the port, dense family, for training."""
from .api import (ModelAPI, count_active_params, count_params_split,  # noqa: F401
                  get_api, model_flops, param_leaves, unflatten_like)
from .transformer import lm_hidden, lm_init, lm_loss  # noqa: F401
