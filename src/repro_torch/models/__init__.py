"""The LM substrate of the port, dense family, for training."""
from .api import ModelAPI, get_api, param_leaves, unflatten_like  # noqa: F401
from .transformer import lm_hidden, lm_init, lm_loss  # noqa: F401
