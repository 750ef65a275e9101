"""AdamW and LR schedules of the port."""
from . import adamw, schedule  # noqa: F401
