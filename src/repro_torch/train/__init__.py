"""Training of the port: state, step factories and the fault-tolerant
loop."""
from .loop import LoopResult, StragglerMonitor, train_loop  # noqa: F401
from .state import TrainState  # noqa: F401
from .step import (init_state, make_dp_compressed_step,  # noqa: F401
                   make_train_step)
