"""Data-parallel gradient exchange and the counted collectives of Alg. 1."""
from . import collectives  # noqa: F401
from .grad_compress import (COMM, allreduce_mean,  # noqa: F401
                            comm_words_compressed, comm_words_exact,
                            compress_and_allreduce, init_error_fb,
                            leaf_seed, reset_comm, reshard_error_fb,
                            worker_rank, world_size)
