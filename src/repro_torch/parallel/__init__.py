"""Data-parallel gradient exchange of the port."""
from .grad_compress import (COMM, allreduce_mean,  # noqa: F401
                            comm_words_compressed, comm_words_exact,
                            compress_and_allreduce, init_error_fb,
                            leaf_seed, reset_comm, reshard_error_fb,
                            worker_rank, world_size)
