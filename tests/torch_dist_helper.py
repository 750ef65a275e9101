"""Run a function in ``world`` gloo processes on the CPU (the port's
stand-in for the reference's fake XLA devices) and collect each rank's
result.  Imports no jax: the workers import only torch and the port."""
import multiprocessing as mp
import socket
import traceback

TIMEOUT_S = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, queue, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        try:
            queue.put((rank, fn(rank, world, *args), None))
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — reported to the parent
        queue.put((rank, None, traceback.format_exc()))


def run_workers(fn, world: int, *args):
    """``[fn(rank, world, *args) for rank in range(world)]``, each in its
    own process of one gloo group."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, port, queue,
                                              args))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = [None] * world, []
    try:
        for _ in range(world):
            rank, res, err = queue.get(timeout=TIMEOUT_S)
            if err:
                errors.append(f"rank {rank}:\n{err}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("\n".join(errors))
    return results


def exchange_worker(rank, world, grads, fbs, decisions, r, step):
    """One worker of the sketched exchange: its own grads and error
    buffers (numpy trees, one per rank) in, (g_hat, e', words moved) out."""
    import numpy as np
    import torch

    from repro_torch.parallel import grad_compress as gc

    def tree(d):
        return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    g, e = tree(grads[rank]), tree(fbs[rank])
    gc.reset_comm()
    gc.compress_and_allreduce(g, e, step=step, rank=r, decisions=decisions)
    return ({k: v.numpy() for k, v in g.items()},
            {k: v.numpy() for k, v in e.items()}, gc.COMM["words"])
