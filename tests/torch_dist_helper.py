"""Run a function in ``world`` gloo processes on the CPU (the port's
stand-in for the reference's fake XLA devices) and collect each rank's
result.  Imports no jax: the workers import only torch and the port."""
import multiprocessing as mp
import os
import shutil
import tempfile
import traceback

TIMEOUT_S = 180


def _entry(fn, rank, world, store, queue, args):
    import datetime

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            queue.put((rank, fn(rank, world, *args), None))
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — reported to the parent
        queue.put((rank, None, traceback.format_exc()))


def run_workers(fn, world: int, *args):
    """``[fn(rank, world, *args) for rank in range(world)]``, each in its
    own process of one gloo group.  The group meets at a ``file://``
    store in a fresh temporary directory (no port to race for); a world
    that has not answered in ``TIMEOUT_S`` seconds is killed."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="torch_dist_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, store, queue,
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
        shutil.rmtree(tmp, ignore_errors=True)
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


def alg1_worker(rank, world, A, seed, r, grids, kinds, auto_cases):
    """One rank of the Alg. 1 cases on the CPU: every grid of ``grids``
    with every kind, the communicating baseline on every grid,
    ``rand_matmul_auto`` on each ``(A, r)`` of ``auto_cases``, the
    collectives' layouts, and a grid larger than the world.  Returns
    numpy blocks (None past a grid) and the words this rank received."""
    import numpy as np
    import torch

    from repro_torch.core import sketch as sk
    from repro_torch.parallel import collectives as col

    def arr(t):
        return None if t is None else t.numpy()

    def comm():
        return {k: dict(v) for k, v in col.COMM.items()}

    At = torch.from_numpy(np.array(A))
    out = {"alg1": {}, "communicating": {}, "auto": [], "layout": {}}
    for grid in grids:
        g = sk.make_grid_groups(*grid)
        out.setdefault("coords", {})[grid] = g.coords
        for kind in kinds:
            col.reset_comm()
            blk = sk.rand_matmul(sk.input_block(At, g), seed, r, g,
                                 kind=kind)
            words = comm()
            out["alg1"][(grid, kind)] = (arr(blk), words,
                                         arr(sk.gather_output(blk, g)))
        col.reset_comm()
        blk = sk.rand_matmul_communicating(sk.input_block(At, g), seed, r,
                                           g)
        out["communicating"][grid] = (arr(blk), comm(),
                                      arr(sk.gather_output(blk, g)))
    for A_s, r_s in auto_cases:
        col.reset_comm()
        blk, gm, g = sk.rand_matmul_auto(torch.from_numpy(np.array(A_s)),
                                         seed, r_s)
        out["auto"].append((gm.shape, gm.regime, gm.bandwidth_words,
                            arr(blk), comm(), arr(sk.gather_output(blk, g))))
    # the layouts alone, on values that every sum keeps exact
    x = (torch.arange(6, dtype=torch.float32).reshape(2, 3)
         + 100.0 * rank)
    g = sk.make_grid_groups(1, 1, world)
    out["layout"]["dim1"] = col.all_gather(x, 1, g.p3_group, world).numpy()
    out["layout"]["dim0"] = col.all_gather(x, 0, g.p3_group, world).numpy()
    y = (rank + 1.0) * torch.arange(24, dtype=torch.float32).reshape(8, 3)
    out["layout"]["reduce_scatter"] = col.reduce_scatter(
        y, None, world).numpy()
    try:
        sk.make_grid_groups(world, 2, 1)
    except ValueError as e:
        out["too_big"] = str(e)
    return out


def alg1_card_worker(rank, world, n1, n2, r, seed, grids):
    """One rank of Alg. 1 on cuda:0 (every rank shares the one card):
    A drawn on the card from a seeded generator, each grid's block against
    the one-device card sketch's block.  Returns, per grid, (bitwise,
    rel_fro, words received, sketch_fwd launches, block device)."""
    import torch

    from repro_torch.core import sketch as sk
    from repro_torch.kernels import LAUNCHES, reset_launches, sketch_block
    from repro_torch.parallel import collectives as col

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    A = torch.randn(n1, n2, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    B_one = sketch_block(A, seed, r)
    out = {}
    for grid in grids:
        g = sk.make_grid_groups(*grid)
        blk_in = sk.input_block(A, g)
        col.reset_comm()
        reset_launches()
        blk = sk.rand_matmul(blk_in, seed, r, g)
        torch.cuda.synchronize()
        ref = sk.output_block(B_one, g)
        err = float(torch.linalg.norm(blk - ref) / torch.linalg.norm(ref))
        out[grid] = (torch.equal(blk, ref), err, col.comm_words(),
                     LAUNCHES["sketch_fwd"], blk.device.type)
    return out


def alg2_worker(rank, world, cases, seed, kinds, stage_cases, subgrid):
    """One rank of the 1-D Alg. 2 cases on the CPU.  ``cases`` maps a
    name to a symmetric numpy A and r: both variants with every kind of
    ``kinds``, ``nystrom_auto`` and the first stage alone on each; the
    second stages alone on each ``(B, r, salt)`` of ``stage_cases``; both
    variants of the first case on a ``subgrid`` of ``(subgrid, 1, 1)``
    ranks; the all-to-all on exact values.  Returns numpy blocks, their
    gathers and the words this rank received, by kind."""
    import numpy as np
    import torch

    from repro_torch.core import nystrom as nys
    from repro_torch.core import sketch as sk
    from repro_torch.parallel import collectives as col

    def arr(t):
        return None if t is None else t.numpy()

    def comm():
        return {k: dict(v) for k, v in col.COMM.items()}

    fns = {"no_redist": nys.nystrom_no_redist, "redist": nys.nystrom_redist}
    g = sk.make_grid_groups(world, 1, 1)
    out = {"coords": g.coords, "alg2": {}, "auto": {}, "first": {},
           "stage": {}, "sub": {}}
    for name, (A, r) in cases.items():
        At = torch.from_numpy(np.array(A))
        blk_in = sk.input_block(At, g)
        for variant, fn in fns.items():
            for kind in kinds:
                col.reset_comm()
                B, C = fn(blk_in, seed, r, g, kind=kind)
                words = comm()
                out["alg2"][(name, variant, kind)] = (
                    arr(B), arr(C), words, arr(nys.nystrom_gather(B, g,
                                                                  variant)),
                    arr(nys.nystrom_gather(C, g, variant)))
        col.reset_comm()
        B, C, ga, variant = nys.nystrom_auto(At, seed, r)
        out["auto"][name] = (variant, ga.shape, arr(B), arr(C), comm())
        col.reset_comm()
        B = nys._sketch_rows_1d(blk_in, seed, r, g, "normal")
        out["first"][name] = (arr(B), col.comm_words())
    for name, (B, r, salt) in stage_cases.items():
        b_blk = sk.input_block(torch.from_numpy(np.array(B)), g)
        col.reset_comm()
        C = nys.nystrom_second_stage_no_redist(b_blk, seed, r, g, salt=salt)
        out["stage"][(name, "no_redist")] = (
            None, arr(nys.nystrom_gather(C, g, "no_redist")), comm())
        col.reset_comm()
        Bk, Ck = nys.nystrom_second_stage_redist(b_blk, seed, r, g,
                                                 salt=salt)
        out["stage"][(name, "redist")] = (
            arr(nys.nystrom_gather(Bk, g, "redist")),
            arr(nys.nystrom_gather(Ck, g, "redist")), comm())
    name = next(iter(cases))
    A, r = cases[name]
    gs = sk.make_grid_groups(subgrid, 1, 1)
    for variant, fn in fns.items():
        col.reset_comm()
        B, C = fn(sk.input_block(torch.from_numpy(np.array(A)), gs), seed,
                  r, gs)
        out["sub"][variant] = (gs.coords, comm(),
                               arr(nys.nystrom_gather(B, gs, variant)),
                               arr(nys.nystrom_gather(C, gs, variant)))
    # the all-to-all alone, on exact values: rank q holds 100·q + arange
    x = (torch.arange(2 * 3 * world, dtype=torch.float32)
         .reshape(2, 3 * world) + 100.0 * rank)
    col.reset_comm()
    out["a2a"] = (col.all_to_all(x, None, world).numpy(), comm())
    col.reset_comm()
    one = col.all_to_all(x, None, 1)
    out["a2a_one"] = (one is x, comm())
    return out


def alg2_card_worker(rank, world, n, r, seed):
    """One rank of the 1-D Alg. 2 on cuda:0 (every rank shares the one
    card): a symmetric A drawn on the card from a seeded generator, both
    variants against the one-device card sketch (``sketch_block``) and
    ``sketch_t_block`` of it.  Returns, per variant, (B bitwise, C
    rel_fro, words received, launches, B and C devices)."""
    import torch

    from repro_torch.core import nystrom as nys
    from repro_torch.core import sketch as sk
    from repro_torch.kernels import (LAUNCHES, reset_launches, sketch_block,
                                     sketch_t_block)
    from repro_torch.parallel import collectives as col

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    G = torch.randn(n, n, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    A = (G + G.T) / 2
    B_one = sketch_block(A, seed, r)
    C_one = sketch_t_block(B_one, seed, r)
    g = sk.make_grid_groups(world, 1, 1)
    out = {}
    for variant, fn in (("no_redist", nys.nystrom_no_redist),
                        ("redist", nys.nystrom_redist)):
        blk_in = sk.input_block(A, g)
        col.reset_comm()
        reset_launches()
        B, C = fn(blk_in, seed, r, g)
        torch.cuda.synchronize()
        launches = {k: LAUNCHES[k] for k in ("sketch_fwd", "sketch_t",
                                             "gen_omega")}
        C_ref = nys.nystrom_block(C_one, g, variant)
        err = float(torch.linalg.norm(C - C_ref) / torch.linalg.norm(C_ref))
        out[variant] = (torch.equal(B, nys.nystrom_block(B_one, g, variant)),
                        err, col.comm_words(), launches,
                        (B.device.type, C.device.type))
    return out


def two_grid_worker(rank, world, spec):
    """One rank of the two-grid Alg. 2 cases on the CPU.  ``spec`` holds
    ``seed``, ``kinds``, ``cases`` (name -> symmetric numpy A and r),
    ``pairs`` (name -> (p, q) pairs: ``nystrom_two_grid`` with every kind,
    ``nystrom_two_grid_fused`` with the first; per name also
    ``nystrom_auto(variant="bound_driven")`` and, where P divides r, the
    1-D variants), ``stage`` (name -> numpy B, r, salt and (p, q) pairs:
    both second stages from B's p-layout blocks), ``general`` (name, p
    and q_perm tuples), ``subgrid`` (p, q on fewer ranks than the
    world), ``layout`` (an (n, r) and (p, q) pairs for ``redistribute``
    alone on exact values) and ``errors`` (name -> call arguments that
    must raise).  Returns numpy blocks (None
    past a grid), their gathers, each q-grid's coordinates and the words
    this rank received, by kind."""
    import numpy as np
    import torch

    from repro_torch.core import nystrom as nys
    from repro_torch.core import sketch as sk
    from repro_torch.parallel import collectives as col

    def arr(t):
        return None if t is None else t.numpy()

    def comm():
        return {k: dict(v) for k, v in col.COMM.items()}

    def result(B, C, gq):
        return {"B": arr(B), "C": arr(C), "words": comm(),
                "coords": gq.coords, "q": gq.shape,
                "B_full": arr(nys.two_grid_gather(B, gq, "B")),
                "C_full": arr(nys.two_grid_gather(C, gq, "C"))}

    seed = spec["seed"]
    out = {"two_grid": {}, "fused": {}, "stage": {}, "general": {},
           "auto": {}, "one_d": {}, "sub": {}, "layout": {}, "errors": {}}
    for name, (A, r) in spec["cases"].items():
        At = torch.from_numpy(np.array(A))
        for p, q in spec["pairs"][name]:
            blk = sk.input_block(At, sk.make_grid_groups(*p))
            gq = sk.make_grid_groups(*q)
            for kind in spec["kinds"]:
                col.reset_comm()
                B, C = nys.nystrom_two_grid(blk, seed, r, p=p, q=q,
                                            kind=kind)
                out["two_grid"][(name, p, q, kind)] = result(B, C, gq)
            col.reset_comm()
            B, C = nys.nystrom_two_grid_fused(blk, seed, r, p=p, q=q)
            out["fused"][(name, p, q)] = result(B, C, gq)
        col.reset_comm()
        B, C, gq, variant = nys.nystrom_auto(At, seed, r,
                                             variant="bound_driven")
        out["auto"][name] = (variant, result(B, C, gq))
        if r % world == 0:
            g = sk.make_grid_groups(world, 1, 1)
            for variant, fn in (("no_redist", nys.nystrom_no_redist),
                                ("redist", nys.nystrom_redist)):
                B, C = fn(sk.input_block(At, g), seed, r, g)
                out["one_d"][(name, variant)] = (arr(B), arr(C))
    for name, (B_np, r, salt, pairs) in spec["stage"].items():
        Bt = torch.from_numpy(np.array(B_np))
        for p, q in pairs:
            gp, gq = sk.make_grid_groups(*p), sk.make_grid_groups(*q)
            b_blk = sk.output_block(Bt, gp)
            for fused, fn in ((False, nys.nystrom_second_stage_two_grid),
                              (True,
                               nys.nystrom_second_stage_two_grid_fused)):
                col.reset_comm()
                B, C = fn(b_blk, seed, r, q, p=p, salt=salt)
                out["stage"][(name, p, q, fused)] = result(B, C, gq)
    for name, p, perm in spec["general"]:
        A, r = spec["cases"][name]
        g = sk.make_grid_groups(*p)
        blk = sk.input_block(torch.from_numpy(np.array(A)), g)
        col.reset_comm()
        B, C = nys.nystrom_general(blk, seed, r, g, q_perm=perm)
        q = tuple(p[a] for a in perm)
        gq = sk.make_grid_groups(*q, order=_perm_order(p, perm))
        out["general"][(name, p, perm)] = result(B, C, gq)
    name, p, q = spec["subgrid"]
    A, r = spec["cases"][name]
    At = torch.from_numpy(np.array(A))
    gq = sk.make_grid_groups(*q)
    for fused, fn in ((False, nys.nystrom_two_grid),
                      (True, nys.nystrom_two_grid_fused)):
        col.reset_comm()
        B, C = fn(sk.input_block(At, sk.make_grid_groups(*p)), seed, r,
                  p=p, q=q)
        out["sub"][fused] = result(B, C, gq)
    # the Redistribute alone, on exact values: B[a, b] = a·r + b
    (n, r), pairs = spec["layout"]
    full = torch.arange(n * r, dtype=torch.float32).reshape(n, r)
    for p, q in pairs:
        gp, gq = sk.make_grid_groups(*p), sk.make_grid_groups(*q)
        src = [nys._b_p_rect(gp.coords_of(d), p, n, r) for d in range(world)]
        dst = [nys._q_rect(gq.coords_of(d), q, "B", n, r)
               for d in range(world)]
        col.reset_comm()
        got = col.redistribute(sk.output_block(full, gp).contiguous(), src,
                               dst, rank, None)
        out["layout"][(p, q)] = (got.numpy(), comm(), gq.coords)
    for key, call in spec["errors"].items():
        try:
            _error_call(call, seed)
        except (ValueError, NotImplementedError) as e:
            out["errors"][key] = (type(e).__name__, str(e))
        else:
            out["errors"][key] = None
    return out


def _perm_order(p, perm):
    """The process rank at each q-grid rank when q-axis m is p-axis
    ``perm[m]`` of the row-major p-grid (an independent copy of
    ``nystrom_general``'s map)."""
    import itertools
    q = [p[a] for a in perm]
    order = []
    for qc in itertools.product(*(range(x) for x in q)):
        pc = [0, 0, 0]
        for m, a in enumerate(perm):
            pc[a] = qc[m]
        order.append((pc[0] * p[1] + pc[1]) * p[2] + pc[2])
    return tuple(order)


def _error_call(call, seed):
    """Run one refused call of ``two_grid_worker``'s ``errors``."""
    import torch

    from repro_torch.core import nystrom as nys
    from repro_torch.core import sketch as sk
    fn, shape, r, p, q = call
    x = torch.zeros(shape)
    if fn == "two_grid":
        nys.nystrom_two_grid(sk.input_block(x, sk.make_grid_groups(*p)),
                             seed, r, p=p, q=q)
    elif fn == "two_grid_fused":
        nys.nystrom_two_grid_fused(
            sk.input_block(x, sk.make_grid_groups(*p)), seed, r, p=p, q=q)
    elif fn in ("stage", "stage_fused"):
        stage = (nys.nystrom_second_stage_two_grid if fn == "stage"
                 else nys.nystrom_second_stage_two_grid_fused)
        stage(sk.output_block(x, sk.make_grid_groups(*p)), seed, r, q, p=p)
    elif fn == "general":
        g = sk.make_grid_groups(*p)
        nys.nystrom_general(sk.input_block(x, g), seed, r, g, q_perm=q)
    else:
        raise AssertionError(fn)


def two_grid_card_worker(rank, world, n, seed, runs):
    """One rank of the two-grid Alg. 2 on cuda:0 (every rank shares the
    one card): a symmetric A drawn on the card from a seeded generator,
    each ``(p, q, r)`` of ``runs`` through ``nystrom_two_grid`` against
    the one-device card sketch (``sketch_block``) and ``sketch_t_block``
    of it.  Returns, per run, (B bitwise, B rel_fro, C rel_fro, words
    received by kind, launches, B and C devices)."""
    import torch

    from repro_torch.core import nystrom as nys
    from repro_torch.core import sketch as sk
    from repro_torch.kernels import (LAUNCHES, reset_launches, sketch_block,
                                     sketch_t_block)
    from repro_torch.parallel import collectives as col

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    G = torch.randn(n, n, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    A = (G + G.T) / 2
    out = {}
    for p, q, r in runs:
        B_one = sketch_block(A, seed, r)
        C_one = sketch_t_block(B_one, seed, r)
        gq = sk.make_grid_groups(*q)
        blk_in = sk.input_block(A, sk.make_grid_groups(*p))
        col.reset_comm()
        reset_launches()
        B, C = nys.nystrom_two_grid(blk_in, seed, r, p=p, q=q)
        torch.cuda.synchronize()
        launches = {k: LAUNCHES[k] for k in ("sketch_fwd", "sketch_t",
                                             "gen_omega")}
        B_ref = nys.two_grid_block(B_one, gq, "B")
        C_ref = nys.two_grid_block(C_one, gq, "C")
        out[(p, q, r)] = (
            torch.equal(B, B_ref),
            float(torch.linalg.norm(B - B_ref) / torch.linalg.norm(B_ref)),
            float(torch.linalg.norm(C - C_ref) / torch.linalg.norm(C_ref)),
            {k: v["words"] for k, v in col.COMM.items()}, launches,
            (B.device.type, C.device.type))
    return out


def stream_dist_worker(rank, world, spec):
    """One rank of the distributed-stream cases on the CPU.  ``spec``
    holds ``seed``, ``A`` (an (n1, n2) numpy matrix) and ``r``;
    ``grids``: per grid a ``ShardedStreamingSketch`` fed ``slabs`` as
    full-shape deltas (``update``) and one fed them as row slabs
    (``update_rows``), and the one-shot ``rand_matmul``; ``ragged`` and
    ``aligned`` slab orders on ``(world, 1, 1)``; ``ckdir``: the ragged
    stream saved there and restored on each of ``restore_grids``;
    ``salt`` (grid, omega_salt, psi_salt); ``S``, ``s_seed``, ``s_r``,
    ``halves``: a symmetric stream on ``(world, 1, 1)`` finalized by each
    of ``variants``, and each variant's second stage on the one-shot
    blocks; ``service_seeds``: a grid service (``make_sketch_service``,
    ``max_resident=1``) with one stream a seed, each updated by ``S``
    once.  Returns numpy blocks, their gathers and the words this rank
    received per call, by kind."""
    import numpy as np
    import torch

    from repro_torch.core import nystrom as nys
    from repro_torch.core import sketch as sk
    from repro_torch.core.grid import select_two_grid_executable
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.parallel import collectives as col
    from repro_torch.serve import make_sketch_service
    from repro_torch.stream import ShardedStreamingSketch, StreamConfig
    from repro_torch.stream import distributed as sd

    def arr(t):
        return None if t is None else t.numpy().copy()

    def comm():
        return {k: dict(v) for k, v in col.COMM.items()}

    def gathered(st):
        return (arr(sk.gather_output(st.Y, st.mesh)),
                None if st.W is None
                else arr(sd.gather_corange(st.W, st.mesh)))

    def frame(i0, i1):
        H = torch.zeros_like(A)
        H[i0:i1] = A[i0:i1]
        return H

    seed, r = spec["seed"], spec["r"]
    A = torch.from_numpy(np.array(spec["A"]))
    n1, n2 = A.shape
    cfg = StreamConfig(n1=n1, n2=n2, r=r, seed=seed)
    out = {"grid": {}}
    for grid in spec["grids"]:
        g = sk.make_grid_groups(*grid)
        full = ShardedStreamingSketch(cfg, g, device="cpu")
        rows = ShardedStreamingSketch(cfg, g, device="cpu")
        w_full, w_rows = [], []
        for i0, i1 in spec["slabs"]:
            col.reset_comm()
            full.update(frame(i0, i1))
            w_full.append(comm())
            col.reset_comm()
            rows.update_rows(i0, A[i0:i1])
            w_rows.append(comm())
        oneshot = sk.rand_matmul(sk.input_block(A, g), seed, r, g)
        out["grid"][grid] = {
            "coords": g.coords, "full": gathered(full),
            "rows": gathered(rows), "Y_full": arr(full.Y),
            "Y_rows": arr(rows.Y), "oneshot": arr(oneshot),
            "words_full": w_full, "words_rows": w_rows,
            "num_updates": (full.num_updates, rows.num_updates)}
    g1 = sk.make_grid_groups(world, 1, 1)
    ragged = ShardedStreamingSketch(cfg, g1, device="cpu")
    for i0, i1 in spec["ragged"]:
        ragged.update_rows(i0, A[i0:i1])
    out["ragged"] = (arr(ragged.Y), arr(sk.rand_matmul(sk.input_block(A, g1),
                                                       seed, r, g1)))
    aligned_full = ShardedStreamingSketch(cfg, g1, device="cpu")
    aligned_rows = ShardedStreamingSketch(cfg, g1, device="cpu")
    for i0, i1 in spec["aligned"]:
        aligned_full.update(frame(i0, i1))
        aligned_rows.update_rows(i0, A[i0:i1])
    out["aligned"] = (gathered(aligned_full), gathered(aligned_rows))
    # save on (world, 1, 1), restore on other grids
    path = ragged.save(spec["ckdir"])
    out["restore"] = {"path": path, "saved": gathered(ragged)}
    for grid in spec["restore_grids"]:
        st = ShardedStreamingSketch.restore(
            spec["ckdir"], sk.make_grid_groups(*grid), device="cpu")
        out["restore"][grid] = (gathered(st), st.num_updates, st.cfg)
    grid, om_salt, psi_salt = spec["salt"]
    salted = ShardedStreamingSketch(
        StreamConfig(n1=n1, n2=n2, r=r, seed=seed, omega_salt=om_salt,
                     psi_salt=psi_salt), sk.make_grid_groups(*grid),
        device="cpu")
    salted.update(A)
    out["salt"] = gathered(salted)
    # the streamed Nystrom finalize on (world, 1, 1)
    S = torch.from_numpy(np.array(spec["S"]))
    cfg_s = StreamConfig(n1=S.shape[0], n2=S.shape[1], r=spec["s_r"],
                         seed=spec["s_seed"], corange=False)
    st = ShardedStreamingSketch(cfg_s, g1, device="cpu")
    for i0, i1 in spec["halves"]:
        H = torch.zeros_like(S)
        H[i0:i1] = S[i0:i1]
        st.update(H)
    one = sk.rand_matmul(sk.input_block(S, g1), cfg_s.seed, cfg_s.r, g1)
    out["finalize"] = {"Y_bitwise_oneshot": torch.equal(st.Y, one)}
    for variant in spec["variants"]:
        col.reset_comm()
        B, C = st.nystrom(variant)
        words = comm()
        B1, C1 = sd.nystrom_finalize(one, cfg_s, g1, variant)
        if variant == "bound_driven":
            q = select_two_grid_executable(S.shape[0], cfg_s.r, world,
                                           p=(world, 1, 1))[1]
            gq = sk.make_grid_groups(*q)
            Bf, Cf = (nys.two_grid_gather(B, gq, "B"),
                      nys.two_grid_gather(C, gq, "C"))
        else:
            layout = "redist" if variant == "redist" else "no_redist"
            Bf, Cf = (nys.nystrom_gather(B, g1, layout),
                      nys.nystrom_gather(C, g1, layout))
        out["finalize"][variant] = {
            "B": arr(Bf), "C": arr(Cf), "words": words,
            "bitwise_oneshot": torch.equal(B, B1) and torch.equal(C, C1)}
    # a grid service: two streams, max_resident=1, eviction and restore
    svc = make_sketch_service(grid=(world, 1, 1), max_resident=1,
                              device="cpu")
    m = obs_metrics.get_metrics().counter("sketch_updates_total")
    dist0 = m.value(path="dist")
    sids, before = [], []
    for s in spec["service_seeds"]:
        sid = svc.open(StreamConfig(n1=S.shape[0], n2=S.shape[1],
                                    r=spec["s_r"], seed=s))
        col.reset_comm()
        svc.update(sid, S)
        sids.append((sid, comm()))
        before.append((svc.sketch(sid).clone(), svc.corange(sid).clone()))
    evicted = svc.num_evicted
    Y0, W0 = svc.sketch(sids[0][0]), svc.corange(sids[0][0])
    B, C = svc.nystrom(sids[0][0], "redist")
    st0 = ShardedStreamingSketch(StreamConfig(n1=S.shape[0], n2=S.shape[1],
                                              r=spec["s_r"],
                                              seed=spec["service_seeds"][0]),
                                 g1, device="cpu")
    st0.update(S)
    B0, C0 = st0.nystrom("redist")
    low = svc.reconstruct(sids[0][0], rank=4)
    out["service"] = {
        "evicted": evicted, "stats": svc.stats(),
        "dist_updates": m.value(path="dist") - dist0,
        "restored_bitwise": (torch.equal(Y0, before[0][0])
                             and torch.equal(W0, before[0][1])),
        "Y_blocks": [arr(y) for y, _ in before],
        "words": [w for _, w in sids],
        "nystrom_bitwise": torch.equal(B, B0) and torch.equal(C, C0),
        "B": arr(nys.nystrom_gather(B, g1, "redist")),
        "C": arr(nys.nystrom_gather(C, g1, "redist")),
        "low": arr(low.matrix()),
        "low_direct": arr(st0.reconstruct(rank=4).matrix())}
    # the all-reduce alone, on exact values
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 100.0 * rank
    col.reset_comm()
    out["all_reduce"] = (col.all_reduce(x, g1.p1_group, world).numpy(),
                         comm())
    return out


def stream_dist_card_worker(rank, world, n, r, slab, seed):
    """One rank of the distributed stream on cuda:0 (every rank shares the
    one card): a symmetric A drawn on the card from a seeded generator,
    fed in ``slab``-row slabs, in reverse order, through ``update_rows``
    on (world, 1, 1) and (2, 2, 1), and once through ``update`` on
    (2, 2, 1).  Returns (Y bitwise rand_matmul on (world, 1, 1), W
    bitwise a one-device stream, update_rows == update on Y on (2, 2, 1),
    words a slab on each grid, the finalize's C bitwise the second stage
    on the one-shot blocks, launches, the blocks' devices)."""
    import torch

    from repro_torch.core import sketch as sk
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.parallel import collectives as col
    from repro_torch.stream import (ShardedStreamingSketch, StreamConfig,
                                    StreamingSketch, nystrom_finalize)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    G = torch.randn(n, n, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    A = (G + G.T) / 2
    cfg = StreamConfig(n1=n, n2=n, r=r, seed=seed)
    order = list(range(n - slab, -1, -slab))
    g1, g2 = sk.make_grid_groups(world, 1, 1), sk.make_grid_groups(2, 2, 1)
    reset_launches()
    streams, words = {}, {}
    for grid, g in (((world, 1, 1), g1), ((2, 2, 1), g2)):
        st = streams[grid] = ShardedStreamingSketch(cfg, g)
        for r0 in order:
            col.reset_comm()
            st.update_rows(r0, A[r0:r0 + slab])
            words.setdefault(grid, set()).add(col.comm_words())
    full = ShardedStreamingSketch(cfg, g2).update(A)
    torch.cuda.synchronize()
    launches = {k: LAUNCHES[k] for k in ("sketch_fwd", "sketch_t",
                                         "fold_rows", "gen_omega")}
    solo = StreamingSketch(cfg)
    for r0 in order:
        solo.update_rows(r0, A[r0:r0 + slab])
    st1 = streams[(world, 1, 1)]
    one = sk.rand_matmul(sk.input_block(A, g1), seed, r, g1)
    _, C = st1.nystrom("redist")
    _, C1 = nystrom_finalize(one, cfg, g1, "redist")
    return (torch.equal(st1.Y, one), torch.equal(st1.W, solo.W),
            torch.equal(streams[(2, 2, 1)].Y, full.Y), words,
            torch.equal(C, C1), launches,
            (st1.Y.device.type, st1.W.device.type))


def planner_worker(rank, world, spec):
    """One rank of the planner's distributed cases on the CPU: each
    planned call beside the explicit call of the entry point it names, on
    the ``cpu`` machine entry.  ``spec`` holds ``seed``, ``sketch`` (name
    -> (A, r): ``Plan.execute`` of ``plan_sketch`` against ``rand_matmul``
    on its grid, and ``rand_matmul_auto(grid="plan")`` against the same
    call on the plan's grid), ``S`` and ``s_r`` (a symmetric A:
    ``Plan.execute`` of ``plan_nystrom`` forced to each of
    ``nystrom_variants`` against the call it names, and
    ``nystrom_auto(variant="plan")`` / ``plan=`` against the explicit
    variant), ``stream`` (name -> (A, r, chunk_rows): ``Plan.execute`` of
    ``plan_stream`` against a ``ShardedStreamingSketch`` on the plan's
    grid, the same stream placed by the plan itself, and a
    ``SketchService(mesh=plan)``), and ``service`` (A and r:
    ``make_sketch_service(grid="auto", shape=...)`` against
    ``make_sketch_service(grid=...)``).  Returns, per call, whether it was
    bitwise the explicit call, the words this rank received on each side,
    the plan's (variant, grid, q_grid, predicted words) and the full
    results as numpy."""
    import numpy as np
    import torch

    from repro_torch.core import nystrom as nys
    from repro_torch.core import sketch as sk
    from repro_torch.parallel import collectives as col
    from repro_torch.plan import (PRESETS, plan_nystrom, plan_sketch,
                                  plan_stream)
    from repro_torch.serve import make_sketch_service
    from repro_torch.stream import (ShardedStreamingSketch, SketchService,
                                    StreamConfig)
    from repro_torch.stream.distributed import gather_corange

    cpu = PRESETS["cpu"]
    seed = spec["seed"]

    def arr(t):
        return None if t is None else t.numpy().copy()

    def call(fn):
        col.reset_comm()
        res = fn()
        return res, col.comm_words()

    def same(a, b):
        if a is None or b is None:
            return a is None and b is None
        return torch.equal(a, b)

    def about(plan):
        return (plan.variant, plan.grid, plan.q_grid, plan.predicted_words)

    out = {"sketch": {}, "nystrom": {}, "stream": {}}
    for name, (A, r) in spec["sketch"].items():
        A = torch.from_numpy(np.array(A))
        plan = plan_sketch(*A.shape, r, P=world, machine=cpu)
        blk, w_exec = call(lambda: plan.execute(A, seed, device="cpu"))
        g = sk.make_grid_groups(*plan.grid)
        ref, w_ref = call(lambda: sk.rand_matmul(sk.input_block(A, g), seed,
                                                 r, g))
        (auto, gm, _), w_auto = call(
            lambda: sk.rand_matmul_auto(A, seed, r, grid="plan"))
        (expl, _, _), w_expl = call(
            lambda: sk.rand_matmul_auto(A, seed, r, grid=plan.grid))
        out["sketch"][name] = {
            "plan": about(plan), "auto_grid": gm.shape,
            "bitwise": (same(blk, ref), same(auto, expl)),
            "words": (w_exec, w_ref, w_auto, w_expl),
            "B": arr(sk.gather_output(blk, g))}
    S, r = torch.from_numpy(np.array(spec["S"])), spec["s_r"]
    n = S.shape[0]
    direct = {"alg2_no_redist": nys.nystrom_no_redist,
              "alg2_redist": nys.nystrom_redist}
    two_grid = {"alg2_bound_driven": nys.nystrom_two_grid,
                "alg2_bound_driven_fused": nys.nystrom_two_grid_fused}
    for variant in spec["nystrom_variants"]:
        plan = plan_nystrom(n, r, P=world, machine=cpu, variant=variant)
        (B, C), w_exec = call(lambda: plan.execute(S, seed, device="cpu"))
        if plan.variant in direct:
            g = sk.make_grid_groups(*plan.grid)
            (B0, C0), w_ref = call(lambda: direct[plan.variant](
                sk.input_block(S, g), seed, r, g))
            layout = plan.variant[len("alg2_"):]
            (B1, C1, _, got), w_auto = call(lambda: nys.nystrom_auto(
                S, seed, r, plan=plan))
            (B2, C2, _, _), w_expl = call(lambda: nys.nystrom_auto(
                S, seed, r, variant=layout))
            full = (nys.nystrom_gather(B, g, layout),
                    nys.nystrom_gather(C, g, layout))
        else:
            p, q = plan.grid, plan.q_grid
            (B0, C0), w_ref = call(lambda: two_grid[plan.variant](
                sk.input_block(S, sk.make_grid_groups(*p)), seed, r, p=p,
                q=q))
            (B1, C1, _, got), w_auto = call(lambda: nys.nystrom_auto(
                S, seed, r, plan=plan))
            (B2, C2), w_expl = (B0, C0), w_ref
            gq = sk.make_grid_groups(*q)
            full = (nys.two_grid_gather(B, gq, "B"),
                    nys.two_grid_gather(C, gq, "C"))
        out["nystrom"][variant] = {
            "plan": about(plan), "auto_variant": got,
            "bitwise": (same(B, B0) and same(C, C0),
                        same(B1, B2) and same(C1, C2)),
            "words": (w_exec, w_ref, w_auto, w_expl),
            "B": arr(full[0]), "C": arr(full[1])}
    (B, C, _, got), w_auto = call(lambda: nys.nystrom_auto(
        S, seed, r, variant="plan"))
    out["nystrom_plan"] = (got, arr(B), arr(C), w_auto)
    for name, (A, r, k) in spec["stream"].items():
        A = torch.from_numpy(np.array(A))
        n1, n2 = A.shape
        plan = plan_stream(n1, n2, r, P=world, chunk_rows=k, corange=True,
                           machine=cpu)
        cfg = StreamConfig(n1=n1, n2=n2, r=r, seed=seed, corange=True)
        g = sk.make_grid_groups(*plan.grid)
        st, w_exec = call(lambda: plan.execute(A, seed, device="cpu"))
        ref = ShardedStreamingSketch(cfg, g, device="cpu")
        by_plan = ShardedStreamingSketch(cfg, plan, device="cpu")
        col.reset_comm()
        for row0 in range(0, n1, k):
            ref.update_rows(row0, A[row0:row0 + k])
        w_ref = col.comm_words()
        for row0 in range(0, n1, k):
            by_plan.update_rows(row0, A[row0:row0 + k])
        svc, svc_ref = (SketchService(mesh=plan, device="cpu"),
                        SketchService(mesh=g, device="cpu"))
        sid, sid_ref = svc.open(cfg), svc_ref.open(cfg)
        svc.update(sid, A)
        svc_ref.update(sid_ref, A)
        out["stream"][name] = {
            "plan": about(plan), "slabs": -(-n1 // k),
            "bitwise": (same(st.Y, ref.Y) and same(st.W, ref.W),
                        same(by_plan.Y, ref.Y) and same(by_plan.W, ref.W),
                        same(svc.sketch(sid), svc_ref.sketch(sid_ref))
                        and same(svc.corange(sid),
                                 svc_ref.corange(sid_ref))),
            "words": (w_exec, w_ref),
            "Y": arr(sk.gather_output(st.Y, g)),
            "W": arr(gather_corange(st.W, g))}
    A, r = spec["service"]
    A = torch.from_numpy(np.array(A))
    shape = (*A.shape, r)
    svc = make_sketch_service(grid="auto", shape=shape, device="cpu")
    grid = plan_sketch(*shape, P=world, machine=cpu).grid
    svc_ref = make_sketch_service(grid=grid, device="cpu")
    cfg = StreamConfig(n1=shape[0], n2=shape[1], r=r, seed=seed)
    sid, sid_ref = svc.open(cfg), svc_ref.open(cfg)
    _, w = call(lambda: svc.update(sid, A))
    _, w_ref = call(lambda: svc_ref.update(sid_ref, A))
    out["service"] = {
        "grid": svc.mesh.shape, "ref_grid": grid,
        "bitwise": (same(svc.sketch(sid), svc_ref.sketch(sid_ref))
                    and same(svc.corange(sid), svc_ref.corange(sid_ref))),
        "words": (w, w_ref)}
    return out


def autotune_worker(rank, world, spec):
    """One rank of the autotuner's rank agreement on the CPU, on the
    ``cpu`` machine entry.  Each rank's timer calls the candidate once
    (the collectives run on every rank in one order) and returns a
    seconds of its own: rank ``i % world`` sees candidate ``i`` at
    ``3 - 0.1·i``, every other rank at 1, so a rank alone would pick
    another candidate than the slowest-rank winner, the last one.
    ``spec`` holds ``seed``, ``dir`` (a directory for the caches),
    ``sketch`` (A, r), ``S`` and ``s_r`` (a symmetric A) and ``stream``
    (A, r, chunk_rows).  Each task is tuned against a cache at
    ``dir/<task>_rank<rank>.json``, its plan executed beside the
    explicit call it names, then tuned again (a timer that raises) for
    the hit; last, the sketch with a preset that only rank 0 is given.
    Returns per task the timed candidates, this rank's and the records'
    seconds, the tuned and the hit plans, whether the execution was
    bitwise, and this rank's cache counts."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import nystrom as nys
    from repro_torch.core import sketch as sk
    from repro_torch.plan import (PRESETS, AutotuneCache, autotune,
                                  cache_key, plan_nystrom, plan_sketch,
                                  plan_stream)
    from repro_torch.stream import ShardedStreamingSketch, StreamConfig

    cpu = PRESETS["cpu"]
    seed = spec["seed"]

    def about(plan):
        return (plan.variant, plan.grid, plan.q_grid, plan.chunk_rows,
                plan.predicted_words, plan.measured_seconds)

    def timer_for(seen):
        def timer(fn):
            i = len(seen)
            fn()
            secs = 3.0 - 0.1 * i if i % world == rank else 1.0
            seen.append(secs)
            return secs
        return timer

    def forbidden(fn):
        raise AssertionError("a cache hit ran the timer")

    A = torch.from_numpy(np.array(spec["sketch"][0]))
    r = spec["sketch"][1]
    S = torch.from_numpy(np.array(spec["S"]))
    s_r = spec["s_r"]
    Ast = torch.from_numpy(np.array(spec["stream"][0]))
    st_r, k = spec["stream"][1], spec["stream"][2]
    plans = {"sketch": plan_sketch(*A.shape, r, P=world, machine=cpu),
             "nystrom": plan_nystrom(S.shape[0], s_r, P=world, machine=cpu),
             "stream": plan_stream(*Ast.shape, st_r, P=world, chunk_rows=k,
                                   corange=True, machine=cpu)}

    def explicit(task, plan):
        if task == "sketch":
            g = sk.make_grid_groups(*plan.grid)
            return plan.execute(A, seed, device="cpu"), sk.rand_matmul(
                sk.input_block(A, g), seed, r, g)
        if task == "nystrom":
            got = plan.execute(S, seed, device="cpu")
            g = sk.make_grid_groups(*plan.grid)
            fn = {"alg2_no_redist": nys.nystrom_no_redist,
                  "alg2_redist": nys.nystrom_redist}.get(plan.variant)
            if fn is not None:
                return got, fn(sk.input_block(S, g), seed, s_r, g)
            fn = (nys.nystrom_two_grid_fused
                  if plan.variant == "alg2_bound_driven_fused"
                  else nys.nystrom_two_grid)
            return got, fn(sk.input_block(S, g), seed, s_r, p=plan.grid,
                           q=plan.q_grid)
        st = plan.execute(Ast, seed, device="cpu")
        cfg = StreamConfig(n1=Ast.shape[0], n2=Ast.shape[1], r=st_r,
                           seed=seed, corange=True)
        ref = ShardedStreamingSketch(cfg, sk.make_grid_groups(*plan.grid),
                                     device="cpu")
        for row0 in range(0, Ast.shape[0], plan.chunk_rows):
            ref.update_rows(row0, Ast[row0:row0 + plan.chunk_rows])
        return (st.Y, st.W), (ref.Y, ref.W)

    def same(a, b):
        if isinstance(a, tuple):
            return all(same(x, y) for x, y in zip(a, b))
        if a is None or b is None:
            return a is None and b is None
        return torch.equal(a, b)

    out = {}
    for task, plan in plans.items():
        path = os.path.join(spec["dir"], f"{task}_rank{rank}.json")
        seen, records = [], []
        cache = AutotuneCache(path)
        tuned = autotune(plan, cache=cache, timer=timer_for(seen),
                         device="cpu", machine=cpu, presets={},
                         records=records)
        got, want = explicit(task, tuned)
        dist.barrier()
        files = [os.path.exists(os.path.join(spec["dir"],
                                             f"{task}_rank{i}.json"))
                 for i in range(world)]
        again_cache = AutotuneCache(path)
        again = autotune(plan, cache=again_cache, timer=forbidden,
                         device="cpu", machine=cpu, presets={})
        out[task] = {"tuned": about(tuned), "again": about(again),
                     "local": seen,
                     "records": [(rec["variant"],
                                  tuple(rec["grid"]) if rec["grid"] else None,
                                  tuple(rec["q_grid"]) if rec["q_grid"]
                                  else None, rec["chunk_rows"],
                                  rec["seconds"]) for rec in records],
                     "bitwise": same(got, want), "files": files,
                     "counts": (cache.hits, cache.misses, again_cache.hits,
                                again_cache.misses)}
    plan = plans["sketch"]
    entry = {"variant": "alg1", "grid": list(spec["preset_grid"]),
             "q_grid": None, "chunk_rows": None, "source": "measured",
             "seconds": 1.0}
    presets = {cache_key(plan, device="cpu"): entry} if rank == 0 else {}
    pre = autotune(plan, timer=forbidden, device="cpu", machine=cpu,
                   presets=presets)
    got, want = explicit("sketch", pre)
    out["preset"] = {"plan": about(pre), "bitwise": same(got, want)}
    return out


def ledger_worker(rank, world, spec):
    """One rank of the comm ledger's sites on the CPU, under
    ``install_observability``.  ``spec`` holds ``seed``, ``H`` (an (n1,
    n2) numpy matrix), ``r``, ``k`` (a slab's rows), ``grids``,
    ``service_grids``, ``S`` (a symmetric (n, n) matrix), ``s_r``, ``p``
    and ``q`` (the fused pair), ``drill_grid`` and ``dir`` (a directory
    for each rank's autotune cache).  Calls, each tagged: per grid
    ``ShardedStreamingSketch.update`` without and with the co-range and
    ``update_rows`` of one slab; per service grid a grid service's
    ``update``; ``nystrom_two_grid_fused`` and
    ``nystrom_second_stage_two_grid_fused`` on (p, q); then the stale
    decision drill: ``rand_matmul`` on ``drill_grid`` observed against the
    0 words of a (P, 1, 1) decision (cache key ``k/stale``) and against
    its own words (``k/fine``), ``drift_flags`` and ``revalidate_autotune``
    twice.  Returns, per call, every site it touched (name, calls, words
    by kind, prediction, floor, drift, bound fraction) beside this rank's
    ``COMM`` words of the call, and the drill's flags, pops and the keys
    left."""
    import os

    import torch

    from repro_torch import obs
    from repro_torch.core import nystrom as nys
    from repro_torch.core import sketch as sk
    from repro_torch.core.grid import alg1_bandwidth_words
    from repro_torch.parallel import collectives as col
    from repro_torch.plan.autotune import AutotuneCache
    from repro_torch.stream import (ShardedStreamingSketch, SketchService,
                                    StreamConfig)

    seed, r = spec["seed"], spec["r"]
    H = torch.from_numpy(spec["H"].copy())
    S = torch.from_numpy(spec["S"].copy())
    n1, n2 = H.shape
    _, ledger, _ = obs.install_observability()
    calls = []

    def call(tag, fn):
        before = {id(s): (s.calls, s.measured_words or 0.0)
                  for s in ledger.sites()}
        col.reset_comm()
        res = fn()
        comm = {k: v["words"] for k, v in col.COMM.items() if v["calls"]}
        for s in ledger.sites():
            c0, w0 = before.get(id(s), (0, 0.0))
            if s.calls == c0:
                continue
            cw = s.collectives()
            calls.append({
                "tag": tag, "name": s.name, "calls": s.calls - c0,
                "words": None if cw is None else s.measured_words - w0,
                "by_kind": None if cw is None else dict(cw.by_kind),
                "redistribute": None if cw is None
                else cw.redistribute_total,
                "pred": s.predicted_words, "floor": s.lower_bound_words,
                "drift": s.drift, "bound_fraction": s.bound_fraction,
                "comm": comm})
        return res

    groups = {g: sk.make_grid_groups(*g) for g in spec["grids"]}
    for corange in (False, True):
        cfg = StreamConfig(n1, n2, r=r, seed=seed, corange=corange)
        for grid, g in groups.items():
            st = ShardedStreamingSketch(cfg, g, device="cpu")
            call(("update", grid, corange), lambda: st.update(H))
    cfg = StreamConfig(n1, n2, r=r, seed=seed, corange=True)
    for grid, g in groups.items():
        st = ShardedStreamingSketch(cfg, g, device="cpu")
        call(("update_rows", grid), lambda: st.update_rows(0, H[:spec["k"]]))
    for grid in spec["service_grids"]:
        svc = SketchService(mesh=sk.make_grid_groups(*grid), device="cpu")
        sid = svc.open(cfg)
        call(("service", grid), lambda: svc.update(sid, H))
    p, q, s_r = spec["p"], spec["q"], spec["s_r"]
    gp = sk.make_grid_groups(*p)
    A_blk = sk.input_block(S, gp)
    call(("fused", p, q), lambda: nys.nystrom_two_grid_fused(
        A_blk, seed, s_r, p=p, q=q))
    B_blk = sk.rand_matmul(A_blk, seed, s_r, gp)
    call(("stage2_fused", p, q),
         lambda: nys.nystrom_second_stage_two_grid_fused(B_blk, seed, s_r,
                                                         q, p=p))

    # the stale decision drill
    dg = sk.make_grid_groups(*spec["drill_grid"])
    cache = AutotuneCache(os.path.join(spec["dir"], f"rank{rank}.json"))
    for key in ("k/stale", "k/fine", "k/other"):
        cache.put(key, {"variant": "alg1"})
    own = alg1_bandwidth_words(n1, n2, r, *spec["drill_grid"])
    for name, pred, key in (("drill.stale", 0.0, "k/stale"),
                            ("drill.fine", own, "k/fine")):
        with obs.observing(name, (H,), predicted_words=pred,
                           cache_key=key):
            sk.rand_matmul(sk.input_block(H, dg), seed, r, dg)
    flags = [(s.name, s.drift) for s, _ in obs.drift_flags(ledger)]
    popped = obs.revalidate_autotune(ledger, cache)
    again = obs.revalidate_autotune(ledger, cache)
    left = sorted(k for k in ("k/stale", "k/fine", "k/other")
                  if cache.get(k) is not None)
    return {"calls": calls, "flags": flags, "popped": popped,
            "again": again, "left": left,
            "report": obs.honesty_report(ledger)}


def dp_step_ledger_worker(rank, world, spec):
    """One worker of ``make_dp_compressed_step`` on reduced gemma2-2b under
    a comm ledger: the plan priced at this world size, one step on this
    rank's share of ``spec["tokens"]`` / ``spec["labels"]``.  Returns the
    ``train.dp_compressed_step`` site's figures, the plan's exchange
    words and ``grad_compress.COMM``'s words of the step."""
    import torch

    from repro_torch import obs
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.models import get_api
    from repro_torch.parallel import grad_compress as gc
    from repro_torch.train import init_state, make_dp_compressed_step

    cfg = get_config("gemma2-2b").reduced()
    api = get_api(cfg)
    run = RunConfig(steps=2, learning_rate=1e-3, warmup_steps=1,
                    grad_compress_rank=spec["rank"])
    # both priced at the process group's world size (init_state without
    # decisions takes the legacy min_dim heuristic, as the reference's)
    from repro_torch.plan import plan_train_compression
    dec = plan_train_compression(api.init(0, cfg, "meta"),
                                 spec["rank"]).decision_tree()
    state = init_state(api, cfg, run, 0, device="cpu", decisions=dec)
    step = make_dp_compressed_step(api, cfg, run)
    batch = {"tokens": torch.from_numpy(spec["tokens"]).long(),
             "labels": torch.from_numpy(spec["labels"]).long()}
    _, ledger, _ = obs.install_observability()
    gc.reset_comm()
    step(state, batch)
    s, plan = ledger.site("train.dp_compressed_step"), step.plan
    return {"calls": s.calls, "measured": s.measured_words_per_call,
            "by_kind": dict(s.collectives().by_kind),
            "pred": s.predicted_words, "floor": s.lower_bound_words,
            "drift": s.drift, "bound_fraction": s.bound_fraction,
            "exchange_words": plan.exchange_words,
            "n_compressed": plan.n_compressed, "comm": gc.COMM["words"]}


def roofline_worker(rank, world, A, seed, r, grids):
    """One rank of the roofline's Alg. 1 case: each grid's call through
    ``analyze_call(chips=world)`` (a warm-up, then the counted call; the
    fleet's terms on every rank) and the words this rank received in one
    call, by kind."""
    import numpy as np
    import torch

    from repro_torch.core import sketch as sk
    from repro_torch.parallel import collectives as col
    from repro_torch.roofline import analyze_call

    At = torch.from_numpy(np.array(A))
    n1, n2 = At.shape
    out = {}
    for grid in grids:
        g = sk.make_grid_groups(*grid)
        blk = sk.input_block(At, g)
        col.reset_comm()
        terms = analyze_call(f"alg1 {grid}",
                             lambda: sk.rand_matmul(blk, seed, r, g),
                             chips=world, model_flops=2.0 * n1 * n2 * r,
                             device="cpu")
        out[grid] = (terms.to_dict(),
                     {k: v["words"] // 2 for k, v in col.COMM.items()})
    return out


def elastic_worker(rank, world, spec):
    """One rank of the live-reshard cases on the CPU.  ``spec`` holds
    ``cfg`` (StreamConfig keywords, co-range on), ``slabs`` [(row0, H)],
    ``A`` (a full-shape delta), ``pairs`` [(old, new)], ``spill_dir`` and
    ``traffic`` [(stream index, full-shape delta)].  Returns, per case,
    what the test holds: bitwise flags, this rank's words by source
    (``COMM``, the ledger site, ``rank_words``) and the standby errors."""
    import numpy as np
    import torch

    from repro_torch.core import sketch as sk
    from repro_torch.obs import install_ledger, uninstall_ledger
    from repro_torch.parallel import collectives as col
    from repro_torch.stream import (IngestQueue, ShardedStreamingSketch,
                                    SketchService, StreamConfig)
    from repro_torch.stream import distributed as sd
    from repro_torch.stream.elastic import (LEDGER_SITE, rank_words,
                                            reshard_stream)
    from repro_torch.stream.faults import bits_equal

    def same(a, b):
        return all(bits_equal(x, y) for x, y in zip(a, b))

    def gathered(Y, W, g):
        """Full (Y, W) from the grid's blocks (None past the grid)."""
        if g.coords is None:
            return None
        return sk.gather_output(Y, g), sd.gather_corange(W, g)

    cfg = StreamConfig(**spec["cfg"])
    slabs = [(r0, torch.from_numpy(np.array(H))) for r0, H in spec["slabs"]]
    A = torch.from_numpy(np.array(spec["A"]))
    out = {}

    # 4 -> 2 -> 4 mid-stream against the stream that never moved
    g4 = sk.make_grid_groups(world, 1, 1)
    ref = ShardedStreamingSketch(cfg, g4, device="cpu")
    for r0, H in slabs:
        ref.update_rows(r0, H)
    st = ShardedStreamingSketch(cfg, g4, device="cpu")
    for r0, H in slabs[:2]:
        st.update_rows(r0, H)
    st = reshard_stream(st, (world // 2, 1, 1))
    shrunk = {"standby": st.standby, "num_updates": st.num_updates}
    if st.standby:
        try:
            st.sketch
        except ValueError as e:
            shrunk["error"] = str(e)
    st.update_rows(*slabs[2])
    st = reshard_stream(st, (world, 1, 1))
    st.update_rows(*slabs[3])
    out["shrink_grow"] = {
        "shrunk": shrunk, "num_updates": (st.num_updates, ref.num_updates),
        "Y": bits_equal(st.sketch, ref.sketch),
        "W": bits_equal(st.corange_sketch, ref.corange_sketch)}

    # one hop on each pair: a layout move, its words from three sources
    out["pairs"] = {}
    for old, new in spec["pairs"]:
        g = sk.make_grid_groups(*old)
        s = ShardedStreamingSketch(cfg, g, device="cpu")
        for r0, H in slabs[:2]:
            s.update_rows(r0, H)
        before = gathered(s.Y, s.W, g)
        led = install_ledger()
        try:
            col.reset_comm()
            s2 = reshard_stream(s, new)
            words = {k: dict(v) for k, v in col.COMM.items()}
            site = next(x for x in led.sites() if x.name == LEDGER_SITE)
            ledger = {"calls": site.calls,
                      "predicted": site.predicted_words,
                      "floor": site.lower_bound_words,
                      "measured": site.measured_words_per_call,
                      "drift": site.drift}
        finally:
            uninstall_ledger()
        after = gathered(s2.Y, s2.W, s2.mesh)
        out["pairs"][(old, new)] = {
            "words": words, "ledger": ledger,
            "rank_words": rank_words(cfg, old, new, world)[rank],
            "bitwise": same(before, after)}

    # a grid service whose evicted stream moves with it, from host memory
    # and from disk; a shrink leaves ranks past the grid a standby service
    out["service"] = {}
    for spill in (None, spec["spill_dir"]):
        svc = SketchService(mesh=sk.make_grid_groups(2, 2, 1),
                            max_resident=1, spill_dir=spill, device="cpu")
        a = svc.open(StreamConfig(**dict(spec["cfg"], seed=1)))
        svc.update(a, A)
        snap_a = gathered(svc.sketch(a), svc.corange(a), svc.mesh)
        b = svc.open(StreamConfig(**dict(spec["cfg"], seed=2)))
        svc.update(b, 2 * A)
        snap_b = gathered(svc.sketch(b), svc.corange(b), svc.mesh)
        evicted = svc.num_evicted
        spilled = (spill is not None and os.path.isdir(os.path.join(
            spill, f"rank_{rank:05d}", f"stream_{a:08d}")))
        moved = svc.reshard((4, 1, 1))
        got_b = gathered(svc.sketch(b), svc.corange(b), svc.mesh)
        got_a = gathered(svc.sketch(a), svc.corange(a), svc.mesh)  # evicts b
        moved_small = svc.reshard((2, 1, 1))
        standby = svc.mesh.coords is None
        err = None
        if standby:
            try:
                svc.sketch(a)
            except ValueError as e:
                err = str(e)
        svc.update(a, A)                     # counted on a standby rank
        svc.reshard((4, 1, 1))
        got_b2 = gathered(svc.sketch(b), svc.corange(b), svc.mesh)
        out["service"][spill is not None] = {
            "evicted": evicted, "spilled": spilled,
            "moved": (moved, moved_small), "standby": standby,
            "error": err,
            "bitwise": (same(got_b, snap_b), same(got_a, snap_a),
                        same(got_b2, snap_b)),
            "updates": svc.stats()["updates"]}

    # grid-mode queues whose windows differ between ranks
    g = sk.make_grid_groups(2, 2, 1)
    svc = SketchService(mesh=g, device="cpu")
    direct = SketchService(mesh=g, device="cpu")
    seeds = sorted({s for s, _ in spec["traffic"]})
    sids = {s: svc.open(StreamConfig(**dict(spec["cfg"], seed=s)))
            for s in seeds}
    dids = {s: direct.open(StreamConfig(**dict(spec["cfg"], seed=s)))
            for s in seeds}
    with IngestQueue(svc, window=rank + 1) as q:
        if rank % 2:
            q.hold()                         # one big window on odd ranks
        for s, H in spec["traffic"]:
            q.submit(sids[s], np.array(H))
        q.release()
        q.flush(raise_errors=True)
        qst = q.stats()
    for s, H in spec["traffic"]:
        direct.update(dids[s], torch.from_numpy(np.array(H)))
    out["queue"] = {
        "rounds": qst["rounds"], "applied": qst["applied"],
        "bitwise": all(same((svc.sketch(sids[s]), svc.corange(sids[s])),
                            (direct.sketch(dids[s]), direct.corange(dids[s])))
                       for s in seeds)}
    return out


# -- data-parallel training (tests/test_torch_dp.py,
#    tests/test_torch_train_elastic.py) --------------------------------------

REFERENCE_DP = r'''
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.checkpoint import ckpt
from repro.checkpoint.ckpt import _flatten_with_names
from repro.configs import get_config
from repro.configs.base import RunConfig
from repro.models import get_api
from repro.plan import plan_train_compression
from repro.train.step import init_state, make_dp_compressed_step

work = @WORK@
spec = json.load(open(work + "/spec.json"))
data = np.load(work + "/batches.npz")
cfg = get_config(spec["arch"]).reduced()
api = get_api(cfg)
run = RunConfig(grad_compress_backend="jnp", **spec["run"])
key = jax.random.key(spec["seed"])
shapes = jax.eval_shape(lambda k: api.init(k, cfg), key)
plan = plan_train_compression(shapes, rank=run.grad_compress_rank,
                              P=spec["world"])
state = init_state(api, cfg, run, key, world=spec["world"],
                   decisions=plan.decision_tree())
ckpt.save(work + "/start", 0, state)
out = {}


def keep(prefix, tree):
    for n, x in _flatten_with_names(tree):
        out[prefix + n.replace("/", ".")] = np.asarray(jax.device_get(x))


def steps(step, state, first, last):
    for i in range(first, last):
        state, met = step(state, {"tokens": jnp.asarray(data["tokens"][i]),
                                  "labels": jnp.asarray(data["labels"][i])})
        out[f"loss.{i}"] = np.float64(met["loss"])
        keep(f"fb.{i}.", state.error_fb)
        keep(f"params.{i}.", state.params)
    return state


mesh = Mesh(np.asarray(jax.devices()[:spec["world"]]), ("data",))
state = steps(make_dp_compressed_step(api, cfg, run, mesh, plan=plan), state,
              0, spec["steps"])
if spec.get("resume_world"):
    from repro.launch.elastic import elastic_restore, remesh
    from repro.parallel.grad_compress import reshard_error_fb
    ckpt.save(work + "/ckpt", spec["steps"], state)
    mesh2 = remesh(jax.devices(), dp=spec["resume_world"], tp=1)
    st2, _, _ = elastic_restore(work + "/ckpt", state, mesh=mesh2)
    st2 = st2.replace(error_fb=reshard_error_fb(
        st2.error_fb, spec["world"], spec["resume_world"]))
    keep("restored.", st2.params)
    steps(make_dp_compressed_step(api, cfg, run, mesh2, axis="data",
                                  plan=plan), st2, spec["steps"],
          spec["steps"] + spec["steps_after"])
np.savez(work + "/out.npz", **out)
'''


class ReferenceDP:
    """The reference's ``make_dp_compressed_step`` at ``spec["world"]``
    fake XLA devices, run in a subprocess started at construction (so the
    port's ranks can run meanwhile).  From its own fresh state (saved with
    its ``ckpt.save`` into ``work/start`` first: :meth:`wait_start`) it
    takes ``spec["steps"]`` steps on ``tokens[i]`` / ``labels[i]``; with
    ``spec["resume_world"]``, then its checkpoint, ``elastic_restore``
    onto that many devices, ``reshard_error_fb`` and
    ``spec["steps_after"]`` more steps.  :meth:`result` is ``out.npz`` as
    a dict: ``loss.<i>``, ``fb.<i>.<leaf>`` (every worker's, stacked),
    ``params.<i>.<leaf>``, ``restored.<leaf>``."""

    def __init__(self, work: str, spec: dict, tokens, labels):
        import json
        import subprocess
        import sys

        import numpy as np

        from dist_helper import SRC
        self.work = work
        with open(os.path.join(work, "spec.json"), "w") as f:
            json.dump(spec, f)
        np.savez(os.path.join(work, "batches.npz"), tokens=tokens,
                 labels=labels)
        env = dict(os.environ)
        env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                            f"{spec['world']}")
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        env.setdefault("JAX_PLATFORMS", "cpu")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", REFERENCE_DP.replace("@WORK@",
                                                        repr(work))],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    def _failed(self):
        out, err = self.proc.communicate()
        raise AssertionError(f"the reference failed (rc="
                             f"{self.proc.returncode})\n{out}\n{err}")

    def wait_start(self, timeout: float = 300) -> str:
        """The reference's start checkpoint directory, once published."""
        import time
        path = os.path.join(self.work, "start")
        t0 = time.monotonic()
        while not os.path.isdir(os.path.join(path, "step_00000000")):
            if self.proc.poll() is not None:
                self._failed()
            if time.monotonic() - t0 > timeout:
                self.proc.kill()
                raise TimeoutError("the reference saved no start state")
            time.sleep(0.2)
        return path

    def result(self, timeout: float = 600) -> dict:
        import numpy as np
        try:
            self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
        if self.proc.returncode != 0:
            self._failed()
        self.proc.communicate()
        with np.load(os.path.join(self.work, "out.npz")) as f:
            return {k: f[k] for k in f.files}


def _dp_setup(rank, spec):
    """Reduced ``spec["arch"]``, its run and this rank's start state:
    worker ``rank``'s slice of the reference's checkpoint ``spec["start"]``
    (``convert.train_state_from_checkpoint``), and the plan priced for
    ``spec["plan_P"]`` workers."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.convert import train_state_from_checkpoint
    from repro_torch.models import get_api
    from repro_torch.plan import plan_train_compression

    cfg = get_config(spec["arch"]).reduced()
    api = get_api(cfg)
    run = RunConfig(**spec["run"])
    state = train_state_from_checkpoint(spec["start"], worker=rank,
                                        device="cpu")
    plan = plan_train_compression(state.params, rank=run.grad_compress_rank,
                                  P=spec["plan_P"])
    return api, cfg, run, state, plan


def _dp_steps(step, state, spec, first, last, out):
    """Steps ``first..last-1`` on the global batches of ``spec``; keeps
    each step's loss, this rank's ``grad_compress.COMM`` words, error
    buffers and params (numpy) in ``out``."""
    import torch

    from repro_torch.models import param_leaves
    from repro_torch.parallel import grad_compress as gc

    for i in range(first, last):
        batch = {"tokens": torch.from_numpy(spec["tokens"][i]).long(),
                 "labels": torch.from_numpy(spec["labels"][i]).long()}
        w0 = gc.COMM["words"]
        state, met = step(state, batch)
        out["words"][i] = gc.COMM["words"] - w0
        out["loss"][i] = met["loss"]
        out["fb"][i] = {n: t.clone().numpy()
                        for n, t in param_leaves(state.error_fb)}
        out["params"][i] = {n: t.detach().clone().numpy()
                            for n, t in param_leaves(state.params)}
    return state


def dp_train_worker(rank, world, spec):
    """One worker of ``make_dp_compressed_step`` from the reference's start
    state: ``spec["steps"]`` steps under the plan, then one more step (on
    the last batch again) under the same plan with every leaf raw.  With
    ``spec["mutate_rank"] == rank`` leaf ``spec["mutate_leaf"]`` draws its
    Omega with the key of leaf idx + 1 on this rank alone.  Returns, per
    step, the loss, the words counted, the buffers and the params."""
    import dataclasses

    from repro_torch.parallel import grad_compress as gc
    from repro_torch.train import make_dp_compressed_step

    api, cfg, run, state, plan = _dp_setup(rank, spec)
    if spec.get("mutate_rank") == rank:
        right = gc.leaf_seed
        gc.leaf_seed = lambda idx, step: right(
            idx + 1 if idx == spec["mutate_leaf"] else idx, step)
    out = {k: {} for k in ("words", "loss", "fb", "params")}
    n = spec["steps"]
    state = _dp_steps(make_dp_compressed_step(api, cfg, run, plan=plan),
                      state, spec, 0, n, out)
    raw = dataclasses.replace(plan, decisions=tuple(
        dataclasses.replace(d, compress=False) for d in plan.decisions))
    raw_out = {k: {} for k in out}
    _dp_steps(make_dp_compressed_step(api, cfg, run, plan=raw), state, spec,
              n - 1, n, raw_out)
    out["raw_words"] = raw_out["words"][n - 1]
    out["raw_params"] = raw_out["params"][n - 1]
    out["decisions"] = [d.compress for d in plan.decisions]
    return out


def elastic_train_worker(rank, world, spec):
    """The 4 -> 2 resume on the port: ``spec["steps"]`` steps at this
    world, the DP checkpoint into ``spec["ckpt"]``, ``remesh`` onto
    ``spec["resume_world"]`` workers, ``elastic_restore`` into a zeroed
    state (ranks past the group stand by), then ``spec["steps_after"]``
    steps on the same global batches.  Returns the steps' figures, the
    saved and the restored params and moments, and the restored buffers."""
    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.launch.elastic import elastic_restore, remesh
    from repro_torch.models import param_leaves
    from repro_torch.train import make_dp_compressed_step

    def snap(state):
        return {f"{tree}.{n}": t.detach().clone().numpy()
                for tree, obj in (("params", state.params),
                                  ("m", state.opt.m), ("v", state.opt.v))
                for n, t in param_leaves(obj)}

    api, cfg, run, state, plan = _dp_setup(rank, spec)
    out = {k: {} for k in ("words", "loss", "fb", "params")}
    n = spec["steps"]
    state = _dp_steps(make_dp_compressed_step(api, cfg, run, plan=plan),
                      state, spec, 0, n, out)
    ckpt.save(spec["ckpt"], n, state, world=world)
    out["saved"] = snap(state)
    group = remesh(range(world), dp=spec["resume_world"])
    out["standby"] = group is None
    if group is None:
        return out
    with torch.no_grad():
        for _, t in ckpt.state_tensors(state).items():
            t.zero_()
    state.step, state.opt.count = 0, 0
    state, step, _ = elastic_restore(spec["ckpt"], state, group=group)
    out["restored"] = snap(state)
    out["restored_step"] = (step, state.step, state.opt.count)
    out["restored_fb"] = {n: t.clone().numpy()
                          for n, t in param_leaves(state.error_fb)}
    _dp_steps(make_dp_compressed_step(api, cfg, run, plan=plan, group=group),
              state, spec, n, n + spec["steps_after"], out)
    return out


def dp_ckpt_worker(rank, world, spec):
    """The DP checkpoint cases at this world, on reduced llama3-8b:
    (a) save -> restore into another state, each rank its own buffers;
    (b) a step whose rank-1 file is gone is torn; (c) a fault inside the
    exchange of step 3 on every rank, after checkpoint 2, against the run
    that never failed."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import get_api, param_leaves
    from repro_torch.parallel import grad_compress as gc
    from repro_torch.plan import plan_train_compression
    from repro_torch.train import (init_state, make_dp_compressed_step,
                                   train_loop)

    cfg = get_config("llama3-8b").reduced()
    api = get_api(cfg)
    plan = plan_train_compression(api.init(0, cfg, "meta"), rank=4,
                                  P=world)
    dec = plan.decision_tree()

    def bits(state):
        named = ckpt.state_tensors(state)
        return {k: t.detach().clone() for k, t in named.items()}

    def same(a, b):
        return sorted(a) == sorted(b) and all(
            torch.equal(a[k], b[k]) for k in a)

    out = {}
    # (a) each worker's own buffers, and the world recorded
    run = RunConfig(grad_compress_rank=4)
    a = init_state(api, cfg, run, 0, "cpu", decisions=dec)
    g = torch.Generator().manual_seed(100 + rank)
    with torch.no_grad():
        for _, e in param_leaves(a.error_fb):
            e.copy_(torch.randn(e.shape, generator=g))
    a.step, a.opt.count = 7, 7
    d = spec["dirs"]["a"]
    ckpt.save(d, 7, a, extra={"data": {"step": 7, "seed": 0}}, world=world)
    b = init_state(api, cfg, run, 1, "cpu", decisions=dec)
    b, step, extra = ckpt.restore(d, b, world=world)
    try:
        ckpt.restore(d, b)
    except ValueError as e:
        out["one_worker_error"] = str(e)
    out["a"] = {"same": same(bits(a), bits(b)), "step": (step, b.step,
                                                        b.opt.count),
                "extra": extra, "files": sorted(os.listdir(
                    os.path.join(d, "step_00000007"))),
                "fb": {n: t.numpy() for n, t in param_leaves(b.error_fb)}}
    # (b) a step missing one rank file is torn
    d = spec["dirs"]["b"]
    for s in (2, 3):
        ckpt.save(d, s, a, world=world)
    if rank == 0:
        os.remove(os.path.join(d, "step_00000003", ckpt.rank_file(1)))
    dist.barrier()
    out["b"] = {"latest": ckpt.latest_step(d), "torn": ckpt.torn_steps(d)}
    try:
        ckpt.restore(d, b, step=3, world=world)
    except ckpt.TornCheckpointError as e:
        out["b"]["error"] = str(e)
    dist.barrier()

    # (c) a fault inside step 3 on every rank resumes bitwise
    def loop(path, fail_at):
        run = RunConfig(steps=4, learning_rate=3e-3, warmup_steps=1,
                        checkpoint_every=2, checkpoint_dir=path,
                        grad_compress_rank=4)
        state = init_state(api, cfg, run, 0, "cpu", decisions=dec)
        right, calls = gc.gemm_block, [0]

        def faulty(*args, **kw):
            calls[0] += 1
            if calls[0] == 3 * plan.n_compressed * fail_at + 4:
                raise RuntimeError("injected fault inside the exchange")
            return right(*args, **kw)
        gc.gemm_block = faulty if fail_at is not None else right
        try:
            res = train_loop(make_dp_compressed_step(api, cfg, run,
                                                     plan=plan),
                             state, DataConfig(cfg.vocab, 16, 4, seed=1),
                             run, device="cpu")
        finally:
            gc.gemm_block = right
        return res

    want = loop(spec["dirs"]["clean"], None)
    got = loop(spec["dirs"]["broken"], 3)
    out["c"] = {"restarts": (got.restarts, want.restarts),
                "losses": (got.losses, want.losses),
                "steps": (got.state.step, want.state.step,
                          got.state.opt.count, want.state.opt.count),
                "same": same(bits(got.state), bits(want.state)),
                "checkpoints": (got.checkpoints, want.checkpoints)}
    out["c"]["fb_nonzero"] = any(
        float(np.abs(t.numpy()).max()) > 0
        for _, t in param_leaves(got.state.error_fb))
    return out
