#!/usr/bin/env python3
"""The sparse fold S1 at one full-width COO slab, across checkouts of this
repository: bit for bit, timed, on one CUDA card.

    python3 scripts/sparse_fold_slab.py TREE [TREE ...] [--out FILE]

Each TREE is the root of a checkout (``.`` for this one).  Each runs in a
process of its own, since every tree has its own ``repro_torch``: it builds
that tree's kernels and makes ``chip_smoke.py`` phase 16's timed slab from
that tree's own ``chip_smoke.py`` (the first slab of the order, 4096 rows of
A = 32768², 139,264 entries from numpy seed 0) for a ``normal`` f32 stream
with r = 512, l = 1025.  It reports:

  * the sha256 of Y's and W's bits after one ``update_rows_sparse`` of a
    fresh stream (the trees must agree);
  * for S1's Y launch (rows from zero) and W launch (columns into W):
    ``ms``, CUDA events over one launch of the launcher with the CSR built
    beforehand (median of 5 after a warm-up, as phase 16 times it);
    ``device_ms``, its device time a launch from ``torch.profiler`` (20
    launches back to back); ``cold_ms``, the same with a 256 MiB buffer
    read before each launch, so W comes from device memory as it does in
    a stream;
  * ``wall_ms``: one ``update_rows_sparse`` (validation, the payload's
    copies, the draws, the CSR builds and S1), ended by a synchronize,
    median of 20.

Name the trees in turns (parent, change, change, parent) to compare times
within one run on one card.  Exits 1 if the bits differ between trees, 2
without a CUDA card.
"""
import argparse
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys
import time


def _time_ms(torch, fn, reps=5):
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(torch, fn, calls=20, flush=None):
    """S1's device time a launch (torch.profiler); with ``flush``, a read
    of a buffer larger than the L2 before each launch."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if flush is not None:
                flush.sum()
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if "sparse_fold" in e.key]
    count = sum(e.count for e in evs)
    return (sum(e.device_time_total for e in evs) / 1e3 / count
            if count else None)


def worker(tree: pathlib.Path) -> dict:
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build, local
    from repro_torch.stream import SparseRows, StreamingSketch, state
    sm = sys.modules["repro_torch.kernels.sketch_matmul"]
    _build.library()
    rng = np.random.default_rng(0)
    first = cs.SD_ORDER[0]
    for s in range(first + 1):          # phase 16 draws the slabs in order
        coo = cs.sparse_coo(rng, cs.SLAB, cs.N, cs.SP_DISTINCT,
                            cs.SP_REPEATS)
    sp, row0 = SparseRows(*coo, (cs.SLAB, cs.N)), first * cs.SLAB
    cfg = state.StreamConfig(cs.N, cs.N, r=cs.R, seed=cs.SEED)
    st = StreamingSketch(cfg)
    st.update_rows_sparse(row0, sp)
    torch.cuda.synchronize()
    bits = b"".join(x.view(torch.int32).cpu().numpy().tobytes()
                    for x in (st.Y, st.W))
    res = {"tree": str(tree), "digest": hashlib.sha256(bits).hexdigest(),
           "nnz": sp.nnz}
    if hasattr(sm, "sparse_fold_plan"):
        res["plans"] = {part: sm.sparse_fold_plan(n, w, axis, cfg.dtype)
                        for part, n, w, axis in (("Y", cs.SLAB, cs.R, 0),
                                                 ("W", cs.N, cfg.sketch_l,
                                                  1))}
    flush = torch.empty(64 * 2 ** 20, device="cuda")    # 256 MiB > 50 MB L2
    folds = state.sparse_update_folds(cfg, st.keys, st.Y, st.W, row0, sp)
    for part, (acc, dest, val, kw) in zip(("Y", "W"), folds):
        axis = kw.get("axis", 0)
        ptr, ops = local.sparse_fold_operands(dest, acc.shape[axis], val,
                                              kw["src"])
        work = acc.clone()

        def launch():
            sm.sparse_fold_cuda(work, ptr, table=kw["table"], axis=axis,
                                from_zero=kw.get("from_zero", False), **ops)
        res[part] = {"ms": _time_ms(torch, launch),
                     "device_ms": _device_ms(torch, launch),
                     "cold_ms": _device_ms(torch, launch, flush=flush)}
        del work
    del folds, flush
    walls = []
    st.update_rows_sparse(row0, sp)
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        st.update_rows_sparse(row0, sp)
        torch.cuda.synchronize()
        walls.append((time.perf_counter_ns() - t0) / 1e6)
    res["wall_ms"] = statistics.median(walls)
    return res


def _fmt(x):
    return "not measured" if x is None else f"{x:.4f}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path)
    ap.add_argument("--worker", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve())))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("sparse_fold_slab: no CUDA device is available",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    runs = []
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", str(tree.resolve())],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        r = runs[-1]
        print(f"{r['tree']}: " + "; ".join(
            f"{p} {_fmt(r[p]['ms'])} ms a launch (device "
            f"{_fmt(r[p]['device_ms'])}, L2 flushed "
            f"{_fmt(r[p]['cold_ms'])})" for p in ("Y", "W"))
            + f"; update_rows_sparse wall {r['wall_ms']:.4f} ms; "
            f"{r['nnz']} entries; plans {r.get('plans', 'none')}; sha256 "
            f"{r['digest'][:16]}")
    same = len({r["digest"] for r in runs}) <= 1
    print(f"card: {card}")
    print(f"bitwise equal across the trees: {same}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "runs": runs,
                                        "bitwise": same}, indent=1))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
