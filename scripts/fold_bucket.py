#!/usr/bin/env python3
"""The fold kernel K4 at one bucket of the sketch service, across checkouts
of this repository: bit for bit, timed, and its wrapper's host time split
into stages, on one CUDA card.

    python3 scripts/fold_bucket.py TREE [TREE ...] [--out FILE]

Each TREE is the root of a checkout (``.`` for this one).  Each runs in a
process of its own, since every tree has its own ``repro_torch``: it builds
that tree's kernels and makes ``chip_smoke.py``'s fold bucket from the same
seed (64 lanes of Y 16384 x 128 f32, d 64 x 256 x 128 f32, heights uniform
in (128, 256], masked).  It reports:

  * the sha256 of the lanes' bits after one fold of fresh Y's;
  * ``wrapper_ms``: one ``fold_rows_block`` call, CUDA events over 50
    calls (host-bound: the host's time a call);
  * ``kernel_ms``: the kernel's device time a launch (torch.profiler),
    back to back (the bucket's 14 MB stay in the 50 MB L2), and
    ``kernel_cold_ms`` with a 256 MiB buffer read before each call (y and
    d come from device memory, as Y's rows do in a serving round);
  * ``split_us``: the wrapper's host time by stage, the median over 200
    calls of ``time.perf_counter_ns`` between stages.  A tree whose
    launcher has ``fold_rows_plan`` is split as check / pack / launch (its
    ``_fold_check``, ``_fold_pack``, ``_fold_launch``); an older tree's
    launcher is replayed here stage by stage (check / pack / pin and copy
    / launch: the body of its ``fold_rows_cuda``, which staged the lanes
    through a pinned buffer and a host-to-device copy);
  * ``foreach_ms``: one ``torch._foreach_add_`` over the lanes' live
    windows, building the view lists included (the same function: one f32
    add rounded once), and ``loop_ms``, the per-lane ``narrow().add_()``
    loop.

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

N1, R, KB, LANES = 16384, 128, 256, 64


def _time_ms(torch, fn, reps=5, inner=1):
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _kernel_ms(torch, fn, calls=20, flush=None):
    """The fold kernel's device time a launch (torch.profiler); with
    ``flush``, a read of a buffer larger than the L2 before each call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if flush is not None:
                flush.sum()             # leaves the L2 full of clean lines
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if "fold_rows_kernel" in e.key]
    count = sum(e.count for e in evs)
    return (sum(e.device_time_total for e in evs) / 1e3 / count
            if count else None)


def bucket(torch, dev):
    import numpy as np
    rng = np.random.default_rng(8)
    ks = rng.integers(KB // 2 + 1, KB + 1, LANES).tolist()
    row0s = [int(rng.integers(0, N1 - k + 1)) for k in ks]
    g = torch.Generator(device=dev).manual_seed(8)
    d = torch.randn(LANES, KB, R, generator=g, device=dev)
    return ks, row0s, d, [N1 - r0 for r0 in row0s]


def _split_new(sm, ys, d, starts, ks):
    ns = time.perf_counter_ns
    t0 = ns()
    lanes = sm._fold_check(ys, d, starts, ks)
    t1 = ns()
    plan, calls = sm._fold_pack(ys[0].dtype, d, *lanes)
    t2 = ns()
    sm._fold_launch(d, calls)
    t3 = ns()
    return {"check": t1 - t0, "pack": t2 - t1, "launch": t3 - t2}


def _split_old(sm, torch, ys, d, start, nvalid):
    """The older launcher's fold_rows_cuda, stage by stage (masked form)."""
    import numpy as np
    ns = time.perf_counter_ns
    name = "fold_rows"
    t0 = ns()
    n = len(ys)
    if d.dim() != 3 or d.shape[0] != n:
        raise ValueError(name)
    _, k, c = d.shape
    if (not d.is_cuda or d.dtype not in sm.KERNEL_DTYPES
            or not d.is_contiguous()):
        raise ValueError(name)
    m = ys[0].shape[0]
    for y in ys:
        sm._check_like(y, (m, c), ys[0].dtype, d.device, "every y", name)
    if ys[0].dtype not in sm.KERNEL_DTYPES:
        raise ValueError(name)
    starts = [int(s) for s in start]
    nvalids = [int(v) for v in nvalid]
    if len(starts) != n or len(nvalids) != n:
        raise ValueError(name)
    if max(m, k, c, n) > sm._INT_MAX or n > 65535 or any(
            not -2 ** 31 <= v <= sm._INT_MAX for v in starts + nvalids):
        raise ValueError(name)
    span = max(nvalids)
    t1 = ns()
    meta = np.zeros(2 * n, np.int64)
    meta[:n] = [y.data_ptr() for y in ys]
    words = meta[n:].view(np.int32)
    words[:n] = starts
    words[n:] = nvalids
    t2 = ns()
    meta_d = torch.from_numpy(meta).pin_memory().to(d.device,
                                                    non_blocking=True)
    t3 = ns()
    base = meta_d.data_ptr()
    lib = sm._build.library()
    with torch.cuda.device(d.device):
        rc = lib.rt_fold_rows(
            base, d.data_ptr(), base + 8 * n, base + 12 * n, n, m, k, c,
            span, int(ys[0].dtype == torch.bfloat16),
            int(d.dtype == torch.bfloat16), sm._stream(d.device))
    sm._launched(rc, name)
    t4 = ns()
    return {"check": t1 - t0, "pack": t2 - t1, "pin_and_copy": t3 - t2,
            "launch": t4 - t3}


def worker(tree: pathlib.Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels import _build, local
    sm = sys.modules["repro_torch.kernels.sketch_matmul"]
    dev = torch.device("cuda")
    _build.library()
    ks, row0s, d, starts = bucket(torch, dev)
    ys = [torch.zeros(N1, R, device=dev) for _ in range(LANES)]
    local.fold_rows_block(ys, d, starts, ks)
    torch.cuda.synchronize()
    bits = torch.stack(ys).view(torch.int32).cpu().numpy().tobytes()
    res = {"tree": str(tree), "digest": hashlib.sha256(bits).hexdigest(),
           "new_launcher": hasattr(sm, "fold_rows_plan")}

    def call():
        local.fold_rows_block(ys, d, starts, ks)

    res["wrapper_ms"] = _time_ms(torch, call, inner=50)
    res["kernel_ms"] = _kernel_ms(torch, call)
    flush = torch.empty(64 * 2 ** 20, device=dev)       # 256 MiB > 50 MB L2
    res["kernel_cold_ms"] = _kernel_ms(torch, call, flush=flush)
    del flush
    stages = []
    for _ in range(200):
        stages.append(_split_new(sm, ys, d, starts, ks)
                      if res["new_launcher"]
                      else _split_old(sm, torch, ys, d, starts, ks))
        torch.cuda.synchronize()
    res["split_us"] = {s: statistics.median(t[s] for t in stages) / 1e3
                       for s in stages[0]}
    calls = []
    for _ in range(200):
        t0 = time.perf_counter_ns()
        call()
        calls.append(time.perf_counter_ns() - t0)
        torch.cuda.synchronize()
    res["call_us"] = statistics.median(calls) / 1e3

    def foreach():
        torch._foreach_add_([y.narrow(0, r0, k) for y, r0, k
                             in zip(ys, row0s, ks)],
                            [di[:k] for di, k in zip(d, ks)])

    def loop():
        for y, r0, k, di in zip(ys, row0s, ks, d):
            y.narrow(0, r0, k).add_(di[:k])

    res["foreach_ms"] = _time_ms(torch, foreach, inner=10)
    res["loop_ms"] = _time_ms(torch, loop, inner=10)
    return res


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
        print("fold_bucket: no CUDA device is available", file=sys.stderr)
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
        print(f"{r['tree']}: wrapper {r['wrapper_ms']:.4f} ms a call (host "
              f"{r['call_us']:.1f} us), kernel "
              + ("not measured" if r["kernel_ms"] is None
                 else f"{r['kernel_ms']:.4f} ms")
              + " on the device ("
              + ("cold not measured" if r["kernel_cold_ms"] is None
                 else f"{r['kernel_cold_ms']:.4f} ms with the L2 flushed")
              + "); host split "
              + ", ".join(f"{s} {us:.1f} us"
                          for s, us in r["split_us"].items())
              + f"; foreach_add_ {r['foreach_ms']:.4f} ms, per-lane loop "
              f"{r['loop_ms']:.4f} ms; sha256 {r['digest'][:16]}")
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
