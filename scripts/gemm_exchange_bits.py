#!/usr/bin/env python3
"""The gradient exchange's K5 calls (b) and (c) across checkouts of this
repository, bit for bit and timed, on one CUDA card.

    python3 scripts/gemm_exchange_bits.py TREE [TREE ...] [--out FILE]

Each TREE is the root of a checkout (``.`` for this one).  Each runs in a
process of its own, since every tree has its own ``repro_torch``: it builds
that tree's kernels, makes the inputs of ``chip_smoke.py``'s phase 9 from
the same seed on the card (gemma2-2b's embed leaf: M 256000 x 2304 f32,
P̂ the Q of ``torch.linalg.qr`` of a 256000 x 8 draw, Qᵀ 8 x 2304), and
runs three calls through ``gemm_block``: (b) P̂·Qᵀ into a new f32 tensor,
(b) into a bf16 tensor through ``out=`` (as the training path writes the
gradient), and (c) M − P̂·Qᵀ in place.  It reports the sha256 of each
output's bytes and each call's time (CUDA events, median of 5 after a
warm-up).  Name the trees in turns (parent, change, change, parent) to
compare times within one run on one card.  Exits 1 if any call's digest
differs between trees, 2 without a CUDA card.
"""
import argparse
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys

T_M, T_N, T_R = 256000, 2304, 8


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


def _digest(torch, x):
    bits = x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)
    return hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()


def worker(tree: pathlib.Path) -> dict:
    """The three calls on ``tree``'s kernels: digests and times."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels import _build, local
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.library()
    g = torch.Generator(device=dev).manual_seed(9)
    M = torch.randn(T_M, T_N, generator=g, device=dev)
    P = torch.linalg.qr(torch.randn(T_M, T_R, generator=g, device=dev)).Q
    Qt = torch.randn(T_R, T_N, generator=g, device=dev)
    G = torch.empty(T_M, T_N, dtype=torch.bfloat16, device=dev)
    Mc = M.clone()
    calls = {
        "b_f32": lambda: local.gemm_block(P, Qt),
        "b_bf16": lambda: local.gemm_block(P, Qt, out_dtype=torch.bfloat16,
                                           out=G),
        "c": lambda: local.gemm_block(P, Qt, acc=Mc, alpha=-1.0),
    }
    res = {"tree": str(tree), "digest": {}, "ms": {}}
    for name, fn in calls.items():
        res["digest"][name] = _digest(torch, fn())   # (c): one step from M
        torch.cuda.synchronize()
        res["ms"][name] = _time_ms(torch, fn)
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
        print("gemm_exchange_bits: no CUDA device is available",
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
        print(f"{r['tree']}: " + ", ".join(
            f"{c} {ms:.3f} ms sha256 {r['digest'][c][:16]}"
            for c, ms in r["ms"].items()))
    same = {c: len({r["digest"][c] for r in runs}) == 1
            for c in (runs[0]["digest"] if runs else {})}
    print(f"card: {card}")
    print(f"bitwise equal across the trees: {same}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "runs": runs,
                                        "bitwise": same}, indent=1))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
