"""Training driver of the port.

Reduced config by default (tiny widths, the synthetic pipeline); ``--full``
runs the config at its published size.  Config -> state -> fault-tolerant
loop -> checkpoints, with optional sketched gradient compression:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch gemma2-2b --steps 20 --batch 4 --seq 32 --grad-compress 8

``--arch`` takes the dense family (gemma2-2b, llama3-8b, internlm2-20b,
h2o-danube-3-4b), the MoE family (granite-moe-1b-a400m, dbrx-132b,
whose load-balancing loss enters the training loss), the SSM family
(falcon-mamba-7b, Mamba-1) and the hybrid family (zamba2-1.2b, Mamba-2
with a shared attention block); ``--full --arch granite-moe-1b-a400m``
or ``--full --arch zamba2-1.2b`` trains at the published size on one
card, while dbrx-132b's 132B parameters fit no single card and
falcon-mamba-7b's bf16 params, grads and f32 AdamW moments (87.3 GB) do
not fit one 80 GB card either.

``--device`` defaults to the card (and fails without one); on the card the
exchange's GEMMs run the hand-written kernels.  With ``--grad-compress``
the per-leaf raw-vs-sketch decisions are planned at the process group's
world size and their word table is printed.  At one process the plan
compresses nothing: both exchanges move 0 words there.

Data parallel: with ``WORLD_SIZE`` > 1 (and ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR`` / ``MASTER_PORT`` as torchrun sets them, or
``--init-method file:///path``) each rank joins the group and trains one
worker of ``make_dp_compressed_step``; the global batch is split over the
ranks and the checkpoints take the DP form (each rank writes its own error
buffers).  The group is gloo on the CPU and whenever the ranks outnumber
the visible cards (rank k on ``cuda:(LOCAL_RANK % device_count)``: NCCL
refuses two ranks on one card), NCCL otherwise.  Rank 0 alone prints the
plan and the summary.  Without ``--grad-compress`` the launcher does what
the reference's does: it trains one replica, with no DP, on rank 0 alone;
the other ranks stand by and exit 0.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full", action="store_true",
                    help="the published config, not the reduced one")
    ap.add_argument("--ckpt-dir", default="repro_torch_train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="checkpoint period in steps (0 = never)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grad-compress", type=int, default=0, metavar="RANK",
                    help="sketched gradient compression at this rank "
                         "(0 = off)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--init-method", default="env://",
                    help="the process group's rendezvous at WORLD_SIZE > 1")
    return ap


def _join_group(device, init_method: str):
    """Join the DP group; returns this rank's device."""
    import torch
    import torch.distributed as dist
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    world = int(os.environ["WORLD_SIZE"])
    nccl = device.type == "cuda" and world <= cards
    dist.init_process_group("nccl" if nccl else "gloo",
                            init_method=init_method, world_size=world,
                            rank=int(os.environ["RANK"]))
    if device.type == "cuda":
        device = torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", "0")) % cards)
        torch.cuda.set_device(device)
    return device


def main(argv=None):
    import torch
    import torch.distributed as dist

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core.rng import resolve_device
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import get_api, param_leaves
    from repro_torch.train import (init_state, make_dp_compressed_step,
                                   make_train_step, train_loop)

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not args.grad_compress:
        # the reference trains one replica here: rank 0 alone, no DP
        if int(os.environ.get("RANK", "0")) != 0:
            print(f"[train] rank {os.environ['RANK']} stands by: without "
                  f"--grad-compress one replica trains, on rank 0")
            return None
        world = 1
    joined = world > 1 and not dist.is_initialized()
    if joined:
        device = _join_group(device, args.init_method)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    api = get_api(cfg)
    run = RunConfig(steps=args.steps, learning_rate=args.lr,
                    checkpoint_every=args.ckpt_every,
                    checkpoint_dir=args.ckpt_dir, seed=args.seed,
                    remat=True, grad_compress_rank=args.grad_compress)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    say(f"[train] arch={cfg.name} family={cfg.family} steps={run.steps} "
        f"batch={args.batch} seq={args.seq} device={device}")
    if args.grad_compress:
        from repro_torch.parallel.grad_compress import world_size
        from repro_torch.plan import (explain_train_compression,
                                      plan_train_compression)
        world = world_size()
        if args.batch % world:
            raise SystemExit(f"--batch {args.batch} must divide over "
                             f"{world} DP workers")
        shapes = api.init(run.seed, cfg, "meta")
        plan = plan_train_compression(shapes, rank=run.grad_compress_rank,
                                      P=world)
        say(explain_train_compression(plan))
        state = init_state(api, cfg, run, run.seed, device,
                           decisions=plan.decision_tree())
        step_fn = make_dp_compressed_step(api, cfg, run, plan=plan)
    else:
        state = init_state(api, cfg, run, run.seed, device)
        step_fn = make_train_step(api, cfg, run)
    n_params = sum(t.numel() for _, t in param_leaves(state.params))
    say(f"[train] params: {n_params / 1e6:.2f}M")

    t0 = time.time()
    result = train_loop(step_fn, state, data_cfg, run, device=device)
    dt = time.time() - t0
    first = float(np.mean(result.losses[:10]))
    last = float(np.mean(result.losses[-10:]))
    say(f"[train] done in {dt:.1f}s; loss {first:.4f} -> {last:.4f} "
        f"({len(result.losses)} steps, {result.restarts} restarts, "
        f"{len(result.checkpoints)} checkpoints)")
    if not last < first:
        raise SystemExit("loss did not decrease")
    if joined:
        dist.barrier()
        dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
