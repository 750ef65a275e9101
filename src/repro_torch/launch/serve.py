"""Serving driver of the port: multi-tenant sketch ingest (shape-bucketed
ragged batching behind the bounded async queue) on one card, LM decoding
of all six families (continuous-batching-lite), and the chaos drills of
the recovery layer.

  PYTHONPATH=src python -m repro_torch.launch.serve --workload sketch \
      --streams 64 --updates 4 --n1 1024 --n2 512 --r 32

LM decoding (``--arch`` of any family: gemma2-2b, llama3-8b,
internlm2-20b, h2o-danube-3-4b, granite-moe-1b-a400m, dbrx-132b,
falcon-mamba-7b, zamba2-1.2b, whisper-tiny, internvl2-26b; the reduced
config unless ``--full``; random weights from seed 0):

  PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \
      --arch gemma2-2b --full --requests 6 --slots 4 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \
      --arch granite-moe-1b-a400m --full --requests 6 --slots 4
  PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \
      --arch zamba2-1.2b --full --requests 6 --slots 4

The SSM and hybrid families keep an O(1) recurrent state a slot (the
hybrid also a KV cache per application of its shared block), and a slot's
prompt is replayed token by token, as in the reference.  whisper-tiny's
decoder serves against zero cross-attention caches (no audio is
submitted) and internvl2-26b serves its text path, as the reference's
server does; ``serve.engine.serve_prefill`` takes the frames or the
patch embeddings.

``--arch dbrx-132b --full`` asks for all 40 layers (263 GB in bf16),
more than one card holds.

``--workload`` defaults to ``sketch``, not to ``lm`` as in the
reference's launcher: the port's sketch workload came first and its
callers run it without the flag.

Chaos drills (``stream/faults.py``): inject a named failure into the
serving stack and check the recovery end to end — kill-worker (WAL
replay, bitwise), torn-write (checkpoint quarantine), shrink-restore (a
live stream resharded (4,1,1) -> (2,1,1) -> (4,1,1) on four gloo ranks,
bitwise), eviction-storm (spill to disk, bitwise).  It prints each
verdict and exits 1 if any drill failed to recover:

  PYTHONPATH=src python -m repro_torch.launch.serve --chaos kill-worker
  PYTHONPATH=src python -m repro_torch.launch.serve --chaos all

``--device`` defaults to the card (and fails without one); ``--device cpu``
runs the plain torch path.  ``--metrics`` dumps the Prometheus text of the
metrics registry after the run, ``--trace-out FILE`` installs the tracer
and the comm ledger (``obs.install_observability``), writes a
Chrome/Perfetto trace of the run and prints the ledger's honesty report.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import obs
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


def run_sketch(args):
    """Drive ``args.streams`` concurrent sketch streams through the async
    ingest queue and report sustained throughput and tail latency.

    Payloads are drawn (numpy, seed 0) before the clock starts, and the
    clock stops after the queue has flushed and the card is idle, so
    updates/s is the serving stack's rate, not numpy's.  The lane heights
    are drawn first and passed as ``expected_ks``, so the queue buckets
    on the planner's edges (``choose_bucket_edges``).  One warm-up round
    on throwaway streams, one lane per bucket height the traffic can
    produce, builds the kernels and warms the allocators first.  The timed
    window is marked ``serve.timed_window`` for torch.profiler.  Returns
    the queue's ``stats()`` plus ``seconds``, ``updates_per_s``, the
    ``bucket_edges``, and over the timed window the kernels' ``launches``
    and the service's ``lane_batches`` (one fold launch each).
    """
    import numpy as np
    import torch

    from repro_torch.kernels.sketch_matmul import LAUNCHES
    from repro_torch.serve.engine import make_ingest_queue, make_sketch_service
    from repro_torch.stream.state import StreamConfig, snap_bucket

    rng = np.random.default_rng(0)
    svc = make_sketch_service(max_resident=args.max_resident or None,
                              device=args.device)
    shape = dict(n1=args.n1, n2=args.n2, r=args.r)
    sids = [svc.open(StreamConfig(seed=s, **shape))
            for s in range(args.streams)]
    ks = [int(rng.integers(1, args.max_rows + 1))
          for _ in range(args.streams * args.updates)]
    q = make_ingest_queue(svc, depth=args.depth, window=args.window,
                          expected_ks=ks)
    tops = sorted({snap_bucket(k, q.bucket_edges) for k in ks})
    tmp = [svc.open(StreamConfig(seed=1_000_000 + i, **shape))
           for i in range(len(tops))]
    svc.update_ragged([(t, np.zeros((kb, args.n2), np.float32), 0)
                       for t, kb in zip(tmp, tops)],
                      bucket_edges=q.bucket_edges)
    svc.sync()
    for t in tmp:
        svc.close(t)
    print(f"[serve:sketch] {svc.device}: bucket edges {q.bucket_edges} "
          f"(choose_bucket_edges over the {len(ks)} lane heights); warmed "
          f"one lane per bucket {tops}")
    it = iter(ks)
    rounds = []
    for _ in range(args.updates):
        rnd = []
        for sid in sids:
            k = next(it)
            rnd.append((sid, rng.standard_normal((k, args.n2),
                                                 dtype=np.float32),
                        int(rng.integers(0, args.n1 - k + 1))))
        rounds.append(rnd)
    before = dict(LAUNCHES)
    batches0 = svc.stats()["lane_batches"]
    with torch.profiler.record_function("serve.timed_window"):
        t0 = time.perf_counter()
        for u, rnd in enumerate(rounds):
            # submit under a round span: the queue worker's apply spans
            # stitch under it cross-thread in the exported trace
            with obs_trace.span("client.update_round", cat="client",
                                round=u):
                for sid, H, row0 in rnd:
                    q.submit(sid, H, row0)
        q.flush(raise_errors=True)
        svc.sync()
        dt = time.perf_counter() - t0
    st = q.stats()
    launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    batches = svc.stats()["lane_batches"] - batches0
    n = args.streams * args.updates
    print(f"[serve:sketch] {n} updates over {args.streams} streams in "
          f"{dt:.2f}s — {n / dt:.1f} updates/s, p50 "
          f"{st['latency_p50_s'] * 1e3:.1f} ms, p99 "
          f"{st['latency_p99_s'] * 1e3:.1f} ms, pad waste "
          f"{st['pad_waste']:.1%}, {st['rounds']} fused rounds")
    print(f"[serve:sketch] kernel launches: {launches}; {batches} lane "
          f"batches")
    q.shutdown()
    st.update(seconds=dt, updates_per_s=n / dt, launches=launches,
              lane_batches=batches, bucket_edges=q.bucket_edges)
    return st


def run_lm(args):
    """Serve ``args.requests`` greedy requests (prompts ``[2 + i, 5, 7]``)
    on ``args.slots`` slots through :class:`BatchedServer`; prints the
    wall and the generated tokens a second, returns the server."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_api
    from repro_torch.serve.engine import BatchedServer, Request

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    params = get_api(cfg).init(0, cfg, args.device)
    server = BatchedServer(params, cfg, slots=args.slots,
                           max_len=args.max_len, eos=-1)
    reqs = [Request(rid=i, prompt=[2 + i, 5, 7], max_new=args.max_new)
            for i in range(args.requests)]
    for req in reqs:
        server.submit(req)
    t0 = time.perf_counter()
    server.run()
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in reqs)
    print(f"[serve] {args.requests} requests on {args.slots} slots in "
          f"{dt:.1f}s — {tokens} tokens, {tokens / dt:.1f} tokens/s "
          f"({cfg.name}, {server.device})")
    return server


def run_chaos(args):
    """Run one drill, or all of them, on ``args.device``; print each
    verdict, and exit 1 if any drill failed to recover."""
    from repro_torch.stream import faults

    names = list(faults.SCENARIOS) if args.chaos == "all" else [args.chaos]
    results = {}
    for name in names:
        print(f"[chaos] scenario {name!r} ...")
        res = faults.run_chaos_scenario(name, streams=min(args.streams, 8),
                                        updates=args.updates,
                                        device=args.device)
        results[name] = res
        print(f"[chaos] {name}: "
              f"{'RECOVERED' if res.get('recovered') else 'FAILED'} "
              f"{ {k: v for k, v in res.items() if k != 'recovered'} }")
    if not all(r.get("recovered") for r in results.values()):
        raise SystemExit(1)
    return results


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve many concurrent sketch streams, or LM "
                    "requests, on one card.")
    ap.add_argument("--workload", choices=("sketch", "lm"), default="sketch")
    ap.add_argument("--chaos", metavar="SCENARIO", default=None,
                    help="run a stream/faults.py chaos drill instead of "
                         "the workload: kill-worker | torn-write | "
                         "shrink-restore | eviction-storm | all")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    # lm
    ap.add_argument("--arch", default="llama3-8b",
                    help="any architecture of repro_torch.configs "
                         "(--workload lm)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="the published config, not the reduced one")
    # sketch
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--updates", type=int, default=4,
                    help="updates per stream")
    ap.add_argument("--n1", type=int, default=1024)
    ap.add_argument("--n2", type=int, default=512)
    ap.add_argument("--r", type=int, default=32)
    ap.add_argument("--max-rows", type=int, default=64,
                    help="lane heights drawn from [1, max-rows]")
    ap.add_argument("--depth", type=int, default=256)
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--max-resident", type=int, default=0,
                    help="admission budget (0 = unlimited)")
    ap.add_argument("--metrics", action="store_true",
                    help="dump the Prometheus text exposition of the "
                         "process metrics registry after the run")
    ap.add_argument("--trace-out", metavar="FILE", default=None,
                    help="write a Chrome/Perfetto trace (trace_event JSON) "
                         "of the run to FILE; also prints the comm-ledger "
                         "honesty report")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    tracing = args.trace_out is not None
    if tracing:
        tracer, ledger, _ = obs.install_observability()
    try:
        if args.chaos is not None:
            out = run_chaos(args)
        else:
            out = (run_lm(args) if args.workload == "lm"
                   else run_sketch(args))
    finally:
        if tracing:
            tracer.export_chrome(args.trace_out)
            print(f"[serve] trace written to {args.trace_out} "
                  f"({len(tracer.spans)} spans)")
            if len(ledger):
                print(obs.honesty_report(ledger))
            obs.uninstall_observability()
        if args.metrics:
            print(obs_metrics.get_metrics().prometheus_text(), end="")
    return out


if __name__ == "__main__":
    main()
