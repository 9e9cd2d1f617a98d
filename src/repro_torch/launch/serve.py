"""Serving launcher of the port: a HybridFlow edge/cloud deployment over two
PyTorch serving engines on the card, driven by the concurrent multi-query
runtime (counterpart of ``repro.launch.serve``).

By default the edge engine runs ``qwen2-1.5b`` and the cloud engine
``mistral-large-123b`` (the paper's executor pair); ``--edge-arch
internlm2-1.8b --cloud-arch mixtral-8x7b`` serves the paper's model-pair
swap (App. D.2), whose moe cloud prefills each request alone through the
engine's batch-1 legacy path. Both run at their published widths in
bf16, the cloud cut to 2 layers as the reference launcher cuts it;
weights are random, drawn from a seed. Queries are admitted together
into ``ServingRuntime``; their ready subtasks share each engine's KV
slots through the fleet scheduler's pump loop. ``--reduced`` serves the
small CPU smoke configs in float32 instead (with ``--device cpu``).

The flags mirror the reference launcher where their machinery is ported;
the replicated cloud pool, autoscaling and fault injection are not yet.

  PYTHONPATH=src python -m repro_torch.launch.serve --queries 6
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --edge-arch internlm2-1.8b --cloud-arch mixtral-8x7b
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Tuple

import torch

from repro_torch.configs import (ARCH_IDS, get_config, PAPER_EDGE_ARCH,
                                 PAPER_CLOUD_ARCH)
from repro_torch.core.exposure import mean_exposure
from repro_torch.core.hybridflow import HybridFlowPolicy
from repro_torch.core.planner import SyntheticPlanner
from repro_torch.core.profiler import train_default_router
from repro_torch.data.tasks import gen_benchmark, WorldModel
from repro_torch.models import kvcache as KV
from repro_torch.models import model as M
from repro_torch.serving import (RuntimeReport, ServingConfig, ServingRuntime,
                                 Trace)
from repro_torch.serving.engine import ServingEngine, TorchExecutor


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--edge-arch", default=PAPER_EDGE_ARCH, choices=ARCH_IDS)
    ap.add_argument("--cloud-arch", default=PAPER_CLOUD_ARCH, choices=ARCH_IDS)
    ap.add_argument("--device", default="cuda",
                    help="torch device of both engines and the router")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced (CPU smoke) configs in float32, "
                         "max_len 192 and 64-token chunks as the reference "
                         "launcher does (full width: max_len 512, 128)")
    ap.add_argument("--queries", type=int, default=6,
                    help="closed-loop batch size (open loop: trace decides)")
    ap.add_argument("--benchmark", default="gpqa")
    ap.add_argument("--tau0", type=float, default=0.35)
    ap.add_argument("--k-max", type=float, default=0.04)
    ap.add_argument("--max-inflight", type=int, default=8,
                    help="concurrently admitted queries (fleet admission)")
    ap.add_argument("--global-k-max", type=float, default=None,
                    help="fleet-wide API $ cap; forces edge when exhausted")
    ap.add_argument("--sequential", action="store_true",
                    help="seed-style one-query-at-a-time baseline")
    ap.add_argument("--no-pump", action="store_true",
                    help="synchronous per-subtask dispatch (engines never "
                         "co-batch queries)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prefill chunk length (long prompts never stall "
                         "co-resident decodes)")
    ap.add_argument("--no-prefix-reuse", action="store_true",
                    help="disable cross-request KV prefix reuse")
    ap.add_argument("--prefix-block", type=int, default=None,
                    help="prefix-hash block size in tokens (default: "
                         "kvcache.PREFIX_BLOCK)")
    ap.add_argument("--calibrate", action="store_true",
                    help="enable the LinUCB calibration head")

    traffic = ap.add_argument_group(
        "open-loop traffic", "timed admission against an arrival trace")
    traffic.add_argument("--rps", type=float, default=None,
                         help="offered load: seeded Poisson arrivals at "
                              "this rate (queries/s)")
    traffic.add_argument("--duration", type=float, default=15.0,
                         help="trace horizon in seconds (with --rps)")
    traffic.add_argument("--trace", default=None, metavar="PATH",
                         help="replay a recorded Trace JSON "
                              "(overrides --rps)")
    traffic.add_argument("--trace-seed", type=int, default=0,
                         help="arrival-sampling seed (with --rps)")

    recovery = ap.add_argument_group(
        "recovery", "scheduler-side retry policy (armed by --timeout)")
    recovery.add_argument("--max-retries", type=int, default=2,
                          help="attempts per side before a cloud subtask "
                               "degrades to the edge")
    recovery.add_argument("--timeout", type=float, default=None,
                          help="per-attempt deadline in seconds")
    recovery.add_argument("--backoff-base", type=float, default=0.05,
                          help="base of the capped exponential retry "
                               "backoff")
    args = ap.parse_args(argv)
    if args.sequential and (args.rps is not None or args.trace is not None):
        ap.error("--sequential is closed-loop; drop --rps/--trace")
    return args


def build_engines(args) -> Tuple[ServingEngine, ServingEngine]:
    """The edge and cloud engines of the deployment, weights from seeds
    0 and 1."""
    edge_cfg = get_config(args.edge_arch)
    cloud_cfg = get_config(args.cloud_arch)
    if args.reduced:
        edge_cfg, cloud_cfg = edge_cfg.reduced(), cloud_cfg.reduced()
    cloud_cfg = cloud_cfg.variant(n_layers=2)
    dtype = torch.float32 if args.reduced else torch.bfloat16
    max_len, chunk = (192, 64) if args.reduced else (512, 128)
    kw = dict(max_len=max_len, prefill_chunk=args.prefill_chunk or chunk,
              prefix_reuse=not args.no_prefix_reuse,
              prefix_block=args.prefix_block or KV.PREFIX_BLOCK,
              dtype=dtype, device=args.device)
    edge = ServingEngine(edge_cfg, M.init_params(edge_cfg, seed=0,
                                                 dtype=dtype,
                                                 device=args.device),
                         batch_slots=2, **kw)
    cloud = ServingEngine(cloud_cfg, M.init_params(cloud_cfg, seed=1,
                                                   dtype=dtype,
                                                   device=args.device),
                          batch_slots=4, **kw)
    return edge, cloud


def run(args) -> Tuple[RuntimeReport, ServingEngine, ServingEngine]:
    """Build the deployment, serve the queries and print the report."""
    trace = None
    if args.trace is not None:
        trace = Trace.from_json(args.trace)
    elif args.rps is not None:
        trace = Trace.poisson(args.rps, args.duration, seed=args.trace_seed)

    wm = WorldModel()
    edge_engine, cloud_engine = build_engines(args)
    edge = TorchExecutor(edge_engine, wm, cloud=False, concurrency=1)
    cloud = TorchExecutor(cloud_engine, wm, cloud=True, price_out=3.2e-5)

    print("warm-starting router from offline profiling...")
    router, _ = train_default_router(n_queries=120, epochs=60,
                                     device=args.device)
    calibrator = None
    if args.calibrate:
        from repro_torch.core.bandit import LinUCBCalibrator
        calibrator = LinUCBCalibrator(dim=3)
    policy = HybridFlowPolicy(router, tau0=args.tau0, k_max=args.k_max,
                              calibrator=calibrator, wm=wm)
    retry = None
    if args.timeout is not None:
        from repro_torch.core.scheduler import RetryPolicy
        retry = RetryPolicy(max_retries=args.max_retries,
                            backoff_base=args.backoff_base,
                            timeout_s=args.timeout)
    config = ServingConfig(max_inflight=args.max_inflight,
                           global_k_max=args.global_k_max,
                           pump=False if args.no_pump else None,
                           retry=retry)
    runtime = ServingRuntime(edge, cloud, policy, planner=SyntheticPlanner(),
                             config=config)

    n_queries = trace.n if trace is not None else args.queries
    qs = gen_benchmark(args.benchmark, n_queries)
    t0 = time.time()
    if trace is not None:
        print(f"open loop: {trace.describe()}")
        report = runtime.serve_trace(trace, qs)
        mode = f"open-loop(max_inflight={args.max_inflight})"
    else:
        report = runtime.serve(
            qs, mode="sequential" if args.sequential else "fleet")
        mode = "sequential" if args.sequential else \
            (f"{'sync' if args.no_pump else 'pumped'}"
             f"(max_inflight={args.max_inflight})")
    for q, res in zip(qs, report.results):
        route = "".join("C" if res.offload[s] else "e"
                        for s in sorted(res.offload))
        print(f"  {q.qid:14s} {res.plan_status:8s} route={route:8s} "
              f"correct={res.final_correct} wall={res.latency:5.2f}s "
              f"api=${res.api_cost:.4f}")
    _, nbar = mean_exposure(report.results)
    print(f"\n[{mode}] {report.summary()} | exposure Ē={nbar:.2f} | "
          f"real {time.time()-t0:.1f}s")
    if report.stats.get("forced_edge"):
        print(f"global budget forced {report.stats['forced_edge']} "
              f"subtasks onto the edge")
    if not args.no_prefix_reuse:
        hits = (edge_engine.stats["prefix_hits"]
                + cloud_engine.stats["prefix_hits"])
        saved = (edge_engine.stats["prefill_tokens_saved"]
                 + cloud_engine.stats["prefill_tokens_saved"])
        print(f"prefix reuse: {hits} hits, {saved} prefill tokens skipped")
    print(f"edge: {edge_engine.stats} | cloud: {cloud_engine.stats}")
    return report, edge_engine, cloud_engine


def main(argv: Optional[List[str]] = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
