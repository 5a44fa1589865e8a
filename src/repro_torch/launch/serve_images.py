"""Batched image-serving driver of the port (the counterpart of
``repro/launch/serve_images.py``).

Feeds a stream of mixed-size classification requests through the
bucketed :class:`repro_torch.serve.ImageServer` and prints the
per-request traffic ledger: bytes/image, distance to the Eq. (15)
bound at the accounting budget, and the weight-read amortization the
bucketing bought vs per-image dispatch.

  # VGG16/224 at full width through the CUDA kernel on the card:
  PYTHONPATH=src python -m repro_torch.launch.serve_images \\
      --width-mult 1.0 --image 224 --requests 16

  # paper-scale serving economics, no compute, on any host:
  PYTHONPATH=src python -m repro_torch.launch.serve_images \\
      --account-only --device cpu --width-mult 1.0 --image 224

  # ResNet-20 through the same server and ledger, plain version on CPU:
  PYTHONPATH=src python -m repro_torch.launch.serve_images \\
      --model resnet --device cpu --width-mult 0.25 --image 32

  # the fault-tolerant loop: deadline shedding + seeded fault injection
  # (account-only runs ride a virtual clock; compute runs real time)
  PYTHONPATH=src python -m repro_torch.launch.serve_images \\
      --account-only --device cpu --requests 32 --deadline 0.25 \\
      --fault-plan "fail@1,delay@3:0.05,service:0.02"

  # a Perfetto/Chrome trace of the run (+ a JSONL event log beside it);
  # an account-only fault-tolerant run's is byte-deterministic per seed
  PYTHONPATH=src python -m repro_torch.launch.serve_images \\
      --account-only --device cpu --deadline 0.25 --fault-plan random:7 \\
      --trace serve.trace.json
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.models.cnn import init_resnet, init_vgg, resnet_graph
from repro_torch.obs import Tracer, write_trace
from repro_torch.serve import FaultPlan, ImageServer, ServingLoop, VirtualClock


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("vgg", "resnet"), default="vgg")
    ap.add_argument("--width-mult", type=float, default=1.0)
    ap.add_argument("--image", type=int, default=224,
                    help="square image edge")
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--buckets", type=int, nargs="+",
                    default=[1, 2, 4, 8])
    ap.add_argument("--wait-ms", type=float, default=20.0,
                    help="deadline flush budget for partial buckets")
    ap.add_argument("--budget-kib", type=int, default=1024,
                    help="on-chip accounting budget (ledger scale)")
    ap.add_argument("--account-only", action="store_true",
                    help="plan + ledger, no compute")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda runs the CUDA kernel; cpu its plain "
                         "PyTorch version")
    ap.add_argument("--deadline", type=float, default=None,
                    metavar="SECONDS",
                    help="serve through the fault-tolerant ServingLoop "
                         "with this per-request latency budget "
                         "(deadline shedding + retry/backoff + "
                         "circuit-breaker degradation to account-only)")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="inject a deterministic fault schedule, e.g. "
                         "'fail@1,delay@3:0.05,service:0.02' or "
                         "'random:7' (implies the ServingLoop; "
                         "account-only runs use a virtual clock so "
                         "delays cost no wall time)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Perfetto/Chrome trace JSON (+ JSONL "
                         "event log at PATH.jsonl); under a virtual "
                         "clock the trace is byte-deterministic per "
                         "seed")
    args = ap.parse_args(argv)

    gen = torch.Generator().manual_seed(args.seed)
    if args.model == "resnet":
        graph = resnet_graph(width_mult=args.width_mult)
        params = init_resnet(gen, graph, n_classes=args.classes,
                             device=args.device)
    else:
        graph = None
        params = init_vgg(gen, n_classes=args.classes,
                          width_mult=args.width_mult, device=args.device)
    fault_tolerant = (args.deadline is not None
                      or args.fault_plan is not None)
    # account-only fault-tolerant runs ride a virtual clock, so injected
    # delays and backoff waits are free; compute runs keep real time
    clock = VirtualClock() if fault_tolerant and args.account_only \
        else None
    # a virtual-clock run gets a virtual-clock trace; the tracer is not
    # made ambient, so the trace holds the server's and the loop's spans
    # and no per-layer ones (which would wait for the card every layer)
    tracer = None
    if args.trace:
        tracer = Tracer(**({"clock": clock} if clock else {}))
    server = ImageServer(params, args.image, args.image, graph=graph,
                         buckets=args.buckets,
                         wait_budget=args.wait_ms / 1e3,
                         account_budget=args.budget_kib * 1024,
                         target=("account-only" if args.account_only
                                 else "kernel"),
                         device=args.device, tracer=tracer,
                         **({"clock": clock} if clock else {}))
    loop = None
    if fault_tolerant:
        plan = FaultPlan.parse(args.fault_plan) if args.fault_plan \
            else None
        loop = ServingLoop(server, deadline_s=args.deadline,
                           fault_plan=plan, seed=args.seed)
    if not args.account_only:
        # build the kernels and run each bucket once first: a first
        # dispatch that paid the build would set the loop's service
        # estimate, and the deadline policy would shed on it
        server.warm()
    rng = np.random.default_rng(args.seed)
    max_req = max(args.buckets)
    t0 = time.perf_counter()
    results = []
    front = server if loop is None else loop
    for _ in range(args.requests):
        n = int(rng.integers(1, max_req + 1))
        if args.account_only:
            front.submit(n_images=n)
        else:
            front.submit(rng.standard_normal(
                (n, args.image, args.image, 3), dtype=np.float32))
        results += server.poll() if loop is None else loop.pump()
    results += server.drain() if loop is None else loop.run_sync()
    dt = time.perf_counter() - t0

    s = server.ledger.summary()
    print(server.ledger.format_summary())
    print(f"stats: {server.stats}")
    if loop is not None:
        print(f"loop: {loop.stats}")
    print(f"served {s['requests']} requests / {s['images']} images in "
          f"{dt:.2f}s on {args.device}")
    if tracer is not None:
        out = write_trace(args.trace, tracer, server.metrics)
        print(f"trace: {out} ({len(tracer.records)} records; open in "
              f"ui.perfetto.dev)")


if __name__ == "__main__":
    main()
