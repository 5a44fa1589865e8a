"""Serve a small model with continuously-batched requests on the PyTorch
port: the sibling of ``examples/serve_batched.py``.

Demonstrates the serving half of the framework: slot-based continuous
batching over shared, ring-buffered (SWA-aware) caches, through
``BatchedServer`` on the (1, world) host mesh.  Where no process group
exists, a one-rank group is started for the run (NCCL on the card, gloo
on the CPU) and destroyed after it.  The config is the reference
example's: ``reduced(get_config(arch), capacity_factor=8.0)``, 96 slots
of cache; prompts of 6 tokens and the weights drawn from seed 0.
Attention runs on the attention kernel (K4) on the card, its plain
PyTorch version on the CPU.

  PYTHONPATH=src python examples/serve_batched_torch.py --arch mixtral-8x7b \\
      [--device cpu]

Runs on the card unless ``--device cpu`` is given; without a card it
raises.
"""

import argparse
import contextlib
import copy
import datetime
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import get_config, reduced
from repro_torch.core.exec_target import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import BatchedServer, Request, card_line

#: the reference example's cache length, step cap, prompt length and
#: progress interval; the seed of the prompts and the weights
MAX_SEQ, MAX_STEPS, PROMPT, EVERY, SEED = 96, 96, 6, 16, 0


def make_requests(cfg, n: int, max_new: int) -> list:
    """``n`` requests of ``PROMPT`` tokens drawn from ``SEED``."""
    gen = torch.Generator().manual_seed(SEED)
    return [Request(rid=rid, prompt=torch.randint(
        0, cfg.vocab, (PROMPT,), generator=gen).tolist(), max_new=max_new)
        for rid in range(n)]


@contextlib.contextmanager
def host_mesh(device: torch.device):
    """The (1, world) host mesh over the process group; where none
    exists, over a one-rank group (NCCL on the card, gloo on the CPU,
    rendezvous through a file in a temporary directory, collectives
    timing out after 60 s) that is destroyed on the way out."""
    if dist.is_initialized():
        yield make_host_mesh(device.type)
        return
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"file://{tmp}/rendezvous", rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=60))
        try:
            yield make_host_mesh(device.type)
        finally:
            dist.destroy_process_group()


def _clone(caches):
    return tree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                         else copy.copy(t), caches)


def serve(cfg, mesh, params, reqs: list, *, slots: int, device="cuda",
          warm_up: bool = False, trace: list | None = None,
          log=print) -> list:
    """``reqs`` through a ``BatchedServer(cfg, mesh, ...)`` (``mesh``
    ``None``: mesh-free, on ``device``) until every request completes or
    ``MAX_STEPS`` steps ran; a progress line every ``EVERY`` steps, then
    the summary and the first three requests' tokens.  ``params`` (the
    port's layout, whole) are used as given, or drawn from ``SEED``
    where ``None``; ``warm_up``: one throwaway step before the clock
    starts.  With a ``trace`` list, each step appends (a clone of the
    caches it started from, its tokens, its position, its logits).
    Returns ``reqs``."""
    server = BatchedServer(cfg, mesh, slots=slots, max_seq=MAX_SEQ,
                           device=device, seed=SEED, params=params)
    if warm_up:
        server.warm_up()
    for r in reqs:
        server.submit(r)

    t0 = time.time()
    steps = 0
    while (server.active or server.queue) and steps < MAX_STEPS:
        before = _clone(server.caches) if trace is not None else None
        pos = server.pos
        tokens, logits = server.step()
        if trace is not None:
            trace.append((before, tokens, pos, logits))
        steps += 1
        if steps % EVERY == 0:
            done = sum(r.done for r in reqs)
            log(f"  step {steps:3d}: {len(server.active)} active, "
                f"{len(server.queue)} queued, {done} done")
    if server.device.type == "cuda":
        torch.cuda.synchronize(server.device)
    dt = time.time() - t0
    total = sum(len(r.out) for r in reqs)
    log(f"\nserved {len(reqs)} requests / {total} tokens in {dt:.1f}s "
        f"({total/dt:.1f} tok/s, {slots} slots, "
        f"{steps} decode steps)")
    for r in reqs[:3]:
        log(f"  req {r.rid}: {r.out}")
    return reqs


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get_config(args.arch), capacity_factor=8.0)
    reqs = make_requests(cfg, args.requests, args.gen)
    with host_mesh(device) as mesh:
        log = print if dist.get_rank() == 0 else (lambda *_: None)
        log(card_line(mesh.device))
        return serve(cfg, mesh, None, reqs, slots=args.slots,
                     warm_up=True, log=log)


if __name__ == "__main__":
    main()
