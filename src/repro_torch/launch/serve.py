"""Batched LM serving: continuous batched decode — the port's
copy of ``repro/launch/serve.py`` (``Request``, ``BatchedServer``,
``main``).

Requests arrive with prompts and advance one token a step against the
shared per-layer caches (KV for attention, state and conv tail for a
Mamba mixer, the static cross K/V of an encoder-decoder); every decode
step feeds each active slot
the token at the server's global position (a prompt token while there
is one, then its own last output) and appends the greedy choice once
past the prompt.  Requests finishing early free their slot for queued
requests (continuous batching on slot granularity).  The same
admission, slot reuse, global ``pos`` and greedy choice as the
reference's; like the reference's, a freed slot's caches are not
reset when a new request takes it.  Every decoder-only arch serves:
dense (phi3-medium-14b, granite-34b, deepseek-7b, minitron-4b), MoE
(mixtral-8x7b, dbrx-132b: the reference's dense MoE mode), SSM
(mamba2-1.3b), hybrid (jamba-1.5-large-398b) and the VLM
(llava-next-34b, text only); so does the encoder-decoder
(whisper-medium), as the reference's server serves it: decode steps
only, from ``init_cache``, with no frames, so that its cross-attention
runs over ``ENC_FRAMES`` zero slots and adds exactly 0.  Attention runs
on K4 on the card (prefill causal, decode over the cache slots its mask
keeps, cross-attention over every cross slot).

On a mesh (``BatchedServer(cfg, mesh, ...)``), as the reference's server
does, the model is built at ``tp = mesh.shape["model"]`` and runs under
``sharding.axis_rules(mesh, slots, max_seq)``; the server holds this
rank's blocks of the weights (``sharding.shard_params``) and of the
caches.  Every rank runs the same admission and the same step: it
hands the model its rows of the step's tokens, gathers the logits over
"model" and the batch axes into whole rows, and takes the greedy choice
on the whole row (ties as ``torch.argmax`` breaks them), so every rank
holds the same requests and outputs.  Without a mesh it is the one-rank
server it was.

Memory: the server draws its weights block by block and keeps each
block's matmul weights only in the compute type (``init_params(...,
cast_blocks=True)``), so phi3-medium-14b (14.15e9 parameters) holds
about 29.3 GB in bf16 (the f32 embedding 2.06 GB of it) where f32
master weights beside them would not fit 80 GB.  mixtral-8x7b at full
depth holds 92.9 GB of bf16 blocks and one jamba-1.5-large-398b block
88.1 GB: neither fits one 80 GB card (the chip smoke serves mixtral at
full width and 20 of its 32 blocks), so both run here ``--reduced``.
whisper-medium holds 2.02 GB in bf16 (24 encoder blocks 0.81 GB, 24
decoder blocks 1.01 GB, the f32 embedding 0.21 GB) and its 4 slots'
cross K/V 0.59 GB: it serves at full size.  So do deepseek-7b (13.8 GB:
12.1 GB of bf16 blocks and its 1.68 GB f32 embedding), minitron-4b
(10.2 GB, 3.15 GB of it the 256000-row embedding) and llava-next-34b
(68.8 GB, text only; the chip smoke's serving peak on an H100 80GB
HBM3 was 74.0 GB).
granite-34b at full depth holds 93.3 GB of bf16 blocks and dbrx-132b
260.7 GB: the chip smoke serves granite at 60 of its 88 layers (64.8
GB) and dbrx at 9 of its 40 blocks (61.1 GB), and this CLI runs both
``--reduced``.  The default arch stays phi3-medium-14b.

  # phi3-medium-14b at full size on the card:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-medium-14b

  # a reduced config on the CPU (K4's plain version):
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --reduced --device cpu

  # whisper-medium at full size on the card (deepseek-7b, minitron-4b and
  # llava-next-34b likewise):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium

  # on the (1, world) host mesh, one card a rank (NCCL), under torchrun:
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --mesh host
  # ... or over gloo on the CPU:
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --mesh host --reduced --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import subprocess
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.exec_target import resolve_device
from repro_torch.models.api import build
from repro_torch.models.embedding import gather_logits
from repro_torch.parallel import axes as axes_mod
from repro_torch.parallel import sharding as sh


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class BatchedServer:
    """Fixed-slot continuous batching over shared per-layer caches.

    ``params`` (the port's layout, whole, e.g. from
    :func:`repro_torch.convert.lm_params_from_numpy`) are used as given;
    without them the weights are drawn from ``seed`` on ``device``.  On
    a ``mesh`` the device is the mesh's, and the server keeps this
    rank's blocks of the weights (a leaf no axis splits is the given
    tensor itself)."""

    def __init__(self, cfg, mesh=None, *, slots: int, max_seq: int,
                 device="cuda", seed: int = 0, params=None):
        self.cfg = cfg
        self.mesh = mesh
        self.slots = slots
        self.max_seq = max_seq
        if mesh is None:
            self.device = resolve_device(device)
            self.rules = None
            tp = 1
        else:
            self.device = mesh.device
            self.rules = sh.axis_rules(mesh, slots, max_seq)
            tp = mesh.shape.get("model", 1)
        self.api = build(cfg, tp=tp)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.api.init(gen, cast_blocks=True)
        if mesh is not None:
            params = sh.shard_params(params, mesh,
                                     fsdp=self.rules["_fsdp"],
                                     moe_ep_data=cfg.moe_ep_data)
        self.params = params
        with self._rules():
            self.caches = self.api.init_cache(slots, max_seq,
                                              device=self.device)
        self.active: dict[int, Request] = {}
        self.queue: list[Request] = []
        self.pos = 0

    def _rules(self):
        """The mesh's rules for the duration of a call (nothing without
        a mesh)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return axes_mod.axis_rules(self.rules, self.mesh)

    def warm_up(self) -> None:
        """One throwaway decode step over a cache of one slot a model
        shard, the server's own caches untouched: on the card it builds
        the attention kernel and sets up the libraries, which a clock
        started after it should not see."""
        with self._rules():
            tokens = torch.zeros((self.slots, 1), dtype=torch.int64,
                                 device=self.device)
            if self.mesh is not None:
                tokens = sh.batch_rows(tokens, self.mesh, self.rules)
            self.api.decode_step(
                self.params, self.api.init_cache(self.slots, self.api.tp,
                                                 device=self.device),
                tokens, 0)

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        while self.queue and len(self.active) < self.slots:
            req = self.queue.pop(0)
            slot = next(i for i in range(self.slots)
                        if i not in self.active)
            self.active[slot] = req

    def step(self):
        """Advance every active request by one token (greedy).  Returns
        the step's (tokens (slots, 1), logits (slots, V)), or ``None``
        when nothing is active."""
        self._admit()
        if not self.active:
            return None
        tok = [0] * self.slots
        for slot, req in self.active.items():
            seq = req.prompt + req.out
            idx = min(self.pos, len(seq) - 1) if seq else 0
            tok[slot] = seq[idx] if idx < len(seq) else (req.out or [0])[-1]
        tokens = torch.tensor(tok, dtype=torch.int64).reshape(
            self.slots, 1).to(self.device)
        with self._rules():
            if self.mesh is not None:
                tokens = sh.batch_rows(tokens, self.mesh, self.rules)
            logits, self.caches = self.api.decode_step(
                self.params, self.caches, tokens, self.pos)
            logits = gather_logits(logits)
        choice = logits.argmax(dim=-1).tolist()
        for slot, req in list(self.active.items()):
            past_prompt = self.pos >= len(req.prompt) - 1
            if past_prompt:
                req.out.append(int(choice[slot]))
            if len(req.out) >= req.max_new:
                req.done = True
                del self.active[slot]
        self.pos += 1
        return tokens, logits


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    the device's name off the card."""
    if device.type != "cuda":
        return str(device)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-medium-14b",
                    help="any arch: dense (phi3-medium-14b, "
                         "granite-34b, deepseek-7b, minitron-4b), MoE "
                         "(mixtral-8x7b, dbrx-132b), SSM (mamba2-1.3b), "
                         "hybrid (jamba-1.5-large-398b), the VLM "
                         "(llava-next-34b) or the encoder-decoder "
                         "(whisper-medium)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", choices=("none", "host"), default="none",
                    help="host: the (1, world) mesh of the process group "
                         "torchrun starts (NCCL on the card, gloo with "
                         "--device cpu)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, capacity_factor=8.0)
    mesh = None
    if args.mesh == "host":
        mesh = _host_mesh(args.device)
    try:
        _serve(args, cfg, mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _host_mesh(device: str):
    """Join torchrun's process group (its environment gives the rank,
    the world and the address) and build the (1, world) mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return make_host_mesh(dev.type)


def _serve(args, cfg, mesh) -> None:
    device = resolve_device(args.device) if mesh is None else mesh.device
    server = BatchedServer(cfg, mesh, slots=args.slots,
                           max_seq=args.max_seq, device=device,
                           seed=args.seed)
    server.warm_up()
    gen = torch.Generator().manual_seed(args.seed + 1)
    for rid in range(args.requests):
        prompt = torch.randint(0, cfg.vocab, (8,), generator=gen).tolist()
        server.submit(Request(rid=rid, prompt=prompt, max_new=args.gen))
    t0 = time.time()
    steps = 0
    while (server.active or server.queue) and steps < args.max_seq:
        server.step()
        steps += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    total_tokens = args.requests * args.gen
    if mesh is None or torch.distributed.get_rank() == 0:
        print(card_line(device))
        where = "" if mesh is None else f" on mesh {dict(mesh.shape)}"
        print(f"served {args.requests} requests, {total_tokens} tokens in "
              f"{dt:.1f}s ({total_tokens/dt:.1f} tok/s) over {steps} "
              f"steps{where}")


if __name__ == "__main__":
    main()
