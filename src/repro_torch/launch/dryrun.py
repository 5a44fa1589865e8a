"""Multi-pod dry-run on the ``meta`` device — the port's counterpart of
``repro/launch/dryrun.py``.

For every (architecture x input shape x mesh) cell, one process plays
one rank of the 256-rank (16, 16) single-pod mesh or the 512-rank
(2, 16, 16) multi-pod mesh over PyTorch's ``"fake"`` process group,
whose collectives move nothing: it builds that rank's blocks of the
params (``init_params(cfg, None, tp)``, already ``meta``), caches and
inputs (:meth:`~repro_torch.models.api.ModelAPI.input_specs`) and runs
one step on them, a train step (``train_loss``, its backward and the
AdamW update), a prefill or a decode step, under a counting mode:

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (K4 counted
    through its ``meta`` stand-in's formula);
  * bytes: the operand and result bytes of every aten op that is not a
    view, an unfused upper bound of what the step moves;
  * collective bytes by op: :func:`repro_torch.parallel.collectives.
    counts_by_op`, what this rank sends.

Nothing is allocated and nothing computed.  Each cell prints a line
and writes one JSON record (the reference's keys; its ``lower_s`` and
``compile_s`` are ``trace_s`` here, and ``memory_analysis`` is
``null``: eager PyTorch has no compiler report, so the ``analytic_*``
fields of :mod:`repro_torch.analysis.memory_model` carry the judgment).
The roofline's terms use the H100's published rates
(:mod:`repro_torch.analysis.roofline`).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch phi3-medium-14b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --debug    # reduced
      # configs on (2, 4) and (2, 2, 4)
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-1.3b \
      --shape decode_32k --mesh-shape 1x1 --json   # any mesh; JSON lines
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.memory_model import (activation_allowance,
                                               sharded_bytes_per_chip)
from repro_torch.analysis.roofline import build_roofline
from repro_torch.configs import (ARCHS, SHAPES, applicable_shapes,
                                 get_config, reduced)
from repro_torch.kernels.attention_block import kernel as K4
from repro_torch.launch import steps as steps_mod
from repro_torch.models.api import build
from repro_torch.parallel import axes as axes_mod
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.axes import Mesh
from repro_torch.tree import leaves

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun_torch")

#: the production meshes (``repro/launch/mesh.py``) and the debug ones
MESHES = {(False, False): ((16, 16), ("data", "model")),
          (True, False): ((2, 16, 16), ("pod", "data", "model")),
          (False, True): ((2, 4), ("data", "model")),
          (True, True): ((2, 2, 4), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """This process as rank ``rank`` of a ``world``-rank ``"fake"``
    process group (its collectives move nothing), destroyed on the way
    out."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


class ByteCounter(TorchDispatchMode):
    """The operand and result bytes of every aten op that is not a view
    (each op's tensors counted once as read and once as written: no
    fusion, so an upper bound of what the step moves)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in leaves((args, kwargs or {}, out))
                              if isinstance(t, torch.Tensor))
        return out


@contextlib.contextmanager
def counting():
    """Counts of the run inside: ``{"flops", "bytes", "collectives"}``
    (filled in on the way out)."""
    counts: dict = {}
    col.reset()
    K4._meta_op()      # its FLOP formula, before the mode copies the table
    with FlopCounterMode(display=False) as flops, ByteCounter() as nbytes:
        yield counts
    counts.update(flops=flops.get_total_flops(), bytes=nbytes.bytes,
                  collectives=col.counts_by_op())


def full_positions(caches, cur_pos: int):
    """The attention caches as full before a decode at ``cur_pos``: each
    ring's slots hold the positions just before it (a 32k-token context
    at ``decode_32k``)."""
    def fill(node):
        if not isinstance(node, dict):
            return
        if "pos" in node:
            slots = node["pos"].shape[0]
            for p in range(max(0, cur_pos - slots), cur_pos):
                node["pos"][p % slots] = p
        for child in node.values():
            fill(child)
    for block in caches:
        fill(block)
    return caches


def cell_config(arch: str, shape_name: str, debug: bool = False,
                optimized: bool = False):
    """(cfg, shape) of a cell, reduced with ``debug`` as the reference
    reduces them."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if debug:
        cfg = reduced(cfg, d_model=128, n_layers=2 * max(
            1, cfg.attn_every or 1), head_dim=32, vocab=512,
            attn_chunk=64)
        shape = dataclasses.replace(shape, seq_len=min(shape.seq_len, 256),
                                    global_batch=min(shape.global_batch, 16))
    if optimized and shape.kind == "decode":
        # the reference's serving variant: exact heads and an f8 KV
        # cache (decode casts the kept slots to q's type before K4)
        cfg = dataclasses.replace(cfg, pad_heads=False,
                                  kv_cache_dtype=torch.float8_e4m3fn)
    return cfg, shape


def run_cell(api, shape, mesh, rules, key=None):
    """One step of ``shape`` for this rank on ``mesh``: its blocks of
    the params, caches and inputs (``meta`` without ``key``; else drawn
    from ``key`` on its device, the inputs by
    :meth:`~repro_torch.models.api.ModelAPI.make_batch`), then the step
    under :func:`counting`, the rules installed.  A decode step runs at
    the last position of a full cache (:func:`full_positions`).
    Returns (counts, ``memo``: the whole state's and inputs' trees with
    their specs, ``{"params" | "state", "caches", "inputs": (tree,
    specs)}``, for the memory model; the local params; the local
    caches, or ``None``)."""
    cfg = api.cfg
    fsdp = rules.get("_fsdp", True)
    params = sh.shard_params(api.init(key) if key is not None
                             else api.init(None), mesh, fsdp,
                             cfg.moe_ep_data)
    whole = api.input_specs(shape)
    batch = api.make_batch(key, shape) if key is not None else whole
    memo = state_memo(api, shape, rules, whole)
    caches = None
    if shape.kind == "decode":
        cur = shape.seq_len - 1
        caches = sh.shard_cache(full_positions(batch["caches"], cur), mesh,
                                rules)
        with axes_mod.axis_rules(rules, mesh):
            token = sh.batch_rows(batch["token"], mesh, rules)
            with counting() as counts:
                api.decode_step(params, caches, token, cur)
        return counts, memo, params, caches
    memo["inputs"] = (whole, sh.train_batch_specs(whole, rules))
    with axes_mod.axis_rules(rules, mesh):
        local = sh.shard_batch(batch, mesh, rules)
        if shape.kind == "prefill":
            with counting() as counts:
                _, caches = api.prefill(params, local, max_seq=shape.seq_len)
        else:
            state = steps_mod.TrainState(
                params=params, opt=steps_mod.adamw.init(params),
                step=torch.zeros((), dtype=torch.int32))
            step = steps_mod.make_train_step(api)
            with counting() as counts:
                step(state, local)
    return counts, memo, params, caches


def state_memo(api, shape, rules, inputs=None) -> dict:
    """The whole state of a cell's step with its specs, ``{"state" |
    "params", "caches": (tree, specs)}``, as the reference's dry-run
    counts it: a train state's params, moments and two step counters;
    else the params, and the caches a prefill builds or a decode step
    takes (``inputs``: :meth:`input_specs` of ``shape``)."""
    fsdp = rules.get("_fsdp", True)
    params = api.init(None)
    specs = sh.param_specs(params, fsdp, api.cfg.moe_ep_data)
    if shape.kind == "train":
        step = torch.empty((), dtype=torch.int32, device="meta")
        return {"state": ((params,) * 3 + (step, step),
                          (specs,) * 3 + ((), ()))}
    if shape.kind == "decode":
        caches = (inputs or api.input_specs(shape))["caches"]
    else:
        caches = api.init_cache(shape.global_batch, shape.seq_len,
                                device="meta")
    return {"params": (params, specs),
            "caches": (caches, _cache_specs(caches, rules))}


def _cache_specs(caches, rules):
    """The specs of the port's per-block caches under the reference's
    ``_cache_spec`` less its stacked-blocks entry (a leaf's name is its
    key).  The host ``pos`` vectors count as the reference counts its
    device ``pos``: split over "model"."""
    def spec(path, leaf):
        name = next(k for k in reversed(path) if isinstance(k, str))
        return sh._cache_spec(name, sh._Dims(leaf.ndim + 1),
                              rules["batch"])[1:]
    return sh._map(spec, caches)


def mesh_of(multi_pod: bool, debug: bool = False,
            dims: tuple | None = None) -> tuple[tuple, tuple]:
    """(dims, axis names) of a cell's mesh: the production or debug mesh,
    or ``dims`` ((data, model) or (pod, data, model)) where given."""
    if dims is None:
        return MESHES[(multi_pod, debug)]
    return tuple(dims), ("pod", "data", "model")[3 - len(dims):]


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               debug: bool = False, optimized: bool = False,
               dims: tuple | None = None):
    """The cell's record (the reference returns its compiled artifact
    beside it; there is none here).  Needs an initialized ``"fake"``
    process group of the mesh's world (:func:`fake_world`).  ``dims``
    replaces the mesh ``multi_pod`` and ``debug`` pick."""
    dims, names = mesh_of(multi_pod, debug, dims)
    mesh = Mesh(dims, names, "meta")
    mesh_name = "x".join(str(d) for d in dims)
    cfg, shape = cell_config(arch, shape_name, debug, optimized)
    tp = mesh.shape["model"]
    chips = int(np.prod(dims))
    api = build(cfg, tp=tp)
    rules = sh.axis_rules(mesh, shape.global_batch, shape.seq_len,
                          sp_rs=optimized)
    t0 = time.time()
    counts, memo, _p, _c = run_cell(api, shape, mesh, rules)
    t_trace = time.time() - t0
    return record(arch, shape, mesh, mesh_name, chips, cfg, counts, memo,
                  t_trace)


def analytic_bytes(memo, mesh) -> tuple[int, int]:
    """(state bytes, input bytes) per rank of a cell's ``memo``."""
    state = sum(sharded_bytes_per_chip(tree, specs, mesh)
                for k, (tree, specs) in memo.items() if k != "inputs")
    inputs = sharded_bytes_per_chip(*memo["inputs"], mesh) \
        if "inputs" in memo else 0
    return state, inputs


def record(arch, shape, mesh, mesh_name, chips, cfg, counts, memo,
           t_trace) -> dict:
    state_b, input_b = analytic_bytes(memo, mesh)
    act_b = activation_allowance(cfg, shape.seq_len, shape.global_batch,
                                 mesh, shape.kind)
    analytic_gb = (state_b + input_b + act_b) / 1e9
    rl = build_roofline(arch, shape.name, mesh_name, counts, cfg,
                        shape.kind, shape.seq_len, shape.global_batch,
                        chips)
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "kind": shape.kind, "chips": chips,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "trace_s": round(t_trace, 1),
        "flops_per_chip": rl.flops_per_chip,
        "hbm_bytes_per_chip": rl.hbm_bytes_per_chip,
        "coll_bytes_per_chip": rl.coll_bytes_per_chip,
        "coll_detail": rl.coll_detail,
        "model_flops_per_chip": rl.model_flops,
        "t_compute_ms": rl.t_compute * 1e3,
        "t_memory_ms": rl.t_memory * 1e3,
        "t_collective_ms": rl.t_collective * 1e3,
        "bottleneck": rl.bottleneck,
        "useful_flops_fraction": rl.useful_flops_fraction,
        "roofline_fraction": rl.roofline_fraction,
        "analytic_memory_gb": round(analytic_gb, 2),
        "analytic_state_gb": round(state_b / 1e9, 2),
        "memory_analysis": None,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCHS + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--debug", action="store_true",
                    help="reduced configs on a small mesh")
    ap.add_argument("--optimized", action="store_true",
                    help="the serving variant: exact heads, an f8 KV "
                         "cache, sp_rs")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--json", action="store_true",
                    help="print each record as one JSON line")
    ap.add_argument("--mesh-shape", default=None,
                    help="another mesh, e.g. 1x1 or 2x2x4 (data x model, "
                         "or pod x data x model) in place of --mesh's")
    args = ap.parse_args(argv)
    args.dims = tuple(int(d) for d in args.mesh_shape.split("x")) \
        if args.mesh_shape else None

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else ARCHS
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    if args.dims:
        meshes = [len(args.dims) == 3]
    for multi in meshes:
        world = int(np.prod(mesh_of(multi, args.debug, args.dims)[0]))
        with fake_world(world):
            for arch in archs:
                failures += _arch_cells(arch, multi, args)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err)
        raise SystemExit(1)
    print("\nAll dry-run cells ran.")


def _arch_cells(arch: str, multi: bool, args) -> list:
    cfg = get_config(arch)
    shapes = [args.shape] if args.shape else applicable_shapes(cfg)
    if not args.shape and not cfg.sub_quadratic:
        print(f"SKIP {arch} x long_500k (full attention at 524k KV)")
    failures = []
    for shape_name in shapes:
        if shape_name not in applicable_shapes(cfg):
            print(f"SKIP {arch} x {shape_name} (not an applicable shape)")
            continue
        tag = f"{arch}_{shape_name}_" + ("x".join(map(str, args.dims))
                                          if args.dims else
                                          "multi" if multi else "single")
        try:
            t0 = time.time()
            rec = lower_cell(arch, shape_name, multi, debug=args.debug,
                             optimized=args.optimized, dims=args.dims)
            print(f"OK   {tag}: trace {time.time()-t0:6.1f}s  "
                  f"flops/chip={rec['flops_per_chip']:.3e}  "
                  f"bytes/chip={rec['hbm_bytes_per_chip']:.3e}  "
                  f"coll/chip={rec['coll_bytes_per_chip']:.3e}  "
                  f"mem/chip={rec['analytic_memory_gb']:.2f}GB  "
                  f"bottleneck={rec['bottleneck']}", flush=True)
            if args.json:
                print(json.dumps(rec), flush=True)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
        except Exception as e:  # noqa: BLE001
            failures.append((tag, repr(e)))
            print(f"FAIL {tag}: {e!r}", flush=True)
            traceback.print_exc()
    return failures


if __name__ == "__main__":
    main()
