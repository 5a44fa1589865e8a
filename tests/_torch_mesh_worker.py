"""One rank of the CPU process groups of ``tests/test_torch_parallel.py``,
``tests/test_torch_parallel_lm.py``,
``tests/test_torch_parallel_train.py`` and
``tests/test_torch_parallel_ssm.py`` (started by
``tests/_torch_group.py``; imports neither JAX nor the reference; the
training job is ``tests/_torch_train_worker.py``'s).

  python -m _torch_mesh_worker <job> <rank> <world> <workdir>

Every rank joins one gloo group (rendezvous through ``workdir``, 60 s
collective timeout), builds the (2, 4) ("data", "model") mesh, reads
``workdir / "inputs.pkl"`` and runs ``<job>`` on its blocks; rank 0
writes the job's result to ``workdir / "result.pkl"``.
"""

from __future__ import annotations

import contextlib
import datetime
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.convert import (lm_cache_from_numpy, lm_cache_to_numpy,
                                lm_params_from_numpy)
from repro_torch.kernels.attention_block import kernel as K4
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.api import build
from repro_torch.models.embedding import gather_logits
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.axes import axis_rules

SHAPE = (2, 4)
#: the a2a's capacity factor where the experts' capacity drops tokens
TIGHT = 1.0


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else t


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _gather_rows(t: torch.Tensor) -> torch.Tensor:
    """This data rank's rows -> every row (the batch over "data")."""
    return col.all_gather(t, "data", dim=0)


# --------------------------------------------------------------------------
# test_torch_parallel.py
# --------------------------------------------------------------------------

def job_parallel(mesh, inp):
    r = dist.get_rank()
    out = {"mesh": (dict(mesh.shape), mesh.axis_names, dict(mesh.index),
                    str(mesh.device))}
    rules = {"batch": ("data",)}
    with axis_rules(rules, mesh):
        col.reset()
        x = torch.arange(24, dtype=torch.float32).reshape(8, 3) + 100 * r
        out["psum_model"] = _np(col.psum(x, "model"))
        out["psum_both"] = _np(col.psum(x, ("model", "data")))
        out["pmax_data"] = _np(col.pmax(x, "data"))
        out["gather_model_dim1"] = _np(col.all_gather(x, "model", dim=1))
        out["scatter_model_dim0"] = _np(col.psum_scatter(x, "model", dim=0))
        out["a2a_model"] = _np(col.all_to_all(x.reshape(4, 2, 3), "model"))
        out["axis_index"] = (col.axis_index("model"), col.axis_index("data"),
                             col.axis_index(("model", "data")))
        out["untouched"] = _np(x)
        out["counts"] = {k: dict(v) for k, v in col.COUNTS.items()}

        # the MoE modes on the shapes of tests/test_distributed.py
        moe = inp["moe"]
        k, e = moe["top_k"], moe["n_experts"]
        p = {n: _t(a) for n, a in moe["params"].items()}
        specs = {"router": (None, None), "wg": ("model", None, "data"),
                 "wi": ("model", None, "data"), "wo": ("model", "data", None)}
        pl = {n: sh.local_shard(p[n], specs[n], mesh) for n in p}
        col.reset()
        xa = sh.local_shard(_t(moe["x_a2a"]), (("data", "model"), None), mesh)
        out["a2a"] = _np(M.moe_ffn_a2a(xa, pl, k, float(e), "model", "data"))
        out["a2a_counts"] = {k_: dict(v) for k_, v in col.COUNTS.items()}
        out["a2a_tight"] = _np(M.moe_ffn_a2a(xa, pl, k, TIGHT, "model",
                                             "data"))
        xp = sh.local_shard(_t(moe["x_psum"]), ("data", None), mesh)
        out["psum"] = _np(M.moe_ffn_psum(xp, pl, k, "model", "data"))
        p2 = {n: _t(a) for n, a in moe["params_ep2"].items()}
        specs2 = {"router": (None, None)} | {
            n: (("model", "data"), None, None) for n in ("wg", "wi", "wo")}
        pl2 = {n: sh.local_shard(p2[n], specs2[n], mesh) for n in p2}
        out["ep2"] = _np(M.moe_ffn_psum_ep2(xp, pl2, k, ("model", "data"),
                                            "data"))

        # the sharded decode's merge (K4 with its log-sum-exp on the CPU,
        # and the plain version's pmax/psum) on each case of the slots
        att = inp["attention"]
        res = {}
        for case, c in att["cases"].items():
            for attn in ("kernel", "plain"):
                cache = {"k": sh.local_shard(_t(c["k"]), (None, "model"),
                                             mesh).clone(),
                         "v": sh.local_shard(_t(c["v"]), (None, "model"),
                                             mesh).clone(),
                         "pos": np.array(c["pos"], np.int32)}
                seen = []
                o = A._decode_local(
                    _t(att["q"]), _t(att["new_k"]), _t(att["new_v"]), cache,
                    c["cur"], c["window"], 4, attn,
                    lambda q_, k_, v_, o_, **kw: seen.append(k_.shape[1]))
                res[(case, attn)] = (_np(o), cache["pos"], seen,
                                     _np(cache["k"]))
        out["attention"] = res
    return out


# --------------------------------------------------------------------------
# test_torch_parallel_lm.py
# --------------------------------------------------------------------------

def _cfg(arch: str, over: dict):
    return reduced(get_config(arch), **over)


def _run_arch(mesh, spec) -> dict:
    cfg = _cfg(spec["arch"], spec["over"])
    b, s = spec["tokens"].shape[0], spec["prompt"]
    rules = sh.axis_rules(mesh, b, s)
    api = build(cfg, tp=mesh.shape["model"])
    params = lm_params_from_numpy(spec["params"], "cpu", mesh=mesh)
    tokens = torch.from_numpy(spec["tokens"].astype(np.int64))
    logits = []
    K4.attention.launches = 0
    with axis_rules(rules, mesh):
        batch = {"tokens": sh.batch_rows(tokens[:, :s], mesh, rules)}
        if "frames" in spec:
            batch["frames"] = sh.batch_rows(_t(spec["frames"]), mesh, rules)
        col.reset()
        lg, caches = api.prefill(params, batch, max_seq=spec["max_seq"])
        prefill_counts = col.counts_by_op()
        logits.append(_np(gather_logits(lg)))
        slots = [c["k"].shape[1] for blk in caches for c in blk.values()
                 if isinstance(c, dict) and "k" in c]
        col.reset()
        for i in range(spec["steps"]):
            tok = sh.batch_rows(tokens[:, s + i:s + i + 1], mesh, rules)
            lg, caches = api.decode_step(params, caches, tok, s + i)
            logits.append(_np(gather_logits(lg)))
        decode_counts = col.counts_by_op()
        whole = _whole_caches(caches, mesh, rules) if spec.get("caches") \
            else None
        unsplit = None
        if "unsplit" in spec:          # a prompt the model axis does not split
            try:
                api.prefill(params, {"tokens": sh.batch_rows(
                    tokens[:, :spec["unsplit"]], mesh, rules)},
                    max_seq=spec["max_seq"])
            except ValueError as e:
                unsplit = str(e)
    return {"logits": logits, "slots_local": slots,
            "prefill_counts": prefill_counts, "decode_counts": decode_counts,
            "lse_launches": dict(K4.attention.lse_launches_by_route),
            "unsplit": unsplit, "caches": whole}


def _whole_caches(caches, mesh, rules) -> dict:
    """Every rank's blocks of the decode caches gathered whole, in the
    reference's stacked numpy layout (``pos`` is whole already)."""
    def whole(name, t):
        if not isinstance(t, torch.Tensor):
            return t
        spec = sh._cache_spec(name, sh._Dims(t.dim() + 1),
                              rules["batch"])[1:]
        return sh.gather_whole(t, spec, mesh)
    return lm_cache_to_numpy([{sub: {n: whole(n, t) for n, t in c.items()}
                               for sub, c in blk.items()} for blk in caches])


def _run_decode_block(mesh, c) -> dict:
    cfg = _cfg("phi3-medium-14b", c["over"])
    nh, nkv = c["heads"]
    rules = sh.axis_rules(mesh, c["h"].shape[0], 1)
    path = ("blocks", 0, "sub0", "attn")
    params = {n: sh.local_shard(_t(a), sh.leaf_spec(path + (n,), a,
                                                    fsdp=False), mesh)
              for n, a in c["params"].items()}
    with axis_rules(rules, mesh):
        cache = lm_cache_from_numpy(
            {"sub0": {n: np.asarray(a)[None] for n, a in c["cache"].items()}},
            device="cpu", mesh=mesh, rules=rules)[0]["sub0"]
        h = sh.batch_rows(_t(c["h"]), mesh, rules)
        seen = []
        out, cache = A.decode_block(
            params, h, cache, c["cur"], cfg, nh, nkv,
            tap=lambda q, k, v, o, **kw: seen.append(k.shape[1]))
        out = _gather_rows(out)
    return {"out": _np(out), "pos": cache["pos"], "seen": seen}


def _serve(mesh, spec) -> dict:
    cfg = _cfg(spec["arch"], spec["over"])
    params = lm_params_from_numpy(spec["params"], "cpu")
    server = BatchedServer(cfg, mesh, slots=spec["slots"],
                           max_seq=spec["max_seq"], params=params)
    for rid, prompt in enumerate(spec["prompts"]):
        server.submit(Request(rid=rid, prompt=list(prompt),
                              max_new=spec["max_new"]))
    reqs = list(server.queue)
    steps = 0
    while (server.active or server.queue) and steps < spec["max_seq"]:
        server.step()
        steps += 1
    return {"outs": [r.out for r in reqs], "steps": steps}


def job_lm(mesh, inp):
    out = {"archs": {}, "blocks": {}, "serve": {}}
    for name, spec in inp["archs"].items():
        out["archs"][name] = _run_arch(mesh, spec)
    for name, c in inp["blocks"].items():
        out["blocks"][name] = _run_decode_block(mesh, c)
    for name, spec in inp["serve"].items():
        out["serve"][name] = _serve(mesh, spec)
    return out


def job_train(mesh, inp, workdir):
    from _torch_train_worker import job_train as run
    return run(mesh, inp, workdir)


_HEADS_CUT = S.heads_cut


def contiguous_cut(cfg, r: int, mp: int):
    """The control of the Mamba mixer's regrouping: rank ``r``'s conv
    channels read at its contiguous block of ``conv_dim`` (the
    reference's split of ``conv_w``) as if they were its heads'."""
    cut = _HEADS_CUT(cfg, r, mp)
    block = (cfg.d_inner + 2 * cfg.ssm_state) // mp
    return S.Cut(z=cut.z, x=(r * block, r * block + cut.x[1] - cut.x[0]),
                 dt=cut.dt)


@contextlib.contextmanager
def _ssm_cut(name: str | None):
    """``contiguous``: :func:`contiguous_cut` in place of the mixer's
    ``heads_cut`` (a control, patched here alone)."""
    if name != "contiguous":
        yield
        return
    S.heads_cut = contiguous_cut
    try:
        yield
    finally:
        S.heads_cut = _HEADS_CUT


def job_ssm(mesh, inp, workdir):
    """The Mamba mixer on the model axis of 4: serving (prefill, decode
    steps, the caches gathered whole; a control under ``_ssm_cut``) and
    the training cases of ``_torch_train_worker``."""
    from _torch_train_worker import _case
    keep = dist.get_rank() == 0
    out = {"serve": {}, "train": {}}
    for name, spec in inp["serve"].items():
        with _ssm_cut(spec.get("control")):
            out["serve"][name] = _run_arch(mesh, spec)
    for name, case in inp["cases"].items():
        out["train"][name] = _case(mesh, case, inp["archs"][case["arch"]],
                                   keep)
    return out


JOBS = {"parallel": lambda mesh, inp, workdir: job_parallel(mesh, inp),
        "lm": lambda mesh, inp, workdir: job_lm(mesh, inp),
        "train": job_train, "ssm": job_ssm}


def main(argv=None) -> None:
    job, rank, world, workdir = (argv or sys.argv[1:])
    rank, world, workdir = int(rank), int(world), Path(workdir)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{workdir / 'rendezvous'}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh_for(world, SHAPE[1], device="cpu")
        with open(workdir / "inputs.pkl", "rb") as f:
            inp = pickle.load(f)
        result = JOBS[job](mesh, inp, workdir)
        gathered = [None] * world if rank == 0 else None
        dist.gather_object(result, gathered, dst=0)
        if rank == 0:
            with open(workdir / "result.pkl", "wb") as f:
                pickle.dump(gathered, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
