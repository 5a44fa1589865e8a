"""The reference dry-run's analytic memory terms (``repro/launch/
dryrun.py:85-170``) without lowering: for each cell, the sharded state
and input bytes a chip holds under the reference's own shardings, on a
mesh of 8 host devices.  Run in a process of its own by
``tests/test_torch_dryrun.py``:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
      python tests/_jax_dryrun_ref.py <inputs.pkl> <outputs.pkl>

``inputs.pkl`` holds ``{"cells": [(arch, shape, mesh shape, axis names,
debug), ...], "optimized": [(arch, decode shape, debug), ...]}``;
``outputs.pkl`` ``{"cells": one {"state", "inputs"} per cell,
"optimized": one {"pad_heads", "kv_cache_dtype", "params", "caches"}
per optimized cell}``.  An optimized cell's config is the one the
reference's ``lower_cell(..., optimized=True)`` builds (caught at its
``build``, before anything is lowered), its bytes those of its params
and caches on the (2, 4) mesh under its ``sp_rs`` rules.
"""

import dataclasses
import pickle
import sys

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.analysis.memory_model import sharded_bytes_per_chip
from repro.configs import SHAPES, get_config, reduced
from repro.launch import steps as steps_mod
from repro.models.api import build
from repro.parallel import axes as axes_mod
from repro.parallel import sharding as sh


def cell(arch, shape_name, dims, names, debug):
    mesh = jax.make_mesh(dims, names)
    cfg, shape = get_config(arch), SHAPES[shape_name]
    if debug:
        cfg = reduced(cfg, d_model=128, n_layers=2 * max(
            1, cfg.attn_every or 1), head_dim=32, vocab=512, attn_chunk=64)
        shape = dataclasses.replace(shape, seq_len=min(shape.seq_len, 256),
                                    global_batch=min(shape.global_batch, 16))
    api = build(cfg, tp=mesh.shape["model"])
    rules = sh.axis_rules(mesh, shape.global_batch, shape.seq_len)
    with axes_mod.axis_rules(rules, mesh):
        specs = api.input_specs(shape)
        batch = sh.batch_shardings(specs, mesh, rules)
        if shape.kind == "train":
            st = jax.eval_shape(lambda: steps_mod.init_train_state(
                api, jax.random.PRNGKey(0)))
            rep = NamedSharding(mesh, P())
            shard = steps_mod.TrainState(
                params=sh.param_shardings(st.params, mesh),
                opt=type(st.opt)(m=sh.param_shardings(st.opt.m, mesh),
                                 v=sh.param_shardings(st.opt.v, mesh),
                                 step=rep), step=rep)
            return {"state": sharded_bytes_per_chip(st, shard, mesh),
                    "inputs": sharded_bytes_per_chip(specs, batch, mesh)}
        params = jax.eval_shape(api.init, jax.random.PRNGKey(0))
        state = sharded_bytes_per_chip(params, sh.param_shardings(
            params, mesh), mesh)
        if shape.kind == "prefill":
            caches = jax.eval_shape(
                lambda: api.init_cache(shape.global_batch, shape.seq_len))
            _, cs = sh.output_shardings_for_decode(mesh, rules, caches)
            return {"state": state + sharded_bytes_per_chip(caches, cs,
                                                            mesh),
                    "inputs": sharded_bytes_per_chip(specs, batch, mesh)}
        _, cs = sh.output_shardings_for_decode(mesh, rules, specs["caches"])
        return {"state": state + sharded_bytes_per_chip(specs["caches"], cs,
                                                        mesh),
                "inputs": 0}


class _Built(Exception):
    """Raised by the stand-in ``build``: the config is caught."""


def optimized_cell(arch, shape_name, debug):
    """The reference's ``--optimized`` decode config of a cell on the
    (2, 4) mesh (its production mesh stood in by that one), and the
    bytes a chip holds of its params and caches."""
    from repro.launch import dryrun as ref_dryrun
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    caught = {}

    def catch(cfg, tp=1):
        caught["cfg"] = cfg
        raise _Built

    saved = ref_dryrun.build, ref_dryrun.make_production_mesh
    ref_dryrun.build = catch
    ref_dryrun.make_production_mesh = lambda multi_pod=False: mesh
    try:
        ref_dryrun.lower_cell(arch, shape_name, False, debug=debug,
                              optimized=True)
    except _Built:
        pass
    finally:
        ref_dryrun.build, ref_dryrun.make_production_mesh = saved
    cfg = caught["cfg"]
    shape = SHAPES[shape_name]
    if debug:
        shape = dataclasses.replace(shape, seq_len=min(shape.seq_len, 256),
                                    global_batch=min(shape.global_batch, 16))
    api = build(cfg, tp=mesh.shape["model"])
    rules = sh.axis_rules(mesh, shape.global_batch, shape.seq_len,
                          sp_rs=True)
    with axes_mod.axis_rules(rules, mesh):
        specs = api.input_specs(shape)
        params = jax.eval_shape(api.init, jax.random.PRNGKey(0))
        _, cs = sh.output_shardings_for_decode(mesh, rules, specs["caches"])
        return {"pad_heads": cfg.pad_heads,
                "kv_cache_dtype": None if cfg.kv_cache_dtype is None
                else jax.numpy.dtype(cfg.kv_cache_dtype).name,
                "params": sharded_bytes_per_chip(params, sh.param_shardings(
                    params, mesh), mesh),
                "caches": sharded_bytes_per_chip(specs["caches"], cs, mesh)}


def main(inputs: str, outputs: str) -> None:
    with open(inputs, "rb") as f:
        todo = pickle.load(f)
    assert len(jax.devices()) >= 8, jax.devices()
    out = {"cells": [cell(*c) for c in todo["cells"]],
           "optimized": [optimized_cell(*c)
                         for c in todo.get("optimized", ())]}
    with open(outputs, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
