"""The reference's MoE mesh modes on a (2, 4) mesh of 8 host devices, as
``tests/test_distributed.py`` runs them: ``moe_ffn_a2a`` (also at
capacity factor 1, where the capacity drops tokens),
``moe_ffn_psum`` and ``moe_ffn_psum_ep2`` under ``shard_map``.  Run in a
process of its own by ``tests/test_torch_parallel.py``:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
      python tests/_jax_moe_modes.py <inputs.pkl> <outputs.npz>
"""

import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from repro.models.moe import moe_ffn_a2a, moe_ffn_psum, moe_ffn_psum_ep2
from repro.parallel.compat import shard_map


def main(inputs: str, outputs: str) -> None:
    with open(inputs, "rb") as f:
        moe = pickle.load(f)["moe"]
    assert len(jax.devices()) >= 8, jax.devices()
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    k, e = moe["top_k"], moe["n_experts"]
    params = {n: jnp.asarray(a) for n, a in moe["params"].items()}
    wspecs = {"router": P(None, None), "wg": P("model", None, "data"),
              "wi": P("model", None, "data"),
              "wo": P("model", "data", None)}
    a2a = shard_map(
        lambda xl, pp: moe_ffn_a2a(xl, pp, k, float(e), "model", "data"),
        mesh=mesh, in_specs=(P(("data", "model")), wspecs),
        out_specs=P(("data", "model")), check_vma=False)(
            jnp.asarray(moe["x_a2a"]), params)
    tight = shard_map(
        lambda xl, pp: moe_ffn_a2a(xl, pp, k, 1.0, "model", "data"),
        mesh=mesh, in_specs=(P(("data", "model")), wspecs),
        out_specs=P(("data", "model")), check_vma=False)(
            jnp.asarray(moe["x_a2a"]), params)
    psum = shard_map(
        lambda xl, pp: moe_ffn_psum(xl, pp, k, "model", "data"),
        mesh=mesh, in_specs=(P("data"), wspecs), out_specs=P("data"),
        check_vma=False)(jnp.asarray(moe["x_psum"]), params)
    params2 = {n: jnp.asarray(a) for n, a in moe["params_ep2"].items()}
    wspecs2 = {"router": P(None, None)} | {
        n: P(("model", "data"), None, None) for n in ("wg", "wi", "wo")}
    ep2 = shard_map(
        lambda xl, pp: moe_ffn_psum_ep2(xl, pp, k, ("model", "data"),
                                        batch_axis="data"),
        mesh=mesh, in_specs=(P("data"), wspecs2), out_specs=P("data"),
        check_vma=False)(jnp.asarray(moe["x_psum"]), params2)
    np.savez(outputs, a2a=np.asarray(a2a), a2a_tight=np.asarray(tight),
             psum=np.asarray(psum),
             ep2=np.asarray(ep2))


if __name__ == "__main__":
    main(*sys.argv[1:])
