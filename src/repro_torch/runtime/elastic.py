"""Elastic scaling: the (data, model) plan for a changed device set and
the state re-sliced onto it — the port's copy of
``repro/runtime/elastic.py``.

When ranks are lost (or added back), :func:`plan_remesh` picks the
largest valid (data, model) split of the survivors, keeping the
model-parallel degree where it divides them (padded head counts bake it
into the weights); the data axis absorbs the change, which needs only
the global batch to stay divisible.  :func:`reshard_state` re-slices
whole state (the port's params layout, or any tree of them) onto the
new mesh's shards.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.parallel import sharding as sh
from repro_torch.parallel.axes import Mesh


@dataclasses.dataclass
class ElasticPlan:
    dp: int
    tp: int
    global_batch: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.dp, self.tp)

    def build_mesh(self, device: str = "cuda") -> Mesh:
        """The mesh over the (surviving) world, which must hold
        ``dp * tp`` ranks."""
        return Mesh(self.shape, ("data", "model"), device)


def plan_remesh(n_devices: int, tp: int, global_batch: int) -> ElasticPlan:
    """Largest usable (data, model) split for the surviving devices.

    Keeps the TP degree when it divides the survivor count; otherwise
    degrades it."""
    mp = max(1, min(tp, n_devices))
    while n_devices % mp:
        mp -= 1
    dp = n_devices // mp
    gb = max((global_batch // dp) * dp, dp)
    return ElasticPlan(dp=dp, tp=mp, global_batch=gb)


def reshard_state(state: Any, mesh: Mesh, fsdp: bool = True,
                  moe_ep_data: bool = False) -> Any:
    """Whole state -> this rank's blocks on ``mesh``: every leaf under
    the spec its path names (a params tree, or one that holds params
    trees, as a ``TrainState`` or ``{"params", "m", "v", "step"}`` does:
    the moments take their params' specs; a step counter stays whole,
    on the host)."""
    return sh.shard_params(state, mesh, fsdp=fsdp, moe_ep_data=moe_ep_data)
