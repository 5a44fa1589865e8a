"""Layer-wise off-chip communication lower bound (paper Sec. III).

The port's copy of the parts of ``repro/core/lower_bound.py`` the
serving path uses:

  * Eq. (15)   — the practical/attainable form
                    Q ~= 2*#MACs/sqrt(R*S) + |outputs|
                 (:func:`q_dram_practical`), floored at the once-per-word
                 ideal, and its serving-horizon form
                 (:func:`q_dram_serving`);
  * Eq. (15) applied to the backward convs of a training step
                 (:func:`q_dram_dgrad`, :func:`q_dram_wgrad`) and
                 their per-step sum (:func:`q_dram_training`);
  * the optimal tile aspect ratio  u = R*z,  u*z = S (Sec. IV-C's two
    key conditions, :func:`optimal_block`), and the unfolding of u into
    a batch-folded (b, y, x) tile (:func:`fold_u`), which seed the
    accounting planner in :mod:`repro_torch.core.hopper_adapter`.

All volumes are in *elements* (words); multiply by dtype bytes for bytes.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.layer import ConvLayer


def q_dram_practical(layer: ConvLayer, s: int) -> float:
    """Eq. (15): attainable lower bound with u*z ~= S and u ~= R*z.

      Q ~= 2 * B*Wo*Ho*Co*Wk*Hk*Ci / sqrt(R*S)  +  B*Wo*Ho*Co

    The second term is the mandatory write-back of every output.
    """
    r = layer.reuse_r
    read = 2.0 * layer.macs / math.sqrt(r * s)
    write = float(layer.n_outputs)
    # The bound can never require less than reading every input+weight
    # once and writing every output once (the "ideal case", Sec. III-B).
    return max(read + write, q_dram_ideal(layer))


def q_dram_serving(layer: ConvLayer, s: int, *, requests: int) -> float:
    """Serving-horizon Eq. (15): per-image attainable bound when one
    plan serves ``requests`` images over its lifetime — the layer at
    batch = n, divided by n, so the once-per-word weight floor inside
    :func:`q_dram_ideal` amortizes 1/n.  Returns words *per image*."""
    n = max(1, int(requests))
    horizon = dataclasses.replace(layer, batch=n)
    return q_dram_practical(horizon, s) / n


def q_dram_dgrad(layer: ConvLayer, s: int) -> float:
    """Eq. (15) applied to the layer's *dgrad* conv (dx from dy).

    A conv's input gradient is itself a conv: dy (spatially dilated by
    the forward stride) against the flipped ``(Hk, Wk, Co, Ci)``
    weights at unit stride and "full" padding.  It performs the same
    #MACs as the forward pass; each *real* dy word feeds Hk*Wk output
    positions (unit-stride window reuse, regardless of the forward
    stride — the dilation zeros carry no data), and every dx element
    is a mandatory write.  Floored at the once-per-word ideal (dy and
    the weights read once, dx written once).
    """
    r = float(layer.hk * layer.wk)
    read = 2.0 * layer.macs / math.sqrt(r * s)
    ideal = float(layer.n_outputs + layer.n_weights + layer.n_inputs)
    return max(read + float(layer.n_inputs), ideal)


def q_dram_wgrad(layer: ConvLayer, s: int) -> float:
    """Eq. (15) applied to the layer's *wgrad* conv (dW from x and dy).

    dW is the conv of the input with the incoming gradient: the
    "kernel" plane is dy (Ho x Wo), batch folds into the reduction
    (every image contributes to the same dW), and the output is the
    Hk x Wk x Ci x Co weight tensor — written exactly once.  Same
    #MACs as the forward; an input element is reused by at most
    Hk*Wk / stride**2 of the Hk x Wk output positions, i.e. the
    forward reuse factor R.  Floored at the once-per-word ideal (x and
    dy read once, dW written once).
    """
    read = 2.0 * layer.macs / math.sqrt(layer.reuse_r * s)
    touched_in = (layer.batch * layer.ci
                  * layer.fetched_area(layer.wo, layer.ho))
    ideal = float(touched_in + layer.n_outputs + layer.n_weights)
    return max(read + float(layer.n_weights), ideal)


def q_dram_training(layer: ConvLayer, s: int, *, bwd: bool = True) -> float:
    """Attainable lower bound for one *training step* of the layer:
    forward + dgrad + wgrad, each a conv covered by Theorem 2.

      Q_step >= Q_fwd(S) + Q_dgrad(S) + Q_wgrad(S)

    ``bwd=False`` reduces to :func:`q_dram_practical` (inference).
    """
    q = q_dram_practical(layer, s)
    if bwd:
        q += q_dram_dgrad(layer, s) + q_dram_wgrad(layer, s)
    return q


def q_dram_ideal(layer: ConvLayer) -> float:
    """Every tensor touched exactly once (needs unbounded on-chip mem).

    Inputs count only *touched* pixels (a strided conv never reads the
    skipped rows/cols), i.e. the clipped union of all sliding windows."""
    touched_in = (layer.batch * layer.ci
                  * layer.fetched_area(layer.wo, layer.ho))
    return float(touched_in + layer.n_weights + layer.n_outputs)


@dataclasses.dataclass(frozen=True)
class OptimalTiles:
    """The bound-attaining block geometry of Sec. IV-C."""

    u: int   # output-block rows  (= b*x*y in conv space)
    z: int   # output-block cols  (= #kernels resident)
    k: int   # reduction slice streamed per pass (paper: k = 1)

    @property
    def psum_footprint(self) -> int:
        return self.u * self.z


def optimal_block(s: int, r: float = 1.0, k: int = 1) -> OptimalTiles:
    """Solve u ~= R*z, u*z ~= S for the psum-resident output block:
    z = sqrt(S / R), u = R*z = sqrt(S * R)."""
    z = max(1, int(math.sqrt(s / r)))
    u = max(1, int(r * z))
    # shrink to respect u*z <= S exactly
    while u * z > s and u > 1:
        u -= max(1, u // 16)
    return OptimalTiles(u=u, z=max(1, z), k=k)


def fold_u(u: int, batch: int, ho: int, wo: int) -> tuple[int, int, int]:
    """Unfold the paper's u = b*x*y output-block rows into (b, y, x):
    a square-ish spatial tile first (minimum halo perimeter per psum
    area), then the remaining u folds into the batch dimension, where
    it adds no halo."""
    x = min(wo, max(1, int(math.sqrt(u))))
    y = min(ho, max(1, u // x))
    b = min(batch, max(1, u // (x * y)))
    return b, y, x
