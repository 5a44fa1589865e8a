"""Layer-wise off-chip communication lower bound (paper Sec. III).

The port's copy of ``repro/core/lower_bound.py``.

Implements:
  * Theorem 2  — asymptotic bound  Q_DRAM = Omega(#MACs / sqrt(R*S))
  * Eq. (15)   — the practical/attainable form used for every "Lower
                 bound" curve in the paper's evaluation:
                    Q ~= 2*#MACs/sqrt(R*S) + |outputs|
  * T(S) bound — Lemma 2's maximum number of terms O(S*sqrt(R*S)),
                 with the exact constant S*sqrt(R*S)/(3*sqrt(3)).
  * the optimal tile aspect ratio  u = R*z,  u*z = S (Sec. IV-C's two
    key conditions), used by the dataflow and by the accounting
    planner's block-shape chooser in
    :mod:`repro_torch.core.hopper_adapter`.

All volumes are in *elements* (words); multiply by dtype bytes for bytes.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.layer import ConvLayer


def terms_upper_bound(s: int, r: float) -> float:
    """Lemma 2: max #terms producible from S memory in <=S add trees.

    T(S) <= S*sqrt(R*S) / (3*sqrt(3)), equality iff the output block is
    a single u x z block with u = R*z and the three operand footprints
    are balanced (u*k/R = z*k = u*z).
    """
    return s * math.sqrt(r * s) / (3.0 * math.sqrt(3.0))


def min_partitions(layer: ConvLayer, s: int) -> float:
    """Eq. (12): P(S) = Omega(#internal+output nodes / (2T(S)+S)).

    Lemma 1 counts 2*#MACs internal+output nodes; Lemma 3 caps each
    subset at 2T(S)+S nodes.
    """
    nodes = 2.0 * layer.macs
    return nodes / (2.0 * terms_upper_bound(s, layer.reuse_r) + s)


def q_dram_theorem2(layer: ConvLayer, s: int) -> float:
    """Theorem 2 asymptotic lower bound via Theorem 1: Q >= S*(P(2S)-1)."""
    return s * max(0.0, min_partitions(layer, 2 * s) - 1.0)


def q_dram_practical(layer: ConvLayer, s: int) -> float:
    """Eq. (15): attainable lower bound with u*z ~= S and u ~= R*z.

      Q ~= 2 * B*Wo*Ho*Co*Wk*Hk*Ci / sqrt(R*S)  +  B*Wo*Ho*Co

    The second term is the mandatory write-back of every output.  The
    paper's Figs. 13-15 plot exactly this quantity as "Lower bound".
    """
    r = layer.reuse_r
    read = 2.0 * layer.macs / math.sqrt(r * s)
    write = float(layer.n_outputs)
    # The bound can never require less than reading every input+weight
    # once and writing every output once (the "ideal case", Sec. III-B).
    return max(read + write, q_dram_ideal(layer))


def q_dram_serving(layer: ConvLayer, s: int, *, requests: int) -> float:
    """Serving-horizon Eq. (15): per-image attainable bound when one
    plan serves ``requests`` images over its lifetime.

    The bound is over output elements u = B*Ho*Wo, so a serving horizon
    of n images through the same compiled plan is just the layer at
    batch = n: the MAC/sqrt(R*S) term and |outputs| scale per image,
    while the once-per-word weight floor inside ``q_dram_ideal``
    amortizes 1/n — the number a bucketed server should be judged
    against, since its weights are resident across requests rather than
    re-justified per dispatch.  Returns words *per image*.
    """
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
    Hk*Wk / stride**2 of the Hk x Wk output positions (the windows of
    the wgrad conv that cover it), i.e. the forward reuse factor R.
    Floored at the once-per-word ideal (x and dy read once, dW written
    once).
    """
    read = 2.0 * layer.macs / math.sqrt(layer.reuse_r * s)
    touched_in = (layer.batch * layer.ci
                  * layer.fetched_area(layer.wo, layer.ho))
    ideal = float(touched_in + layer.n_outputs + layer.n_weights)
    return max(read + float(layer.n_weights), ideal)


def q_dram_training(layer: ConvLayer, s: int, *, bwd: bool = True) -> float:
    """Attainable lower bound for one *training step* of the layer:
    forward + dgrad + wgrad, each a conv covered by Theorem 2.

    Per step the weights are read (at least) twice — once by the
    forward, once by dgrad — and dW is written once; x and dy are each
    read by two passes.  All of that is captured by summing the three
    per-conv Eq. (15) bounds (each with its own once-per-word floor):

      Q_step >= Q_fwd(S) + Q_dgrad(S) + Q_wgrad(S)

    ``bwd=False`` reduces to :func:`q_dram_practical` (inference).
    Monotone non-increasing in S, like every Eq. (15) form.
    """
    q = q_dram_practical(layer, s)
    if bwd:
        q += q_dram_dgrad(layer, s) + q_dram_wgrad(layer, s)
    return q


def q_dram_graph(stages, *, bwd: bool = False) -> float:
    """Per-graph Eq. (15) sum over heterogeneous layers.

    The bound is per-conv, so a conv network's bound is the sum over
    its layers — strided, 1x1, grouped alike.  ``stages`` is a
    sequence of ``(ConvLayer, S)`` pairs (each layer scored at its own
    realized footprint, the convention every distance-to-bound test
    uses); ``bwd=True`` sums the training-step form
    (:func:`q_dram_training`) instead of the inference form.  Residual
    joins add their mandatory read on the *plan* side
    (``ConvPlan.bound_words``), not here — this is the pure per-layer
    conv sum."""
    return sum(q_dram_training(layer, s, bwd=bwd) for layer, s in stages)


def q_dram_graph_serving(stages, *, requests: int) -> float:
    """Serving-horizon per-graph bound: the :func:`q_dram_serving` sum
    over heterogeneous ``(ConvLayer, S)`` pairs — words *per image*
    when one set of compiled plans serves ``requests`` images (the
    weights of every layer amortize over the horizon jointly)."""
    return sum(q_dram_serving(layer, s, requests=requests)
               for layer, s in stages)


def q_dram_naive(layer: ConvLayer) -> float:
    """No-reuse implementation: 2 accesses per MAC (Sec. III-B)."""
    return 2.0 * layer.macs


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
    """Solve u ~= R*z, u*z ~= S for the psum-resident output block.

      z = sqrt(S / R),   u = R*z = sqrt(S * R)

    With R == 1 this is the classical square sqrt(S) x sqrt(S) block of
    communication-optimal matmul (Goto & van de Geijn / Hong-Kung).
    """
    z = max(1, int(math.sqrt(s / r)))
    u = max(1, int(r * z))
    # shrink to respect u*z <= S exactly
    while u * z > s and u > 1:
        u -= max(1, u // 16)
    return OptimalTiles(u=u, z=max(1, z), k=k)


def fold_u(u: int, batch: int, ho: int, wo: int) -> tuple[int, int, int]:
    """Unfold the paper's u = b*x*y output-block rows into (b, y, x).

    The bound (Eq. 13-15) is over *output elements* u = B*Ho*Wo: batch
    rows are just more u.  Spatial rows are taken first as a square-ish
    (y, x) tile (minimum halo perimeter per psum area); once the tile
    covers the whole output plane, the remaining u folds into the batch
    dimension — batch rows add u without adding any halo overhead, so
    they are "free" u at serving scale and are what lets the weight
    slice of a u x z block amortize over many images.
    """
    x = min(wo, max(1, int(math.sqrt(u))))
    y = min(ho, max(1, u // x))
    b = min(batch, max(1, u // (x * y)))
    return b, y, x


def reduction_factor(layer: ConvLayer, s: int) -> float:
    """How much below naive the bound sits: sqrt(R*S) (Sec. III-B)."""
    return math.sqrt(layer.reuse_r * s)


def gbuf_lower_bound_reads(q_dram_in: float, q_dram_w: float) -> float:
    """Sec. IV-C: GBuf communication lower bound = the off-chip traffic
    of inputs and weights (each loaded word must leave the GBuf once)."""
    return q_dram_in + q_dram_w


def reg_lower_bound_writes(layer: ConvLayer) -> int:
    """Eq. (16): minimum register writes = #MACs."""
    return layer.macs


def energy_lower_bound_pj(layer: ConvLayer, s: int, *,
                          dram_pj: float, mac_pj: float,
                          reg_pj: float) -> float:
    """Sec. VI-D lower bound: DRAM traffic at Eq.(15) + one MAC + one
    psum register write per MAC."""
    return (q_dram_practical(layer, s) * dram_pj
            + layer.macs * (mac_pj + reg_pj))
