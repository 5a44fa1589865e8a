"""Static conv plan verifier and traffic cross-audit — the port's copy
of the accounting-profile half of ``repro/analysis/plan_check.py``.

  * **Legality pass** — :func:`check_conv_plan` verifies a
    :class:`~repro_torch.kernels.conv_lb.ops.ConvPlan` against the
    structural contract of the reference planner: grid divisibility,
    halo windows in bounds, the lhs-dilated compact walk, fused pool
    alignment, and the working set against the budget;
    :func:`check_wgrad_plan` does the same for a
    :class:`~repro_torch.kernels.conv_lb.ops.WgradPlan`.
    :func:`check_matmul_block` checks the matmul's accounted block
    (``repro/analysis/plan_check.py:412-457``) with the reference's
    rules, severities and messages, its alignment rules included
    (:func:`_lane_rule` / :func:`_sublane_rule`): warnings under the
    ``interpret`` profile the port plans at, errors under ``mosaic``.
    The conv plans' alignment rules are TPU legality and are not
    ported.
  * **Traffic cross-audit** — :func:`symbolic_conv_traffic` /
    :func:`symbolic_wgrad_traffic` / :func:`symbolic_bound_words`
    re-derive each plan's words and its Eq. (15) bound by a second,
    simpler route, and :func:`audit_handles` asserts exact agreement
    with the accountant for every handle the serve ledger and the
    training report charge (forward, dgrad and wgrad plans).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.dataflow import Traffic
from repro_torch.core.hopper_adapter import (REF_ALIGN, REF_PLAN_BUDGET,
                                             row_align_for)
from repro_torch.core.layer import ceil_div

ERROR = "error"
WARN = "warn"

#: the reference's plan profiles: ``interpret`` (accounting; alignment
#: findings are warnings) and ``mosaic`` (alignment findings are errors)
TARGET_INTERPRET = "interpret"
TARGET_MOSAIC = "mosaic"
#: the reference's last-dim tile and systolic-array edge
LANE = MXU_DIM = REF_ALIGN


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding of the static verifier: ``severity`` is ``error``
    (the plan must not be served) or ``warn``; ``hint`` says how to
    repair the shape."""

    rule: str
    severity: str
    message: str
    hint: str = ""
    where: str = ""

    def __str__(self) -> str:
        tail = f"  [{self.hint}]" if self.hint else ""
        head = f"{self.where}: " if self.where else ""
        return f"{self.severity}:{self.rule}: {head}{self.message}{tail}"


def errors(diags) -> list[Diagnostic]:
    return [d for d in diags if d.severity == ERROR]


def format_diagnostics(diags) -> str:
    return "\n".join(str(d) for d in diags) or "clean"


class PlanLegalityError(ValueError):
    """An auto-chosen plan failed the legality pass (a planner bug:
    the search must never emit a structurally illegal plan)."""

    def __init__(self, diags):
        self.diagnostics = list(diags)
        super().__init__("illegal plan:\n" + format_diagnostics(
            errors(self.diagnostics)))


def _err(rule: str, message: str, hint: str = "",
         where: str = "") -> Diagnostic:
    return Diagnostic(rule=rule, severity=ERROR, message=message,
                      hint=hint, where=where)


def _mosaic_sev(target: str) -> str:
    return ERROR if target == TARGET_MOSAIC else WARN


def _lane_rule(block: int, full: int, operand: str, target: str,
               where: str = "") -> Diagnostic | None:
    """Last-dim tile rule: a LANE multiple, or the block covers the
    whole (padded) dim."""
    if block % LANE == 0 or block >= full:
        return None
    legal = min(full, -(-block // LANE) * LANE)
    return Diagnostic(
        rule="mosaic.lane", severity=_mosaic_sev(target), where=where,
        message=f"{operand} last dim {block} is neither a multiple of "
                f"{LANE} nor the full dim {full}",
        hint=f"grow to {legal} (or the full {full})")


def _sublane_rule(block: int, full: int, dtype_bytes: int,
                  operand: str, target: str,
                  where: str = "") -> Diagnostic | None:
    """Second-minor tile rule, keyed by the word size."""
    sub = row_align_for(dtype_bytes)
    if block % sub == 0 or block >= full:
        return None
    legal = min(full, -(-block // sub) * sub)
    return Diagnostic(
        rule="mosaic.sublane", severity=_mosaic_sev(target), where=where,
        message=f"{operand} second-minor dim {block} is not a "
                f"{sub}-row tile ({dtype_bytes}-byte words) nor the "
                f"full dim {full}",
        hint=f"grow to {legal} (or the full {full})")


def check_matmul_block(blk, m: int, n: int, k: int, *,
                       dtype_bytes: int = 2,
                       vmem_budget: int | None = None,
                       target: str = TARGET_INTERPRET,
                       where: str = "") -> list[Diagnostic]:
    """Verify the matmul's accounted
    :class:`~repro_torch.core.hopper_adapter.BlockShape`: a degenerate
    block and a working set over the budget are errors; the alignment
    rules follow ``target``; a reduction slice under the 128-wide
    array is a warning.  The CUDA kernel's own CTA tile is not this
    block and is not checked here."""
    budget = REF_PLAN_BUDGET if vmem_budget is None else vmem_budget
    diags: list[Diagnostic] = []
    for name, b in (("bm", blk.bm), ("bn", blk.bn), ("bk", blk.bk)):
        if b < 1:
            diags.append(_err("matmul.shape", f"{name}={b} < 1",
                              where=where))
    if diags:
        return diags
    need = blk.vmem_bytes(dtype_bytes)
    if need > budget:
        diags.append(_err(
            "matmul.vmem", f"psum + double-buffered panels need "
            f"{need} B > {budget} B budget",
            hint="shrink bm/bn toward the paper's u ~= R*z balance",
            where=where))
    mp, np_, kp = (ceil_div(m, blk.bm) * blk.bm,
                   ceil_div(n, blk.bn) * blk.bn,
                   ceil_div(k, blk.bk) * blk.bk)
    for d in (_lane_rule(blk.bn, np_, "B-panel/psum block", target,
                         where),
              _lane_rule(blk.bk, kp, "A-panel block", target, where),
              _sublane_rule(blk.bm, mp, dtype_bytes, "A-panel/psum "
                            "block", target, where),
              _sublane_rule(blk.bk, kp, dtype_bytes, "B-panel block",
                            target, where)):
        if d:
            diags.append(d)
    if blk.bk < min(MXU_DIM, kp):
        diags.append(Diagnostic(
            rule="mosaic.mxu", severity=WARN, where=where,
            message=f"reduction slice bk={blk.bk} underfills the "
                    f"{MXU_DIM}-wide MXU"))
    return diags


def check_conv_plan(plan, *, batch: int = 1, dtype_bytes: int = 4,
                    vmem_budget: int | None = None,
                    where: str = "") -> list[Diagnostic]:
    """Verify one plan against the structural contract of the
    reference planner, re-derived independently of it."""
    del batch          # plans carry no batch extent
    budget = REF_PLAN_BUDGET if vmem_budget is None else vmem_budget
    blk = plan.blocks
    sy, sx = plan.stride
    ekh = (plan.hk - 1) * plan.dilation[0] + 1
    ekw = (plan.wk - 1) * plan.dilation[1] + 1
    diags: list[Diagnostic] = []

    # -- grid divisibility ---------------------------------------------------
    for name, dim, b in (("ho_pad", plan.ho_pad, blk.y),
                         ("wo_pad", plan.wo_pad, blk.x),
                         ("ci_pad", plan.ci_pad, blk.ci),
                         ("co_pad", plan.co_pad, blk.co)):
        if b < 1 or dim % b:
            diags.append(_err(
                "conv.grid", f"{name}={dim} does not divide its block "
                f"{b}", hint=f"pad {name} to a multiple of {b}",
                where=where))
    for name, dim, true in (("ho", plan.ho_pad, plan.ho),
                            ("wo", plan.wo_pad, plan.wo),
                            ("ci", plan.ci_pad, plan.ci),
                            ("co", plan.co_pad, plan.co)):
        if true and dim < true:
            diags.append(_err(
                "conv.grid", f"padded {name} {dim} is smaller than "
                f"the true dim {true}", where=where))

    # -- halo windows in bounds ----------------------------------------------
    want_hy = (blk.y - 1) * sy + ekh
    want_hx = (blk.x - 1) * sx + ekw
    if (blk.halo_y, blk.halo_x) != (want_hy, want_hx):
        diags.append(_err(
            "conv.halo", f"halo ({blk.halo_y}, {blk.halo_x}) does not "
            f"match the tile's input footprint ({want_hy}, {want_hx})",
            hint="halos belong to the tile: (t-1)*stride + dilated "
                 "kernel extent", where=where))
    if plan.ho_pad // max(1, blk.y):
        last_y = (plan.ho_pad // blk.y - 1) * blk.y * sy + blk.halo_y
        last_x = (plan.wo_pad // blk.x - 1) * blk.x * sx + blk.halo_x
        if last_y > plan.hp_pad or last_x > plan.wp_pad:
            diags.append(_err(
                "conv.halo", f"last tile's halo reads "
                f"({last_y}, {last_x}) past the padded input plane "
                f"({plan.hp_pad}, {plan.wp_pad})",
                hint="pad the input to the last tile's halo end",
                where=where))

    # -- lhs-dilated compact-plane walk --------------------------------------
    if plan.lhs_dilated:
        ldy, ldx = plan.lhs_dilation
        for name, bv, s, ld in (("y", blk.y, sy, ldy),
                                ("x", blk.x, sx, ldx)):
            if ld > 1 and (bv * s) % ld:
                diags.append(_err(
                    "conv.lhsdil",
                    f"{name}-block {bv} * stride {s} is not a multiple "
                    f"of lhs_dilation {ld} — compact fetches would "
                    f"start mid-phase",
                    hint="snap the block so block*stride % lhs_dilation"
                         " == 0", where=where))
        if plan.pool > 1 or plan.residual:
            diags.append(_err(
                "conv.lhsdil", "lhs-dilated plans fuse no "
                "pool/residual epilogue", where=where))

    # -- fused pool alignment ------------------------------------------------
    if plan.pool > 1:
        if blk.y % plan.pool or blk.x % plan.pool:
            diags.append(_err(
                "conv.pool", f"tile {blk.y}x{blk.x} is not divisible "
                f"by the fused pool {plan.pool}",
                hint="snap spatial blocks to pool multiples",
                where=where))
        if plan.ho % plan.pool or plan.wo % plan.pool:
            diags.append(_err(
                "conv.pool", f"output plane {plan.ho}x{plan.wo} is "
                f"not divisible by the fused pool {plan.pool}",
                where=where))

    # -- working set against the budget --------------------------------------
    pinned = blk.ci >= plan.ci_pad and blk.co >= plan.co_pad
    need = blk.vmem_bytes(plan.hk, plan.wk, dtype_bytes,
                          w_pinned=pinned, residual=plan.residual)
    if need > budget:
        diags.append(_err(
            "conv.vmem", f"working set {need} B exceeds the "
            f"{budget} B budget (psum {blk.psum_bytes} B + "
            f"double-buffered panels"
            f"{' + residual join panel' if plan.residual else ''})",
            hint="shrink ci/batch blocks first (they only cost "
                 "memory), then the spatial tile", where=where))
    return diags


def check_wgrad_plan(wplan, *, batch: int = 1, dtype_bytes: int = 4,
                     vmem_budget: int | None = None,
                     where: str = "") -> list[Diagnostic]:
    """Verify a dW-stationary plan: the resident dW block plus
    double-buffered x/dy strips must fit the budget, the channel
    blocks must describe a real partition of the layer, and the lagged
    carry must cover the strip halo."""
    del batch          # plans carry no batch extent
    budget = REF_PLAN_BUDGET if vmem_budget is None else vmem_budget
    diags: list[Diagnostic] = []
    for name, b, dim in (("ci_b", wplan.ci_b, wplan.ci),
                         ("co_b", wplan.co_b, wplan.co),
                         ("strip", wplan.strip, wplan.ho)):
        if b < 1 or b > dim:
            diags.append(_err(
                "wgrad.grid", f"{name}={b} outside [1, {dim}]",
                where=where))
    if diags:
        return diags
    # the lagged rolling fetch: carry rows must cover the halo strips
    # share (re-derived from the raw geometry, not through
    # WgradPlan.lag)
    r_rows = wplan.strip * wplan.sy
    k_rows = max(0, wplan.ekh - wplan.sy)
    lag = -(-k_rows // r_rows) if k_rows > 0 else 0
    if wplan.lag != lag or lag * r_rows < k_rows:
        diags.append(_err(
            "wgrad.strip",
            f"lag {wplan.lag} x {r_rows}-row fetches cannot carry the "
            f"{k_rows}-row strip halo",
            hint="lag must be ceil((ekh - stride) / (strip*stride))",
            where=where))
    xrows = (wplan.strip - 1) * wplan.sy + wplan.ekh
    need = (4 * wplan.hk * wplan.wk * wplan.ci_b * wplan.co_b
            + 2 * dtype_bytes * xrows * wplan.wp * wplan.ci_b
            + 2 * dtype_bytes * wplan.strip * wplan.wo * wplan.co_b)
    if need > budget:
        diags.append(_err(
            "wgrad.vmem", f"resident dW block + strips need {need} B "
            f"> {budget} B budget",
            hint="shrink the strip first, then the channel blocks",
            where=where))
    return diags


def symbolic_conv_traffic(plan, batch: int) -> Traffic:
    """Independent re-derivation of :meth:`ConvPlan.traffic`: fetches
    per operand counted straight from the block walk (an operand is
    re-fetched when its block index changes between consecutive grid
    steps, nci innermost) times the block volume, with ceil divisions
    of the *true* dims."""
    blk = plan.blocks
    tb = max(1, min(blk.b, batch))
    nb = ceil_div(batch, tb)
    ny, nx = ceil_div(plan.ho, blk.y), ceil_div(plan.wo, blk.x)
    nci = ceil_div(plan.ci_pad, blk.ci)
    nco = ceil_div(plan.co_pad, blk.co)
    spatial_blocks = nb * ny * nx
    # the input halo tile is constant across the Co sweep only when
    # there is a sole Ci block
    in_fetches = (spatial_blocks if nci == 1
                  else spatial_blocks * nco * nci)
    fetch_y, fetch_x = blk.halo_y, blk.halo_x
    if plan.lhs_dilated:
        def compact(halo, ld, p):
            if ld == 1:
                return halo
            return ceil_div(p, ld) + max(1, ceil_div(halo - p, ld))
        fetch_y = compact(blk.halo_y, plan.lhs_dilation[0], plan.py)
        fetch_x = compact(blk.halo_x, plan.lhs_dilation[1], plan.px)
    in_words = in_fetches * (tb * fetch_y * fetch_x * blk.ci)
    # the weight slice is constant over the whole grid iff both channel
    # dims have a single block
    w_fetches = 1 if nci * nco == 1 else spatial_blocks * nco * nci
    w_words = w_fetches * (plan.hk * plan.wk * blk.ci * blk.co)
    if plan.residual:
        in_words += spatial_blocks * nco * (tb * blk.y * blk.x * blk.co)
    out_words = (spatial_blocks * nco
                 * (tb * (blk.y // plan.pool) * (blk.x // plan.pool)
                    * blk.co))
    return Traffic(reads_in=float(in_words), reads_w=float(w_words),
                   reads_out=0.0, writes_out=float(out_words))


def symbolic_wgrad_traffic(wplan, batch: int) -> Traffic:
    """Independent re-derivation of :meth:`WgradPlan.traffic`, walked
    off the reference kernel's grid ``(nci, nco, batch, strips +
    lag)``: the disjoint x fetch changes every step (warm-up fetches
    included), the dy strip takes exactly ``strips`` distinct values
    per (ci-block, co-block, image), and the resident dW block flushes
    exactly once."""
    nci = ceil_div(wplan.ci, wplan.ci_b)
    nco = ceil_div(wplan.co, wplan.co_b)
    ns = ceil_div(wplan.ho, wplan.strip)
    r_rows = wplan.strip * wplan.sy
    k_rows = max(0, wplan.ekh - wplan.sy)
    lag = -(-k_rows // r_rows) if k_rows > 0 else 0
    reads_x = (nci * nco * batch * (ns + lag)
               * r_rows * wplan.wp * wplan.ci_b)
    reads_dy = (nci * nco * batch * ns
                * wplan.strip * wplan.wo * wplan.co_b)
    writes = (wplan.hk * wplan.wk) * (nci * wplan.ci_b) * (nco
                                                           * wplan.co_b)
    return Traffic(reads_in=float(reads_x), reads_w=float(reads_dy),
                   reads_out=0.0, writes_out=float(writes))


def symbolic_bound_words(plan, layer) -> float:
    """Independent re-derivation of :meth:`ConvPlan.bound_words`:
    Eq. (15) at the plan's realized footprint, floored at the
    once-per-word ideal, plus the residual join's mandatory read."""
    s = plan.footprint_elems()
    macs = (layer.batch * layer.ho * layer.wo * layer.co
            * layer.hk * layer.wk * layer.ci)
    r = max(1.0, (layer.hk * layer.wk) / float(layer.stride ** 2))
    outputs = layer.batch * layer.co * layer.ho * layer.wo
    touched = (layer.batch * layer.ci
               * layer.fetched_area(layer.wo, layer.ho))
    ideal = float(touched + layer.hk * layer.wk * layer.ci * layer.co
                  + outputs)
    q = max(2.0 * macs / math.sqrt(r * s) + outputs, ideal)
    if plan.residual:
        q += float(outputs)
    return q


@dataclasses.dataclass(frozen=True)
class PlanAuditEntry:
    """One plan's verdict: legality diagnostics + cross-audit flags."""

    name: str
    diagnostics: tuple[Diagnostic, ...]
    traffic_ok: bool     # symbolic re-derivation == accountant
    bound_ok: bool       # symbolic Eq. (15) == ConvPlan.bound_words
    words: float
    bound: float

    @property
    def legal(self) -> bool:
        return not errors(self.diagnostics)

    @property
    def ok(self) -> bool:
        return self.legal and self.traffic_ok and self.bound_ok


@dataclasses.dataclass(frozen=True)
class PlanAudit:
    """The audit over a set of plan handles."""

    entries: tuple[PlanAuditEntry, ...]

    @property
    def ok(self) -> bool:
        return all(e.ok for e in self.entries)

    def errors(self) -> list[Diagnostic]:
        return [d for e in self.entries for d in errors(e.diagnostics)]

    def report(self) -> str:
        lines = [f"plan audit: "
                 f"{sum(e.legal for e in self.entries)}/"
                 f"{len(self.entries)} legal, "
                 f"{sum(not e.traffic_ok for e in self.entries)} traffic"
                 f" mismatch(es), "
                 f"{sum(not e.bound_ok for e in self.entries)} bound "
                 f"mismatch(es)"]
        for e in self.entries:
            flag = "ok " if e.ok else "BAD"
            lines.append(f"  {flag} {e.name}: {e.words:.3g} words vs "
                         f"bound {e.bound:.3g}")
            for d in errors(e.diagnostics):
                lines.append(f"       {d}")
        return "\n".join(lines)


def _audit_conv(name, layer, plan, *, batch, dtype_bytes,
                vmem_budget) -> PlanAuditEntry:
    diags = check_conv_plan(plan, batch=batch, dtype_bytes=dtype_bytes,
                            vmem_budget=vmem_budget, where=name)
    acct = plan.traffic(batch)
    bound = plan.bound_words(layer) if layer is not None else 0.0
    return PlanAuditEntry(
        name=name, diagnostics=tuple(diags),
        traffic_ok=symbolic_conv_traffic(plan, batch) == acct,
        bound_ok=(layer is None
                  or symbolic_bound_words(plan, layer) == bound),
        words=acct.total, bound=bound)


def _audit_wgrad(name, wplan, *, batch, dtype_bytes,
                 vmem_budget) -> PlanAuditEntry:
    diags = check_wgrad_plan(wplan, dtype_bytes=dtype_bytes,
                             vmem_budget=vmem_budget, where=name)
    acct = wplan.traffic(batch)
    return PlanAuditEntry(
        name=name, diagnostics=tuple(diags),
        traffic_ok=symbolic_wgrad_traffic(wplan, batch) == acct,
        bound_ok=True, words=acct.total, bound=0.0)


def audit_handles(handles, *, batch: int, dtype_bytes: int = 4,
                  vmem_budget: int | None = None) -> PlanAudit:
    """Audit ``[(ConvLayer, ConvPlan | ConvTrainingPlan)]`` handles (the
    :func:`~repro_torch.models.graph.graph_plan_handles` export): the
    legality pass on every constituent plan and the exact traffic/bound
    cross-audit against the accountant."""
    kw = dict(batch=batch, dtype_bytes=dtype_bytes,
              vmem_budget=vmem_budget)
    entries = []
    for layer, handle in handles:
        if hasattr(handle, "fwd"):        # ConvTrainingPlan triple
            entries.append(_audit_conv(f"{layer.name}/fwd", layer,
                                       handle.fwd, **kw))
            # the dgrad conv is its own layer geometry; legality and
            # the traffic re-derivation apply, the fwd bound does not
            entries.append(_audit_conv(f"{layer.name}/dgrad", None,
                                       handle.dgrad, **kw))
            entries.append(_audit_wgrad(f"{layer.name}/wgrad",
                                        handle.wgrad, **kw))
        else:
            entries.append(_audit_conv(f"{layer.name}/fwd", layer,
                                       handle, **kw))
    return PlanAudit(entries=tuple(entries))
