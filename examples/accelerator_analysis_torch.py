"""The paper's analysis, end to end, for any conv layer you type in, on
the PyTorch port: the sibling of ``examples/accelerator_analysis.py``.

Computes the communication lower bound (Thm 2 / Eq 15), searches the
bound-attaining tiling, compares the dataflow zoo and maps the layer
onto the Table-I accelerator, printing each line as the reference does.
In place of the reference's TPU adaptation it prints the port's: the
same theory's matmul block at the reference planner's budget, the plan
the port's conv planner takes for the layer with its words against Eq.
(15), and the route the conv kernel (K1) takes on the card.  Then it
runs the layer once through ``conv2d_lb`` on f32 inputs drawn from
seed 0 and prints the route whose launch counter rose (``plain``:
the plain PyTorch version, on the CPU).

  PYTHONPATH=src python examples/accelerator_analysis_torch.py \\
      --ci 128 --co 256 --hw 56 --batch 3 --s-kb 66.5 [--device cpu]

Runs on the card unless ``--device cpu`` is given; without a card it
raises.
"""

import argparse

import torch

from repro_torch.core import (ConvLayer, IMPLEMENTATIONS, dataflow_zoo,
                              lb_block_shape, q_dram_ideal,
                              q_dram_naive, q_dram_practical,
                              simulate_layer)
from repro_torch.core.exec_target import resolve_device
from repro_torch.core.hopper_adapter import REF_PLAN_BUDGET
from repro_torch.core.lower_bound import optimal_block
from repro_torch.kernels.conv_lb import kernel as K1
from repro_torch.kernels.conv_lb.ops import conv2d_lb, plan_conv

MB = 2 / 1e6
#: the header that opens the port's counterpart of the reference's
#: "TPU adaptation" section; every line before it is the reference's
ADAPTATION = "Hopper adaptation"
#: the line that names the route the layer's run launched
RAN = "  ran conv2d_lb on "
SEED = 0


def layer_inputs(layer: ConvLayer, device: torch.device):
    """f32 x (B, H, W, Ci) and w (Hk, Wk, Ci, Co), drawn from ``SEED`` on
    the host, w at 1/sqrt(fan-in)."""
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(layer.batch, layer.hi, layer.wi, layer.ci, generator=gen)
    w = torch.randn(layer.hk, layer.wk, layer.ci, layer.co,
                    generator=gen) / (layer.hk * layer.wk * layer.ci) ** 0.5
    return x.to(device), w.to(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--ci", type=int, default=128)
    ap.add_argument("--co", type=int, default=256)
    ap.add_argument("--hw", type=int, default=56)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--s-kb", type=float, default=66.5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    layer = ConvLayer("user", args.batch, args.ci, args.co, args.hw,
                      args.hw, args.k, args.k, stride=args.stride,
                      pad=args.k // 2)
    s = int(args.s_kb * 1024 // 2)
    print(f"layer: {layer}")
    print(f"  MACs {layer.macs/1e6:.1f}M   WndR reuse R = "
          f"{layer.reuse_r:.2f}   on-chip S = {args.s_kb}KB\n")

    print("off-chip communication (MB):")
    print(f"  naive (no reuse)      {q_dram_naive(layer)*MB:10.1f}")
    print(f"  lower bound (Eq.15)   {q_dram_practical(layer, s)*MB:10.1f}")
    print(f"  ideal (infinite S)    {q_dram_ideal(layer)*MB:10.1f}\n")

    blk = optimal_block(s, layer.reuse_r)
    print(f"bound-attaining block (Sec IV-C): u={blk.u} z={blk.z} "
          f"(u/z={blk.u/blk.z:.1f} ~ R={layer.reuse_r:.1f})\n")

    print("dataflow zoo at this S:")
    for df in dataflow_zoo():
        t, q = df.search(layer, s)
        star = " <== ours" if df.name == "ours" else ""
        print(f"  {df.name:8s} {q.total*MB:10.1f} MB  "
              f"(b{t.b} z{t.z} y{t.y} x{t.x} k{t.k}){star}")

    impl = IMPLEMENTATIONS[0]
    r = simulate_layer(layer, impl)
    print(f"\non Table-I implementation 1 (16x16 PEs, 66.5KB):")
    print(f"  DRAM {r.dram.total*MB:.1f} MB   GBuf "
          f"{r.mapping.gbuf_total*MB:.1f} MB   "
          f"Regs {r.mapping.reg_total/1e6:.0f}M accesses")
    print(f"  energy {r.pj_per_mac:.2f} pJ/MAC   time {r.time_s*1e3:.1f} ms"
          f"   PE util {r.mapping.pe_utilization:.2f}")

    m, n, k = layer.mm_m, layer.mm_n, layer.mm_k
    mm = lb_block_shape(m, n, k)
    print(f"\n{ADAPTATION} (conv as {m}x{k} @ {k}x{n} matmul):")
    print(f"  matmul block bm={mm.bm} bn={mm.bn} bk={mm.bk} at the "
          f"reference planner's budget ({REF_PLAN_BUDGET >> 20} MiB: "
          f"operands {2 * mm.operand_bytes(2)/1e6:.1f} MB double-buffered,"
          f" psums {mm.psum_bytes/1e6:.1f} MB)")
    pad, st = (args.k // 2,) * 2, (args.stride,) * 2
    plan = plan_conv(args.hw, args.hw, args.ci, args.co, args.k, args.k,
                     batch=args.batch, stride=st, padding=pad)
    b = plan.blocks
    words, bound = plan.traffic(args.batch).total, plan.bound_words(layer)
    print(f"  conv plan (plan_conv, f32): b={b.b} y={b.y} x={b.x} "
          f"ci={b.ci} co={b.co}, {words/1e6:.2f}M words against Eq. (15)'s "
          f"{bound/1e6:.2f}M at its S = {plan.footprint_elems()} words "
          f"({words/bound:.2f}x)")
    route, k1_plan, _shape = plan.launch(args.batch, torch.float32)
    tile = getattr(k1_plan, "tile", k1_plan)
    print(f"  K1 on the card, f32: route {route}, tile {tile}")

    x, w = layer_inputs(layer, device)
    before = dict(K1.conv_lb.launches_by_route)
    out = conv2d_lb(x, w, stride=st, padding=pad)
    rose = [rt for rt, n in K1.conv_lb.launches_by_route.items()
            if n > before[rt]]
    ran = "+".join(rose) if rose else "plain"
    print(f"{RAN}{device.type}: route {ran}, out {tuple(out.shape)}, "
          f"max |out| {out.abs().max().item():.4f}")
    return {"layer": layer, "block": mm, "plan": plan, "route": route,
            "ran": ran, "x": x, "w": w, "out": out,
            "stride": st, "padding": pad}


if __name__ == "__main__":
    main()
