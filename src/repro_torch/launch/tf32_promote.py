"""K3's 3xTF32 kernel (route ``sm90_tf32``) against the length of the
range its tensor cores sum, on the card: phi3-medium-14b's FFN down (K =
17,920, the deepest projection) and wq (K = 5,120) at 4096 tokens, f32,
``w`` N-major and scaled by 1/sqrt(K) as a projection's is.  The
promotion interval (stages of 32 of K the tensor cores sum before the
kernel adds their sums into its CUDA-core f32 sums; 0: never) is the
kernel's compile-time ``kPromote``: each interval is a copy of
``csrc/matmul_lb_sm90_tf32.cu`` with that value, under
``build/tf32_promote/``, all built together.  Each is launched on both
column tiles, held to the plain version at the card's f32 gate
(:data:`~repro_torch.launch.yardstick.CARD_TOL`) and to float64, and
timed as ``chip_smoke.py`` times a projection
(:func:`~repro_torch.launch.yardstick.time_ms`); beside them the 1xTF32
control (lo words dropped) of the wrapper's kernel and the FMA kernel
(route ``fma``, another f32 order of the sums).  ``--unscaled`` draws
``w`` from N(0, 1) as well: the sums cancel more, and the gate is read
against float64 too (``*_exact``), the plain product's own included.

  PYTHONPATH=src python -m repro_torch.launch.tf32_promote [--promote 0,1,4,16] [--unscaled]

Prints one JSON line per (projection, tile, interval).  The tensor
cores' f32 sums drift with the length of a range (``PERF.md``):
the wrapper's ``TF32_PROMOTE`` is the interval this sweep chose.  Needs
a CUDA device: a measurement of the card has no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import re

import torch

from repro_torch.core.exec_target import resolve_device
from repro_torch.kernels.matmul_lb import kernel as K3
from repro_torch.kernels.matmul_lb.ref import matmul_ref
from repro_torch.kernels.nvcc import BUILD_DIR, build_many
from repro_torch.launch.yardstick import time_ms, within

#: phi3-medium-14b (d_model 5120, d_ff 17920) at 4096 tokens
SHAPES = [("ffn_down", 4096, 17920, 5120), ("wq", 4096, 5120, 5120)]
PROMOTE = re.compile(r"constexpr int kPromote = \d+;")


def variants(promotes: list[int]) -> dict[int, object]:
    """Per interval, the bound C entry of a copy of the kernel's source
    whose ``kPromote`` is that interval, built together."""
    src = K3.TF32_SOURCE.read_text()
    if len(PROMOTE.findall(src)) != 1:
        raise ValueError(f"{K3.TF32_SOURCE} must define kPromote once")
    paths = []
    for r in promotes:
        path = (BUILD_DIR / "tf32_promote" / f"promote{r}"
                / K3.TF32_SOURCE.name)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(PROMOTE.sub(f"constexpr int kPromote = {r};", src))
        paths.append(path)
    libs = build_many(paths)
    return {r: (lib, lib.bind("matmul_lb_sm90_tf32_forward", 3, 8))
            for r, lib in zip(promotes, libs)}


def launch(entry, x: torch.Tensor, w: torch.Tensor, bn: int
           ) -> torch.Tensor:
    """One launch of a variant, as ``K3._sm90_tf32`` launches the
    kernel (w N-major, lo words kept) on column tile ``bn``."""
    lib, forward = entry
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = forward(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                  x.stride(0), w.stride(0), bn, 0, 1,
                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul_lb_sm90_tf32 variant: "
                           f"{lib.error_string(err)} (error {err})")
    return out


def _errors(out: torch.Tensor, plain: torch.Tensor,
            exact: torch.Tensor) -> dict:
    gate = within(out, plain, torch.float32)
    return {"worst_over_tol": gate["worst_over_tol"],
            "worst_over_tol_exact":
            within(out, exact, torch.float32)["worst_over_tol"],
            "err_over_max_plain":
            gate["max_abs_err"] / plain.abs().max().item(),
            "err_over_max_exact":
            (out.double() - exact).abs().max().item()
            / exact.abs().max().item()}


def sweep(promotes: list[int], unscaled: bool = False,
          seed: int = 5) -> list[dict]:
    resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    entries = variants(promotes)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    card = torch.cuda.get_device_name(0)
    rows = []
    for name, m, k, n in SHAPES:
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda")
        if not unscaled:
            w *= k ** -0.5
        exact = x.double() @ w.double()
        plain = matmul_ref(x, w)
        base = {"projection": name, "shape": [m, k, n], "card": card,
                "w_scale": "none" if unscaled else "1/sqrt(K)",
                "plain_err_over_max_exact":
                (plain.double() - exact).abs().max().item()
                / exact.abs().max().item(),
                "plain_worst_over_tol_exact":
                within(plain, exact, torch.float32)["worst_over_tol"]}
        for bn in K3.TF32_TILES:
            for r in promotes:
                out = launch(entries[r], x, w, bn)
                row = dict(base, bn=bn, promote=r,
                           stages=-(-k // K3.TF32_BK),
                           picked=(bn == K3.tf32_tile(m, n)
                                   and r == K3.TF32_PROMOTE),
                           **_errors(out, plain, exact),
                           ms=time_ms(lambda: launch(entries[r], x, w, bn),
                                      flush))
                print(json.dumps(row), flush=True)
                rows.append(row)
        controls = {"1xTF32": K3._sm90_tf32(x, w, lo_terms=False),
                    "fma": K3._fma(x, w)}
        for control, out in controls.items():
            row = dict(base, control=control, **_errors(out, plain, exact))
            print(json.dumps(row), flush=True)
            rows.append(row)
        del exact, plain
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--promote", default="0,1,2,4,8,16,32,64,140")
    ap.add_argument("--unscaled", action="store_true",
                    help="w from N(0, 1), not scaled by 1/sqrt(K)")
    args = ap.parse_args(argv)
    sweep([int(v) for v in args.promote.split(",")], args.unscaled)


if __name__ == "__main__":
    main()
