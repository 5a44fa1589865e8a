"""How ``chip_smoke.py`` and the launch probes time a kernel on the card
and hold its result: one copy of each gate and timer, so that a probe
reads what the smoke reads.

Needs a CUDA device: a measurement of the card has no CPU fallback.
"""

from __future__ import annotations

import torch

#: wgrad kernel vs plain version: sums over up to 401,408 pixels in
#: another order (split ranges, then the splits), relative to max |plain|
WGRAD_TOL = 2e-4
#: K3 and K4 vs their plain versions on the card: (rtol, atol, atol per
#: rms of the plain output), |out - plain| <= rtol |plain| + atol', where
#: atol' = min(atol, atol_rms * rms(plain)), so the gate is never looser
#: than the reference's (tests/test_kernels.py: f32 rtol 2e-5, atol 2e-4;
#: bf16 rtol 8e-2, atol 0.8).  Kernel and plain version sum the same
#: words in f32 and round once to the output type: in f32 they differ by
#: the order of the sums (~sqrt(K) 2^-24 of the summed magnitude, so
#: 1e-3 rms leaves a wide margin); in bf16 by at most one rounding step
#: (<= 2^-7 |plain|), so rtol 2^-6 is two steps, and near zero by the
#: f32 order of the sums, which 1e-2 rms covers.
CARD_TOL = {torch.float32: (2e-5, 2e-4, 1e-3),
            torch.bfloat16: (2 ** -6, 0.8, 1e-2)}


def within(out: torch.Tensor, ref: torch.Tensor, dtype) -> dict:
    """K3/K4 against a plain version at :data:`CARD_TOL`: the max abs
    error and the worst |err| / tolerance (the gate is <= 1)."""
    rtol, atol, atol_rms = CARD_TOL[dtype]
    ref = ref.float()
    rms = ref.square().mean().sqrt().item()
    atol = min(atol, atol_rms * rms)
    err = (out.float() - ref).abs()
    return {"max_abs_err": err.max().item(),
            "worst_over_tol": (err / (atol + rtol * ref.abs())).max().item(),
            "rtol": rtol, "atol": atol, "plain_rms": rms}


def time_ms(fn, flush: torch.Tensor, reps: int = 10) -> float:
    """Mean device ms of ``fn`` with the L2 cache flushed before each
    call (a serving layer finds its weights cold)."""
    for _ in range(2):
        fn()
    start = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    end = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for i in range(reps):
        flush.zero_()
        start[i].record()
        fn()
        end[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(start, end)) / reps


def device_ms(fn, calls: int = 100) -> float:
    """Mean device ms of one of ``calls`` back-to-back calls of ``fn``,
    all enqueued while the stream spins (some 20 ms), so that the card
    runs them one after another and no host enqueue is in the time: the
    kernel's own time, L2 warm."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls
