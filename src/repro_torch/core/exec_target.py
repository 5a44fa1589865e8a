"""Execution targets of the port, and where they run.

Two targets:

  ============ ======= =================================================
  target       compute what runs
  ============ ======= =================================================
  KERNEL       True    the hand-written CUDA kernel on a CUDA tensor;
                       its plain PyTorch version on a CPU tensor
  ACCOUNT_ONLY False   planning and the traffic ledger, no execution
  ============ ======= =================================================

There is no rung between them.  In particular nothing steps from the
kernel down to the plain version on the card: a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ExecTarget:
    """One execution choice, carried through every layer."""

    name: str
    compute: bool       # False: account-only (plan + ledger, no exec)

    def __str__(self) -> str:
        return self.name


ACCOUNT_ONLY = ExecTarget(name="account-only", compute=False)
KERNEL = ExecTarget(name="kernel", compute=True)

#: every target by name
TARGETS = {t.name: t for t in (KERNEL, ACCOUNT_ONLY)}


def resolve_target(value: "ExecTarget | str") -> ExecTarget:
    """An :class:`ExecTarget` passes through, a string resolves by
    name."""
    if isinstance(value, ExecTarget):
        return value
    name = str(value).strip().lower()
    try:
        return TARGETS[name]
    except KeyError:
        raise ValueError(
            f"unknown execution target {value!r}; expected one of "
            f"{sorted(TARGETS)}") from None


def resolve_device(device: "torch.device | str" = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    asks for ``cpu``.  A CUDA request on a host without a card raises;
    it never carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run the plain PyTorch "
                           "version on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or "
                         f"'cpu'")
    return dev
