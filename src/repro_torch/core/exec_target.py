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

The port's counterpart of ``repro/core/exec_target.py``: ``clamp`` is
the one downward-only negotiation (a request or the serving loop's
circuit breaker can degrade a server's target, never upgrade it), and
``ladder`` the breaker's degradation ladder, which is therefore
KERNEL -> ACCOUNT_ONLY: a degraded dispatch plans and charges the
ledger but computes nothing.
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

    def clamp(self, other: "ExecTarget | str | None") -> "ExecTarget":
        """The lower of self and ``other`` (``None`` keeps self): a
        request can degrade a computing target to account-only, never
        upgrade one."""
        if other is None:
            return self
        other = resolve_target(other)
        return other if self.compute and not other.compute else self

    def ladder(self) -> tuple["ExecTarget", ...]:
        """The circuit breaker's degradation ladder from this target:
        itself, then ACCOUNT_ONLY below a computing one.  There is no
        rung between (no plain version, no library call on the card)."""
        return (self, ACCOUNT_ONLY) if self.compute else (self,)


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
    asks for ``cpu``, or for ``meta`` (shapes and types only, as the
    dry-run makes them).  A CUDA request on a host without a card
    raises; it never carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run the plain PyTorch "
                           "version on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda', 'cpu' "
                         f"or 'meta' (shapes only)")
    return dev
