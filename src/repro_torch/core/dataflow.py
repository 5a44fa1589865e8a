"""DRAM access volume split by tensor — the port's copy of
``Traffic`` from ``repro/core/dataflow.py``.  The dataflow zoo itself
is an analysis tool of the reference and is not ported."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Traffic:
    """DRAM access volume split by tensor (elements)."""

    reads_in: float
    reads_w: float
    reads_out: float   # psum re-reads (0 when psums never spill)
    writes_out: float

    @property
    def total(self) -> float:
        return self.reads_in + self.reads_w + self.reads_out + self.writes_out

    @property
    def reads(self) -> float:
        return self.reads_in + self.reads_w + self.reads_out

    def __add__(self, other: "Traffic") -> "Traffic":
        return Traffic(self.reads_in + other.reads_in,
                       self.reads_w + other.reads_w,
                       self.reads_out + other.reads_out,
                       self.writes_out + other.writes_out)
