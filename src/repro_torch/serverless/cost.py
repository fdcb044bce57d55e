"""GB-seconds cost model (paper §2, §5.2).

AWS Lambda bills duration x allocated memory; CPU share scales with memory
(1769 MB ~= 1 vCPU, capped at 6 vCPU / 10240 MB).  The simulator maps a
task's work units through that speed curve, reproducing the paper's
Figure 3 shape: more memory -> faster (diminishing returns) and a U-shaped
cost curve.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

MB_PER_VCPU = 1769.0
MAX_VCPU = 6.0
USD_PER_GB_S = 0.0000166667          # eu-central-1, paper ref [5]
BILLING_GRANULARITY_S = 0.001        # per-ms billing, paper ref [2]


def vcpu_of(memory_mb: int) -> float:
    return min(memory_mb / MB_PER_VCPU, MAX_VCPU)


def speedup_of(memory_mb: int, parallel_frac: float = 0.9) -> float:
    """Amdahl-style speed curve: work parallelizes over the vCPU share.

    parallel_frac < 1 produces the paper's diminishing returns (Fig 3a/b).
    """
    c = vcpu_of(memory_mb)
    return 1.0 / ((1.0 - parallel_frac) + parallel_frac / c)


@dataclass
class BillingRecord:
    invocation: int
    duration_s: float
    memory_mb: int
    retry: int = 0
    speculative: bool = False

    @property
    def billed_gb_s(self) -> float:
        dur = max(
            BILLING_GRANULARITY_S,
            round(self.duration_s / BILLING_GRANULARITY_S)
            * BILLING_GRANULARITY_S)
        return dur * self.memory_mb / 1024.0


@dataclass
class Bill:
    records: List[BillingRecord] = field(default_factory=list)

    def add(self, rec: BillingRecord):
        self.records.append(rec)

    @property
    def total_gb_s(self) -> float:
        return sum(r.billed_gb_s for r in self.records)

    @property
    def total_usd(self) -> float:
        return self.total_gb_s * USD_PER_GB_S

    @property
    def n_invocations(self) -> int:
        return len(self.records)

    def summary(self) -> dict:
        durs = [r.duration_s for r in self.records] or [0.0]
        return {
            "invocations": self.n_invocations,
            "billed_gb_s": self.total_gb_s,
            "usd": self.total_usd,
            "avg_duration_s": sum(durs) / len(durs),
            "max_duration_s": max(durs),
            "retries": sum(1 for r in self.records if r.retry),
            "speculative": sum(1 for r in self.records if r.speculative),
        }
