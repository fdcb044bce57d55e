"""Finding records and report formatting shared by the analysis passes
(a copy of the JAX package's ``analysis/report.py``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence


@dataclass(frozen=True)
class Finding:
    """One audit violation.

    ``passname`` names the pass ("cache-keys", "protocol", "empirical",
    "dead-code"); ``rule`` the
    specific invariant (stable identifiers — the mutation tests key on
    them); ``where`` the location (``file:line``); ``detail`` the human
    explanation.
    """
    passname: str
    rule: str
    where: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.passname}] {self.rule} @ {self.where}: {self.detail}"


def render(findings: Sequence[Finding], header: str = "") -> str:
    lines: List[str] = []
    if header:
        lines.append(header)
    for f in findings:
        lines.append(f"  FAIL {f}")
    return "\n".join(lines)
