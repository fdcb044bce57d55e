"""CLI: ``python -m repro_torch.analysis [--dead-code] [--pass NAME]``.

The default run executes the port's three invariant passes — cache-key
soundness, the async protocol, and the empirical checks that stand in
for the reference's jaxpr audit — and exits nonzero on any finding;
``--dead-code`` runs the import-reachability report instead.  CI runs
both (job ``port-lint`` in .github/workflows/port.yml).
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List

from repro_torch.analysis.report import Finding, render


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis",
        description="cache-key / protocol / empirical auditor of the port")
    ap.add_argument("--dead-code", action="store_true",
                    help="run the import-reachability report instead of "
                         "the invariant passes")
    ap.add_argument("--pass", dest="only", default=None,
                    choices=("cache-keys", "protocol", "empirical"),
                    help="run a single invariant pass")
    args = ap.parse_args(argv)

    passes: Dict[str, Callable[[], List[Finding]]] = {}
    if args.dead_code:
        from repro_torch.analysis import deadcode
        passes["dead-code"] = deadcode.run
    else:
        if args.only in (None, "cache-keys"):
            from repro_torch.analysis import cache_keys
            passes["cache-keys"] = cache_keys.run
        if args.only in (None, "protocol"):
            from repro_torch.analysis import protocol
            passes["protocol"] = protocol.run
        if args.only in (None, "empirical"):
            # imported last: it runs the programs on the CPU
            from repro_torch.analysis import empirical
            passes["empirical"] = empirical.run

    findings: List[Finding] = []
    for name, fn in passes.items():
        got = fn()
        status = "OK" if not got else f"{len(got)} finding(s)"
        print(f"[{name}] {status}")
        findings.extend(got)
    if findings:
        print()
        print(render(findings, header=f"{len(findings)} finding(s):"))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
