"""The port's invariant auditor, ``python -m repro_torch.analysis``: the
``@warm_cache`` registry (``registry.py``) that every bounded warm cache
declares its key and reads in, and the pass that audits it
(``cache_keys.py``); the async drain protocol as a checked table
(``protocol.py``), whose runtime half is ``serverless/sanitize.py``; the
empirical checks that stand in for the JAX package's jaxpr audit
(``empirical.py``); and the import-reachability report
(``deadcode.py``).  The static passes read source text (``astutil.py``)
and report ``Finding`` records (``report.py``)."""
from repro_torch.analysis.registry import REGISTRY, WarmCacheSpec, warm_cache

__all__ = ["warm_cache", "WarmCacheSpec", "REGISTRY"]
